"""Pretraining: RBM CD-1, the greedy DBN, unfolding, autoencoder and
conv-AE finetuning, and the stacked denoising autoencoder (the port of
ip_avsr_tpu/pretrain)."""
