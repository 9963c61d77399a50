"""PyTorch/CUDA port of ip_avsr_tpu for NVIDIA Hopper (H100).

The package mirrors ``ip_avsr_tpu``'s layout (``ops/``, ``models/``,
``train/``, ``data/``, ``utils/``, ``serve.py``) and imports neither JAX
nor ``ip_avsr_tpu``.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; every hand-written kernel (``ops/kernels/``,
sources in ``csrc/``) has a plain PyTorch version beside it that runs only
for tensors on the CPU.

The port covers the flagship trimodal AdeNet-v3 (inference from raw uint8
ROI frames to class scores with ``serve.make_trimodal_server``) and the
generic N-stream AdeNets with peephole LSTMs that INI configs such as
``configs/oulu_4stream.ini`` select (``train.config.load_config`` and
``build_model_config``; inference on preprocessed streams with
``serve.make_server``), and their training: the bare step
(``train.trainer.make_train_step``) and the single-device trainer
(``train.trainer.Trainer``: fit, evaluation, checkpoints, every optimizer).
``export`` ships a served program as one artifact through ``torch.export``
(``cli.export_model``; the demo's ``--artifact`` serves it).  The whole
model zoo builds (``models.zoo``, ``models.avnet``), batch norm, grouped
recurrences (``fuse_scans``) and the LSTM residual levers included, and the
training CLIs run from ``.mat`` files.  ``pretrain`` makes the encoders
(RBM CD-1, the greedy DBN, unfolding, AE and conv-AE finetuning, the
stacked denoising AE; ``cli.pretrain_dbn``, ``cli.ae_finetuner``,
``cli.convae``).  The last CLIs and host tools are ported too
(``cli.parity_check``, ``cli.confusion_visualizer``, ``cli.prepare_data``,
``cli.landmark``, ``cli.playvid``, ``utils.plotting``, ``utils.draw_net``),
and ``.mat`` files are read by a native C++ reader (``native``, built by
``g++`` at first use).  Every kernel of the JAX package's ``ops/pallas/``
has its CUDA counterpart.
"""

from ip_avsr_torch.device import resolve_device

__all__ = ["resolve_device"]
