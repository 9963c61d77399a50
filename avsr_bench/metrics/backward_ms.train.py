"""backward_ms.train: the backward of a training step (the span train.backward,
torch.autograd.grad in trainer.grads_of), card milliseconds per step; the first
traced window's mean."""

from avsr_bench.harness import spans


def read(run):
    return spans.layer_ms(run, "train", "train.backward", "device")
