"""forward_ms.train: the forward and the loss of a training step (the span
train.forward in trainer.grads_of), card milliseconds per step; the first traced
window's mean."""

from avsr_bench.harness import spans


def read(run):
    return spans.layer_ms(run, "train", "train.forward", "device")
