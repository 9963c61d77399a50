"""optimizer_ms.train: Adam's update and the batch-norm merge of a training step
(the span train.optimizer in Trainer.train_step), card milliseconds per step;
the first traced window's mean."""

from avsr_bench.harness import spans


def read(run):
    return spans.layer_ms(run, "train", "train.optimizer", "device")
