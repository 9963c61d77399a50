"""train_mfu: the training window's model operations (3x a forward's) over the
float32 peak of the cell's cards, per cent."""

from avsr_bench.harness import layers


def read(run):
    return layers.mfu(run, "train", 3)
