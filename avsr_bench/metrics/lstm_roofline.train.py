"""lstm_roofline.train: the training recurrences and backward chains (rows 3, 4,
6 and 7) against their bound, per cent."""

from avsr_bench.harness import layers


def read(run):
    return layers.lstm_roofline(run, "train", layers.TRAIN_ROWS)
