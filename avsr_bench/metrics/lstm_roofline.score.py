"""lstm_roofline.score: the inference recurrences (rows 1 and 5) against their bound, per cent."""

from avsr_bench.harness import layers


def read(run):
    return layers.lstm_roofline(run, "score", layers.SCORE_ROWS)
