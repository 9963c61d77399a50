"""score_mfu: the scoring window's model operations over the float32 peak, per cent."""

from avsr_bench.harness import layers


def read(run):
    return layers.mfu(run, "score", 1)
