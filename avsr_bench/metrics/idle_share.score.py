"""idle_share.score: per cent of the traced scoring window the card sat idle."""

from avsr_bench.harness import layers


def read(run):
    return layers.idle_share(run, "score")
