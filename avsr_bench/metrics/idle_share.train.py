"""idle_share.train: per cent of the traced training window the card sat idle
(the mean over the ranks on several cards)."""

from avsr_bench.harness import layers


def read(run):
    return layers.idle_share(run, "train")
