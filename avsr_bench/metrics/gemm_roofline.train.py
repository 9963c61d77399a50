"""gemm_roofline.train: the training window's cuBLAS products, forward and
backward, against their bound, per cent."""

from avsr_bench.harness import layers


def read(run):
    return layers.gemm_roofline(run, "train")
