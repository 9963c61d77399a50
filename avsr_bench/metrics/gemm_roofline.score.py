"""gemm_roofline.score: the scoring window's cuBLAS products against their bound, per cent."""

from avsr_bench.harness import layers


def read(run):
    return layers.gemm_roofline(run, "score")
