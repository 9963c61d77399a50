"""collective_share.train: per cent of the traced training window spent in nccl
kernels, waits for the slowest rank included (they spin on the card)."""


def read(run):
    if run.kind != "train" or not run.traced or run.world < 2 or run.summary is None:
        return None
    if run.device.type != "cuda" or not run.summary["nccl_s"]:
        return None
    return 100.0 * run.summary["nccl_s"] / run.window_s
