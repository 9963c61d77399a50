"""launch_calls_per_step.train: the host's kernel-launch calls per training step
in the traced window (cudaLaunchKernel, its ExC form, cuLaunchKernel and the
cooperative launches)."""


def read(run):
    if run.kind != "train" or not run.traced or run.summary is None or not run.completed:
        return None
    if run.device.type != "cuda" or not run.summary["launch_calls"]:
        return None
    return run.summary["launch_calls"] / run.completed
