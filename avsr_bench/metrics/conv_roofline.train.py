"""conv_roofline.train: the training window's convolutions, forward and backward
(data and weight gradients, cuDNN), against their bound from each call's shapes,
per cent; read from the profiled window with shapes that the lipread_train
driver adds."""

from avsr_bench.harness import conv_cost


def read(run):
    records = getattr(run, "convs", None)
    if run.kind != "train" or not run.traced or not records or run.device.type != "cuda":
        return None
    return conv_cost.roofline(records)
