"""lipread_mfu.train: the training window's model operations (3x a forward's:
the conv front end, the BLSTM's products and the head) over the float32 peak,
per cent; a model without a conv front end reads nothing."""

from avsr_bench.harness import conv_cost, yardstick


def read(run):
    if run.kind != "train" or not run.traced or run.device.type != "cuda" or not run.window_s:
        return None
    per_frame = conv_cost.frontend_model_flops(run.config)
    if per_frame is None:
        return None
    return 100.0 * 3 * per_frame * run.valid_frames / (run.window_s * yardstick.F32_FLOP_PER_S)
