"""frontend_ms.train: the conv front end's forward in a training step (the span
model.frontend in models/adenet.stream_prefix: the 3-D stem, the residual trunk
and the pool), card milliseconds per step; the first traced window's mean."""

from avsr_bench.harness import spans


def read(run):
    return spans.layer_ms(run, "train", "model.frontend", "device")
