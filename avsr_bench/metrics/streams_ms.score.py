"""streams_ms.score: the encoders and the delta stage of a scoring request's
forward (the span model.streams in adenet.adenet_forward), card milliseconds per
request; the first traced window's mean."""

from avsr_bench.harness import spans


def read(run):
    return spans.layer_ms(run, "score", "model.streams", "device")
