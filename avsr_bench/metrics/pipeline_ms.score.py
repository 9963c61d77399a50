"""pipeline_ms.score: the on-card input pipeline of a scoring request: DCT,
difference images, normalisation (the span serve.pipeline in
TrimodalServer.forward), card milliseconds per request; the first traced
window's mean."""

from avsr_bench.harness import spans


def read(run):
    return spans.layer_ms(run, "score", "serve.pipeline", "device")
