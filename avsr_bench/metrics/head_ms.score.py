"""head_ms.score: the recurrent head of a scoring request's forward: stream LSTMs,
fusion, aggregator, classifier (the span model.head in adenet.adenet_forward),
card milliseconds per request; the first traced window's mean."""

from avsr_bench.harness import spans


def read(run):
    return spans.layer_ms(run, "score", "model.head", "device")
