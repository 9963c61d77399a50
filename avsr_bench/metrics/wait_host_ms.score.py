"""wait_host_ms.score: host milliseconds per request blocked on a block of results
coming home (the span serve.wait in PipelinedServer._unpack); the first traced
window's mean."""

from avsr_bench.harness import spans


def read(run):
    return spans.layer_ms(run, "score", "serve.wait", "host")
