"""stage_host_ms.score: host milliseconds per request staging its arrays in pinned
memory and issuing the one non_blocking upload (the span serve.stage in
PipelinedServer.submit); the first traced window's mean."""

from avsr_bench.harness import spans


def read(run):
    return spans.layer_ms(run, "score", "serve.stage", "host")
