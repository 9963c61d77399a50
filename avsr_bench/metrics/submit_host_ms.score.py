"""submit_host_ms.score: host milliseconds per request between the loop handing a
request to serve.PipelinedServer.map and the server asking for the next (the
benchmark's own spans, traced window)."""

import statistics


def read(run):
    if run.kind != "score" or not run.traced or not run.spans:
        return None
    return 1e3 * statistics.fmean(run.spans)
