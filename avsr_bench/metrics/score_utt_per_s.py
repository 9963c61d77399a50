"""score_utt_per_s: utterances whose scores came home within the window, per second."""


def read(run):
    if run.traced or run.kind != "score":
        return None
    return run.utterances / run.window_s
