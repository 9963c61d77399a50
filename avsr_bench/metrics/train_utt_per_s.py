"""train_utt_per_s: utterances trained on by the steps finished in the window
(over every rank), per second of it."""


def read(run):
    if run.traced or run.kind != "train":
        return None
    return run.utterances * run.world / run.window_s
