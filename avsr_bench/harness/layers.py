"""The arithmetic of the per-layer metrics, shared by their readers
(``avsr_bench/metrics/<name>.py``).  Each returns None where the run has
nothing to read: no traced window, no card, or no record of the layer."""

from __future__ import annotations

import statistics

from avsr_bench.harness import trace, yardstick

ROW_COSTS = {
    "lstm_recurrence": yardstick.lstm_cost,
    "lstm_peep_recurrence": yardstick.lstm_cost,
    "lstm_recurrence_train": yardstick.lstm_train_cost,
    "lstm_peep_recurrence_train": yardstick.lstm_train_cost,
    "lstm_bwd_chain": yardstick.lstm_bwd_cost,
    "lstm_peep_bwd_chain": yardstick.lstm_bwd_cost,
}
SCORE_ROWS = ("lstm_recurrence", "lstm_peep_recurrence")
TRAIN_ROWS = ("lstm_recurrence_train", "lstm_peep_recurrence_train", "lstm_bwd_chain",
              "lstm_peep_bwd_chain")


def _traced(run, kind: str) -> bool:
    return run.kind == kind and run.traced and run.summary is not None and (
        run.device.type == "cuda")


def mfu(run, kind: str, passes: int):
    """Per cent of the float32 peak: the model's product operations on the
    traced window's valid frames (``passes`` times one forward's: 1 to
    score, 3 to train, none recomputed counted) over the window."""
    if not _traced(run, kind):
        return None
    per_frame, per_utt = yardstick.model_flops(run.config["model"])
    flops = passes * (per_frame * run.valid_frames + per_utt * run.utterances)
    return 100.0 * flops / (run.window_s * yardstick.F32_FLOP_PER_S)


def idle_share(run, kind: str):
    """Per cent of the traced window in which no operation ran on the card."""
    if not _traced(run, kind):
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)


def lstm_roofline(run, kind: str, rows):
    """Per cent: the LSTM rows' bound time over their traced time.  Each
    row's time is its recorded launches' mean times the launches the
    port's counters gave; its bound, each call's (the larger of operations
    at the float32 peak and bytes at the HBM rate), the calls spread evenly
    over the model's recurrences as every forward spreads them."""
    if not _traced(run, kind):
        return None
    layers = yardstick.lstm_layers(run.config["model"])
    B, T = run.lstm_shape
    bound = spent = 0.0
    for row in rows:
        calls, launches = run.launches[row]
        if not calls:
            continue
        t = trace.row_time(run.summary, row, launches)
        if t is None:
            return None
        per_call = statistics.fmean(yardstick.bound(*ROW_COSTS[row](B, T, H, peep))
                                    for _, _, H, peep in layers)
        bound += calls * per_call
        spent += t
    return 100.0 * bound / spent if spent else None


def gemm_roofline(run, kind: str):
    """Per cent: the ``aten::mm``/``aten::addmm`` calls' bound time (from
    their shapes) over their traced device time."""
    if not _traced(run, kind):
        return None
    calls = [g for g in run.summary["gemms"] if g[3] > 0]
    spent = sum(g[3] for g in calls)
    if not spent:
        return None
    return 100.0 * sum(yardstick.bound(*yardstick.gemm_cost(M, K, N))
                       for M, K, N, _ in calls) / spent
