"""The ``lipread_train`` driver: ``train/trainer.Trainer.train_step`` with
Adam on a model whose one stream is a conv front end (``frontend:
"resnet"``, ``models/resnet.py``) of (B, T, H, W) uint8 frames.  As the
``train`` driver, each step copies a pinned host batch to the card without
blocking and runs the step; the batches are made and pinned at set-up and
taken in turn.  Set-up's first three steps are the check's, against the
plain reference ``avsr_bench/reference/resnet_blstm_ref.py`` after the
window.  A step takes about half a second, so the clock is read after
every step.

Besides the ``train`` driver's numbers the check holds ``state_gap``: the
front end's running batch-norm statistics after the third step, which
have no gradient and so enter neither ``grad_gap`` nor ``change_gap``
(:func:`state_gap`).

With ``--trace 1`` the window is traced as every driver's
(``drive.trace_window``), then once more with the host's operators and
their shapes, whose convolutions ``conv_roofline.train`` reads
(``harness/conv_cost.py``).

Its traffic file gives ``batch_per_rank``, ``ranks`` (1), ``lr``,
``min_len`` and ``max_len`` (frames), ``pool_batches``, ``warmup_steps``
and ``trace_steps``.
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from avsr_bench.harness import check, conv_cost, drive, guard, inputs, spec, trace
from avsr_bench.reference import resnet_blstm_ref as ref


def _bn(c: int) -> tuple:
    return ({"gamma": ((c,), "gamma"), "beta": ((c,), inputs.VECTOR_RANGE)},
            {"mean": ((c,), "zeros"), "var": ((c,), "ones")})


def _conv(shape) -> tuple:
    return shape, math.sqrt(6.0 / math.prod(shape[1:]))


def layout(model: dict) -> dict:
    """The parameter tree of ``model`` (``models/adenet.
    init_adenet_params``'s keys, shapes and order) with each leaf
    ``(shape, range)``, drawn uniform on [-range, range), or ``(shape,
    "gamma")`` on 1 +- 0.1, or a running statistic ``(shape, "zeros")`` or
    ``(shape, "ones")``, which is not drawn."""
    (s,) = model["streams"]
    widths = [int(w) for w in s["frontend_widths"]]
    bn, bn_state = _bn(widths[0])
    front = {"stem": {"conv": _conv((widths[0], 1, 5, 7, 7)), "bn": bn}, "layers": []}
    state = {"stem": {"bn": bn_state}, "layers": []}
    c = widths[0]
    for i, (width, n) in enumerate(zip(widths, conv_cost.BLOCKS)):
        front["layers"].append([])
        state["layers"].append([])
        for j in range(n):
            stride = 2 if (i > 0 and j == 0) else 1
            p, st = {"conv1": _conv((width, c, 3, 3))}, {}
            p["bn1"], st["bn1"] = _bn(width)
            p["conv2"] = _conv((width, width, 3, 3))
            p["bn2"], st["bn2"] = _bn(width)
            if stride != 1 or c != width:
                p["down_conv"] = _conv((width, c, 1, 1))
                p["down_bn"], st["down_bn"] = _bn(width)
            front["layers"][-1].append(p)
            state["layers"][-1].append(st)
            c = width
    tree = {"streams": {s["name"]: {"frontend": front, "frontend_state": state}},
            "aggregator": []}
    H, v = int(model["lstm_size"]), inputs.VECTOR_RANGE
    d = c
    for _ in range(int(model["agg_layers"])):
        layer = {}
        for k in ("fwd", "bwd"):
            layer[k] = {"w_in": ((d, 4 * H), math.sqrt(6.0 / (d + H))),
                        "w_hid": ((H, 4 * H), math.sqrt(6.0 / (2 * H))),
                        "b": ((4 * H,), v), "cell_init": ((1, H), v),
                        "hid_init": ((1, H), v)}
        tree["aggregator"].append(layer)
        d = 2 * H if model.get("agg_merge") == "concat" else H
    C = int(model["output_classes"])
    tree["output"] = {"w": ((d, C), math.sqrt(6.0 / (d + C))), "b": ((C,), v)}
    return tree


def make_weights(model: dict, seed: int, device) -> dict:
    """The seeded parameter tree of ``model`` on ``device``, float32: one
    uniform draw on [-1, 1) for every drawn leaf, then each leaf scaled to
    its range (:func:`layout`); running means 0 and variances 1."""
    lay = layout(model)
    leaves = list(inputs._leaves(lay))
    drawn = [(p, shape, r) for p, (shape, r) in leaves if r not in ("zeros", "ones")]
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    flat = torch.empty(total, dtype=torch.float32, device=device).uniform_(
        -1.0, 1.0, generator=inputs.generator(seed, "weights", device))
    values, off = {}, 0
    for path, shape, r in drawn:
        n = math.prod(shape)
        leaf = flat[off: off + n].view(shape)
        values[path] = 1.0 + inputs.VECTOR_RANGE * leaf if r == "gamma" else leaf * r
        off += n
    for path, (shape, r) in leaves:
        if r in ("zeros", "ones"):
            values[path] = (torch.zeros if r == "zeros" else torch.ones)(
                shape, dtype=torch.float32, device=device)
    return inputs._rebuild(lay, values)


def frames_pool(config: dict, n: int, seed: int, device):
    """``n`` clips of uint8 frames (n, T, H, W), uniform on 0..255, drawn on
    ``device`` and copied home."""
    T = int(config["input"]["frames"])
    H, W = (int(v) for v in config["input"]["image_shape"])
    return torch.randint(0, 256, (n, T, H, W), dtype=torch.uint8,
                         generator=inputs.generator(seed, "frames", device),
                         device=device).cpu().numpy()


def train_pool(config: dict, traffic: dict, seed: int, device):
    """``pool_batches`` batches of clips, with their labels, masks and
    lengths (every clip ``max_len`` frames long where ``min_len`` equals
    it)."""
    N = int(traffic["pool_batches"]) * int(traffic["batch_per_rank"])
    T = int(config["input"]["frames"])
    lens = inputs.lengths(N, int(traffic["min_len"]), int(traffic["max_len"]), seed)
    return (frames_pool(config, N, seed, device), inputs.masks(lens, T),
            inputs.labels(N, int(config["model"]["output_classes"]), seed), lens)


def batches(seed: int, N: int, B: int):
    """The rows of each batch, forever: a seeded permutation of the pool cut
    into batches, then the next; the first ``N // B`` share no row."""
    order = inputs.order(seed)
    while True:
        perm = order.permutation(N)
        for k in range(N // B):
            yield perm[k * B:(k + 1) * B]


def running_stats(params: dict) -> dict:
    """The running statistics of a parameter tree, by leaf path, copied."""
    return {path: t.detach().clone() for path, t in ref.leaves(params) if ref.is_state(path)}


def state_gap(got: dict, want: dict) -> float:
    """The largest gap between two readings of the running statistics (by
    :func:`running_stats`), leaf by leaf: the norm of their difference over
    the larger of the reference leaf's norm and the median leaf's."""
    norms = {k: float(t.double().norm()) for k, t in want.items()}
    median = statistics.median(norms.values())
    return max(float((got[k].double() - want[k].double()).norm()) / max(norms[k], median)
               for k in want)


def reference_train(config: dict, traffic: dict, seed: int, pool, device, tf32: bool,
                    rows: int = None) -> dict:
    """The reference's readings over the first three batches (in float32
    or, with ``tf32``, the control's precision), with the running
    statistics after them under ``"state"``; with ``rows``, over the first
    ``rows`` rows of each (a fault of the control)."""
    frames, mask, labels, _ = pool
    order = batches(seed, len(mask), int(traffic["batch_per_rank"]))
    steps = []
    for _ in range(3):
        idx = next(order)[:rows]
        steps.append((torch.as_tensor(frames[idx], device=device),
                      torch.as_tensor(labels[idx], device=device),
                      torch.as_tensor(mask[idx], device=device)))
    p0 = make_weights(config["model"], seed, device)
    with ref.precision(tf32):
        losses, first, p3 = ref.train_steps(config["model"], p0, steps, float(traffic["lr"]))
    return {**check.reference_readings(p0, losses, first, p3), "state": running_stats(p3)}


def gaps(got: dict, want: dict) -> dict:
    """The cell's numbers: ``check.train_gaps`` and :func:`state_gap`."""
    return {**check.train_gaps(got, want), "state_gap": state_gap(got["state"], want["state"])}


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t0: float,
        world: int = 1, rank: int = 0, flag_group=None) -> drive.Run:
    """One run of a conv front-end training cell on one card."""
    from ip_avsr_torch.train.trainer import Trainer, TrainOptions

    if world != 1:
        raise ValueError(f"{cell.name}: the lipread_train driver runs on one card")
    config, traffic = cell.config, cell.traffic
    drive.set_precision(config)
    B, lr = int(traffic["batch_per_rank"]), float(traffic["lr"])
    trainer = Trainer(drive.adenet_config(config["model"]),
                      TrainOptions(learning_rate=lr, optimizer="adam", batchsize=B,
                                   log_fn=lambda _: None), device=device)
    out = drive.Run("train", config, traffic, device, traced, world)
    out.lstm_shape = (B, int(config["input"]["frames"]))
    params = make_weights(config["model"], seed, device)
    opt_state = trainer.optimizer.init(params)
    gen = inputs.generator(seed, "dropout", device)
    pool = train_pool(config, traffic, seed, device)
    frames, mask, labels, lens = pool
    rows = batches(seed, len(mask), B)
    ring = []
    for _ in range(int(traffic["pool_batches"])):
        idx = next(rows)
        host = [torch.from_numpy(a) for a in (frames[idx], labels[idx], mask[idx])]
        ring.append((int(lens[idx].sum()),
                     [t.pin_memory() if device.type == "cuda" else t for t in host]))
    done = []

    def step():
        nonlocal params, opt_state
        n_frames, host = ring[len(done) % len(ring)]
        done.append(n_frames)
        x, y, m = (t.to(device, non_blocking=True) for t in host)
        params, opt_state, loss = trainer.train_step(params, opt_state, [x], y, m, gen, lr)
        return loss

    p0 = params
    losses = [step()]
    m1 = opt_state["m"]
    losses += [step(), step()]
    got = {**check.program_readings(p0, params, m1, losses), "state": running_stats(params)}
    del p0, m1
    for _ in range(int(traffic["warmup_steps"])):
        step()
    drive.sync(device)
    done_before = len(done)
    gc.collect()
    gc.freeze()
    out.setup_s = time.perf_counter() - t0
    steps = 0
    if traced:
        steps = int(traffic["trace_steps"])

        def body():
            for _ in range(steps):
                step()

        drive.trace_window(out, body, device)
        with trace.profiler(device) as prof:
            body()
            drive.sync(device)
        out.convs = conv_cost.conv_records(prof)
        del prof
    else:
        start = time.perf_counter()
        end = start + seconds
        while time.perf_counter() < end:
            step()
            steps += 1
        drive.sync(device)
        out.window_s = time.perf_counter() - start
    out.unexpected = guard.forbidden_modules()
    out.attempted = out.completed = steps
    out.utterances = steps * B
    out.valid_frames = sum(done[done_before:done_before + steps])
    out.memory_peak_bytes = drive.memory_peak(device)
    del trainer, params, opt_state, ring, step
    gc.unfreeze()
    drive.free(device)
    want = reference_train(config, traffic, seed, pool, device, tf32=False)
    out.checks = gaps(got, want)
    return out


def control(cell: spec.Cell, seed: int, device) -> dict:
    """The control's and the faults' readings of the check (see
    ``harness/control.py``); ``state_not_merged`` is a program that leaves
    the running statistics as they were drawn."""
    config, traffic = cell.config, cell.traffic
    pool = train_pool(config, traffic, seed, device)
    full = reference_train(config, traffic, seed, pool, device, tf32=False)
    low = reference_train(config, traffic, seed, pool, device, tf32=True)
    half = reference_train(config, traffic, seed, pool, device, tf32=False,
                           rows=int(traffic["batch_per_rank"]) // 2)
    drawn = running_stats(make_weights(config["model"], seed, device))
    return {"control": gaps(low, full),
            "faults": {"state_unchanged": {"change_gap": 1.0},
                       "half_batch": gaps(half, full),
                       "state_not_merged": {"state_gap": state_gap(drawn, full["state"])}}}
