"""The ``train`` driver: ``train/trainer.Trainer.train_step`` with Adam,
each step a pinned host batch copied to the card without blocking, then
the step.  The batches are made and pinned at set-up and taken in turn, so
that the window holds the program's work and none of the benchmark's own
batch making (``Trainer.fit``'s host data path is not driven here).  With
``ranks`` > 1 one process per card runs its rows of the global batch
through the Trainer's data-parallel mesh (``use_mesh``, ``gspmd``).

Its traffic file gives ``batch_per_rank``, ``ranks``, ``lr``, ``min_len``
and ``max_len`` (frames), ``pool_batches`` (global batches of distinct
rows), ``warmup_steps`` and ``trace_steps``.  Set-up's first three steps
are the check's.
"""

from __future__ import annotations

import gc
import time

import torch

from avsr_bench.harness import check, drive, guard, inputs, spec
from avsr_bench.reference import adenet_ref as ref

# steps between two looks at the clock for the window's end (on several
# cards, an all-reduce of the ranks' flags over gloo)
STOP_CHECK_EVERY = 4


def train_pool(config: dict, traffic: dict, seed: int, device, world: int = 1):
    """The host pool of a training cell: ``pool_batches`` global batches of
    utterances, with their masks, labels and lengths."""
    G = int(traffic["batch_per_rank"]) * world
    N = int(traffic["pool_batches"]) * G
    T = int(config["input"]["frames"])
    lens = inputs.lengths(N, int(traffic["min_len"]), int(traffic["max_len"]), seed)
    streams = inputs.frames_pool(config, N, lens, seed, device, features=True)
    return streams, inputs.masks(lens, T), inputs.labels(
        N, int(config["model"]["output_classes"]), seed), lens


def global_batches(seed: int, N: int, G: int):
    """The rows of each global batch, forever: a seeded permutation of the
    pool cut into batches, then the next; the first ``N // G`` batches
    share no row."""
    order = inputs.order(seed)
    while True:
        perm = order.permutation(N)
        for k in range(N // G):
            yield perm[k * G:(k + 1) * G]


def reference_train(config: dict, traffic: dict, seed: int, pool, device, world: int,
                    tf32: bool, rows: int = None) -> dict:
    """The reference's readings over the first three global batches (in
    float32 or, with ``tf32``, the control's precision); with ``rows``,
    over the first ``rows`` rows of each (a fault of the control)."""
    streams, mask, labels, _ = pool
    G = int(traffic["batch_per_rank"]) * world
    order = global_batches(seed, len(mask), G)
    batches = []
    for _ in range(3):
        idx = next(order)[:rows]
        batches.append(([torch.as_tensor(s[idx], device=device) for s in streams],
                        torch.as_tensor(labels[idx], device=device),
                        torch.as_tensor(mask[idx], device=device)))
    model = config["model"]
    p0 = inputs.make_weights(model, seed, device)
    gen = inputs.generator(seed, "dropout", device)
    with ref.precision(tf32):
        losses, first, p3 = ref.train_steps(model, p0, batches, float(traffic["lr"]),
                                            [gen] * 3)
    return check.reference_readings(p0, losses, first, p3)


def _window_closed(world: int, group, end: float) -> bool:
    """Whether the window has closed, agreed by every rank: the max of
    their flags over the gloo ``group``."""
    if world == 1:
        return time.perf_counter() >= end
    import torch.distributed as dist

    flag = torch.tensor([1.0 if time.perf_counter() >= end else 0.0])
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag.item())


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t0: float,
        world: int = 1, rank: int = 0, flag_group=None) -> drive.Run:
    """One run of a training cell on this rank (of ``world``).  Rank 0
    (alone) runs the reference and sets ``checks``."""
    from ip_avsr_torch.parallel import mesh as mesh_lib
    from ip_avsr_torch.train.trainer import Trainer, TrainOptions

    config, traffic = cell.config, cell.traffic
    drive.set_precision(config)
    out = drive.Run("train", config, traffic, device, traced, world)
    Bl = int(traffic["batch_per_rank"])
    G = Bl * world
    lr = float(traffic["lr"])
    out.lstm_shape = (Bl, int(config["input"]["frames"]))
    trainer = Trainer(drive.adenet_config(config["model"]),
                      TrainOptions(learning_rate=lr, optimizer="adam", batchsize=G,
                                   use_mesh=world > 1, mesh_mode="gspmd",
                                   log_fn=lambda _: None), device=device)
    params = inputs.make_weights(config["model"], seed, device)
    if trainer.mesh is not None:
        params = mesh_lib.replicate(trainer.mesh, params)
    opt_state = trainer.optimizer.init(params)
    gen = inputs.generator(seed, "dropout", device)
    pool = train_pool(config, traffic, seed, device, world)
    streams, mask, labels, lens = pool
    # this rank's rows of each global batch of the pool, pinned once; the
    # steps take them in turn (the first three are the check's)
    rows = global_batches(seed, len(mask), G)
    ring = []
    for _ in range(int(traffic["pool_batches"])):
        idx = next(rows)[rank * Bl:(rank + 1) * Bl]
        host = [torch.from_numpy(a) for a in [s[idx] for s in streams] + [labels[idx], mask[idx]]]
        ring.append((int(lens[idx].sum()),
                     [t.pin_memory() if device.type == "cuda" else t for t in host]))
    frames = []

    def step():
        nonlocal params, opt_state
        n_frames, host = ring[len(frames) % len(ring)]
        frames.append(n_frames)
        dev = [t.to(device, non_blocking=True) for t in host]
        params, opt_state, loss = trainer.train_step(params, opt_state, dev[:-2], dev[-2],
                                                     dev[-1], gen, lr)
        return loss

    p0 = params
    losses = [step()]
    m1 = opt_state["m"]
    losses += [step(), step()]
    got = check.program_readings(p0, params, m1, losses)
    del p0, m1
    for _ in range(int(traffic["warmup_steps"])):
        step()
    drive.sync(device)
    done_before = len(frames)
    gc.collect()
    gc.freeze()  # set-up's objects are never scanned again by the collector
    if world > 1:
        import torch.distributed as dist

        dist.barrier(group=flag_group)
    out.setup_s = time.perf_counter() - t0
    steps = 0
    if traced:
        steps = int(traffic["trace_steps"])

        def body():
            for _ in range(steps):
                step()

        drive.trace_window(out, body, device)
    else:
        start = time.perf_counter()
        end = start + seconds
        while True:
            step()
            steps += 1
            if steps % STOP_CHECK_EVERY == 0 and _window_closed(world, flag_group, end):
                break
        drive.sync(device)
        out.window_s = time.perf_counter() - start
    out.unexpected = guard.forbidden_modules()
    out.attempted = out.completed = steps
    out.utterances = steps * Bl
    out.valid_frames = sum(frames[done_before:done_before + steps])
    out.memory_peak_bytes = drive.memory_peak(device)
    del trainer, params, opt_state, ring, step
    gc.unfreeze()
    drive.free(device)
    if rank == 0:
        want = reference_train(config, traffic, seed, pool, device, world, tf32=False)
        out.checks = check.train_gaps(got, want)
    return out


def control(cell: spec.Cell, seed: int, device) -> dict:
    """The control's and the faults' readings of the check (see
    ``harness/control.py``)."""
    config, traffic = cell.config, cell.traffic
    world = int(traffic.get("ranks", 1))
    pool = train_pool(config, traffic, seed, device, world)
    full = reference_train(config, traffic, seed, pool, device, world, tf32=False)
    low = reference_train(config, traffic, seed, pool, device, world, tf32=True)
    G = int(traffic["batch_per_rank"]) * world
    # a step that returns its state unchanged reads 1 by change_gap, no run
    # needed; the others see only the first rows of each global batch (the
    # mean over them): half of it, or on several cards rank 0's rows alone,
    # the gradients' exchange between the cards left out
    faults = {"state_unchanged": {"change_gap": 1.0}}
    cuts = {"half_batch": G // 2}
    if world > 1:
        cuts["exchange_left_out"] = int(traffic["batch_per_rank"])
    for name, rows in cuts.items():
        part = reference_train(config, traffic, seed, pool, device, world, tf32=False,
                               rows=rows)
        faults[name] = check.train_gaps(part, full)
    return {"control": check.train_gaps(low, full), "faults": faults}
