"""Rank bodies for the multi-process runs: the port of
ip_avsr_tpu/parallel/_multiprocess_worker.py.

Each function here runs on every rank of a pool that
``utils/cpu_mesh.RankPool`` (or ``spawn_ranks``) started, as one SPMD
program: it builds what it needs from its picklable arguments (configs,
numpy parameter trees and batches), runs one path of the port over the
group, and returns numpy results for the caller to compare.  The tests and
``chip_smoke.py`` send these, so that a spawned rank imports neither a test
module nor JAX; every body first checks that JAX is not loaded in a rank.
Without a group the same bodies run in the caller's process, as the
one-process reference.

``make_corpus`` and ``make_case`` are the JAX worker's deterministic corpus
and case (the same seeds, the port's model and init); ``multihost_step`` is
its two-process run: each rank contributes its rows of the global batch
through ``TrainOptions(multihost=True)``, then a short multihost fit.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch
import torch.distributed as dist

from ip_avsr_torch.device import tree_map


def no_jax():
    """Raise in a rank of a group that has JAX loaded (a body run in the
    caller's own process, as a one-process reference, is not checked)."""
    if dist.is_initialized() and "jax" in sys.modules:
        raise AssertionError("a rank process imported jax")


def tensors(tree, device="cpu"):
    """A numpy tree as tensors on ``device`` (copies)."""
    return tree_map(lambda a: torch.as_tensor(np.array(a), device=device), tree)


def arrays(tree):
    """A tensor tree as numpy arrays (on the host)."""
    return tree_map(lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                    else np.asarray(t), tree)


def shapes(tree):
    return tree_map(lambda t: tuple(t.shape), tree)


def _quiet(*_):
    pass


def trainer(cfg, options: dict, device="cpu"):
    from ip_avsr_torch.train.trainer import Trainer, TrainOptions

    return Trainer(cfg, TrainOptions(log_fn=_quiet, **options), device=device)


def setup_state(tr, params):
    """A whole numpy parameter tree -> this rank's ``(params, opt_state)``
    on the trainer's device (its blocks under tensor parallelism and
    ZeRO-1), as ``Trainer.fit`` places them."""
    p = tensors(params, tr.device)
    tr._finalize_optimizer(p)
    st = tr.optimizer.init(p)
    if tr.mesh is not None and tr._tp_active:
        return tr._setup_tensor_parallel(p, st)
    if tr.mesh is not None and tr.options.zero1:
        return tr._setup_zero1(p, st)
    return p, st


def trainer_step(cfg, options: dict, params, batch, seed: int = 3, lr: float = 1e-3,
                 device="cpu", evaluate: bool = True) -> dict:
    """One ``Trainer.train_step`` on this rank's share of ``batch`` =
    (streams, y, mask) from ``params``, with the generator seeded by
    ``seed``: the global loss, the whole updated parameters and optimizer
    state, this rank's leaf shapes, and (``evaluate``) from ``params`` the
    whole batch's gradients, eval cost, predictions and confusion
    counts."""
    no_jax()
    tr = trainer(cfg, options, device)
    p0, s0 = setup_state(tr, params)
    dev = tr._device_batch(*batch)
    seed = tr._dropout_seed(seed)
    gen = lambda: torch.Generator(device=tr.device).manual_seed(seed)  # noqa: E731
    out = {"mesh": None if tr.mesh is None else dict(tr.mesh.shape),
           "local_params": shapes(p0), "local_opt_state": shapes(s0)}
    if evaluate:
        if tr.mesh is not None:
            _, grads, _ = tr.mesh_loss_and_grads(p0, *dev, gen())
        else:
            from ip_avsr_torch.train.trainer import loss_and_grads

            _, grads = loss_and_grads(p0, cfg, *dev, gen(), window=tr.options.window)
        out.update(grads=arrays(tr._whole(grads, tr._param_sh)),
                   eval_cost=float(tr.eval_cost(p0, *dev)),
                   predict=arrays(tr.predict(p0, dev[0], dev[2])),
                   confusion=arrays(tr.eval_confusion(p0, *dev)))
    p1, s1, loss = tr.train_step(p0, s0, *dev, gen(), lr)
    p1, s1 = tr._whole_state(p1, s1)
    out.update(loss=float(loss), params=arrays(p1), opt_state=arrays(s1))
    return out


def trainer_refusal(cfg, options: dict) -> str:
    """The ValueError a Trainer with ``options`` raises on this rank."""
    no_jax()
    try:
        trainer(cfg, options)
    except ValueError as e:
        return str(e)
    raise AssertionError(f"no ValueError for {options}")


def trainer_fit(cfg, options: dict, train, val, test, params=None, device="cpu") -> dict:
    """``Trainer.fit`` on every rank (from ``params`` when given): the
    result's numbers and best parameters."""
    no_jax()
    tr = trainer(cfg, options, device)
    if params is not None:
        tr.init_params = lambda generator, **kw: tensors(params, tr.device)
    res = tr.fit(train, val, test)
    return {"cost_val": [float(v) for v in res.cost_val],
            "cost_train": [float(v) for v in res.cost_train],
            "class_rate": [float(v) for v in res.class_rate],
            "best_val": float(res.best_val), "best_cr": float(res.best_cr),
            "test_cr": float(res.test_cr), "test_conf": np.asarray(res.test_conf),
            "epochs_run": res.epochs_run, "final_lr": res.final_lr,
            "best_params": arrays(res.best_params)}


def evaluate(cfg, options: dict, params, streams, y, mask, eval_batchsize=512) -> tuple:
    """``Trainer.evaluate`` of a split on every rank -> (rate, confusion)."""
    no_jax()
    tr = trainer(cfg, options)
    cr, conf = tr.evaluate(tensors(params), streams, y, mask, eval_batchsize=eval_batchsize)
    return float(cr), np.asarray(conf)


def serve(cfg, params, streams, mask, vote: bool = True, device="cpu") -> dict:
    """``serve.make_server(mesh=make_mesh())``'s scores of one request,
    and the error a batch the mesh does not divide gets."""
    from ip_avsr_torch import serve as serve_lib
    from ip_avsr_torch.parallel import mesh as mesh_lib

    no_jax()
    mesh = mesh_lib.make_mesh()
    fn = serve_lib.make_server(tensors(params), cfg, vote=vote, mesh=mesh, device=device)
    out = {"scores": arrays(fn(streams, mask))}
    if mesh.size > 1:
        try:
            fn([s[:mesh.size + 1] for s in streams], mask[:mesh.size + 1])
        except ValueError as e:
            out["error"] = str(e)
    return out


def multihost_rows(global_batch: int) -> dict:
    """``process_local_slice`` and ``global_batch_from_local`` on this
    rank."""
    from ip_avsr_torch.parallel import mesh as mesh_lib
    from ip_avsr_torch.parallel import multihost

    no_jax()
    sl = multihost.process_local_slice(global_batch)
    x = np.arange(global_batch * 3, dtype=np.float32).reshape(global_batch, 3)
    local = multihost.global_batch_from_local(mesh_lib.make_mesh(), x[sl],
                                              global_batch=global_batch)
    out = {"slice": (sl.start, sl.stop), "local": local.numpy()}
    try:
        multihost.process_local_slice(global_batch + 1)
    except ValueError as e:
        out["error"] = str(e)
    return out


def _sp_mesh(data: int, seq: int):
    from ip_avsr_torch.parallel import mesh as mesh_lib

    return mesh_lib.make_mesh_nd({"data": data, "seq": seq})


def sp_delta(x, window: int, n_seq: int, weights) -> dict:
    """``append_delta_coeff_sp`` of this rank's time block of ``x`` (on a
    data x seq mesh), gathered over seq; the gradient of sum(out * weights)
    with respect to ``x``, gathered likewise; or the error it raises."""
    from ip_avsr_torch.parallel import collectives
    from ip_avsr_torch.parallel import sequence

    no_jax()
    mesh = _sp_mesh(dist.get_world_size() // n_seq, n_seq)
    T_local = x.shape[1] // n_seq
    frames = slice(mesh.axis_index("seq") * T_local, (mesh.axis_index("seq") + 1) * T_local)
    xb = torch.from_numpy(np.array(x[:, frames])).requires_grad_(True)
    try:
        out = sequence.append_delta_coeff_sp(xb, window, "seq", n_seq, mesh)
    except ValueError as e:
        return {"error": str(e)}
    (torch.from_numpy(np.array(weights[:, frames])) * out).sum().backward()
    group = mesh.group("seq")
    return {"out": collectives.all_gather(out.detach(), 1, group).numpy(),
            "grad": collectives.all_gather(xb.grad, 1, group).numpy()}


def sp_forward(cfg, params, inputs, mask, data: int, seq: int, y=None, train=False,
               seed: int = 7) -> dict:
    """``adenet_forward_sp`` on a data x seq mesh: the whole batch's output
    (and with ``train`` the batch-norm aux); with labels ``y`` also the
    gradients of the masked last-step loss of that output, summed over the
    ranks (the whole gradient)."""
    from ip_avsr_torch.ops import losses
    from ip_avsr_torch.parallel import collectives
    from ip_avsr_torch.parallel import sequence
    from ip_avsr_torch.train.trainer import grads_of

    no_jax()
    mesh = _sp_mesh(data, seq)
    xs = [torch.from_numpy(np.array(x)) for x in inputs]
    m = torch.from_numpy(np.array(mask))
    gen = lambda: torch.Generator().manual_seed(seed)  # noqa: E731
    out, aux = sequence.adenet_forward_sp(tensors(params), cfg, xs, m, mesh, train=train,
                                          generator=gen(), return_aux=True)
    res = {"out": arrays(out), "bn_state": arrays(aux["bn_state"])}
    if y is not None:
        yt = torch.from_numpy(np.array(y)).long()

        def fn(p):
            o = sequence.adenet_forward_sp(p, cfg, xs, m, mesh, train=train, generator=gen())
            loss = losses.categorical_crossentropy_masked(o, yt, m.sum(dim=1) > 0)
            return loss, loss.detach()

        res["loss"], grads = grads_of(fn, tensors(params))
        leaves = []
        tree_map(leaves.append, grads)
        summed = iter(collectives.flat_all_reduce(leaves, mesh.group(("data", "seq"))))
        res["grads"] = arrays(tree_map(lambda _: next(summed), grads))
        res["loss"] = float(res["loss"])
    return res


def sp_errors(cfg, params, inputs, mask, data: int, seq: int) -> list:
    """The ValueErrors of ``adenet_forward_sp`` for a T and a B the mesh
    does not divide."""
    from ip_avsr_torch.parallel import sequence

    no_jax()
    mesh = _sp_mesh(data, seq)
    xs = [torch.from_numpy(np.array(x)) for x in inputs]
    m = torch.from_numpy(np.array(mask))
    got = []
    for cut in ((slice(None), slice(0, xs[0].shape[1] - 1)), (slice(0, 6), slice(None))):
        try:
            sequence.adenet_forward_sp(tensors(params), cfg, [x[cut] for x in xs], m[cut], mesh)
            got.append(None)
        except ValueError as e:
            got.append(str(e))
    return got


def strided_collectives(a, w) -> dict:
    """On each rank ``k`` of the world group, with ``x`` = ``a[k]``
    transposed (a dense tensor in permuted strides): ``ppermute`` of ``x``
    from each rank to the next, the gradient of sum(y^T * w[k]) with
    respect to ``a[k]`` (the exchange's backward gets a transposed
    cotangent), and ``all_gather`` of ``x`` along dim 0."""
    from ip_avsr_torch.parallel import collectives

    no_jax()
    k, n, world = dist.get_rank(), dist.get_world_size(), dist.group.WORLD
    leaf = torch.from_numpy(np.array(a[k])).requires_grad_(True)
    x = leaf.t()
    y = collectives.ppermute(x, [(i, i + 1) for i in range(n - 1)], world)
    (y.t() * torch.from_numpy(np.array(w[k]))).sum().backward()
    return {"y": y.detach().numpy(), "grad": leaf.grad.numpy(),
            "gathered": collectives.all_gather(x.detach(), 0, world).numpy()}


def bn_synced(x, axis_name="data") -> dict:
    """Batch norm with statistics synced over the ranks, each rank on its
    rows of ``x``: the whole output (gathered) and the moved statistics."""
    from ip_avsr_torch.ops import normalization as norm
    from ip_avsr_torch.parallel import collectives
    from ip_avsr_torch.parallel import mesh as mesh_lib

    no_jax()
    mesh = mesh_lib.make_mesh()
    params, state = norm.init_batch_norm(x.shape[-1])
    y, new = norm.batch_norm_forward(params, state,
                                     mesh_lib.batch_sharding(mesh).local(torch.from_numpy(x)),
                                     True, axis_name=axis_name, mesh=mesh)
    return {"y": collectives.all_gather(y, 0, mesh.group("data")).numpy(),
            "state": arrays(new)}


def nstream_options(argv) -> dict:
    """``cli.nstream.main(argv)`` on every rank, with the ``TrainOptions``
    that reached its Trainer and the Trainer's mesh recorded."""
    from ip_avsr_torch.cli import nstream

    no_jax()
    seen = {}
    base = nstream.Trainer

    class Recording(base):
        def __init__(self, config, options, device=None):
            super().__init__(config, options, device)
            seen["options"] = {k: getattr(options, k) for k in (
                "use_mesh", "mesh_mode", "model_parallel", "sequence_parallel", "zero1")}
            seen["mesh"] = None if self.mesh is None else dict(self.mesh.shape)

    nstream.Trainer = Recording
    try:
        res = nstream.main(list(argv))
    finally:
        nstream.Trainer = base
    seen.update(cost_val=[float(v) for v in res.cost_val], test_cr=float(res.test_cr))
    return seen


# -- the JAX worker's two-process multihost case ---------------------------

def make_corpus(n_videos: int = 24, dim: int = 10, classes: int = 4):
    """Deterministic flat corpus (streams, y_frames, vidlens), the same on
    every process (the JAX worker's, seeds included)."""
    rng = np.random.RandomState(5)
    lens = rng.randint(4, 8, n_videos)
    y_video = rng.randint(0, classes, n_videos)
    frames, y_frames = [], []
    for n, c in zip(lens, y_video):
        base = np.zeros(dim)
        base[c] = 3.0
        frames.append(base + 0.3 * rng.randn(n, dim))
        y_frames.append(np.full(n, c))
    return ([np.concatenate(frames).astype(np.float32)], np.concatenate(y_frames), lens)


def make_case(params=None):
    """Deterministic tiny model, its parameters (the port's init from seed
    0 unless given) and a global batch (the JAX worker's), the same on
    every process and in a one-process reference run."""
    from ip_avsr_torch.models import adenet, zoo

    cfg = zoo.lstm_classifier_majority_vote(10, lstm_size=8, output_classes=4)
    if params is None:
        params = arrays(adenet.init_adenet_params(torch.Generator().manual_seed(0), cfg,
                                                  device="cpu"))
    rng = np.random.RandomState(0)
    B, T = 16, 7
    x = rng.randn(B, T, 10).astype(np.float32)
    lens = rng.randint(3, T + 1, B)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    y = rng.randint(0, 4, B).astype(np.int32)
    return cfg, params, (x, y, mask)


def multihost_step(params=None, device="cpu") -> dict:
    """The JAX worker's run on this rank: one multihost step and eval cost
    from :func:`make_case`, then a two-epoch multihost fit on
    :func:`make_corpus` (device-side evaluation, turned on by
    ``multihost``)."""
    no_jax()
    cfg, params, (x, y, mask) = make_case(params)
    tr = trainer(cfg, dict(optimizer="momentum", learning_rate=1e-3, use_mesh=True,
                           multihost=True), device)
    dev = tr._device_batch([x], y, mask)
    p0, s0 = setup_state(tr, params)
    eval_loss = float(tr.eval_cost(p0, *dev))
    gen = torch.Generator(device=tr.device).manual_seed(3)
    _, _, train_loss = tr.train_step(p0, s0, *dev, gen, 1e-3)
    corpus = make_corpus()
    fit = trainer(cfg, dict(num_epoch=2, epochsize=3, batchsize=8, optimizer="momentum",
                            learning_rate=1e-2, use_mesh=True, multihost=True,
                            prefetch_batches=False), device)
    fit.init_params = lambda generator, **kw: tensors(params, fit.device)
    res = fit.fit(corpus, corpus, corpus)
    return {"train_loss": float(train_loss), "eval_loss": eval_loss,
            "local_rows": int(dev[0][0].shape[0]),
            "fit_cost_val": [float(v) for v in res.cost_val], "fit_test_cr": float(res.test_cr),
            "process_count": dist.get_world_size() if dist.is_initialized() else 1}


# -- the card: chip_smoke.py's scale phase ---------------------------------

def _counters(spec: dict) -> dict:
    """{name: (wrapper, attribute)} of the kernels' launch counters from
    chip_smoke's ``{name: (module, wrapper, attribute)}``."""
    import importlib

    return {name: (getattr(importlib.import_module(f"ip_avsr_torch.ops.kernels.{mod}"), fn),
                   attr) for name, (mod, fn, attr) in spec.items()}


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _align():
    """Synchronize the device and, in a group, wait for every rank (the
    barrier of ``distributed_c10d`` itself, which a
    :class:`CollectiveTally` does not count)."""
    from torch.distributed import distributed_c10d

    _sync()
    if dist.is_initialized():
        distributed_c10d.barrier()


def _launched(counters, fn):
    """``(fn(), {kernel: launches during fn})``, the device synchronized."""
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)
    out = fn()
    _sync()
    return out, {name: getattr(wrapper, attr) for name, (wrapper, attr) in counters.items()}


class CollectiveTally:
    """Counts the ``torch.distributed`` collectives called while active and
    the bytes this rank hands them (the inputs it contributes), per
    collective in ``by_name`` too; on CUDA tensors each call is timed with
    CUDA events on the current stream around it (a blocking collective
    makes that stream wait for its end; an exchange's requests are waited
    for inside the span), read by :meth:`times_ms` after a synchronize."""

    NAMES = ("all_reduce", "all_gather", "broadcast", "all_to_all", "batch_isend_irecv",
             "barrier")

    def __init__(self):
        self.calls = {}
        self.bytes = 0
        self.by_name = {}
        self._events = []

    def _wrap(self, name, fn):
        def counted(*args, **kwargs):
            self.calls[name] = self.calls.get(name, 0) + 1
            if name == "batch_isend_irecv":
                ts = [op.tensor for op in args[0] if op.op is dist.isend]
            elif name in ("all_gather", "all_to_all"):
                ts = [args[1]] if name == "all_gather" else list(args[1])
            elif name == "barrier":
                ts = []
            else:
                ts = [args[0]]
            nbytes = sum(t.numel() * t.element_size() for t in ts)
            self.bytes += nbytes
            count, total = self.by_name.get(name, (0, 0))
            self.by_name[name] = (count + 1, total + nbytes)
            if not any(t.is_cuda for t in ts):
                return fn(*args, **kwargs)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            if name == "batch_isend_irecv":
                for req in out:
                    req.wait()
            end.record()
            self._events.append((name, start, end))
            return out

        return counted

    def times_ms(self) -> dict:
        """{collective: milliseconds summed over its timed calls}."""
        _sync()
        out = {}
        for name, start, end in self._events:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out

    def __enter__(self):
        self._saved = {n: getattr(dist, n) for n in self.NAMES}
        for n, fn in self._saved.items():
            setattr(dist, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(dist, n, fn)


def _named(tree, path=""):
    items = tree.items() if isinstance(tree, dict) else (
        enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    return [(path, tree)] if items is None else [
        n for k, v in items for n in _named(v, f"{path}/{k}")]


def step_gaps(got, ref, zero=()) -> dict:
    """The gaps of a step ``got`` = (loss, grads, params after) from ``ref``
    (the same, numpy or tensors): the loss relative, each gradient's max
    abs error over its tensor's max abs (worst), each parameter's max abs
    error (worst); the biases ``zero`` (exact gradient 0 before batch norm)
    are left out and reported as noise against their weight's gradient."""
    def host(t):
        return t.detach().cpu().double().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t, np.float64)

    (loss, grads, params), (rloss, rgrads, rparams) = got, ref
    g, rg = dict(_named(grads)), dict(_named(rgrads))
    p, rp = dict(_named(params)), dict(_named(rparams))
    out = {"loss_rel": abs(float(loss) - float(rloss)) / abs(float(rloss)),
           "grad_rel": 0.0, "grad_worst": None, "param_abs": 0.0, "zero_noise": 0.0}
    for path, r in rg.items():
        r, a = host(r), host(g[path])
        top = float(np.abs(r).max())
        if path in zero:
            weight = float(np.abs(host(rg[path[:-1] + "w"])).max())
            out["zero_noise"] = max(out["zero_noise"],
                                    float(max(np.abs(a).max(), top)) / weight)
            continue
        rel = float(np.abs(a - r).max()) / max(top, 1e-30)
        if rel >= out["grad_rel"]:
            out["grad_rel"], out["grad_worst"] = rel, path
        out["param_abs"] = max(out["param_abs"],
                               float(np.abs(host(p[path]) - host(rp[path])).max()))
    return out


def _host_ms(fn, turns, warmup=2):
    import time

    times = []
    for i in range(warmup + turns):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def _card_step(tr, params, batch, seed=0, lr=1.0):
    """(loss, grads, params after one step) of a Trainer (mesh or not) on
    the card from whole numpy ``params``, and the step's launches."""
    p0, s0 = setup_state(tr, params)
    dev = tr._device_batch(*batch)
    gen = lambda: torch.Generator(device=tr.device).manual_seed(seed)  # noqa: E731
    if tr.mesh is None:
        from ip_avsr_torch.train.trainer import loss_and_grads

        _, grads = loss_and_grads(p0, tr.config, *dev, gen(), window=tr.options.window)
    else:
        _, grads, _ = tr.mesh_loss_and_grads(p0, *dev, gen())
    return p0, s0, dev, gen, grads


@contextlib.contextmanager
def local_bn_statistics():
    """While active, the model's batch norm normalises each rank's block
    with that rank's own statistics (``stream_prefix(bn_axis=None)``, which
    both the Trainer's data-parallel forward and the sequence-parallel
    ``forward_rows`` call): the control that a check of statistics synced
    over the ranks must fail."""
    from ip_avsr_torch.models import adenet

    prefix = adenet.stream_prefix
    adenet.stream_prefix = lambda *a, **kw: prefix(*a, **dict(kw, bn_axis=None))
    try:
        yield
    finally:
        adenet.stream_prefix = prefix


@contextlib.contextmanager
def bottleneck_terms(shape):
    """A list that, while active, each encoder product with a weight of
    ``shape`` (K, N) appends a dict to: its input ``X`` and, once the
    backward has reached it, the gradient ``dZ`` of its output, as float64
    numpy arrays of (rows, K) and (rows, N), the two factors of that
    weight's gradient X^T dZ."""
    from ip_avsr_torch.models import encoder

    product, (K, N), taken = encoder.product, shape, []

    def capture(a, b, matmul_dtype=None):
        out = product(a, b, matmul_dtype)
        if tuple(b.shape) == (K, N):
            taken.append({"X": a.detach().reshape(-1, K).double().cpu().numpy()})
            out.register_hook(lambda g, d=taken[-1]: d.update(
                dZ=g.detach().reshape(-1, N).double().cpu().numpy()))
        return out

    encoder.product = capture
    try:
        yield taken
    finally:
        encoder.product = product


@contextlib.contextmanager
def counted_on_cpu(counters_spec: dict):
    """While active, a call of a kernel's wrapper on CPU tensors, which runs
    the plain version and launches nothing, counts as one launch in that
    kernel's float32 counter (``counters_spec`` as :func:`_counters`
    takes it; its bf16 counters are left alone): the wrappers are replaced
    where the model looks them up (``ops/lstm`` imports the LSTM wrappers,
    ``ops/delta`` calls the grouped delta wrapper through its module), so
    that a rehearsal on the CPU reads the launches a card would count."""
    import importlib

    from ip_avsr_torch.ops import lstm as lstm_ops
    from ip_avsr_torch.ops.kernels import delta as delta_kernel

    def counting(fn, holder):
        def call(*args, **kwargs):
            first = args[0][0] if isinstance(args[0], (list, tuple)) else args[0]
            if first.device.type == "cpu":
                holder.launches += 1
            return fn(*args, **kwargs)

        return call

    saved = []
    for mod, fn, attr in counters_spec.values():
        if attr != "launches":
            continue
        holder = getattr(importlib.import_module(f"ip_avsr_torch.ops.kernels.{mod}"), fn)
        where, name = ((delta_kernel, "append_delta_group") if mod == "delta"
                       else (lstm_ops, fn))
        saved.append((where, name, getattr(where, name)))
        setattr(where, name, counting(getattr(where, name), holder))
    try:
        yield
    finally:
        for where, name, fn in reversed(saved):
            setattr(where, name, fn)


def _trace(step, n: int = 3) -> dict:
    """A torch.profiler trace of ``n`` steps on the card, after one
    warm-up step that the profile throws away (chip_smoke.traced's
    schedule; its ``ProfilerStep*`` records left out): the device time per
    step of every kernel and of the collectives' own (nccl) kernels, which
    include their wait for the other ranks, the count of those per step,
    and the traced steps' host time per step.  The traced steps start
    together on every rank (:func:`_align`)."""
    import time

    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=schedule) as prof:
        step()
        _sync()
        prof.step()
        _align()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        _sync()
        wall = (time.perf_counter() - t0) * 1e3 / n
        prof.step()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not e.key.startswith("ProfilerStep")]
    nccl = [e for e in events if "nccl" in e.key.lower()]
    ms = lambda es: sum(e.self_device_time_total for e in es) / 1e3 / n  # noqa: E731
    return {"device_ms": ms(events), "nccl_ms": ms(nccl),
            "nccl_kernels": sum(e.count for e in nccl) / n, "traced_ms": wall}


def chip_step(counters_spec: dict, cfg, params, batch, options: dict, ref=None, zero=(),
              turns: int = 0, device="cuda", local_bn: bool = False, bottleneck=None,
              trace: bool = False) -> dict:
    """One Trainer step (adadelta at lr 1.0, as chip_smoke's card-vs-CPU
    checks) on this rank of the card's group with ``options``: its launches
    and collectives, its host median over 5 steps (on two or more ranks also
    that of the gradients' all-reduce alone), its whole (loss, grads, params
    after) against ``ref`` (:func:`step_gaps`; without ``ref``, the result
    itself), and with ``turns`` the host times of the step in turns with the
    one-process Trainer's (the mesh's first, then the plain one's, each
    turn).  ``local_bn`` runs all of it under :func:`local_bn_statistics`;
    ``bottleneck`` (a weight's shape) adds the factors X and dZ of that
    weight's gradient on this rank's rows (:func:`bottleneck_terms`).  Also
    the mesh's shape, the device, each collective's calls and bytes in the
    step and on two or more ranks its time per step (:class:`CollectiveTally`,
    the mean of 5 steps started together), and with ``trace`` on the card
    the step's device time and its collectives' kernels (:func:`_trace`).
    On the CPU each wrapper's call counts as its launch
    (:func:`counted_on_cpu`)."""
    on_cpu = torch.device(device).type == "cpu"
    with local_bn_statistics() if local_bn else contextlib.nullcontext(), \
            counted_on_cpu(counters_spec) if on_cpu else contextlib.nullcontext():
        return _chip_step(counters_spec, cfg, params, batch, options, ref, zero, turns,
                          device, bottleneck, trace and not on_cpu)


def _chip_step(counters_spec, cfg, params, batch, options, ref, zero, turns, device,
               bottleneck, trace):
    from ip_avsr_torch.parallel import collectives

    no_jax()
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = _counters(counters_spec)
    opts = dict(options, optimizer="adadelta", learning_rate=1.0)
    tr = trainer(cfg, opts, device)
    with bottleneck_terms(bottleneck) if bottleneck else contextlib.nullcontext() as taken:
        p0, s0, dev, gen, grads = _card_step(tr, params, batch)
    step = lambda: tr.train_step(p0, s0, *dev, gen(), 1.0)  # noqa: E731
    with CollectiveTally() as tally:
        (p1, s1, loss), launches = _launched(counters, step)
    world = dist.get_world_size() if dist.is_initialized() else 1
    out = {"launches": launches, "collectives": dict(tally.calls), "collective_bytes": tally.bytes,
           "by_collective": dict(tally.by_name),
           "mesh": None if tr.mesh is None else dict(tr.mesh.shape), "device": str(dev[2].device),
           "loss": float(loss), "world": world, "step_ms": float(np.median(_host_ms(step, 5)))}
    if trace:
        out["trace"] = _trace(step)
    if bottleneck:
        out["bottleneck"] = taken[0]
    if world > 1:
        # each collective's time per step, the mean of 5 steps that start
        # together (a barrier before each): the rank that comes last to a
        # collective waits for no other
        with CollectiveTally() as timed:
            for _ in range(5):
                _align()
                step()
        out["collective_ms"] = {k: v / 5 for k, v in timed.times_ms().items()}
        leaves = []
        tree_map(leaves.append, grads)
        out["allreduce_ms"] = float(np.median(_host_ms(
            lambda: collectives.flat_all_reduce(leaves, tr._batch_group), 5)))
    whole_grads = tr._whole(grads, tr._param_sh)
    whole_params = tr._whole_state(p1, s1)[0]
    if ref is not None:
        out["gaps"] = step_gaps((loss, whole_grads, whole_params), ref, zero)
    else:
        out["result"] = (float(loss), arrays(whole_grads), arrays(whole_params))
    if turns:
        plain = trainer(cfg, dict(optimizer="adadelta", learning_rate=1.0), device)
        q0, r0, qdev, qgen, _ = _card_step(plain, params, batch)
        mesh_ms, plain_ms = [], []
        for _ in range(turns):
            mesh_ms += _host_ms(step, 1, warmup=1)
            plain_ms += _host_ms(lambda: plain.train_step(q0, r0, *qdev, qgen(), 1.0), 1,
                                 warmup=1)
        out.update(mesh_ms=mesh_ms, plain_ms=plain_ms)
    return out


def rank_card() -> dict:
    """This rank's backend, rank and device, printed by the rank and
    returned."""
    no_jax()
    backend = dist.get_backend() if dist.is_initialized() else None
    rank = dist.get_rank() if dist.is_initialized() else 0
    out = {"rank": rank, "backend": backend, "device": None, "name": None}
    if backend == "nccl":
        index = torch.cuda.current_device()
        out.update(device=f"cuda:{index}", name=torch.cuda.get_device_name(index))
    print(f"rank {rank}: backend {backend}, device {out['device']}, {out['name']}",
          flush=True)
    return out


def sp_max_t(cfg, options: dict, seqlens):
    """``Trainer._sp_max_t(seqlens)`` on this rank: the padded T, or the
    ValueError's message."""
    no_jax()
    try:
        return trainer(cfg, options)._sp_max_t(np.asarray(seqlens))
    except ValueError as e:
        return str(e)


def chip_serve(counters_spec: dict, cfg, params, streams, mask, device="cuda",
               turns: int = 0) -> dict:
    """``make_server(mesh=make_mesh())`` on the card against the plain
    server from the same parameters: the scores' max abs gap, the mesh
    server's launches and collectives per forward (their time as
    :func:`chip_step` takes it), and with ``turns`` the
    host times of the two servers' requests in turns (the mesh's first).
    On the CPU each wrapper's call counts as its launch
    (:func:`counted_on_cpu`)."""
    from ip_avsr_torch import serve as serve_lib
    from ip_avsr_torch.parallel import mesh as mesh_lib

    no_jax()
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = _counters(counters_spec)
    p = tensors(params, device)
    mesh_fn = serve_lib.make_server(p, cfg, mesh=mesh_lib.make_mesh(), device=device)
    plain_fn = serve_lib.make_server(p, cfg, device=device)
    mesh_fn(streams, mask)  # warm-up: libraries, handles
    on_cpu = torch.device(device).type == "cpu"
    with counted_on_cpu(counters_spec) if on_cpu else contextlib.nullcontext(), \
            CollectiveTally() as tally:
        got, launches = _launched(counters, lambda: mesh_fn(streams, mask))
    want = plain_fn(streams, mask)
    with CollectiveTally() as timed:
        for _ in range(5):
            _align()
            mesh_fn(streams, mask)
    out = {"launches": launches, "max_abs_err": float((got - want).abs().max()),
           "finite": bool(torch.isfinite(got).all()), "collectives": dict(tally.calls),
           "collective_bytes": tally.bytes,
           "collective_ms": {k: v / 5 for k, v in timed.times_ms().items()}}
    if turns:
        mesh_ms, plain_ms = [], []
        for _ in range(turns):
            mesh_ms += _host_ms(lambda: mesh_fn(streams, mask), 1, warmup=1)
            plain_ms += _host_ms(lambda: plain_fn(streams, mask), 1, warmup=1)
        out.update(mesh_ms=mesh_ms, plain_ms=plain_ms)
    return out
