"""Serving on one device, or on the ranks of a mesh.

Mirrors ip_avsr_tpu/serve.py:

* ``make_trimodal_server``: diff images, DCT features, normalisations,
  encoders, deltas, LSTMs, fusion, aggregation, softmax and optionally the
  masked majority vote on the server's device; raw (B, T, D) uint8 pixels
  in, (B, C) scores out;
* ``make_server``: the same for preprocessed streams, on one device or, with
  ``mesh=``, each request's rows split over the ranks of a mesh;
* ``PipelinedServer``: requests dispatched asynchronously through pinned
  host buffers, results fetched in blocks of ``depth``, in submission order;
* ``make_bucketed_server``: any request size rounded up to a bounded set of
  (batch, time) shapes;
* ``StreamingSession``: online inference, frames fed as they arrive,
  per-frame scores with a ``2 * window`` lookahead equal to the one-shot
  forward's.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from ip_avsr_torch.device import resolve_device, tree_map, tree_to
from ip_avsr_torch.models import adenet
from ip_avsr_torch.models import encoder as encoder_mod
from ip_avsr_torch.ops import normalization as norm_ops
from ip_avsr_torch.ops import pipeline
from ip_avsr_torch.ops.dct import dct_feature_basis_np
from ip_avsr_torch.ops.voting import majority_voting_layer_masked
from ip_avsr_torch.parallel import collectives
from ip_avsr_torch.parallel import mesh as mesh_lib
from ip_avsr_torch.utils import spans


def _index_leaves(tree, leaves: list, recurrent: set, key=None):
    """The skeleton of ``tree`` with each leaf replaced by its index in
    ``leaves`` (appended in ``device.tree_map`` order); the indices of the
    leaves stored under a ``"w_hid"`` key go into ``recurrent``."""
    if isinstance(tree, dict):
        return {k: _index_leaves(v, leaves, recurrent, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index_leaves(v, leaves, recurrent) for v in tree)
    leaves.append(tree)
    if key == "w_hid":
        recurrent.add(len(leaves) - 1)
    return len(leaves) - 1


class _ParamBuffers(torch.nn.Module):
    """A parameter tree held as buffers ``p0, p1, ...`` (leaves in
    ``device.tree_map`` order), so ``.to(device)`` moves it and
    ``torch.export`` records it as the program's state.  :meth:`tree`
    gives the tree with every buffer stored narrower (an artifact's bf16
    weights) upcast to float32 before any op, as the JAX package's products
    promote a bf16 weight against float32 activations, except a bf16
    recurrent matrix ``w_hid``: the LSTM kernels take it as it is, and
    their bf16 instantiations round h_{t-1} to bf16 before the product, as
    the JAX package's recurrence does with a bf16 ``w_hid``
    (ip_avsr_tpu/ops/lstm.py:236-242)."""

    def __init__(self, params: dict):
        super().__init__()
        leaves = []
        self._recurrent = set()
        self._skeleton = _index_leaves(params, leaves, self._recurrent)
        for i, t in enumerate(leaves):
            self.register_buffer(f"p{i}", t)
        self._tree = (None, None)

    def _kept(self, i, t) -> bool:
        return t.dtype == torch.float32 or (i in self._recurrent and t.dtype == torch.bfloat16)

    def tree(self) -> dict:
        """The tree over the current buffers.  Where no buffer needs an
        upcast the tree holds the buffers themselves, and is built once for
        each set of buffer objects (``.to()`` and the exporter's tracing
        swap them) instead of on every call; an upcast tree is built anew
        each call, so it never holds a stale copy."""
        bufs = tuple(self._buffers.values())
        held, tree = self._tree
        if held is not None and len(held) == len(bufs) and all(
                a is b for a, b in zip(held, bufs)):
            return tree

        def leaf(i):
            t = getattr(self, f"p{i}")
            return t if self._kept(i, t) else t.to(torch.float32)

        tree = tree_map(leaf, self._skeleton)
        self._tree = ((bufs, tree) if all(self._kept(i, b) for i, b in enumerate(bufs))
                      else (None, None))
        return tree


class Server(torch.nn.Module):
    """The served forward of :func:`make_server` as a module: ``forward(
    streams, mask) -> scores`` on float32 tensors of one device, the
    parameters as buffers.  The closures of :func:`make_server` and the
    exporter (``ip_avsr_torch.export``) both run it."""

    def __init__(self, params: dict, config: adenet.AdeNetConfig, vote: bool = True):
        super().__init__()
        adenet.check_supported(config)
        self.config = config
        self.vote = bool(vote)
        self.params = _ParamBuffers(params)

    def forward(self, streams, mask):
        return _scores(adenet.adenet_forward(self.params.tree(), self.config, list(streams),
                                             mask), mask, self.config, self.vote)


class TrimodalServer(Server):
    """The served forward of :func:`make_trimodal_server` as a module:
    ``forward(raw, mask) -> scores`` with raw (B, T, H*W) float32 pixels;
    the DCT basis and, where given, the DCT mean and std are buffers too."""

    def __init__(self, params: dict, config: adenet.AdeNetConfig, image_shape,
                 dct_coeffs: Optional[int] = None, dct_mean=None, dct_std=None,
                 vote: bool = True):
        if (dct_mean is None) != (dct_std is None):
            raise ValueError("dct_mean and dct_std must be given together "
                             "(featurewise normalization needs both)")
        super().__init__(params, config, vote)
        self.image_shape = tuple(int(v) for v in image_shape)
        self.dct_coeffs = int(dct_coeffs or config.streams[1].input_dim)
        self.register_buffer("dct_basis", torch.as_tensor(
            dct_feature_basis_np(self.image_shape, self.dct_coeffs), dtype=torch.float32))
        stats = [None if v is None else torch.as_tensor(v, dtype=torch.float32)
                 for v in (dct_mean, dct_std)]
        self.register_buffer("dct_mean", stats[0])
        self.register_buffer("dct_std", stats[1])

    def forward(self, raw, mask):
        with spans.span("serve.pipeline"):
            streams = pipeline.trimodal_streams(raw, mask, self.image_shape, self.dct_coeffs,
                                                self.dct_mean, self.dct_std,
                                                dct_basis=self.dct_basis)
        return super().forward(streams, mask)


def make_trimodal_server(
    params: dict,
    config: adenet.AdeNetConfig,
    image_shape,
    dct_coeffs: Optional[int] = None,
    dct_mean=None,
    dct_std=None,
    vote: bool = True,
    device=None,
):
    """Returns ``serve(raw, mask) -> scores`` for a trimodal (raw, dct, diff)
    model on ``device`` (default ``cuda``): a :class:`TrimodalServer`.

    ``raw`` is (B, T, H*W) uint8 (or float) pixels and ``mask`` (B, T); both
    may be tensors or arrays.  Scores are (B, C); a per-step head with
    ``vote=False`` returns its (B, T, C) probabilities."""
    device = resolve_device(device)
    program = TrimodalServer(params, config, image_shape, dct_coeffs, dct_mean, dct_std,
                             vote).to(device)

    @torch.inference_mode()
    def serve(raw, mask):
        raw = torch.as_tensor(raw, device=device).to(torch.float32)
        mask = torch.as_tensor(mask, device=device).to(torch.float32)
        return program(raw, mask)

    return serve


def _scores(out, mask, config, vote):
    """A per-step head's (B, T, C) probabilities through the masked vote
    when ``vote`` (padded frames must not cast votes), else as they are."""
    if out.dim() == 3 and vote:
        return majority_voting_layer_masked(out, mask, config.output_classes)
    return out


def make_server(params: dict, config: adenet.AdeNetConfig, vote: bool = True,
                mesh=None, device=None):
    """Returns ``serve(streams, mask) -> scores`` for preprocessed streams on
    ``device`` (default ``cuda``): a :class:`Server`.

    ``streams[i]`` is (B, T, D_i) and ``mask`` (B, T), tensors or arrays;
    a conv front end's stream is (B, T, H, W) frames, uint8 or float, cast
    to float32 on ``device`` by the front end.  Scores are (B, C); a
    per-step head with ``vote=False`` returns its (B, T, C) probabilities.

    ``mesh`` (``parallel/mesh.make_mesh()``; every rank of its group calls
    the server with the same request) splits the request's rows over the
    mesh's first dim: the weights are replicated once, from rank 0, when the
    server is built; each rank runs its rows and the scores are
    all-gathered, on every rank.  Every layer on the serve path is per row,
    so the scores equal one device's.  The batch must divide by the mesh
    size (pad rows with a zero mask)."""
    device = resolve_device(device)
    adenet.check_supported(config, mesh)
    if mesh is not None:
        params = mesh_lib.replicate(mesh, tree_to(params, device))
    program = Server(params, config, vote).to(device)
    frames = [bool(spec.frontend) for spec in config.streams]
    rows = None if mesh is None else mesh_lib.batch_sharding(mesh, mesh.axis_names[0])

    @torch.inference_mode()
    def serve(streams, mask):
        if rows is not None:
            if streams[0].shape[0] % mesh.size:
                raise ValueError(f"batch {streams[0].shape[0]} must be divisible by the mesh "
                                 f"size {mesh.size} (pad rows with a zero mask)")
            streams, mask = [rows.local(s) for s in streams], rows.local(mask)
        streams = [torch.as_tensor(s, device=device) for s in streams]
        streams = [s if raw else s.to(torch.float32) for s, raw in zip(streams, frames)]
        mask = torch.as_tensor(mask, device=device).to(torch.float32)
        out = program(streams, mask)
        if rows is None:
            return out
        return collectives.all_gather(out, 0, mesh.group(mesh.axis_names[0]))

    serve._mesh = mesh
    return serve


def _leaves(tree) -> list:
    """The leaves of a nested list/tuple tree (a request tuple), in order."""
    if isinstance(tree, (list, tuple)):
        return [leaf for node in tree for leaf in _leaves(node)]
    return [tree]


def _to_host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class PipelinedServer:
    """Batch-1 serving that keeps the card fed while results come home.

    ``map`` submits each request at once (its upload and forward are queued
    on the card's stream and the host goes on), concatenates every
    ``depth`` results into one block on the card, and copies each block
    home once, keeping one block in flight beyond the one being drained:
    block i's copy overlaps the queueing of block i + 1.  Results come back
    per request, in submission order.

    On the card each request's arrays are staged in one freshly pinned
    host buffer and uploaded in one ``non_blocking`` copy (an upload from
    pageable memory would make the host wait for the card, and the server
    would be a synchronous one); a block's copy home goes into a freshly
    pinned buffer, followed by a ``torch.cuda.Event`` that the drain waits
    on.  No
    pinned buffer is reused, and each is kept referenced until the block it
    belongs to has been drained, so none can be freed or refilled while the
    card may still read or write it.  On the CPU the same loop runs
    synchronously.

    ``serve_fn`` replaces the default server (``make_server(params, config,
    vote)`` on ``device``, default ``cuda``); requests in ``map`` are its
    argument tuples.  ``batch`` > 1 stacks up to ``batch`` same-shaped
    queued requests on the host (one ``np.concatenate`` on the leading
    axis) into a single upload and forward, split back per request.  That is
    valid only where the served program treats batch rows independently,
    as every layer on the port's serve path does."""

    def __init__(self, params: dict = None, config: adenet.AdeNetConfig = None,
                 vote: bool = True, depth: int = 8, serve_fn=None, batch: int = 1,
                 device=None):
        self._device = resolve_device(device)
        self._serve = serve_fn or make_server(params, config, vote=vote, device=self._device)
        self._depth = max(1, int(depth))
        self._batch = max(1, int(batch))

    def _upload(self, args):
        """The request's arrays on the device, and the pinned buffers they
        were uploaded from (empty off the card).

        On the card every host array of the request goes into one freshly
        pinned byte buffer, each at a 16-byte aligned offset, which is
        uploaded in one ``non_blocking`` copy; the arrays on the device are
        views of that upload.  Tensors already on the device pass as they
        are."""
        if self._device.type != "cuda":
            return tuple(args), []
        host = [None if isinstance(a, torch.Tensor) and a.device == self._device
                else np.ascontiguousarray(_to_host(a)) for a in _leaves(args)]
        offsets, total = [], 0
        for a in host:
            offsets.append(total)
            total += 0 if a is None else -(-a.nbytes // 16) * 16
        if not total:
            return tuple(args), []
        pinned = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        staged = pinned.numpy()
        for a, off in zip(host, offsets):
            if a is not None:
                staged[off: off + a.nbytes] = a.reshape(-1).view(np.uint8)
        upload = pinned.to(self._device, non_blocking=True)
        it = iter(zip(host, offsets))

        def view(leaf):
            a, off = next(it)
            if a is None:
                return leaf
            dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
            return upload[off: off + a.nbytes].view(dtype).view(a.shape)

        return tree_map(view, tuple(args)), [pinned]

    def submit(self, *args, requests: int = 1):
        """Queue one request (``requests`` stacked into one, by :meth:`map`);
        returns an opaque handle for :meth:`result`.  Its spans, under a new
        request id: ``serve.stage`` (the upload) and ``serve.forward``."""
        ident = spans.new_id()
        with spans.span("serve.stage", ident=ident, device=False):
            dev_args, pinned = self._upload(args)
        with spans.span("serve.forward", ident=ident, count=requests):
            return self._serve(*dev_args), pinned, ident

    def result(self, handle) -> np.ndarray:
        """Wait for ``handle``'s scores and return them on the host."""
        return _to_host(handle[0])

    def _pack(self, handles, sizes):
        """One concat on the card and one copy home of the block (into a
        fresh pinned buffer, then an event); ``sizes`` are the per-request
        row counts (a stacked handle covers several requests)."""
        out = torch.cat([h[0] for h in handles], dim=0)
        keep = [p for h in handles for p in h[1]]
        ids = [h[2] for h in handles]
        if self._device.type != "cuda":
            return out, None, list(sizes), keep, ids
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self._device))
        return host, done, list(sizes), keep + [out], ids

    def _unpack(self, packed):
        host, done, sizes, _, ids = packed
        with spans.span("serve.wait", device=False, ids=ids):
            if done is not None:
                done.synchronize()  # the block's copy home, and every upload before it
        arr = host.numpy()
        off = 0
        for s in sizes:
            yield arr[off: off + s]
            off += s

    def map(self, requests):
        """Generator: ``requests`` yields argument tuples for the serve fn
        (``(streams, mask)`` for the generic server, ``(raw, mask)`` for a
        trimodal one); yields each request's scores as a numpy array, in
        submission order.  A change of the result's trailing shape (a
        ``vote=False`` server's T) flushes the block being filled, and a
        change of a request's shapes flushes the stack being built."""
        block, sizes = [], []   # dispatched handles + per-request row counts
        stage = []              # request tuples awaiting one dispatch
        pending = collections.deque()

        def dispatch_stage():
            rows = [int(np.shape(_leaves(req)[0])[0]) for req in stage]
            if len(stage) == 1:
                args = stage[0]
            else:
                args = tree_map(lambda *xs: np.concatenate([_to_host(x) for x in xs], axis=0),
                                *stage)
            h = self.submit(*args, requests=len(stage))
            stage.clear()
            if block and h[0].shape[1:] != block[-1][0].shape[1:]:
                pending.append(self._pack(block, sizes))
                block.clear()
                sizes.clear()
            block.append(h)
            sizes.extend(rows)
            if len(block) >= self._depth:
                pending.append(self._pack(block, sizes))
                block.clear()
                sizes.clear()

        def shapes(req):
            return tuple(tuple(np.shape(leaf)) for leaf in _leaves(req))

        for req in requests:
            req = tuple(req)
            if stage and shapes(req) != shapes(stage[-1]):
                dispatch_stage()
            stage.append(req)
            if len(stage) >= self._batch:
                dispatch_stage()
            while len(pending) > 1:
                yield from self._unpack(pending.popleft())
        if stage:
            dispatch_stage()
        if block:
            pending.append(self._pack(block, sizes))
        while pending:
            yield from self._unpack(pending.popleft())


def make_bucketed_server(params: dict = None, config: adenet.AdeNetConfig = None,
                         batch_buckets=(1, 8, 32), time_buckets=(32, 64), vote: bool = True,
                         allow_time_truncation: bool = False, serve_fn=None,
                         output_classes: int = None, device=None):
    """Serving of ARBITRARY request sizes through a bounded set of shapes.

    Each request is rounded up to the nearest (batch_bucket, time_bucket),
    so at most ``len(batch_buckets) * len(time_buckets)`` shapes ever reach
    the model: padded rows carry an all-zero mask, padded frames are masked,
    and the padding is sliced off the scores.  In eager PyTorch a new shape
    costs no compilation; the bounded set is the set of static shapes a
    CUDA graph capture of the forward (ROADMAP Queue 1 item 2) would need,
    one graph each, and none is built here.  Requests with more utterances
    than the largest batch bucket are served in chunks of it.  Time cannot
    be chunked (the recurrence carries state across frames), so a request
    LONGER than the largest time bucket raises, unless lossy prefix
    classification is asked for with ``allow_time_truncation=True``.

    The delta FIR has no mask: time padding changes the delta features of
    the last ``2 * window`` valid frames, as it does in the JAX package.

    Returns ``serve(streams, lengths) -> scores`` on ``device`` (default
    ``cuda``), where ``streams[i]`` is (B, T_actual, D_i) and ``lengths``
    the per-utterance frame counts; scores are (B, C), or (B, T_actual, C)
    for a per-step head with ``vote=False``.  ``serve_fn`` substitutes any
    per-step ``(streams, mask) -> (B, T, C)`` program for the live model;
    pass ``output_classes`` with it."""
    device = resolve_device(device)
    batch_buckets = sorted(set(int(b) for b in batch_buckets))
    time_buckets = sorted(set(int(t) for t in time_buckets))
    # the live model votes inside make_server (masked: padded frames cast no
    # vote); a caller's per-step serve_fn is voted here
    inner = serve_fn or make_server(params, config, vote=vote, device=device)
    if output_classes is not None:
        n_classes = output_classes
    elif config is not None:
        n_classes = config.output_classes
    elif vote:
        raise ValueError("vote=True needs output_classes (no config to "
                         "read the class count from)")
    else:
        n_classes = None  # vote=False never consults it

    def bucket(v, buckets):
        return next((b for b in buckets if v <= b), buckets[-1])

    @torch.inference_mode()
    def serve(streams, lengths):
        lengths = np.asarray(lengths).reshape(-1)
        B = len(lengths)
        T = int(streams[0].shape[1])
        max_b = batch_buckets[-1]
        if B > max_b:
            return torch.cat([serve([s[i: i + max_b] for s in streams], lengths[i: i + max_b])
                              for i in range(0, B, max_b)], dim=0)
        bb = bucket(B, batch_buckets)
        tb = bucket(T, time_buckets)
        if T > tb:
            if not allow_time_truncation:
                raise ValueError(
                    f"request has T={T} frames but the largest time bucket is "
                    f"{tb}; raise time_buckets or pass allow_time_truncation="
                    f"True to classify the first {tb} frames only")
            streams = [s[:, :tb] for s in streams]
            lengths = np.minimum(lengths, tb)
            T = tb
        padded = [torch.nn.functional.pad(
            torch.as_tensor(s, dtype=torch.float32, device=device),
            (0, 0, 0, tb - T, 0, bb - B)) for s in streams]
        mask = torch.as_tensor(
            (np.arange(tb)[None, :] < np.pad(lengths, (0, bb - B))[:, None]).astype(np.float32),
            device=device)
        scores = inner(padded, mask)
        if scores.dim() == 3 and vote:
            scores = majority_voting_layer_masked(scores, mask, n_classes)
        if scores.dim() == 3:
            # vote=False per-step scores: the time padding's frames do not exist
            return scores[:B, :T]
        return scores[:B]

    return serve


# ---------------------------------------------------------------------------
# Streaming (online) inference
# ---------------------------------------------------------------------------

def _np_delta_fir(padded, window):
    """The delta FIR of ops/delta.py (same theta loop and coefficients) in
    numpy, over an already time-extended (B, T + 2W, D) array -> the (B, T,
    D) centre."""
    T = padded.shape[1] - 2 * window
    out = np.zeros((padded.shape[0], T, padded.shape[2]), padded.dtype)
    for theta in range(1, window + 1):
        coeff = np.float32(1.0 / (2.0 * theta))
        out += coeff * (padded[:, window + theta: window + theta + T]
                        - padded[:, window - theta: window - theta + T])
    return out


class StreamPrep(torch.nn.Module):
    """A streaming session's prep of one stream as a module: ``forward(x)``
    maps (B, n, D) float32 to (B, n, E) through the stream's encoder (where
    it has one, its products with the model's ``matmul_dtype``) and then its
    batch norm in evaluation mode (where it has one: ``bn`` holds ``{"bn":
    ..., "bn_state": ...}``), as the JAX session's prep does; the parameters
    are buffers."""

    def __init__(self, encoder_params: Optional[dict], nonlinearities, bn: Optional[dict] = None,
                 matmul_dtype=None):
        super().__init__()
        self.matmul_dtype = matmul_dtype
        self.nonlinearities = tuple(nonlinearities or ())
        self.params = _ParamBuffers({"encoder": encoder_params or {}, **(bn or {})})
        self.has_encoder, self.has_bn = bool(encoder_params), bn is not None

    def forward(self, x):
        B, n, D = x.shape
        p = self.params.tree()
        if self.has_encoder:
            x = encoder_mod.encoder_forward(p["encoder"], x.reshape(B * n, D),
                                            self.nonlinearities,
                                            matmul_dtype=self.matmul_dtype).reshape(B, n, -1)
        if self.has_bn:
            x, _ = norm_ops.batch_norm_forward(p["bn"], p["bn_state"], x, train=False)
        return x


class StreamAdvance(torch.nn.Module):
    """A streaming session's advance as a module: ``forward(feats, mask,
    state) -> (probs, new_state)`` through
    ``models/adenet.head_forward_streaming``, with the head's parameters
    (every stream's LSTM, the fusion, the aggregator and the output layer,
    no encoder) as buffers."""

    def __init__(self, params: dict, config: adenet.AdeNetConfig):
        super().__init__()
        self.config = config
        head = {**params, "streams": {name: {k: v for k, v in sp.items()
                                             if k not in ("encoder", "bn", "bn_state")}
                                      for name, sp in params["streams"].items()}}
        self.params = _ParamBuffers(head)

    def forward(self, feats, mask, state):
        return adenet.head_forward_streaming(self.params.tree(), self.config, list(feats),
                                             mask, state)


def _identity(x):
    return x


def numpy_prep(program, device):
    """A session's prep callable over ``program`` (a :class:`StreamPrep` or
    a loaded one): (B, n, D) float32 numpy uploaded to ``device``, the
    (B, n, E) result left there."""
    def prep(x):
        with torch.inference_mode():
            return program(torch.from_numpy(np.ascontiguousarray(x)).to(device))

    return prep


def numpy_advance(program, device):
    """A session's advance callable over ``program`` (a
    :class:`StreamAdvance` or a loaded one): the numpy features and mask
    uploaded to ``device``, the state kept there."""
    def advance(feats, mask, state):
        with torch.inference_mode():
            feats = tuple(torch.from_numpy(np.ascontiguousarray(f)).to(device) for f in feats)
            return program(feats, torch.from_numpy(np.ascontiguousarray(mask)).to(device),
                           state)

    return advance


class StreamingSession:
    """Online inference: feed frames as they arrive, get per-frame scores.

    The session advances the model incrementally with the one-shot
    forward's result for every frame:

    * the recurrent head carries (cell, hid) across feeds
      (``models/adenet.head_forward_streaming``; masked steps make chunk
      padding free), on the device, where the state stays between feeds;
    * the delta features are centred FIRs (cascaded twice for the
      acceleration, each with its own edge padding, ``ops/delta.py``), so
      frame t's features are final once frame t + 2 * window has arrived:
      scores are emitted with a fixed ``2 * window``-frame lookahead, and
      :meth:`finalize` flushes the tail with the true end-of-utterance edge
      padding.

    The encoders run on the device and the encoded frames come to the
    host, where the delta FIR runs in numpy over the retained tail of the
    buffer (the frames a future delta context can still read); the head
    runs on the device.

    The aggregator must be forward-only
    (:func:`models.adenet.check_streamable`): a BLSTM's backward half
    consumes the whole utterance.  ``batch`` > 1 streams B utterances in
    lockstep (every fed frame valid for every row); utterances that end
    apart belong in separate sessions.  Chunks of any size may be fed;
    internally they are rounded up to powers of two with zero-mask padding,
    the bounded shape set a CUDA graph capture would need.

    >>> sess = StreamingSession(params, cfg)
    >>> for chunk in frame_source:          # (1, n, D) per stream
    ...     for probs in sess.feed([chunk]):
    ...         ...                         # (1, C) per emitted frame
    >>> final = sess.finalize()             # flush tail; vote / last_step
    """

    def __init__(self, params: dict, config: adenet.AdeNetConfig, batch: int = 1,
                 device=None):
        adenet.check_streamable(config)
        adenet.check_supported(config)
        device = resolve_device(device)
        params = tree_to(params, device)
        self._B = int(batch)
        self._W = int(config.window)
        # the cascaded delta FIRs need 2W future frames; without a delta
        # stream every frame is final at once
        self._L = 2 * self._W if any(s.use_delta for s in config.streams) else 0
        self._use_delta = [bool(s.use_delta) for s in config.streams]
        self._n_streams = len(config.streams)
        self._out_mode = config.output_mode
        self._C = int(config.output_classes)
        self._reset_feed_state(adenet.streaming_init_state(params, config, self._B))

        preps = []
        for spec in config.streams:
            sp = params["streams"][spec.name]
            bn = ({"bn": sp["bn"], "bn_state": sp["bn_state"]} if spec.use_batchnorm
                  else None)
            preps.append(StreamPrep(sp.get("encoder"), spec.encoder_nonlinearities,
                                    bn, config.matmul_dtype).to(device)
                         if spec.encoder_shapes or bn is not None else None)
        advance = StreamAdvance(params, config).to(device)
        # the modules, for the exporter; a stream with neither an encoder nor
        # batch norm has no prep
        self._programs = (preps, advance)
        self._prep = [_identity if p is None else numpy_prep(p, device) for p in preps]
        self._advance = numpy_advance(advance, device)

    @classmethod
    def _from_parts(cls, *, prep, advance, state0, window, lookahead,
                    use_delta, output_mode, output_classes, batch):
        """A session over given callables: ``prep`` a list of per-stream
        ``(B, n, D_i) numpy -> (B, n, E_i)`` callables (tensor or array),
        ``advance`` a ``(feats tuple, mask, state) -> (probs, state)``
        callable, ``state0`` the initial recurrent state; how an exported
        streaming program would be revived without the model code."""
        self = cls.__new__(cls)
        self._B = int(batch)
        self._W = int(window)
        self._L = int(lookahead)
        self._use_delta = list(use_delta)
        self._n_streams = len(prep)
        self._out_mode = output_mode
        self._C = int(output_classes)
        self._reset_feed_state(state0)
        self._prep = list(prep)
        self._advance = advance
        return self

    def _reset_feed_state(self, state0):
        """The mutable per-utterance state, shared by __init__ and
        _from_parts."""
        self._state0 = state0
        self._state = state0
        self._enc = []      # per stream: retained tail of encoded frames
        self._base = 0      # absolute frame index of _enc[i][:, 0]
        self._emitted = 0   # frames whose scores have been returned
        self._votes = None  # (B, C) int64 running argmax counts
        self._last_probs = None
        self._finalized = False

    def fresh(self) -> "StreamingSession":
        """A new session for the next utterance, sharing this one's
        parameters on the device and its prep/advance callables."""
        return StreamingSession._from_parts(
            prep=self._prep, advance=self._advance, state0=self._state0,
            window=self._W, lookahead=self._L, use_delta=self._use_delta,
            output_mode=self._out_mode, output_classes=self._C, batch=self._B)

    # -- internals ----------------------------------------------------------

    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def _encode(self, chunks):
        if len(chunks) != self._n_streams:
            raise ValueError(f"model has {self._n_streams} streams, got {len(chunks)} chunks")
        out = []
        for i, x in enumerate(chunks):
            x = np.asarray(_to_host(x), np.float32)
            if x.shape[0] != self._B:
                raise ValueError(f"batch {x.shape[0]} != session batch {self._B}")
            n = x.shape[1]
            nb = self._bucket(n)
            if nb != n:
                x = np.pad(x, ((0, 0), (0, nb - n), (0, 0)))
            out.append(_to_host(self._prep[i](x))[:, :n])
        return out

    def _features(self, stream_idx, e, f, final):
        """The [x, delta, accel] features of frames [e, f) of one stream
        from the encoded buffer; indices are absolute frame positions, and
        the buffer holds the frames from ``self._base`` on."""
        x = self._enc[stream_idx]
        base = self._base
        if not self._use_delta[stream_idx]:
            return x[:, e - base: f - base]
        W = self._W
        d_start = max(e - W, 0)
        x_lo = max(d_start - W, 0)
        left_x = W - (d_start - x_lo)
        parts = []
        if left_x:
            # the start-of-utterance edge pad; eviction keeps base == 0
            # until e >= 2W, after which no left pad occurs
            assert base == 0, (base, e)
            parts.append(np.repeat(x[:, :1], left_x, axis=1))
        parts.append(x[:, x_lo - base:])
        if final:
            parts.append(np.repeat(x[:, -1:], W, axis=1))
        ctx = np.concatenate(parts, axis=1)        # spans [d_start - W, ...)
        d = _np_delta_fir(ctx, W)                  # d over [d_start, S[-W])
        left_d = d_start - (e - W)                 # > 0 only near the start
        parts = []
        if left_d:
            parts.append(np.repeat(d[:, :1], left_d, axis=1))
        parts.append(d)
        if final:
            parts.append(np.repeat(d[:, -1:], W, axis=1))
        d_cov = np.concatenate(parts, axis=1)      # spans [e - W, f + W)
        a = _np_delta_fir(d_cov, W)                # a over [e, f)
        n = f - e
        return np.concatenate([x[:, e - base: f - base], d_cov[:, W: W + n], a[:, :n]],
                              axis=-1)

    def _emit(self, f, final=False):
        """Run the head over frames [self._emitted, f) and yield each
        frame's (B, C) probabilities."""
        e = self._emitted
        if f <= e:
            return
        feats = [self._features(i, e, f, final) for i in range(self._n_streams)]
        n = f - e
        nb = self._bucket(n)
        mask = np.zeros((self._B, nb), np.float32)
        mask[:, :n] = 1.0
        if nb != n:
            feats = [np.pad(x, ((0, 0), (0, nb - n), (0, 0))) for x in feats]
        probs, self._state = self._advance(tuple(feats), mask, self._state)
        probs = _to_host(probs)[:, :n]
        self._emitted = f
        # evict the frames no later delta context reads (it reaches back at
        # most 2W before the emit point)
        keep_from = self._emitted - (2 * self._W if self._L else 0)
        if keep_from > self._base:
            drop = keep_from - self._base
            self._enc = [x[:, drop:] for x in self._enc]
            self._base = keep_from
        if self._votes is None:
            self._votes = np.zeros((self._B, self._C), np.int64)
        for t in range(n):
            p = probs[:, t]
            np.add.at(self._votes, (np.arange(self._B), p.argmax(-1)), 1)
            self._last_probs = p
            yield p

    # -- public API ---------------------------------------------------------

    def feed(self, chunks) -> list:
        """Append one chunk per stream ((B, n, D_i), equal n) and return the
        list of (B, C) probabilities of every frame that became final.

        Eager on purpose (a list, not a generator): the frames enter the
        buffers whether or not the caller looks at the scores."""
        if self._finalized:
            raise RuntimeError("session is finalized")
        enc = self._encode(chunks)
        n = enc[0].shape[1]
        if any(e.shape[1] != n for e in enc):
            raise ValueError("streams must advance in lockstep (equal frames per feed)")
        if not self._enc:
            self._enc = enc
        else:
            self._enc = [np.concatenate([b, e], axis=1) for b, e in zip(self._enc, enc)]
        S = self._base + self._enc[0].shape[1]
        return list(self._emit(S - self._L))

    def finalize(self):
        """Flush the lookahead tail (end-of-utterance edge padding) and
        return ``(tail_probs, result)``: the (B, k, C) probabilities of the
        k flushed frames, and the utterance's result: majority-vote class
        ids (B,) for per_step models, the last frame's (B, C) probabilities
        for last_step ones."""
        if self._finalized:
            raise RuntimeError("session is finalized")
        # judged on the absolute frame count: zero-length chunks leave _enc
        # non-empty but frameless, and a delta-free session evicts every
        # emitted frame
        total = self._base + (self._enc[0].shape[1] if self._enc else 0)
        if total == 0:
            raise RuntimeError("no frames were fed")
        tail = list(self._emit(total, final=True))
        tail = (np.stack(tail, axis=1) if tail
                else np.zeros((self._B, 0, self._C), np.float32))
        self._finalized = True
        if self._out_mode == "last_step":
            return tail, self._last_probs
        return tail, np.argmax(self._votes, axis=-1)

    def predict(self):
        """Running majority-vote class ids (B,) over the frames emitted so
        far (ties toward the lower class id, as masked_majority_vote)."""
        if self._votes is None:
            raise RuntimeError("no frames emitted yet (the delta lookahead "
                               f"is {self._L} frames)")
        return np.argmax(self._votes, axis=-1)
