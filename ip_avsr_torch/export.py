"""Deployment export: one self-contained artifact for the serve program.

The port of ip_avsr_tpu/export.py.  The served program (``serve.Server``,
``serve.TrimodalServer``, or a streaming session's ``serve.StreamPrep``
and ``serve.StreamAdvance`` modules) is traced by ``torch.export`` with
its parameters as buffers and written with ``torch.export.save``, so the
serving host needs torch, this module and the kernels' operator
registrations (``ip_avsr_torch.ops.kernels``), and not the model zoo, the
model code, ``train/config.py`` or the INI parser.

The kernels of the path are operators that the exported graph records as
opaque nodes: ``ip_avsr::lstm_recurrence``, ``lstm_recurrence_state``,
``lstm_peep_recurrence``, ``lstm_peep_recurrence_state`` (kernel-table rows
1 and 5) and ``ip_avsr::delta_group`` (row 2), each with a CPU
implementation (its plain version) and a CUDA one (its kernel).  A ``.pt2``
cannot carry the CUDA libraries themselves, as a JAX blob carries a Pallas
kernel as ``tpu_custom_call``: on the card a loaded program builds them
from ``ip_avsr_torch/csrc`` at first use, as the live code does, which
needs the CUDA toolkit (``nvcc``).

Two export shapes, as in the JAX package:

- **Symbolic** (default): the batch and time axes are ``Dim("b", min=1)``
  and ``Dim("t", min=floor)``, so ONE artifact serves any request size;
  the floor is the model's window where any stream has deltas, else 1,
  and at least 3 for the raw-pixel server (its T - 1 frame differences).
  The JAX package disables its Pallas dispatch for a symbolic trace, since
  its kernel heuristics need concrete shapes.  Nothing of the kind is
  needed here: the kernels' launch plans (``fwd_launch_plan``, the row
  chunks, the delta kernel's block layout) are made inside the operators'
  CUDA implementations from the concrete shapes of each call, so the
  traced graph holds no shape decision.
- **Fixed-shape**: ``batch``/``time`` pin that axis; the loaded program
  refuses any other size.

Every artifact can be loaded on the CPU or on the card, whichever device
it was exported on: the loader moves it with
``torch.export.passes.move_to_device_pass`` (every operator on the path
has both implementations), unless ``platforms`` restricts it.

The artifact is a zip (conventionally ``.ipax``) with ``meta.json`` (the
JAX package's fields, with ``torch_version`` for ``jax_version`` and its
own format tag) and one ``torch.export`` program per entry.  Each
package's loader refuses the other's artifacts.
"""

from __future__ import annotations

import dataclasses
import io
import json
import zipfile
from typing import Optional, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.export import Dim
from torch.export.passes import move_to_device_pass

# the operators a loaded program calls must be registered before it loads
import ip_avsr_torch.ops.kernels.delta  # noqa: F401
import ip_avsr_torch.ops.kernels.lstm  # noqa: F401
from ip_avsr_torch.device import resolve_device, tree_map

_FORMAT = "ipavsr-torch-export/1"
# the JAX package's artifacts (ip_avsr_tpu/export.py), refused by name
_JAX_FORMAT = "ipavsr-export/1"
PLATFORMS = ("cpu", "cuda")


def config_to_dict(config) -> dict:
    """JSON-able dict of an :class:`AdeNetConfig` (tuples become lists).
    The fields the JAX package's dataclasses lack (``adenet.PORT_FIELDS``:
    a conv front end's, ``agg_merge``) are written only where they differ
    from their defaults, so a config the JAX package can express gives the
    JAX package's dict."""
    from ip_avsr_torch.models import adenet

    def strip(d, obj):
        for f in dataclasses.fields(obj):
            if f.name in adenet.PORT_FIELDS and getattr(obj, f.name) == f.default:
                del d[f.name]
        return d

    d = strip(dataclasses.asdict(config), config)
    d["streams"] = [strip(s, spec) for s, spec in zip(d["streams"], config.streams)]
    return d


def config_from_dict(d: dict):
    from ip_avsr_torch.models import adenet

    def tuples(s, *keys):
        return {**s, **{k: tuple(s[k]) if s.get(k) else None for k in keys if k in s}}

    streams = [adenet.StreamSpec(**tuples(s, "encoder_shapes", "encoder_nonlinearities",
                                          "frontend_widths"))
               for s in d["streams"]]
    rest = {k: v for k, v in d.items() if k != "streams"}
    if rest.get("agg_sizes") is not None:
        rest["agg_sizes"] = tuple(rest["agg_sizes"])
    return adenet.AdeNetConfig(streams=streams, **rest)


def _dtype(weights_dtype) -> torch.dtype:
    """A torch dtype from a dtype or its name (``"bfloat16"``)."""
    if isinstance(weights_dtype, torch.dtype):
        return weights_dtype
    dtype = getattr(torch, str(weights_dtype), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown weights_dtype {weights_dtype!r}")
    return dtype


def _dtype_name(weights_dtype) -> str:
    if weights_dtype is None:
        return "float32"
    return str(_dtype(weights_dtype)).removeprefix("torch.")


def _cast_weights(params, weights_dtype):
    """The artifact's size lever: store the float32 weights in a narrower
    dtype (bf16 halves the artifact).  The served program upcasts them to
    float32 before any op (``serve._ParamBuffers.tree``), as the JAX
    package's dots promote bf16 weights against f32 activations, except
    each LSTM's bf16 ``w_hid``, which the recurrences take as it is: their
    kernels' bf16 instantiations round h_{t-1} to bf16 before the product,
    as the JAX package's recurrence does with a bf16 ``w_hid``.  None is a
    no-op."""
    if weights_dtype is None:
        return params
    wd = _dtype(weights_dtype)
    return tree_map(lambda x: x.to(wd) if x.dtype == torch.float32 else x, params)


def resolved_platforms(platforms=None) -> list:
    """The devices an artifact may be loaded on, as meta.json records them:
    ``platforms`` checked against :data:`PLATFORMS`, or both when None.
    Unlike the JAX package, where a pinned shape keeps the TPU kernels and
    so the native platform only, every artifact of the port runs on either
    device, symbolic or pinned."""
    if platforms is None:
        return list(PLATFORMS)
    platforms = list(platforms)
    if not platforms or any(p not in PLATFORMS for p in platforms):
        raise ValueError(f"platforms must be a non-empty subset of {PLATFORMS}, "
                         f"got {platforms}")
    return platforms


def _time_floor(config, min_time, raw=False) -> int:
    """The least T a symbolic artifact serves: ``min_time`` when given, the
    window where any stream has deltas (the FIR needs that many frames),
    else 1 (a delta-free model serves any length).  The ``raw`` server's
    frame differences have T - 1 frames, and its traced program holds only
    where that size is never 1: its floor is at least 3."""
    if min_time is not None:
        floor = int(min_time)
    elif any(s.use_delta for s in config.streams):
        floor = max(int(config.window), 1)
    else:
        floor = 1
    return max(floor, 3) if raw else floor


def _serialize(program) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_server(
    params: dict,
    config,
    *,
    vote: bool = True,
    batch: Optional[int] = None,
    time: Optional[int] = None,
    platforms: Optional[Sequence[str]] = None,
    min_time: Optional[int] = None,
    trimodal: Optional[dict] = None,
    weights_dtype=None,
    device=None,
) -> bytes:
    """Trace the generic preprocessed-streams server and serialize it.

    ``batch``/``time`` = None exports that axis symbolically (any size at
    call time); integers pin it.  ``min_time`` sets the symbolic time
    axis's floor (default :func:`_time_floor`).  ``trimodal`` (a kwargs dict
    for ``serve.TrimodalServer``: ``image_shape``, optional
    ``dct_coeffs``/``dct_mean``/``dct_std``) exports the raw-pixel server
    instead: input one (B, T, H*W) float32 pixel array, the diff, DCT and
    normalisation inside the program.  The trace runs on ``device``
    (default ``cuda``) with example sizes of at least 2 (T at least 3 for
    the raw server, see :func:`_time_floor`), so no axis, and no size
    derived from one, is specialised to 0 or 1."""
    from ip_avsr_torch import serve

    device = resolve_device(device)
    resolved_platforms(platforms)
    params = _cast_weights(params, weights_dtype)
    if trimodal is not None:
        program = serve.TrimodalServer(params, config, vote=vote, **trimodal)
    else:
        program = serve.Server(params, config, vote=vote)
    program = program.to(device)

    b = Dim("b", min=1) if batch is None else None
    floor = _time_floor(config, min_time, raw=trimodal is not None)
    t = Dim("t", min=floor) if time is None else None
    B = 2 if batch is None else int(batch)
    T = max(floor, 2) if time is None else int(time)
    axes = {k: d for k, d in ((0, b), (1, t)) if d is not None} or None
    mask = torch.ones((B, T), dtype=torch.float32, device=device)
    if trimodal is not None:
        hw = int(trimodal["image_shape"][0]) * int(trimodal["image_shape"][1])
        args = (torch.zeros((B, T, hw), dtype=torch.float32, device=device), mask)
        dynamic = (axes, axes)
    else:
        args = ([torch.zeros((B, T, s.input_dim), dtype=torch.float32, device=device)
                 for s in config.streams], mask)
        dynamic = ([axes] * len(config.streams), axes)
    exported = torch.export.export(program, args, dynamic_shapes=dynamic, strict=False)
    return _serialize(exported)


def save_artifact(
    path: str,
    params: dict,
    config,
    *,
    vote: bool = True,
    batch: Optional[int] = None,
    time: Optional[int] = None,
    platforms: Optional[Sequence[str]] = None,
    labels: Optional[Sequence[str]] = None,
    trimodal: Optional[dict] = None,
    min_time: Optional[int] = None,
    weights_dtype=None,
    device=None,
) -> None:
    """Export the serve program (:func:`export_server`, traced on
    ``device``) and write the ``.ipax`` zip artifact.

    ``labels`` (optional class names) ride along in meta.json so a serving
    host can map argmax indices to names without the training config.
    ``weights_dtype="bfloat16"`` halves the artifact.
    """
    blob = export_server(params, config, vote=vote, batch=batch, time=time,
                         platforms=platforms, trimodal=trimodal, min_time=min_time,
                         weights_dtype=weights_dtype, device=device)
    if trimodal is not None:
        hw = int(trimodal["image_shape"][0]) * int(trimodal["image_shape"][1])
        input_kind, stream_dims = "raw", [hw]
    else:
        input_kind = "streams"
        stream_dims = [s.input_dim for s in config.streams]
    meta = {
        "format": _FORMAT,
        "torch_version": torch.__version__,
        "config": config_to_dict(config),
        "labels": list(labels) if labels is not None else None,
        "entries": [{
            "name": "serve",
            "blob": "entries/serve.pt2",
            "vote": bool(vote),
            "input": input_kind,
            "batch": batch,
            "time": time,
            "platforms": resolved_platforms(platforms),
            "stream_dims": stream_dims,
            "output_classes": config.output_classes,
            "weights_dtype": _dtype_name(weights_dtype),
        }],
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        z.writestr("entries/serve.pt2", blob)


def _read_meta(z: zipfile.ZipFile) -> dict:
    """meta.json of an artifact of this package; raises ``ValueError`` for
    the JAX package's artifacts and anything else."""
    meta = json.loads(z.read("meta.json").decode("utf-8"))
    fmt = meta.get("format")
    if fmt == _JAX_FORMAT:
        raise ValueError(f"this is an ip_avsr_tpu (JAX) artifact (format={fmt!r}): "
                         "load it with ip_avsr_tpu.export; ip_avsr_torch reads "
                         f"{_FORMAT!r} artifacts")
    if fmt != _FORMAT:
        raise ValueError(f"not an ip_avsr_torch export artifact: format={fmt!r}")
    return meta


def _load_program(blob: bytes, device: torch.device, platforms) -> torch.nn.Module:
    """A serialized program on ``device``, as a callable module (which
    checks its inputs against the exported shapes)."""
    if device.type not in platforms:
        raise ValueError(f"the artifact was exported for {platforms}, not {device.type}")
    program = torch.export.load(io.BytesIO(blob))
    return move_to_device_pass(program, device).module()


class ExportedServer:
    """A loaded artifact: ``server(streams, mask) -> scores`` on its device.

    ``streams`` is a list of (B, T, D_i) arrays or tensors (one (B, T, H*W)
    pixel array for a raw-input artifact), ``mask`` (B, T) {0,1}; both are
    uploaded to the device as float32.  Fixed-shape entries require exactly
    the exported (B, T); symbolic entries accept any size satisfying the
    export constraints."""

    def __init__(self, meta: dict, program, device: torch.device):
        self.meta = meta
        entry = meta["entries"][0]
        self.vote = entry["vote"]
        self.input_kind = entry.get("input", "streams")
        self.batch = entry["batch"]
        self.time = entry["time"]
        self.stream_dims = entry["stream_dims"]
        self.output_classes = entry["output_classes"]
        self.labels = meta.get("labels")
        self.device = device
        self._program = program

    @property
    def config(self):
        return config_from_dict(self.meta["config"])

    def _upload(self, x) -> torch.Tensor:
        # contiguous: the program was traced on contiguous examples, and the
        # operators' CUDA implementations read dense rows (a dense array
        # with swapped axes would reach them as it is and be refused)
        return torch.as_tensor(x, device=self.device).to(torch.float32).contiguous()

    @torch.inference_mode()
    def __call__(self, streams, mask):
        mask = self._upload(mask)
        if self.input_kind == "raw":
            raw = self._upload(streams)
            if raw.shape[-1] != self.stream_dims[0]:
                raise ValueError(f"raw pixel dim {raw.shape[-1]} != "
                                 f"exported {self.stream_dims[0]}")
            return self._program(raw, mask)
        if len(streams) != len(self.stream_dims):
            raise ValueError(f"artifact expects {len(self.stream_dims)} "
                             f"streams, got {len(streams)}")
        streams = [self._upload(s) for s in streams]
        for s, d in zip(streams, self.stream_dims):
            if s.shape[-1] != d:
                raise ValueError(f"stream dim {s.shape[-1]} != exported {d}")
        return self._program(streams, mask)


def save_streaming_artifact(
    path: str,
    params: dict,
    config,
    *,
    batch: int = 1,
    platforms: Optional[Sequence[str]] = None,
    labels: Optional[Sequence[str]] = None,
    weights_dtype=None,
    device=None,
) -> None:
    """Export a streaming session (``serve.StreamingSession``) as one
    artifact.

    Serializes the session's two device programs, traced on ``device``:
    one ``prep_i`` per stream with an encoder or batch norm
    (``serve.StreamPrep``, batch norm in evaluation mode; any other
    stream's prep is the identity and has no entry) and the
    stateful head advance (``serve.StreamAdvance``), both with a symbolic
    chunk axis ``n >= 1``, plus the initial recurrent state (``state0.npz``)
    and the scalar session contract (window, lookahead, per-stream delta
    flags, head mode).  :func:`load_streaming_session` revives a working
    session from it."""
    from ip_avsr_torch import serve

    device = resolve_device(device)
    platforms = resolved_platforms(platforms)
    params = _cast_weights(params, weights_dtype)
    sess = serve.StreamingSession(params, config, batch=batch, device=device)
    preps, advance = sess._programs
    n = Dim("n", min=1)

    blobs = {}
    for i, (spec, prep) in enumerate(zip(config.streams, preps)):
        if prep is not None:
            x = torch.zeros((batch, 2, spec.input_dim), dtype=torch.float32, device=device)
            blobs[f"prep_{i}"] = _serialize(torch.export.export(
                prep, (x,), dynamic_shapes=({1: n},), strict=False))
    feats = tuple(torch.zeros((batch, 2, s.feature_dim()), dtype=torch.float32, device=device)
                  for s in config.streams)
    mask = torch.ones((batch, 2), dtype=torch.float32, device=device)
    blobs["advance"] = _serialize(torch.export.export(
        advance, (feats, mask, sess._state),
        dynamic_shapes=(tuple({1: n} for _ in feats), {1: n},
                        tree_map(lambda _: None, sess._state)), strict=False))

    leaves, treespec = pytree.tree_flatten(sess._state)
    state_buf = io.BytesIO()
    np.savez(state_buf, **{f"leaf_{i}": leaf.cpu().numpy() for i, leaf in enumerate(leaves)})

    meta = {
        "format": _FORMAT,
        "torch_version": torch.__version__,
        "config": config_to_dict(config),
        "labels": list(labels) if labels is not None else None,
        "streaming": {
            "batch": int(batch),
            "window": int(config.window),
            "lookahead": int(sess._L),
            "use_delta": [bool(s.use_delta) for s in config.streams],
            "output_mode": config.output_mode,
            "output_classes": int(config.output_classes),
            "stream_dims": [s.input_dim for s in config.streams],
            "n_state_leaves": len(leaves),
            # loud-error guard for structural drift between save and load
            # (the loader rebuilds the structure from parallel code)
            "state_treedef": str(treespec),
            "platforms": platforms,
        },
        "entries": [{"name": k, "blob": f"entries/{k}.pt2"} for k in sorted(blobs)],
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        for k, blob in blobs.items():
            z.writestr(f"entries/{k}.pt2", blob)
        z.writestr("state0.npz", state_buf.getvalue())


class StreamingArtifact:
    """A loaded streaming artifact: call :meth:`new_session` per utterance.

    Load once, open many sessions: each session reuses the same loaded
    prep/advance programs on the artifact's device and starts from the same
    initial state there (no session writes it)."""

    def __init__(self, meta: dict, programs: dict, state0, device: torch.device):
        from ip_avsr_torch import serve

        self.meta = meta
        self.labels = meta.get("labels")
        self.device = device
        self._s = meta["streaming"]
        self._state0 = state0
        self._prep = [serve.numpy_prep(programs[f"prep_{i}"], device)
                      if f"prep_{i}" in programs else serve._identity
                      for i in range(len(self._s["stream_dims"]))]
        self._advance = serve.numpy_advance(programs["advance"], device)

    def new_session(self):
        from ip_avsr_torch.serve import StreamingSession

        s = self._s
        return StreamingSession._from_parts(
            prep=self._prep, advance=self._advance, state0=self._state0,
            window=s["window"], lookahead=s["lookahead"],
            use_delta=s["use_delta"], output_mode=s["output_mode"],
            output_classes=s["output_classes"], batch=s["batch"])


def load_streaming_artifact(path: str, device=None) -> StreamingArtifact:
    """Load a :func:`save_streaming_artifact` file onto ``device`` (default
    ``cuda``); open per-utterance sessions with
    :meth:`StreamingArtifact.new_session`."""
    device = resolve_device(device)
    with zipfile.ZipFile(path) as z:
        meta = _read_meta(z)
        if "streaming" not in meta:
            raise ValueError("not a streaming export artifact: use load_server()")
        s = meta["streaming"]
        programs = {e["name"]: _load_program(z.read(e["blob"]), device, s["platforms"])
                    for e in meta["entries"]}
        npz = np.load(io.BytesIO(z.read("state0.npz")))
        leaves = [torch.as_tensor(npz[f"leaf_{i}"], device=device)
                  for i in range(s["n_state_leaves"])]

    # rebuild the state structure from the config (the structure
    # streaming_init_state produces, which the advance program was traced
    # with); the saved string turns any structural drift into a loud error
    # instead of silently scrambled state
    treespec = pytree.tree_structure(_streaming_state_structure(meta["config"]))
    if s.get("state_treedef") and s["state_treedef"] != str(treespec):
        raise ValueError(
            "state structure mismatch: the artifact was saved with "
            f"{s['state_treedef']} but this code rebuilds {treespec}; "
            "re-export the artifact with this version")
    return StreamingArtifact(meta, programs, pytree.tree_unflatten(leaves, treespec), device)


def load_streaming_session(path: str, device=None):
    """Revive a :func:`save_streaming_artifact` file as one live
    ``serve.StreamingSession`` on ``device``.  For many utterances,
    :func:`load_streaming_artifact` once and ``new_session()`` per
    utterance avoids loading the programs again."""
    return load_streaming_artifact(path, device).new_session()


def _streaming_state_structure(config: dict):
    """A value with the structure of ``adenet.streaming_init_state``'s
    output for the config dict of meta.json (leaf values irrelevant: used
    only for unflattening)."""
    state = {"streams": {}, "aggregator": []}
    for spec in config["streams"]:
        if spec["use_lstm"]:
            state["streams"][spec["name"]] = (0, 0)
    for _ in range(config["agg_layers"]):
        state["aggregator"].append((0, 0))
    return state


def load_server(path: str, device=None) -> ExportedServer:
    """Load a ``.ipax`` artifact written by :func:`save_artifact` onto
    ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    with zipfile.ZipFile(path) as z:
        meta = _read_meta(z)
        if "streaming" in meta:
            raise ValueError("this is a streaming artifact: use "
                             "load_streaming_session()")
        entry = meta["entries"][0]
        program = _load_program(z.read(entry["blob"]), device, entry["platforms"])
    return ExportedServer(meta, program, device)
