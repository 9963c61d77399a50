"""What the benchmark makes from ``--seed``: the weights, the traffic's
utterances and the order they are sent in.

The program and the reference are handed the same tensors.  Weights are
drawn on the card in one call and cut into the layout of
``models/adenet.init_adenet_params`` (keys, shapes and order), worked out
here from the configuration's widths.  Utterances come from the traffic
file's parameters: every seed gets the same multiset of lengths, in its own
order, so the work of a run does not depend on the seed.  Host pools are
drawn on the card and copied home once.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from avsr_bench.harness import yardstick

ENCODER_NAMES = ("fc1", "fc2", "fc3", "bottleneck")
PEEPHOLE_KEYS = ("w_cell_to_ingate", "w_cell_to_forgetgate", "w_cell_to_outgate")
# the range of every vector leaf (biases, initial states, peepholes)
VECTOR_RANGE = 0.1


def sub_seed(seed: int, what: str) -> int:
    """A 60-bit seed for one use of ``seed`` (weights, inputs, order,
    dropout), so that the uses draw independent streams."""
    return int(hashlib.sha256(f"{int(seed)}:{what}".encode()).hexdigest()[:15], 16)


def generator(seed: int, what: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, what))


def _lstm_layout(d: int, H: int, peep: bool) -> dict:
    glorot_in = math.sqrt(6.0 / (d + H))
    glorot_hid = math.sqrt(6.0 / (2 * H))
    out = {"w_in": ((d, 4 * H), glorot_in), "w_hid": ((H, 4 * H), glorot_hid),
           "b": ((4 * H,), VECTOR_RANGE), "cell_init": ((1, H), VECTOR_RANGE),
           "hid_init": ((1, H), VECTOR_RANGE)}
    if peep:
        out.update({k: ((H,), VECTOR_RANGE) for k in PEEPHOLE_KEYS})
    return out


def layout(model: dict) -> dict:
    """The parameter tree of ``model`` with each leaf ``(shape, range)``:
    the leaf is drawn uniform on [-range, range) (an adasum coefficient on
    1 +- range)."""
    if any(s.get("use_batchnorm") for s in model["streams"]):
        raise ValueError("batch-norm streams are not drawn by this benchmark")
    layers = {name: (d, H, peep) for name, d, H, peep in yardstick.lstm_layers(model)}
    tree = {"streams": {}}
    for s in model["streams"]:
        sp = {}
        widths = [int(w) for w in (s.get("encoder_shapes") or [])]
        if widths:
            enc, d = {}, int(s["input_dim"])
            for i, w in enumerate(widths):
                name = ENCODER_NAMES[i] if i < len(ENCODER_NAMES) else f"fc{i + 1}"
                enc[name] = {"w": ((d, w), math.sqrt(6.0 / (d + w))), "b": ((w,), VECTOR_RANGE)}
                d = w
            sp["encoder"] = enc
        if s.get("use_lstm", True):
            sp["lstm"] = _lstm_layout(*layers[s["name"]])
        tree["streams"][s["name"]] = sp
    if model.get("fusiontype") == "adasum":
        tree["adasum"] = {f"adacoeff{i}": ((), VECTOR_RANGE)
                          for i in range(len(model["streams"]))}
    tree["aggregator"] = []
    n_agg = len(model.get("agg_sizes") or [None] * int(model.get("agg_layers", 1)))
    for i in range(n_agg):
        dirs = ("fwd", "bwd") if model.get("agg_bidirectional", True) else ("fwd",)
        tree["aggregator"].append({k: _lstm_layout(*layers[f"aggregator{i}.{k}"])
                                   for k in dirs})
    cin, C = yardstick.classifier_in_dim(model), int(model["output_classes"])
    tree["output"] = {"w": ((cin, C), math.sqrt(6.0 / (cin + C))), "b": ((C,), VECTOR_RANGE)}
    return tree


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, values, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, values, path + (i,)) for i, v in enumerate(tree)]
    return values[path]


def make_weights(model: dict, seed: int, device) -> dict:
    """The seeded parameter tree of ``model`` on ``device``, float32: one
    uniform draw for every leaf, then each leaf scaled to its range."""
    lay = layout(model)
    leaves = list(_leaves(lay))
    total = sum(math.prod(shape) for _, (shape, _) in leaves)
    flat = torch.empty(total, dtype=torch.float32, device=device).uniform_(
        -1.0, 1.0, generator=generator(seed, "weights", device))
    values, off = {}, 0
    for path, (shape, scale) in leaves:
        n = math.prod(shape)
        leaf = flat[off: off + n].view(shape) * scale
        if path[-1].startswith("adacoeff"):
            leaf = leaf + 1.0
        values[path] = leaf
        off += n
    return _rebuild(lay, values)


def lengths(n: int, lo: int, hi: int, seed: int) -> np.ndarray:
    """``n`` utterance lengths in [lo, hi]: the same multiset for every seed
    (lo, lo + 1, ..., hi repeated), in the seed's order."""
    base = lo + np.arange(n) % (hi - lo + 1)
    return np.random.default_rng(sub_seed(seed, "lengths")).permutation(base)


def masks(lens: np.ndarray, T: int) -> np.ndarray:
    return (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)


def frames_pool(config: dict, n: int, lens: np.ndarray, seed: int, device,
                features: bool = False) -> list:
    """The host arrays of ``n`` utterances of ``config``'s input, padded
    frames zero: for a trimodal configuration one (n, T, H*W) uint8 array
    of pixels; for a streams configuration, or with ``features`` (the
    trimodal model is trained on its preprocessed streams), one (n, T, D)
    float32 array per stream, standard normal.  Drawn on ``device`` and
    copied home."""
    inp = config["input"]
    T = int(inp["frames"])
    keep = torch.from_numpy(masks(lens, T)).to(device)[..., None]
    g = generator(seed, "frames", device)
    if inp["kind"] == "trimodal_raw" and not features:
        D = int(inp["image_shape"][0]) * int(inp["image_shape"][1])
        x = torch.randint(0, 256, (n, T, D), dtype=torch.uint8, generator=g, device=device)
        return [(x * keep.to(torch.uint8)).cpu().numpy()]
    if inp["kind"] in ("streams", "trimodal_raw"):
        return [(torch.randn((n, T, int(s["input_dim"])), generator=g, device=device) * keep)
                .cpu().numpy() for s in config["model"]["streams"]]
    raise ValueError(f"unknown input kind {inp['kind']!r}")


def labels(n: int, classes: int, seed: int) -> np.ndarray:
    return np.random.default_rng(sub_seed(seed, "labels")).integers(0, classes, n)


def order(seed: int):
    """The seeded random source of the send order."""
    return np.random.default_rng(sub_seed(seed, "order"))
