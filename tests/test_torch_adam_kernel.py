"""The multi-tensor Adam kernel's wrapper (ip_avsr_torch/ops/kernels/adam.py)
and the optimizers' routing through it.

The launch plan and the leaf table are the pure-Python half of
csrc/adam.cu: the leaves back to back in one flat index space (each from a
multiple of 4), cut into equal chunks of ``CHUNK`` values a block, tables of
a launch's capacity, 16-byte access only where all seven pointers are
aligned.  They are held here on both benchmark configurations' trees (43
and 70 leaves, ``avsr_bench/harness/inputs.layout``) and on edge cases,
every value of every leaf owned by exactly one block as the kernel's index
arithmetic (mirrored below) assigns them.  The source's table size is held
to the kernel-parameter limit it is chosen for.  The wrapper pairs the
trees' leaves by the params' keys, whatever the other trees' order.

Routing: a CPU tree takes the plain version, today's three ``tree_map``s
bit for bit and no launch; a CUDA tree takes the kernel or raises (a
float64 leaf, checked before the library is loaded; a fake CUDA tree
stands in for the card).  The ``cuda`` case runs on the card alone (``python
-m pytest tests/test_torch_adam_kernel.py -m cuda --noconftest``): the kernel
bit-equal to the plain version over 5 steps for ``adam`` and ``adam_vlr``
and on ZeRO-1's ``narrow`` blocks, one launch an update.  The file imports
no JAX.
"""

import ctypes
import json
import math
import os
import re

import numpy as np
import pytest
import torch

from avsr_bench.harness import inputs
from ip_avsr_torch.device import tree_map
from ip_avsr_torch.ops.kernels import _build
from ip_avsr_torch.ops.kernels import adam as kadam
from ip_avsr_torch.train import optimizers as topt

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"adenet_v3-oulu-trimodal": 43, "adenet-oulu-4stream": 70}
SOURCE = os.path.join(_build.CSRC, "adam.cu")


def _source_int(name):
    with open(SOURCE) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


LARGE = _source_int("kLeaves")
# a table smaller than either benchmark tree's, to hold the splits at
SMALL = 48


def _numels(config):
    with open(os.path.join(ROOT, "avsr_bench", "configs", f"{config}.json")) as f:
        model = json.load(f)["model"]
    return [math.prod(shape) for _, (shape, _) in inputs._leaves(inputs.layout(model))]


def _addresses(numels, base=1 << 32):
    """Seven addresses a leaf as the caching allocator hands them out:
    every tensor at a multiple of 512 bytes."""
    out, at = [], base
    for n in numels:
        leaf = []
        for _ in range(7):
            leaf.append(at)
            at += -(-max(4 * n, 1) // 512) * 512
        out.append(tuple(leaf))
    return out


def _owners(plan, numels):
    """How many blocks own each value of each leaf, by the kernel's
    arithmetic: block b takes [b chunk, (b + 1) chunk) of its launch's flat
    space, finds its first leaf by a binary search over the table and walks
    on while a leaf starts before its end."""
    count = [np.zeros(n, dtype=np.int64) for n in numels]
    segments = []
    for launch in plan:
        starts, ns = launch.starts, [numels[i] for i in launch.leaves]
        for b in range(launch.blocks):
            lo, hi = b * launch.chunk, (b + 1) * launch.chunk
            k, top = 0, len(ns) - 1
            while k < top:
                mid = (k + top) // 2
                if starts[mid] + ns[mid] <= lo:
                    k = mid + 1
                else:
                    top = mid
            held = []
            while k < len(ns) and starts[k] < hi:
                first = max(lo, starts[k]) - starts[k]
                end = min(hi, starts[k] + ns[k]) - starts[k]
                if launch.vector[k]:
                    assert first % 4 == 0
                count[launch.leaves[k]][first:end] += 1
                held.append((launch.leaves[k], end - first))
                k += 1
            segments.append(held)
    return count, segments


def _assert_plan(plan, numels, capacity):
    live = [i for i, n in enumerate(numels) if n > 0]
    assert [i for launch in plan for i in launch.leaves] == live
    for launch in plan:
        assert 1 <= len(launch.leaves) <= capacity
        ends = [s + numels[i] for s, i in zip(launch.starts, launch.leaves)]
        assert launch.starts[0] == 0
        assert all(s % 4 == 0 for s in launch.starts)
        assert all(s == -(-e // 4) * 4 for s, e in zip(launch.starts[1:], ends[:-1]))
        assert launch.total == ends[-1]
        assert launch.blocks == -(-launch.total // launch.chunk)
    count, _ = _owners(plan, numels)
    assert all((c == 1).all() for c in count)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_benchmark_trees_take_one_launch_of_equal_chunks(config):
    numels = _numels(config)
    assert len(numels) == CONFIGS[config]
    addresses = _addresses(numels)
    plan = kadam.launch_plan(numels, addresses, LARGE)
    assert len(plan) == 1
    _assert_plan(plan, numels, LARGE)
    launch = plan[0]
    assert all(launch.vector)
    # equal chunks across leaves: every block but the last holds a chunk's
    # values less the padding between its leaves, so no small leaf holds a
    # block alone
    _, segments = _owners(plan, numels)
    assert len(segments) == launch.blocks
    for held in segments[:-1]:
        assert sum(n for _, n in held) > launch.chunk - 4 * len(held)
    assert launch.total < sum(numels) + 4 * len(numels)
    assert len(numels) <= kadam.CAPACITY == LARGE


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_benchmark_trees_split_at_a_small_table(config):
    """At a table of 48 leaves the flagship's tree still takes one launch
    and the 4-stream tree two."""
    numels = _numels(config)
    plan = kadam.launch_plan(numels, _addresses(numels), SMALL)
    assert len(plan) == -(-len(numels) // SMALL)
    assert [len(p.leaves) for p in plan][0] == min(SMALL, len(numels))
    _assert_plan(plan, numels, SMALL)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_leaf_table_packs_the_kernels_entries(config):
    numels = _numels(config)
    addresses = _addresses(numels)
    factors = [0.5 + i / 7 for i in range(len(numels))]
    launch, = kadam.launch_plan(numels, addresses, LARGE)
    table = kadam.leaf_table(launch, numels, addresses, factors)
    assert table.dtype == np.int64 and table.shape == (len(numels), kadam.LEAF_WORDS)
    assert table.nbytes == 80 * len(numels)
    assert (table[:, :7].view(np.uint64) == np.array(addresses, dtype=np.uint64)).all()
    assert (table[:, 7] == launch.starts).all() and (table[:, 8] == numels).all()
    low = (table[:, 9] & 0xFFFFFFFF).astype(np.uint32).view(np.float32)
    assert (low == np.array(factors, dtype=np.float32)).all()
    assert ((table[:, 9] >> 32) == 1).all()


def test_one_value_leaves_share_a_block():
    numels = [1] * 100
    plan = kadam.launch_plan(numels, _addresses(numels), LARGE)
    launch, = plan
    assert launch.starts == tuple(range(0, 400, 4))
    assert launch.total == 397 and launch.blocks == 1
    _assert_plan(plan, numels, LARGE)


def test_a_tree_larger_than_a_table_takes_one_launch_a_table():
    numels = [3, 4097, 1, 0, 250000] * 20
    plan = kadam.launch_plan(numels, _addresses(numels), SMALL)
    live = sum(n > 0 for n in numels)
    assert [len(p.leaves) for p in plan] == [SMALL, live - SMALL]
    assert all(p.starts[0] == 0 for p in plan)
    _assert_plan(plan, numels, SMALL)
    big = kadam.launch_plan(numels, _addresses(numels), LARGE)
    assert len(big) == 1
    _assert_plan(big, numels, LARGE)


def test_misaligned_leaves_take_scalar_access():
    """One of a leaf's seven pointers off a 16-byte boundary turns its
    loads and stores scalar; ZeRO-1's block of a (500,) bias at rank 1 of 4
    lies 500 bytes into the leaf."""
    numels = [500, 125, 77, 8]
    addresses = _addresses(numels)
    bias = torch.zeros(500)
    block = bias.narrow(0, 125, 125)
    assert (block.data_ptr() - bias.data_ptr()) % 16 == 4
    addresses[1] = (block.data_ptr(),) + addresses[1][1:]
    addresses[2] = addresses[2][:6] + (addresses[2][6] + 8,)
    plan = kadam.launch_plan(numels, addresses, LARGE)
    assert plan[0].vector == (True, False, False, True)
    _assert_plan(plan, numels, LARGE)


@pytest.mark.parametrize("chunk", [4, 12, 4096, 65536])
def test_any_chunk_covers_every_value_once(chunk):
    numels = [1, 2, 3, 5, 4096, 4095, 4097, 13, 0, 9000]
    plan = kadam.launch_plan(numels, _addresses(numels), 4, chunk=chunk)
    assert all(p.chunk == chunk for p in plan)
    _assert_plan(plan, numels, 4)


@pytest.mark.parametrize("capacity,chunk", [(0, 4096), (48, 0), (48, 6)])
def test_plan_refuses_a_bad_table_or_chunk(capacity, chunk):
    with pytest.raises(ValueError):
        kadam.launch_plan([5], _addresses([5]), capacity, chunk=chunk)


def test_table_sizes_fit_the_kernel_parameter_limits():
    """The entry is 10 words (80 bytes, ``static_assert`` in the source);
    the table and the kernel's other parameters fit the 32,764 bytes of
    CUDA 12.1+, which the source asserts of its toolkit and the wrapper
    asks of the driver; the wrapper's capacity is the source's."""
    with open(SOURCE) as f:
        src = f.read()
    assert "static_assert(sizeof(Leaf) == 80" in src
    assert "static_assert(CUDART_VERSION >= 12010" in src
    assert kadam.LEAF_WORDS * 8 == 80
    others = 4 + 8 + 8 + 5 * 4  # n_leaves, chunk, step, the constants (padded)
    assert LARGE * 80 + others <= 32764
    assert kadam.CAPACITY == LARGE and kadam.MIN_DRIVER == 12010
    assert kadam.CHUNK % 4 == 0


@pytest.mark.parametrize("driver", [0, 11080, 12000])
def test_a_driver_older_than_12_1_is_refused_at_load(monkeypatch, driver):
    def version():
        return driver

    fake = type("Lib", (), {})()
    fake.adam_driver_version = version
    monkeypatch.setattr(_build, "load", lambda name: fake)
    kadam._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="12.1"):
            kadam._lib()
    finally:
        kadam._lib.cache_clear()


# -- the wrapper's launches, against csrc/adam.cu's kernel emulated ------------


class _EmulatedKernel:
    """csrc/adam.cu's entry point and kernel on the host, reading the table
    and the tensors through their addresses (CPU tensors here): block by
    block, the binary search for the first leaf, then each leaf's segment
    with the kernel's float32 operations in its order, each rounded.  They
    are PyTorch's CPU operations: its CPU square root, which the plain
    version uses here, is not always correctly rounded (the card's and
    numpy's are)."""

    def __init__(self):
        self.calls = []

    def adam_multi_update(self, table_ptr, n, chunk, blocks, step_ptr, b1, omb1, b2, omb2,
                          eps, stream):
        words = (ctypes.c_int64 * (n * kadam.LEAF_WORDS)).from_address(table_ptr)
        table = np.ctypeslib.as_array(words).reshape(n, kadam.LEAF_WORDS).copy()
        step = torch.tensor(ctypes.c_float.from_address(step_ptr).value, dtype=torch.float32)
        b1, omb1, b2, omb2, eps = (c.value for c in (b1, omb1, b2, omb2, eps))
        starts, ns = table[:, 7], table[:, 8]
        factors = (table[:, 9] & 0xFFFFFFFF).astype(np.uint32).view(np.float32)
        vector = table[:, 9] >> 32
        assert blocks * chunk >= starts[-1] + ns[-1] and chunk % 4 == 0
        for b in range(blocks):
            lo, hi = b * chunk, (b + 1) * chunk
            k, top = 0, n - 1
            while k < top:
                mid = (k + top) // 2
                if starts[mid] + ns[mid] <= lo:
                    k = mid + 1
                else:
                    top = mid
            while k < n and starts[k] < hi:
                first = max(lo, starts[k]) - starts[k]
                end = min(hi, starts[k] + ns[k]) - starts[k]
                if vector[k]:
                    assert first % 4 == 0 and all(int(a) % 16 == 0 for a in table[k, :7])
                p, g, m, v, p_out, m_out, v_out = (torch.from_numpy(np.ctypeslib.as_array(
                    (ctypes.c_float * int(end - first)).from_address(int(a) + 4 * int(first))))
                    for a in table[k, :7])
                s = torch.tensor(factors[k]) * step
                m_out.copy_(b1 * m + omb1 * g)
                v_out.copy_(b2 * v + (omb2 * g) * g)
                p_out.copy_(p - (s * m_out) / (torch.sqrt(v_out) + eps))
                k += 1
        self.calls.append((n, chunk, blocks))
        return blocks


def _groups(gen, step, narrow):
    """p, g, m, v leaf lists: a 1-value leaf, a 0-d one, an empty one, odd
    sizes, and with ``narrow`` ZeRO-1 blocks (rank 1 of 4) of the weights,
    one not contiguous and one 4 bytes off a 16-byte boundary."""
    shapes = [(1144, 20), (20,), (), (1,), (0,), (77, 5), (500,), (3, 7, 2)]

    def draw(scale):
        return [torch.randn(s, generator=gen) * scale for s in shapes]

    groups = [draw(1.0), draw(10.0 ** -step), draw(0.1), [t.abs() for t in draw(0.01)]]
    if narrow:
        groups = [[t.narrow(1, 5, 5) if i == 0 else t.narrow(0, 125, 125) if i == 6 else t
                   for i, t in enumerate(group)] for group in groups]
    return groups


@pytest.mark.parametrize("capacity,chunk", [(LARGE, kadam.CHUNK), (3, 8), (SMALL, 12)])
@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("vlr", [False, True])
def test_wrapper_launches_equal_the_plain_version(monkeypatch, capacity, chunk, narrow, vlr):
    """The wrapper's outputs, allocation, table and launches, with the
    kernel emulated over real addresses, bit-equal to the plain version
    over 5 steps; the inputs untouched; one launch a table."""
    lib = _EmulatedKernel()
    monkeypatch.setattr(kadam, "_lib", lambda: lib)
    gen = torch.Generator().manual_seed(5)
    p, g, m, v = _groups(gen, 0, narrow)
    factors = [0.3 * (i + 1) if vlr else 1.0 for i in range(len(p))]
    if narrow:
        assert not p[0].is_contiguous() and (p[6].data_ptr() % 16) == 4
    t = torch.zeros((), dtype=torch.float32)
    for step in range(5):
        g = _groups(gen, step, narrow)[1]
        t = t + 1.0
        size = 1e-3 * torch.sqrt(1.0 - 0.999 ** t) / (1.0 - 0.9 ** t)
        keep = [x.clone() for x in p + g + m + v]
        kadam.adam_update.launches = 0
        got = kadam._launch([p, g, m, v], size, factors, 0.9, 0.999, 1e-8, 0, chunk=chunk,
                            capacity=capacity)
        live = sum(x.numel() > 0 for x in p)
        assert kadam.adam_update.launches == -(-live // capacity)
        assert all(torch.equal(a, b) for a, b in zip(keep, p + g + m + v))
        want = kadam.plain(p, g, m, v, size, 0.9, 0.999, 1e-8, factors if vlr else None)
        for outs, ref in zip(got, want):
            assert all(o.is_contiguous() and torch.equal(o, r) for o, r in zip(outs, ref))
        p, m, v = got
    assert all(c[1] == chunk for c in lib.calls)


@pytest.mark.parametrize("vlr", [False, True])
def test_trees_in_another_key_order_pair_by_the_params_keys(monkeypatch, vlr):
    """m, v, the gradients and the rates in another order than the params
    (JAX-bridged state comes back with sorted keys), leaves of one shape
    under swapped keys as the aggregator's ``fwd`` and ``bwd``: the
    wrapper's rows and launches, the kernel emulated, bit-equal key by key
    to the plain version, which pairs the trees by key."""
    lib = _EmulatedKernel()
    monkeypatch.setattr(kadam, "_lib", lambda: lib)
    gen = torch.Generator().manual_seed(9)
    shapes = {"fwd": (30, 8), "bwd": (30, 8), "out": {"w": (8, 3), "b": (3,)}}

    def draw(scale, order):
        tree = _draw(shapes, gen, scale)
        return {k: ({j: tree[k][j] for j in order(tree[k])} if isinstance(tree[k], dict)
                    else tree[k]) for k in order(tree)}

    same, backwards = list, lambda d: list(d)[::-1]
    params = draw(1.0, same)
    grads, m = draw(0.1, backwards), draw(0.01, sorted)
    v = tree_map(torch.abs, draw(0.001, backwards))
    rates = {"out": {"b": 0.5, "w": 0.25}, "bwd": 2.0, "fwd": 4.0} if vlr else None
    assert list(m) != list(params) and list(grads["out"]) != list(params["out"])
    step = torch.tensor(1e-3)
    rows = kadam._rows(params, grads, m, v, *([rates] if vlr else []))
    assert [r[0] for r in rows] == _leaves(params)
    groups = [list(group) for group in zip(*rows)]
    factors = [float(r) for r in groups[4]] if vlr else [1.0] * len(rows)
    got = kadam._launch(groups[:4], step, factors, 0.9, 0.999, 1e-8, 0)
    want = kadam.plain(params, grads, m, v, step, 0.9, 0.999, 1e-8, rates)
    for outs, ref in zip(got, want):
        same = []
        tree_map(lambda r, o: same.append(torch.equal(r, o)), ref, kadam._rebuild(params, outs))
        assert len(same) == len(rows) and all(same)
    assert len(lib.calls) == 1


def test_a_tree_that_lacks_a_leaf_of_the_params_raises():
    params = {"a": torch.zeros(3), "b": torch.zeros(2)}
    with pytest.raises(KeyError):
        kadam._rows(params, {"a": torch.zeros(3)})


# -- routing ------------------------------------------------------------------


def _draw(shapes, gen, scale, device="cpu"):
    if isinstance(shapes, dict):
        return {k: _draw(v, gen, scale, device) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_draw(v, gen, scale, device) for v in shapes]
    return torch.randn(shapes, generator=gen, device=device) * scale


def _old_adam(params, grads, state, lr, lr_map=None, beta1=0.9, beta2=0.999, epsilon=1e-8):
    """The optimizers' Adam before the kernel, as written then; with
    ``lr_map``, ``lr`` is adam_vlr's scale."""
    t = state["t"] + 1.0
    corr = lr * torch.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
    m = tree_map(lambda m, g: beta1 * m + (1.0 - beta1) * g, state["m"], grads)
    v = tree_map(lambda v, g: beta2 * v + (1.0 - beta2) * g * g, state["v"], grads)
    if lr_map is None:
        new = tree_map(lambda p, m, v: p - corr * m / (torch.sqrt(v) + epsilon), params, m, v)
    else:
        new = tree_map(lambda p, m, v, lr: p - (lr * corr) * m / (torch.sqrt(v) + epsilon),
                       params, m, v, lr_map)
    return new, {"m": m, "v": v, "t": t}


def _equal(a, b):
    la, lb = [], []
    tree_map(la.append, a)
    tree_map(lb.append, b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("name", ["adam", "adam_vlr"])
def test_cpu_trees_take_the_plain_tree_maps_bit_for_bit(name, monkeypatch):
    def no_library():
        raise AssertionError("a CPU tree loaded the kernel's library")

    monkeypatch.setattr(kadam, "_lib", no_library)
    gen = torch.Generator().manual_seed(3)
    params = _draw({"a": (5, 3), "b": [(3,), ()], "c": (40,)}, gen, 1.0)
    lr_map = topt.generate_lr_map(params, {"b": 0.3, "c": 0.07}, 0.01)
    opt = topt.adam(1e-3) if name == "adam" else topt.adam_vlr(lr_map, base_lr=0.01)
    state = opt.init(params)
    ref_p, ref_s = params, opt.init(params)
    kadam.adam_update.launches = 0
    for step in range(5):
        grads = _draw({"a": (5, 3), "b": [(3,), ()], "c": (40,)}, gen, 10.0 ** -step)
        rate = (1e-3 if name == "adam" else 0.02) * 0.9 ** step
        params, state = opt.apply(params, grads, state, learning_rate=rate)
        ref_p, ref_s = (_old_adam(ref_p, grads, ref_s, rate) if name == "adam" else
                        _old_adam(ref_p, grads, ref_s, rate / 0.01, lr_map))
        assert _equal(params, ref_p) and _equal(state, ref_s)
    assert kadam.adam_update.launches == 0


def _fake_cuda_tree(dtype_of):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode()
    with mode:
        params = {"w": torch.zeros(4, 3, dtype=dtype_of("w"), device="cuda"),
                  "b": torch.zeros(3, dtype=dtype_of("b"), device="cuda")}
        grads = tree_map(torch.ones_like, params)
    return mode, params, grads


@pytest.mark.parametrize("name", ["adam", "adam_vlr"])
def test_a_float64_cuda_leaf_raises_before_the_library_loads(name, monkeypatch):
    def no_library():
        raise AssertionError("the library was loaded for a refused tree")

    monkeypatch.setattr(kadam, "_lib", no_library)
    mode, params, grads = _fake_cuda_tree(lambda k: torch.float64 if k == "b" else torch.float32)
    opt = (topt.adam(1e-3) if name == "adam"
           else topt.adam_vlr({"w": 0.1, "b": 0.2}, base_lr=0.1))
    with mode:
        state = opt.init(params)
        with pytest.raises(TypeError, match="float32"):
            opt.apply(params, grads, state)


def test_a_cuda_tree_with_a_leaf_elsewhere_raises(monkeypatch):
    monkeypatch.setattr(kadam, "_lib", lambda: pytest.fail("library loaded"))
    mode, params, grads = _fake_cuda_tree(lambda k: torch.float32)
    with mode:
        state = topt.adam(1e-3).init(params)
        grads = dict(grads, b=torch.zeros(3, device="cpu"))
        with pytest.raises(ValueError, match="device"):
            topt.adam(1e-3).apply(params, grads, state)


# -- on the card --------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip)")
    return torch.device("cuda", 0)


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adam", "adam_vlr", "zero1"])
def test_kernel_is_bit_equal_to_the_plain_version_on_the_card(card, name):
    gen = torch.Generator(device=card).manual_seed(11)
    shapes = {"enc": {"w": (1144, 200), "b": (200,)}, "one": (), "odd": (77, 5),
              "agg": [{"w_hid": (500, 2000), "peep": (3,)}, {"b": (1,)}]}

    def draw(scale):
        return _draw(shapes, gen, scale, card)

    params = draw(1.0)
    lr_map = topt.generate_lr_map(params, {"agg": 0.3, "odd": 0.07}, 0.01)
    opt = topt.adam_vlr(lr_map, base_lr=0.01) if name == "adam_vlr" else topt.adam(1e-3)
    state = opt.init(params)
    ref_p, ref_m, ref_v = params, state["m"], state["v"]
    for step in range(5):
        grads = draw(10.0 ** -step)
        if name == "zero1":
            # rank 1 of 4's blocks along dim 0 or 1, as Trainer._block cuts them
            cut = lambda t: t if t.dim() == 0 else t.narrow(  # noqa: E731
                t.dim() - 1, t.shape[-1] // 4, max(t.shape[-1] // 4, 1))
            p_in, g_in = tree_map(cut, params), tree_map(cut, grads)
            if step == 0:
                state = opt.init(tree_map(lambda t: t.contiguous(), p_in))
                ref_m, ref_v = state["m"], state["v"]
            ref_p = p_in
        else:
            p_in, g_in = params, grads
        keep = [t.clone() for t in _leaves((p_in, g_in, state))]
        rate = (0.01 if name == "adam_vlr" else 1e-3) * 0.9 ** step
        kadam.adam_update.launches = 0
        new, new_state = opt.apply(p_in, g_in, state, learning_rate=rate)
        assert kadam.adam_update.launches == 1
        assert all(torch.equal(a, b) for a, b in zip(keep, _leaves((p_in, g_in, state))))
        t = new_state["t"]
        lr = rate / 0.01 if name == "adam_vlr" else rate
        step_size = lr * torch.sqrt(1.0 - 0.999 ** t) / (1.0 - 0.9 ** t)
        want_p, want_m, want_v = kadam.plain(ref_p, g_in, ref_m, ref_v, step_size, 0.9, 0.999,
                                             1e-8, lr_map if name == "adam_vlr" else None)
        assert _equal(new, want_p) and _equal(new_state["m"], want_m)
        assert _equal(new_state["v"], want_v)
        params, state = (params if name == "zero1" else new), new_state
        ref_p, ref_m, ref_v = new, want_m, want_v
    torch.cuda.synchronize()

