"""The bf16 instantiations of the six LSTM kernels (rows 1 and 3-7), held on
the CPU through their plain versions, against the TPU kernels in interpret
mode with a bf16 W_hid (``ip_avsr_tpu/ops/pallas/lstm_kernel.py``: each body
rounds h_{t-1}, or the clipped dgates, to W_hid's dtype before the product
and sums in float32).

Every case also holds the float32 result of the same inputs apart from the
bf16 one by more than ten times the case's tolerance, so a test passes only
where the rounding happens.  Tolerances (float32, measured on the CPU at
these sizes, B = 5, T = 9, H = 12 with a ragged mask): forward values
within ``FWD_TOL`` and chain outputs within ``BWD_TOL`` of each output's
max abs (at least 1).  The port and XLA sum h @ W_hid in other orders, so
an h_{t-1} that lies on a bf16 rounding boundary may round the other way,
and the step's difference carries.

Also here: the state variants of rows 1 and 5 through ``lstm_forward(...,
matmul_dtype="bfloat16", initial_state=, return_state=True)`` against the
JAX package's scan, the bf16 launch plans (``fwd_launch_plan``,
``bwd_launch_plan``: their caps at H = 500 and 250), the chunk split under
a bf16 plan driven with the plain versions, the wrappers' dtype checks,
and the four ``ip_avsr::`` recurrence operators on a bf16 W_hid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_avsr_tpu.ops import lstm as jlstm
from ip_avsr_tpu.ops.pallas import lstm_kernel
from ip_avsr_torch.ops import lstm as tlstm
from ip_avsr_torch.ops.kernels import _build
from ip_avsr_torch.ops.kernels import lstm as klstm

torch.set_num_threads(1)

# forward values relative to max(1, max abs): measured up to 1.5e-7 here
# (the state variants against the scan 1.2e-7), where the float32-vs-bf16
# gap of the same values is 5.9e-4 to 5e-3
FWD_TOL = 1e-6
# backward chain outputs relative to max(1, max abs): measured up to 3.6e-6
# (the dgates of the x100 case, where a clipped entry's neighbours round
# differently), where the float32-vs-bf16 gap is 5.6e-5 (dhid0 of the x100
# case, 838 at its largest) to 2.5e-3
BWD_TOL = 5e-6
PEEP = ("w_cell_to_ingate", "w_cell_to_forgetgate", "w_cell_to_outgate")
BF16 = torch.bfloat16


def _case(seed, peep, B=5, T=9, D=7, H=12):
    """A random layer with a learned non-zero initial state and ragged
    lengths (a fully padded row at index 3)."""
    rng = np.random.RandomState(seed)
    params = {
        "w_in": rng.randn(D, 4 * H).astype(np.float32) * 0.5,
        "w_hid": rng.randn(H, 4 * H).astype(np.float32) * 0.5,
        "b": rng.randn(4 * H).astype(np.float32) * 0.1,
        "cell_init": rng.randn(1, H).astype(np.float32),
        "hid_init": rng.randn(1, H).astype(np.float32) * 0.5,
    }
    if peep:
        params.update({k: rng.randn(H).astype(np.float32) * 0.5 for k in PEEP})
    x = rng.randn(B, T, D).astype(np.float32)
    lens = np.array([T, T // 2, 1, 0, T - 1, *rng.randint(0, T + 1, max(B - 5, 0))][:B])
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    g = rng.randn(B, T, H).astype(np.float32)
    return params, x, mask, g


def _inputs(params, x, mask, backwards):
    """(x_proj, w_hid, mask, cell0, hid0) batch-major, as _lstm_prep builds
    them (float32 projection: the kernels' inputs are what is held here)."""
    B, T, _ = x.shape
    H = params["w_hid"].shape[0]
    xs, ms = (x[:, ::-1], mask[:, ::-1]) if backwards else (x, mask)
    x_proj = (xs.reshape(B * T, -1) @ params["w_in"]).reshape(B, T, 4 * H) + params["b"]
    cell0 = np.broadcast_to(params["cell_init"], (B, H)).copy()
    hid0 = np.broadcast_to(params["hid_init"], (B, H)).copy()
    return [np.ascontiguousarray(a, dtype=np.float32)
            for a in (x_proj, params["w_hid"], ms, cell0, hid0)]


def _tm(a):
    """(B, T, .) <-> (T, B, .)."""
    return np.ascontiguousarray(np.swapaxes(np.asarray(a), 0, 1))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jbf16(w):
    return jnp.asarray(w).astype(jnp.bfloat16)


def _hold(got, ref, f32, tol, name, scale=1.0):
    """``got`` within ``tol * scale`` of ``ref`` (the bf16 reference), and
    the float32 result ``f32`` more than ten times that from ``ref``."""
    got, ref, f32 = (np.asarray(a, np.float64) for a in (got, ref, f32))
    err, gap = np.abs(got - ref).max(), np.abs(f32 - ref).max()
    assert err <= tol * scale, f"{name}: {err:.3g} from the bf16 reference, tol {tol * scale:.3g}"
    assert gap > 10 * tol * scale, (f"{name}: the float32 result is only {gap:.3g} from the "
                                    f"bf16 one, under 10 x tol {tol * scale:.3g}")


def _scale(ref):
    return max(1.0, float(np.abs(np.asarray(ref)).max()))


@pytest.mark.parametrize("backwards", [False, True])
@pytest.mark.parametrize("peep", [False, True], ids=["rows1_3", "rows5_6"])
def test_bf16_recurrences_match_pallas_interpret(peep, backwards):
    """Rows 1 and 3 (5 and 6 with peepholes): the inference and training
    plain versions with a bf16 W_hid against ``lstm_pallas(_peep)`` and
    ``lstm_pallas(_peep)_train`` in interpret mode with the same bf16
    W_hid."""
    params, x, mask, _ = _case(0, peep)
    x_proj, w_hid, ms, cell0, hid0 = _inputs(params, x, mask, backwards)
    pv = [params[k] for k in PEEP] if peep else []
    args = [_t(a) for a in (x_proj, w_hid, ms, cell0, hid0)]
    args_bf = [args[0], args[1].to(BF16), *args[2:]]
    tpv = [_t(v) for v in pv]
    if peep:
        inf, train = klstm.lstm_peep_recurrence_plain, klstm.lstm_peep_recurrence_train_plain
        ref_inf = lstm_kernel.lstm_pallas_peep(
            jnp.asarray(x_proj), _jbf16(w_hid), *map(jnp.asarray, (ms, cell0, hid0, *pv)),
            block_b=8, interpret=True)
        ref = lstm_kernel.lstm_pallas_peep_train(
            jnp.asarray(_tm(x_proj)), _jbf16(w_hid), jnp.asarray(_tm(ms[..., None])),
            *map(jnp.asarray, (cell0, hid0, *pv)), block_b=8, interpret=True)
    else:
        inf, train = klstm.lstm_recurrence_plain, klstm.lstm_recurrence_train_plain
        ref_inf = lstm_kernel.lstm_pallas(
            jnp.asarray(x_proj), _jbf16(w_hid), *map(jnp.asarray, (ms, cell0, hid0)),
            block_b=8, interpret=True)
        ref = lstm_kernel.lstm_pallas_train(
            jnp.asarray(_tm(x_proj)), _jbf16(w_hid), jnp.asarray(_tm(ms[..., None])),
            jnp.asarray(cell0), jnp.asarray(hid0), block_b=8, interpret=True)
    got_inf = inf(*args_bf, *tpv)
    _hold(got_inf.numpy(), ref_inf, inf(*args, *tpv).numpy(), FWD_TOL, "inference hids",
          _scale(ref_inf))
    got, f32 = train(*args_bf, *tpv), train(*args, *tpv)
    for name, r, o, f in zip(("hids", "cells", "gates_pre"), ref, got, f32):
        _hold(o.numpy(), _tm(r), f.numpy(), FWD_TOL, name, _scale(_tm(r)))
    # the inference and training instantiations share one body
    torch.testing.assert_close(got[0], got_inf, rtol=0, atol=0)
    # the fully padded row carries the float32 initial state, unrounded
    np.testing.assert_array_equal(got[0][3].numpy(), np.broadcast_to(hid0[3], got[0][3].shape))
    np.testing.assert_array_equal(got[1][3].numpy(), np.broadcast_to(cell0[3], got[1][3].shape))


def _chain(seed, peep, scale, backwards=False):
    """The backward chain's inputs from the bf16 training recurrence."""
    params, x, mask, g = _case(seed, peep)
    x_proj, w_hid, ms, cell0, hid0 = _inputs(params, x, mask, backwards)
    pv = [params[k] for k in PEEP] if peep else []
    train = klstm.lstm_peep_recurrence_train_plain if peep else klstm.lstm_recurrence_train_plain
    _, cells, gates = train(_t(x_proj), _t(w_hid).to(BF16), *map(_t, (ms, cell0, hid0, *pv)))
    cells = cells.numpy()
    cells_prev = np.concatenate([cell0[:, None], cells[:, :-1]], axis=1)
    return [g * scale, gates.numpy(), cells, cells_prev, ms, w_hid], pv


@pytest.mark.parametrize("clip,scale", [(5.0, 1.0), (5.0, 100.0), (0.0, 1.0)],
                         ids=["clip5", "clip5_x100", "clip0"])
@pytest.mark.parametrize("peep", [False, True], ids=["row4", "row7"])
def test_bf16_bwd_chains_match_pallas_interpret(peep, clip, scale):
    """Rows 4 and 7: the chains' plain versions with a bf16 W_hid against
    ``lstm_pallas(_peep)_bwd_chain`` in interpret mode with the same bf16
    W_hid, clip 5 (with an upstream gradient x100, so the clip bites) and
    clip 0; the dgates returned are the unrounded float32 ones."""
    chain, pv = _chain(1, peep, scale)
    g, gates, cells, cells_prev, ms, w_hid = chain
    jargs = (jnp.asarray(_tm(g)), jnp.asarray(_tm(gates)), jnp.asarray(_tm(cells)),
             jnp.asarray(_tm(cells_prev)), jnp.asarray(_tm(ms[..., None])), _jbf16(w_hid))
    targs = [_t(a) for a in chain]
    targs_bf = [*targs[:5], targs[5].to(BF16)]
    tpv = [_t(v) for v in pv]
    if peep:
        ref = lstm_kernel.lstm_pallas_peep_bwd_chain(*jargs, *map(jnp.asarray, pv), clip,
                                                     block_b=8, interpret=True)
        got = klstm.lstm_peep_bwd_chain_plain(*targs_bf, *tpv, clip)
        f32 = klstm.lstm_peep_bwd_chain_plain(*targs, *tpv, clip)
        names = ("dgates", "dcell0", "dhid0", "dw_ci", "dw_cf", "dw_co")
    else:
        ref = lstm_kernel.lstm_pallas_bwd_chain(*jargs, clip, block_b=8, interpret=True)
        got = klstm.lstm_bwd_chain_plain(*targs_bf, clip)
        f32 = klstm.lstm_bwd_chain_plain(*targs, clip)
        names = ("dgates", "dcell0", "dhid0")
    ref = [_tm(ref[0]), *(np.asarray(r) for r in ref[1:])]
    for name, r, o, f in zip(names, ref, got, f32):
        _hold(o.numpy(), r, f.numpy(), BWD_TOL, name, _scale(r))
    dgates = got[0].numpy()
    if clip and scale > 1:
        assert (np.abs(dgates) == clip).mean() > 0.05  # the clip bites
    assert not dgates[3].any()  # the fully padded row


@pytest.mark.parametrize("peep", [False, True], ids=["row1", "row5"])
def test_bf16_state_variants_match_the_jax_scan(peep):
    """Rows 1 and 5 with a per-row initial state and the final one back:
    the port's ``lstm_forward(..., matmul_dtype="bfloat16",
    initial_state=, return_state=True)`` (the state plain versions, through
    their operators) against the JAX package's scan with the same
    arguments, at T = 9 and in chunks of 4 + 5 resumed from the carried
    state."""
    params, x, mask, _ = _case(2, peep)
    rng = np.random.RandomState(3)
    B, H = x.shape[0], params["w_hid"].shape[0]
    state = (rng.randn(B, H).astype(np.float32), (rng.randn(B, H) * 0.5).astype(np.float32))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}

    def jax_run(xx, mm, st):
        return jlstm.lstm_forward(jp, jnp.asarray(xx), jnp.asarray(mm), matmul_dtype=jnp.bfloat16,
                                  initial_state=tuple(map(jnp.asarray, st)), return_state=True)

    def port_run(xx, mm, st, dtype="bfloat16"):
        with torch.no_grad():
            return tlstm.lstm_forward(tp, _t(xx), _t(mm), matmul_dtype=dtype,
                                      initial_state=tuple(map(_t, st)), return_state=True)

    ref_out, ref_st = jax_run(x, mask, state)
    out, st = port_run(x, mask, state)
    f32_out, f32_st = port_run(x, mask, state, None)
    _hold(out.numpy(), ref_out, f32_out.numpy(), FWD_TOL, "hids", _scale(ref_out))
    for name, o, r, f in zip(("cell_T", "hid_T"), st, ref_st, f32_st):
        _hold(o.numpy(), r, f.numpy(), FWD_TOL, name, _scale(r))
    # two chunks resumed from the carried state give the one-shot result
    out1, st1 = port_run(x[:, :4], mask[:, :4], state)
    out2, st2 = port_run(x[:, 4:], mask[:, 4:], tuple(s.numpy() for s in st1))
    np.testing.assert_allclose(torch.cat([out1, out2], 1).numpy(), out.numpy(), atol=1e-6,
                               rtol=0)
    for a, b in zip(st2, st):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


# (plan, H, dtype) -> the most rows one launch holds on 132 SMs: a bf16
# W_hid in the tensor cores' fragment order (K padded to a multiple of 16)
# takes fewer bytes than float32 and its warps' partial tiles more, so more
# recurrence carries fit beside them at H = 500 and 250 and fewer at H =
# 130; the bf16 backward chain takes 8 units per block (MMA_UNITS), so each
# row's carries take twice (H = 500) to eight times (H = 130) the f32
# plan's bytes
CAPS = {("fwd", 500, "float32"): 5982, ("fwd", 500, "bfloat16"): 6496,
        ("fwd", 250, "float32"): 13714, ("fwd", 250, "bfloat16"): 14016,
        ("fwd", 130, "float32"): 28668, ("fwd", 130, "bfloat16"): 28656,
        ("bwd", 500, "float32"): 2077, ("bwd", 500, "bfloat16"): 1022,
        ("bwd", 250, "float32"): 4654, ("bwd", 250, "bfloat16"): 1105,
        ("bwd", 130, "float32"): 9556, ("bwd", 130, "bfloat16"): 1145}
PLANS = {"fwd": klstm.fwd_launch_plan, "bwd": klstm.bwd_launch_plan}


@pytest.mark.parametrize("key", list(CAPS), ids=["-".join(map(str, k)) for k in CAPS])
def test_bf16_launch_plan_caps(key):
    """The caps: one row more than the cap takes two launches; the
    recurrence plan's grid and units do not depend on W_hid's dtype, and
    the bf16 backward chain's blocks take MMA_UNITS (8) units."""
    kind, H, name = key
    dtype, cap = getattr(torch, name), CAPS[key]
    plan = PLANS[kind](cap, H, 132, w_dtype=dtype)
    assert plan.chunks == 1 and plan.rows == cap and plan.smem_bytes <= _build.SMEM_LIMIT
    over = PLANS[kind](cap + 1, H, 132, w_dtype=dtype)
    assert over.chunks == 2 and over.rows == -(-(cap + 1) // 2)
    f32 = PLANS[kind](cap, H, 132)
    if kind == "bwd" and dtype == BF16:
        assert (plan.units, plan.grid, plan.last_units) == (
            klstm.MMA_UNITS, -(-H // 8), H - (-(-H // 8) - 1) * 8)
    else:
        assert (plan.units, plan.grid, plan.last_units) == (f32.units, f32.grid,
                                                             f32.last_units)


@pytest.mark.parametrize("units", klstm.CHAIN_UNITS)
def test_bf16_shared_memory_rows(units):
    """The bf16 W in shared memory, in the tensor cores' fragment order
    with K padded to a multiple of 16: a recurrence block holds 4U bf16
    values per padded k (csrc/lstm_fwd.cu::mma_w_bytes), a backward block U
    per padded k of 4H; the partial tiles are 8 warps x 16 rows x 4U (or U)
    floats; float32 keeps its rows of 4U + 4 floats (4 at one unit) and 8 x
    32 partial sums."""
    for H in (100, 130, 250, 500, 12):
        kp_f, kp_b = 16 * -(-H // 16), 16 * -(-4 * H // 16)
        assert klstm.fwd_w_bytes(units, H, BF16) == 2 * 4 * units * kp_f
        assert klstm.bwd_w_bytes(units, H, BF16) == 2 * units * kp_b
        assert klstm.fwd_w_bytes(units, H) == 4 * klstm.fwd_row_floats(units) * H
        assert klstm.bwd_w_bytes(units, H) == 16 * units * H
        # 16-byte aligned carries follow W
        assert klstm.fwd_w_bytes(units, H, BF16) % 16 == 0
        assert klstm.bwd_w_bytes(units, H, BF16) % 16 == 0
        for kind, per_row, red in (("fwd", 8, 4 * 8 * 16 * 4), ("bwd", 24, 4 * 8 * 16)):
            one = PLANS[kind](1, H, 1000, units=units, w_dtype=BF16).smem_bytes
            w = (klstm.fwd_w_bytes if kind == "fwd" else klstm.bwd_w_bytes)(units, H, BF16)
            assert one == w + red * units + per_row * units
            f32 = PLANS[kind](1, H, 1000, units=units).smem_bytes
            w32 = (klstm.fwd_w_bytes if kind == "fwd" else klstm.bwd_w_bytes)(units, H)
            assert f32 == w32 + 1024 + per_row * units


def _fragment_product(h, w, kind):
    """numpy's model of the bf16 tensor-core product of one block as the
    kernels' headers lay it out (csrc/lstm_fwd.cu, csrc/lstm_bwd.cu): the
    block's W in fragment order (every (k, column) in exactly one half of
    one 32-bit word, zeros in the padding), the A fragments of the rows of
    ``h`` (the operand, bf16-rounded), mma.sync m16n8k16's fragment layouts
    (PTX ISA), the 16-row tiles, and the product mapped back from the
    accumulator fragments.  ``w`` is the block's (K, N) operand: (H, 4U)
    forward, (4H, U) backward; returns (B, N)."""
    K, N = w.shape
    KS = -(-K // 16)
    lanes = np.arange(32)
    g, tig = lanes // 4, lanes % 4
    # the layout's words: forward ((s * LW + lane) * NT + j) * 2 + r, N = 4U
    # over NT n8 tiles; backward (s * 4U + lane) * 2 + r, one n8 tile; each
    # holds K rows k and k + 1 of column 8 j + lane / 4 for k = 16 s + 4
    # (lane % 4) + 2 r: the fragment's k 2 (lane % 4) + 8 r sits at K row
    # 4 (lane % 4) + 2 r of the step, so that a lane's four A values are
    # neighbours in memory
    NT = -(-N // 8)
    words = np.full((KS * 32 * NT * 2, 2), np.nan)
    lw = 16 if N == 4 else 32
    for s in range(KS):
        for lane in range(32):
            for j in range(NT):
                for r in range(2):
                    k = 16 * s + 4 * tig[lane] + 2 * r
                    col = 8 * j + g[lane]
                    if kind == "fwd":
                        if lane >= lw:
                            continue
                        idx = ((s * lw + lane) * NT + j) * 2 + r
                    else:
                        if lane >= 4 * N:
                            continue
                        idx = (s * 4 * N + lane) * 2 + r
                    pair = [w[k + e, col] if k + e < K and col < N else 0.0 for e in (0, 1)]
                    assert np.isnan(words[idx]).all(), "a word written twice"
                    words[idx] = pair
    live = ~np.isnan(words).any(axis=1)
    n_live = KS * 16 * N
    assert live.sum() * 2 == n_live  # every padded (k, column) exactly once
    wb = 2 * n_live
    assert wb == (klstm.fwd_w_bytes(N // 4, K, BF16) if kind == "fwd"
                  else klstm.bwd_w_bytes(N, K // 4, BF16))
    B = h.shape[0]
    hp = np.zeros((16 * -(-B // 16), 16 * KS))
    hp[:B, :K] = klstm.round_operand(torch.from_numpy(h), BF16).double().numpy()
    out = np.zeros((hp.shape[0], 8 * NT))
    for b0 in range(0, hp.shape[0], 16):
        for s in range(KS):
            # A from the lanes' fragments: (row g or g + 8, fragment k 2 tig
            # + {0, 1} or + 8, from K rows 4 tig + {0, 1} or + {2, 3}); B
            # from the words; D's fragments back into (row, col)
            A = np.zeros((16, 16))
            for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                for e in (0, 1):
                    A[g + dr, 2 * tig + dk + e] = hp[b0 + g + dr,
                                                     16 * s + 4 * tig + dk // 4 + e]
            for j in range(NT):
                Bt = np.zeros((16, 8))
                for lane in range(32):
                    if kind == "fwd":
                        base = ((s * lw + lane) * NT + j) * 2 if lane < lw else None
                    else:
                        base = (s * 4 * N + lane) * 2 if lane < 4 * N else None
                    for r in range(2):
                        pair = words[base + r] if base is not None else (0.0, 0.0)
                        for e in (0, 1):
                            Bt[2 * tig[lane] + 8 * r + e, g[lane]] = pair[e]
                D = A @ Bt
                for c in range(4):
                    row = g + (8 if c >= 2 else 0)
                    col = 8 * j + 2 * tig + c % 2
                    out[b0 + row, col] += D[row, 2 * tig + c % 2]
    return out[:B, :N]


@pytest.mark.parametrize("kind,B,H,units", [
    ("fwd", 1, 20, 1), ("fwd", 10, 36, 2), ("fwd", 17, 44, 4), ("fwd", 33, 18, 8),
    ("bwd", 1, 6, 1), ("bwd", 10, 10, 2), ("bwd", 17, 9, 4), ("bwd", 64, 5, 8),
], ids=lambda v: str(v))
def test_bf16_fragment_order(kind, B, H, units):
    """The bf16 tensor-core layout of the kernels' headers, modelled in
    numpy at ragged shapes (one, two and more 16-row tiles; H and 4H that
    leave the last k step padded; 1 to 8 units): every W value sits in one
    word, the padding is zero, the words take the bytes the plans count, and
    the fragments multiply to bf16(h) @ W exactly (float64 sums)."""
    rng = np.random.RandomState(B + H + units)
    wfull = klstm.round_operand(torch.from_numpy(rng.randn(H, 4 * H).astype(np.float32)),
                                BF16).double().numpy()
    if kind == "fwd":
        # the block of units j0 .. j0 + U - 1: columns gate * H + j0 + u
        j0 = 0
        cols = [q * H + j0 + u for q in range(4) for u in range(units)]
        w = wfull[:, cols]
        h = rng.randn(B, H).astype(np.float32)
    else:
        w = wfull[:units].T.copy()  # (4H, U): dh = dg @ W_hid[j0 : j0 + U]^T
        h = rng.randn(B, 4 * H).astype(np.float32)
    got = _fragment_product(h, w, kind)
    want = klstm.round_operand(torch.from_numpy(h), BF16).double().numpy() @ w
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("H", [500, 250, 130])
@pytest.mark.parametrize("B", [1, 10, 17, 64])
def test_bf16_plans_at_ragged_shapes(B, H):
    """The bf16 plans at the shapes that break fragment code (B = 1, 10, 17
    and 64 rows; H = 500, 250 and 130, the recurrence at 4, 2 and 1 units
    per block, the backward chain at 8): one launch, the f32 plan's grid
    for the recurrence, shared memory within a block's limit, and
    the rows split into 2 forced chunks reassembling to the unsplit plain
    result (rows 1 and 4 with a bf16 W_hid, T = 3): row 1 bit for bit, row
    4 within 1e-5 of max(1, max abs)."""
    for kind in ("fwd", "bwd"):
        plan = PLANS[kind](B, H, 132, w_dtype=BF16)
        f32 = PLANS[kind](B, H, 132)
        assert plan.chunks == 1 and plan.rows == B and plan.smem_bytes <= _build.SMEM_LIMIT
        if kind == "fwd":
            assert (plan.units, plan.grid, plan.last_units) == (f32.units, f32.grid,
                                                                 f32.last_units)
        assert plan.units == ({500: 4, 250: 2, 130: 1}[H] if kind == "fwd" else 8)
        assert plan.grid == -(-H // plan.units) and plan.grid <= 132
        if B > 1:
            forced = PLANS[kind](B, H, 132, chunks=2, w_dtype=BF16)
            assert forced.rows == -(-B // 2) and forced.smem_bytes <= plan.smem_bytes
    rng = np.random.RandomState(B * H)
    T = 3
    x_proj = _t(rng.randn(B, T, 4 * H).astype(np.float32))
    w = _t((rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)).to(BF16)
    ms = _t((rng.rand(B, T) < 0.8).astype(np.float32))
    cell0, hid0 = (_t(rng.randn(B, H).astype(np.float32)) for _ in range(2))
    hids, cells, gates = klstm.lstm_recurrence_train_plain(x_proj, w, ms, cell0, hid0)
    if B > 1:
        out = torch.full_like(hids, float("nan"))

        def launch(xc, mc, c0, h0, oc):
            oc.copy_(klstm.lstm_recurrence_plain(xc, w, mc, c0, h0))

        klstm.map_chunks(launch, 2, x_proj, ms, cell0, hid0, out)
        torch.testing.assert_close(out, hids, rtol=0, atol=0)
    cells_prev = torch.cat([cell0[:, None], cells[:, :-1]], dim=1)
    args = (_t(rng.randn(B, T, H).astype(np.float32)), gates, cells, cells_prev, ms)
    whole = klstm.lstm_bwd_chain_plain(*args, w, 5.0)
    parts = klstm.map_chunks(lambda *v: klstm.lstm_bwd_chain_plain(*v, w, 5.0),
                             min(2, B), *args)
    # the CPU's matrix products sum the 2000-deep dh in another order for
    # another row count, so the chunks agree to float32 rounding, not bits
    for i in range(3):
        torch.testing.assert_close(torch.cat([p[i] for p in parts]), whole[i], rtol=0,
                                   atol=1e-5 * max(1.0, float(whole[i].abs().max())))


@pytest.mark.parametrize("chunks", [2, 3])
@pytest.mark.parametrize("row", ["row1", "row5", "row4", "row7"])
def test_bf16_chunks_reassemble(row, chunks):
    """The chunk split under a bf16 plan, driven with the bf16 plain
    versions in place of the launches: the pieces reassemble to the unsplit
    result (rows bit-equal; the peephole gradients, summed per chunk and
    added in chunk order, within 1e-6 of their max abs)."""
    params, x, mask, g = _case(4, row in ("row5", "row7"), B=19, H=32)
    x_proj, w_hid, ms, cell0, hid0 = map(_t, _inputs(params, x, mask, False))
    w = w_hid.to(BF16)
    pv = [_t(params[k]) for k in PEEP] if row in ("row5", "row7") else []
    fwd = klstm.lstm_peep_recurrence_train_plain if pv else klstm.lstm_recurrence_train_plain
    hids, cells, gates = fwd(x_proj, w, ms, cell0, hid0, *pv)
    if row in ("row1", "row5"):
        plain = klstm.lstm_peep_recurrence_plain if pv else klstm.lstm_recurrence_plain
        out = torch.full_like(hids, float("nan"))

        def launch(xc, mc, c0, h0, oc):
            oc.copy_(plain(xc, w, mc, c0, h0, *pv))

        klstm.map_chunks(launch, chunks, x_proj, ms, cell0, hid0, out)
        torch.testing.assert_close(out, hids, rtol=0, atol=0)
        return
    cells_prev = torch.cat([cell0[:, None], cells[:, :-1]], dim=1)
    gc = _t(g)
    args = (gc, gates, cells, cells_prev, ms)
    whole = (klstm.lstm_peep_bwd_chain_plain(*args, w, *pv, 5.0) if pv
             else klstm.lstm_bwd_chain_plain(*args, w, 5.0))

    def launch_bwd(*views):
        return (klstm.lstm_peep_bwd_chain_plain(*views, w, *pv, 5.0) if pv
                else klstm.lstm_bwd_chain_plain(*views, w, 5.0))

    parts = klstm.map_chunks(launch_bwd, chunks, *args)
    for i in range(3):
        torch.testing.assert_close(torch.cat([p[i] for p in parts]), whole[i], rtol=0, atol=0)
    for i in range(3, len(whole)):
        total = parts[0][i]
        for p in parts[1:]:
            total = total + p[i]
        np.testing.assert_allclose(total.numpy(), whole[i].numpy(), rtol=0,
                                   atol=1e-6 * float(whole[i].abs().max()))


@pytest.mark.parametrize("w_dtype,other_dtype,error", [
    (torch.float16, torch.float32, TypeError),
    (torch.float64, torch.float32, TypeError),
    (torch.bfloat16, torch.bfloat16, TypeError),
    (torch.bfloat16, torch.float32, ValueError),
], ids=["w_f16", "w_f64", "x_proj_bf16", "bf16_w_on_the_cpu"])
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_kernel_launchers_check_dtypes(kind, w_dtype, other_dtype, error):
    """The launchers behind the wrappers take a float32 or bf16 W_hid and
    float32 everywhere else: float16 and float64 W_hid, and bf16 in any
    other argument, raise ``TypeError`` before anything is built or
    launched; the right dtypes on CPU tensors reach the device check
    (``ValueError``: the launchers have no plain fallback)."""
    B, T, H = 3, 4, 8
    w = torch.zeros(H, 4 * H, dtype=w_dtype)
    if kind == "fwd":
        args = [torch.zeros(B, T, 4 * H, dtype=other_dtype), w, torch.ones(B, T),
                torch.zeros(B, H), torch.zeros(B, H)]
        with pytest.raises(error):
            klstm._run_fwd("lstm_recurrence", args, train=False)
        return
    args = [torch.zeros(B, T, H), torch.zeros(B, T, 4 * H, dtype=other_dtype),
            torch.zeros(B, T, H), torch.zeros(B, T, H), torch.ones(B, T), w]
    with pytest.raises(error):
        klstm._run_bwd("lstm_bwd_chain", args, 5.0)


@pytest.mark.parametrize("w_dtype", [torch.float16, torch.float64])
def test_plain_versions_refuse_other_w_dtypes(w_dtype):
    """The plain versions, which the wrappers take on the CPU, raise too:
    no W_hid dtype runs that has no kernel instantiation on the card."""
    params, x, mask, _ = _case(5, False)
    x_proj, w_hid, ms, cell0, hid0 = map(_t, _inputs(params, x, mask, False))
    with pytest.raises(TypeError, match="w_hid"):
        klstm.lstm_recurrence(x_proj, w_hid.to(w_dtype), ms, cell0, hid0)


OPS = {"lstm_recurrence": False, "lstm_recurrence_state": False,
       "lstm_peep_recurrence": True, "lstm_peep_recurrence_state": True}


@pytest.mark.parametrize("name", sorted(OPS))
def test_operators_take_a_bf16_w_hid(name):
    """The four ``ip_avsr::`` recurrence operators with a bf16 W_hid:
    ``torch.library.opcheck`` (schema, fake against real, dynamic shapes)
    and float32 outputs equal to the bf16 plain version's, as a loaded
    bf16-weight artifact calls them."""
    params, x, mask, _ = _case(6, OPS[name])
    x_proj, w_hid, ms, cell0, hid0 = map(_t, _inputs(params, x, mask, False))
    args = [x_proj, w_hid.to(BF16), ms, cell0, hid0,
            *(_t(params[k]) for k in PEEP if OPS[name])]
    op = getattr(torch.ops.ip_avsr, name).default
    torch.library.opcheck(op, args)
    got = op(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = getattr(klstm, f"{name}_plain")(*args)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("peep", [False, True], ids=["rows1_3_4", "rows5_6_7"])
def test_bf16_plain_versions_take_the_kernels_operands(peep):
    """The plain versions' ``operands`` hook, through which the card holds
    each step of a bf16 kernel to a plain step from the kernel's own
    operand (chip_smoke.bf16_kernel_checks): fed their own hids (or their
    own clipped dgates) the recurrence and the backward chain give their
    own results bit for bit; fed other operands, every step follows those
    (the first step's product from hid0 stays the same)."""
    params, x, mask, g = _case(7, peep)
    x_proj, w_hid, ms, cell0, hid0 = map(_t, _inputs(params, x, mask, False))
    w = w_hid.to(BF16)
    pv = tuple(_t(params[k]) for k in PEEP) if peep else None
    own = klstm._recurrence_plain(x_proj, w, ms, cell0, hid0, pv)
    fed = klstm._recurrence_plain(x_proj, w, ms, cell0, hid0, pv, operands=own[0])
    for a, b in zip(own, fed):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    moved = klstm._recurrence_plain(x_proj, w, ms, cell0, hid0, pv, operands=own[0] + 0.25)
    torch.testing.assert_close(moved[2][:, 0], own[2][:, 0], rtol=0, atol=0)
    assert (moved[2][:, 1:] - own[2][:, 1:]).abs().max() > 1e-2
    cells_prev = torch.cat([cell0[:, None], own[1][:, :-1]], dim=1)
    chain = (_t(g), own[2], own[1], cells_prev, ms, w)
    base = klstm._bwd_chain_plain(*chain, 5.0, pv)
    fed = klstm._bwd_chain_plain(*chain, 5.0, pv, operands=base[0])
    for a, b in zip(base[:3], fed[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    moved = klstm._bwd_chain_plain(*chain, 5.0, pv, operands=base[0] * 2)
    assert (moved[2] - base[2]).abs().max() > 1e-3
