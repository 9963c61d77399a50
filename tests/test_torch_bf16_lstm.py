"""``matmul_dtype="bfloat16"`` through the port's LSTM and encoder against the
JAX package's, on the CPU.

* ``ops/lstm.lstm_forward(..., matmul_dtype="bfloat16")``: outputs and
  gradients (both LSTM families, both directions, clip 5 with an upstream
  x100 so the clip bites, ``remat``, ``residual_dtype="bfloat16"`` with it)
  against ``jax.value_and_grad`` of ``ip_avsr_tpu.ops.lstm.lstm_forward``
  with its custom VJP and ``matmul_dtype=jnp.bfloat16``;
  ``lstm_forward_grouped`` against the JAX grouped core; a bf16 ``w_hid``
  parameter with no ``matmul_dtype`` (a bf16-weight artifact's recurrence).
* ``models/encoder.encoder_forward(..., matmul_dtype="bfloat16")``: values
  and gradients against ``jax.grad`` of the JAX encoder; its operand
  cotangents come back rounded to bf16, as JAX's transpose of a
  bf16-operand dot gives them.

Each case asserts the port within its tolerance of JAX and the port's own
float32 result (``matmul_dtype=None``) more than ten times that tolerance
from JAX's bf16 one.  Tolerances relative to each tensor's max abs (at
least ``FLOOR``), measured at these sizes: see the constants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_avsr_tpu.models import encoder as jencoder
from ip_avsr_tpu.ops import lstm as jlstm
from ip_avsr_torch.models import encoder as tencoder
from ip_avsr_torch.ops import lstm as tlstm

torch.set_num_threads(1)

# LSTM outputs: measured up to 1.8e-7 of max abs, the float32-vs-bf16 gap
# 1.1e-3 and more
OUT_TOL = 1e-6
# LSTM gradients: measured up to 4.2e-6 of max abs (dW_in; the chain's
# dgates differ from XLA's in the last bits, and the batched products sum
# them over T x B rows), the float32-vs-bf16 gap 8.5e-4 and more, except
# the learned hid_init's: measured up to 7.6e-8, its gap 8.5e-5 (dhid0 is
# the last product's output, summed over the rows)
GRAD_TOL = 1e-5
HID_INIT_TOL = 1e-6
# encoder: values measured up to 2.2e-8 of max abs (gap 3.8e-3); the weight
# and input gradients, bf16 values in both packages, equal to JAX's but for
# 1 entry of 320 one bf16 ulp away (its float32 value lies near a rounding
# boundary and the two packages' sums round it apart); the bias gradients,
# float32 sums, up to 2.3e-6 of max abs; the gradients' float32-vs-bf16
# gap 2.3e-3 to 3.1e-2
ENC_OUT_TOL = 1e-6
ENC_GRAD_ULPS = 1
ENC_BIAS_TOL = 1e-5
FLOOR = 1e-3
PEEP = ("w_cell_to_ingate", "w_cell_to_forgetgate", "w_cell_to_outgate")
LEVERS = {"none": {}, "remat": dict(remat=True),
          "remat_residual_bf16": dict(remat=True, residual_dtype="bfloat16")}


def _case(seed, peep, B=4, T=9, D=7, H=12):
    rng = np.random.RandomState(seed)
    params = {"w_in": rng.randn(D, 4 * H) * 0.5, "w_hid": rng.randn(H, 4 * H) * 0.5,
              "b": rng.randn(4 * H) * 0.1, "cell_init": rng.randn(1, H),
              "hid_init": rng.randn(1, H) * 0.5}
    if peep:
        params.update({k: rng.randn(H) * 0.3 for k in PEEP})
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.randn(B, T, D).astype(np.float32)
    lens = np.array([T, T // 2, 1, 0][:B])
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    g = rng.randn(B, T, H).astype(np.float32)
    return params, x, mask, g


def _port(params, x, mask, g, backwards, matmul_dtype="bfloat16", **lever):
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tlstm.lstm_forward(tp, tx, torch.from_numpy(mask), backwards=backwards,
                             matmul_dtype=matmul_dtype, **lever)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), {**{k: tp[k].grad.numpy() for k in params},
                                  "x": tx.grad.numpy()}


def _jax(params, x, mask, g, backwards, **lever):
    if lever.get("residual_dtype"):
        lever = {**lever, "residual_dtype": jnp.bfloat16}

    def f(p, xx):
        out = jlstm.lstm_forward(p, xx, jnp.asarray(mask), backwards=backwards,
                                 matmul_dtype=jnp.bfloat16, **lever)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, out), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return np.asarray(out), {**{k: np.asarray(gp[k]) for k in params}, "x": np.asarray(gx)}


def _rel(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), FLOOR)


def _hold(got, ref, f32, tol, name):
    err, gap = _rel(got, ref), _rel(f32, ref)
    assert err <= tol, f"{name}: {err:.3g} of max abs from JAX's bf16 result, tol {tol}"
    assert gap > 10 * tol, f"{name}: the float32 result is only {gap:.3g} from JAX's bf16 one"


@pytest.mark.parametrize("lever", list(LEVERS))
@pytest.mark.parametrize("backwards", [False, True])
@pytest.mark.parametrize("peep", [False, True], ids=["plain", "peephole"])
def test_bf16_lstm_grads_match_jax(peep, backwards, lever):
    """Both families, both directions, the residual levers: the
    recurrence's and the chain's bf16 products, the projection's, and the
    batched dW_in, dW_hid and dx, all with bf16 operands."""
    params, x, mask, g = _case(0, peep)
    g = g * 100.0  # the clip bites
    ref_out, ref = _jax(params, x, mask, g, backwards, **LEVERS[lever])
    out, got = _port(params, x, mask, g, backwards, **LEVERS[lever])
    f32_out, f32 = _port(params, x, mask, g, backwards, matmul_dtype=None, **LEVERS[lever])
    _hold(out, ref_out, f32_out, OUT_TOL, "out")
    for k, r in ref.items():
        _hold(got[k], r, f32[k], HID_INIT_TOL if k == "hid_init" else GRAD_TOL, k)


@pytest.mark.parametrize("peep", [False, True], ids=["plain", "peephole"])
def test_bf16_lstm_inference_matches_jax(peep):
    """No gradient: the inference recurrence with a bf16 W_hid, and a bf16
    ``w_hid`` parameter with no ``matmul_dtype`` (a bf16-weight artifact's
    recurrence) against the JAX scan with the same bf16 ``w_hid``, which
    rounds h_{t-1} to W_hid's dtype and promotes the rest to float32."""
    params, x, mask, _ = _case(1, peep)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ref = np.asarray(jlstm.lstm_forward(jp, jnp.asarray(x), jnp.asarray(mask),
                                        matmul_dtype=jnp.bfloat16))
    with torch.no_grad():
        got = tlstm.lstm_forward(tp, torch.from_numpy(x), torch.from_numpy(mask),
                                 matmul_dtype="bfloat16").numpy()
        f32 = tlstm.lstm_forward(tp, torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    _hold(got, ref, f32, OUT_TOL, "matmul_dtype out")
    # a bf16 w_hid leaf: only the recurrent product's operand is rounded
    jp_w = {**jp, "w_hid": jp["w_hid"].astype(jnp.bfloat16)}
    tp_w = {**tp, "w_hid": tp["w_hid"].to(torch.bfloat16)}
    ref_w = np.asarray(jlstm.lstm_forward(jp_w, jnp.asarray(x), jnp.asarray(mask),
                                          use_custom_vjp=False))
    with torch.no_grad():
        got_w = tlstm.lstm_forward(tp_w, torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    _hold(got_w, ref_w, f32, OUT_TOL, "bf16 w_hid out")


@pytest.mark.parametrize("value", [None, "float32"])
def test_float32_matmul_dtype_changes_nothing(value):
    """None and "float32" run the float32 path bit for bit; another dtype
    raises."""
    params, x, mask, g = _case(2, False)
    base, grads = _port(params, x, mask, g, False, matmul_dtype=None)
    out, got = _port(params, x, mask, g, False, matmul_dtype=value)
    np.testing.assert_array_equal(out, base)
    for k in grads:
        np.testing.assert_array_equal(got[k], grads[k])
    with pytest.raises(ValueError, match="matmul_dtype"):
        _port(params, x, mask, g, False, matmul_dtype="float16")


def test_bf16_grouped_lstms_match_jax():
    """``lstm_forward_grouped`` (the fused BLSTM halves) with
    ``matmul_dtype``: outputs and gradients against the JAX grouped core."""
    params, x, mask, g = _case(3, False)
    params2, _, _, g2 = _case(4, False)

    def jf(ps, xx):
        f, b = jlstm.lstm_forward_grouped(ps, [xx, xx], jnp.asarray(mask), [False, True],
                                          matmul_dtype=jnp.bfloat16)
        return jnp.sum(f * jnp.asarray(g) + b * jnp.asarray(g2)), (f, b)

    jps = [{k: jnp.asarray(v) for k, v in p.items()} for p in (params, params2)]
    (_, ref_out), (jg, jgx) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jps, jnp.asarray(x))

    def port(mm):
        tps = [{k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
               for p in (params, params2)]
        tx = torch.from_numpy(x).requires_grad_(True)
        f, b = tlstm.lstm_forward_grouped(tps, [tx, tx], torch.from_numpy(mask), [False, True],
                                          matmul_dtype=mm)
        (f * torch.from_numpy(g) + b * torch.from_numpy(g2)).sum().backward()
        return (f.detach().numpy(), b.detach().numpy()), tps, tx

    (f, b), tps, tx = port("bfloat16")
    (f32_f, f32_b), f32_ps, f32_x = port(None)
    _hold(f, np.asarray(ref_out[0]), f32_f, OUT_TOL, "fwd out")
    _hold(b, np.asarray(ref_out[1]), f32_b, OUT_TOL, "bwd out")
    for i in range(2):
        for k in params:
            _hold(tps[i][k].grad.numpy(), np.asarray(jg[i][k]), f32_ps[i][k].grad.numpy(),
                  HID_INIT_TOL if k == "hid_init" else GRAD_TOL, f"member {i} {k}")
    _hold(tx.grad.numpy(), np.asarray(jgx), f32_x.grad.numpy(), GRAD_TOL, "x")


def _bf16_ulp(a):
    """The spacing of bf16 values at each entry of ``a`` (8 significant
    bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("nl", [("sigmoid", "sigmoid", "linear"), ("rectify", "tanh", "linear")])
def test_bf16_encoder_values_and_grads_match_jax(nl):
    """The dense stack with bf16 products: values against JAX within
    ENC_OUT_TOL; the gradients of every weight and of the input, which
    JAX's autodiff of ``jnp.dot(a.astype(bf16), w.astype(bf16),
    preferred_element_type=f32)`` rounds to bf16, equal to JAX's up to
    ENC_GRAD_ULPS bf16 ulp per entry; the biases' within ENC_BIAS_TOL; the
    float32 stack's values and gradients far from both."""
    rng = np.random.RandomState(5)
    shapes, D, N = (16, 12, 6), 20, 30
    params = {}
    fan = D
    for name, units in zip(("fc1", "fc2", "fc3"), shapes):
        params[name] = {"w": (rng.randn(fan, units) * 0.4).astype(np.float32),
                        "b": (rng.randn(units) * 0.1).astype(np.float32)}
        fan = units
    x = rng.randn(N, D).astype(np.float32)
    g = rng.randn(N, shapes[-1]).astype(np.float32)

    def jf(p, xx):
        out = jencoder.encoder_forward(p, xx, nl, matmul_dtype=jnp.bfloat16)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, ref_out), (jg, jgx) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))

    def port(mm):
        tp = {n: {k: torch.from_numpy(v).requires_grad_(True) for k, v in layer.items()}
              for n, layer in params.items()}
        tx = torch.from_numpy(x).requires_grad_(True)
        out = tencoder.encoder_forward(tp, tx, nl, matmul_dtype=mm)
        (out * torch.from_numpy(g)).sum().backward()
        grads = {f"{n}/{k}": tp[n][k].grad.numpy() for n in tp for k in tp[n]}
        return out.detach().numpy(), {**grads, "x": tx.grad.numpy()}

    out, got = port("bfloat16")
    f32_out, f32 = port(None)
    _hold(out, np.asarray(ref_out), f32_out, ENC_OUT_TOL, "out")
    ref = {f"{n}/{k}": np.asarray(jg[n][k]) for n in params for k in params[n]}
    ref["x"] = np.asarray(jgx)
    for k, r in ref.items():
        if k.endswith("/b"):
            # the last layer is linear, so its bias's gradient is the
            # upstream gradient's sum at any matmul dtype: no gap to hold
            if k == "fc3/b":
                np.testing.assert_allclose(got[k], r, rtol=0, atol=ENC_BIAS_TOL * np.abs(r).max())
            else:
                _hold(got[k], r, f32[k], ENC_BIAS_TOL, k)
            continue
        # weight and input cotangents are bf16 values in both packages
        assert np.array_equal(got[k], torch.from_numpy(got[k]).to(torch.bfloat16)
                              .to(torch.float32).numpy()), f"{k} is not bf16-rounded"
        off = np.abs(got[k] - r)
        assert (off <= ENC_GRAD_ULPS * _bf16_ulp(r) + 1e-12).all(), (
            f"{k}: {off.max():.3g} from JAX, more than {ENC_GRAD_ULPS} bf16 ulp")
        assert (off > 0).mean() < 0.01, f"{k}: {(off > 0).sum()} entries differ from JAX"
        assert _rel(f32[k], r) > 10 * max(_rel(got[k], r), ENC_OUT_TOL), (
            f"{k}: no gap to the float32 gradient")
    # without a gradient the same rounded product gives the same output
    with torch.no_grad():
        tp = {n: {k: torch.from_numpy(v) for k, v in layer.items()} for n, layer in params.items()}
        again = tencoder.encoder_forward(tp, torch.from_numpy(x), nl, matmul_dtype="bfloat16")
    np.testing.assert_array_equal(again.numpy(), out)


def test_jax_bf16_dot_rounds_operand_cotangents():
    """What the encoder's backward matches, pinned on JAX itself: the
    cotangent of a bf16-operand dot's operand is the float32 product of
    the upstream gradient with the other rounded operand, rounded to bf16
    (what autograd of ``encoder.product``'s casts gives)."""
    rng = np.random.RandomState(6)
    a, b = rng.randn(6, 7).astype(np.float32), rng.randn(7, 5).astype(np.float32)
    g = rng.randn(6, 5).astype(np.float32)

    def f(aa, bb):
        return jnp.sum(jnp.dot(aa.astype(jnp.bfloat16), bb.astype(jnp.bfloat16),
                               preferred_element_type=jnp.float32) * jnp.asarray(g))

    ja, jb = jax.grad(f, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.from_numpy(a).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    (tencoder.product(ta, tb, "bfloat16") * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(ta.grad.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.grad.numpy(), np.asarray(jb))


def test_encoder_float32_matmul_dtype_changes_nothing():
    rng = np.random.RandomState(7)
    params = {"fc1": {"w": torch.from_numpy(rng.randn(5, 4).astype(np.float32)),
                      "b": torch.zeros(4)}}
    x = torch.from_numpy(rng.randn(3, 5).astype(np.float32))
    base = tencoder.encoder_forward(params, x, ("sigmoid",))
    for mm in (None, "float32", torch.float32):
        torch.testing.assert_close(tencoder.encoder_forward(params, x, ("sigmoid",),
                                                            matmul_dtype=mm),
                                   base, rtol=0, atol=0)
