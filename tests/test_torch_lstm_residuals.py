"""The LSTM training cores' residual levers (``lstm_forward(remat=,
residual_dtype=)``, ip_avsr_torch/ops/lstm.py) against the JAX package's
same settings, for the non-peephole and the peephole core, both directions.

* ``remat``: the backward rebuilds the gates from x and the stored hids;
  values and gradients within 1e-5 of each gradient's max abs of JAX's
  remat, and within 1e-4 of the port's own run without the lever.
* ``residual_dtype="bfloat16"`` (alone and with remat): the backward
  computes from rounded stacks, so its gradients sit about 2e-3 of max abs
  from the float32 ones (2.42e-3 and 3.10e-3 measured on the JAX package,
  ROADMAP Queue 3; 6.7e-4 to 6.4e-3 in these cases).  The port is held to
  JAX's bf16 gradients within BF16_TOL = 1e-5 of max abs (2.7e-7 measured
  at most), 242x under the 2.42e-3 gap, and the test also shows its
  gradients farther than BF16_TOL from the float32 ones: the rounded
  stacks are the ones used.  Forward values stay float32 (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_avsr_tpu.ops import lstm as jlstm
from ip_avsr_torch.ops import lstm as tlstm

torch.set_num_threads(1)
TOL = 1e-5
REMAT_TOL = 1e-4
BF16_TOL = 1e-5
PEEP = ("w_cell_to_ingate", "w_cell_to_forgetgate", "w_cell_to_outgate")
SETTINGS = {"remat": dict(remat=True), "bf16": dict(residual_dtype="bfloat16"),
            "remat_bf16": dict(remat=True, residual_dtype="bfloat16")}


def _case(seed, peep, B=4, T=9, D=7, H=6):
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


def _port(params, x, mask, g, backwards, **lever):
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tlstm.lstm_forward(tp, tx, torch.from_numpy(mask), backwards=backwards, **lever)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), {**{k: tp[k].grad.numpy() for k in params},
                                  "x": tx.grad.numpy()}


def _jax(params, x, mask, g, backwards, **lever):
    if lever.get("residual_dtype"):
        lever = {**lever, "residual_dtype": jnp.bfloat16}

    def f(p, xx):
        out = jlstm.lstm_forward(p, xx, jnp.asarray(mask), backwards=backwards, **lever)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, out), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return np.asarray(out), {**{k: np.asarray(gp[k]) for k in params}, "x": np.asarray(gx)}


def _worst(got, ref):
    """The largest gradient difference relative to that gradient's max abs."""
    return max(np.abs(got[k] - r).max() / max(np.abs(r).max(), 1e-30) for k, r in ref.items())


@pytest.mark.parametrize("backwards", [False, True])
@pytest.mark.parametrize("peep", [False, True], ids=["plain", "peephole"])
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_residual_levers_match_jax(setting, peep, backwards):
    lever = SETTINGS[setting]
    params, x, mask, g = _case(3 + peep, peep)
    out, got = _port(params, x, mask, g * 10, backwards, **lever)
    ref_out, ref = _jax(params, x, mask, g * 10, backwards, **lever)
    f32_out, f32 = _port(params, x, mask, g * 10, backwards)
    np.testing.assert_allclose(out, ref_out, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(out, f32_out)  # the levers change no output
    if "residual_dtype" in lever:
        assert _worst(got, ref) <= BF16_TOL, _worst(got, ref)
        assert _worst(got, f32) > BF16_TOL  # the rounded stacks were used
    else:
        assert _worst(got, ref) <= TOL, _worst(got, ref)
        assert _worst(got, f32) <= REMAT_TOL


def test_levers_do_not_combine_with_state_and_leave_inference_alone():
    params, x, mask, _ = _case(5, False)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    with pytest.raises(ValueError, match="remat"):
        tlstm.lstm_forward(tp, torch.from_numpy(x), torch.from_numpy(mask), remat=True,
                           return_state=True)
    with pytest.raises(ValueError, match="residual_dtype"):
        tlstm.lstm_forward(tp, torch.from_numpy(x), torch.from_numpy(mask),
                           residual_dtype="float64x")
    plain = tlstm.lstm_forward(tp, torch.from_numpy(x), torch.from_numpy(mask))
    levered = tlstm.lstm_forward(tp, torch.from_numpy(x), torch.from_numpy(mask), remat=True,
                                 residual_dtype=torch.bfloat16)
    assert torch.equal(plain, levered)


def test_remat_keeps_no_gate_stack_and_bf16_stores_bf16():
    """What the Function saves: under remat no (B, T, 4H) tensor, with
    bf16 the stacks in bf16, the output float32 either way."""
    params, x, mask, _ = _case(6, False)
    H = params["w_hid"].shape[0]
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    for lever, want in ((dict(remat=True), {torch.float32}),
                        (dict(residual_dtype="bfloat16"), {torch.bfloat16}),
                        (dict(remat=True, residual_dtype="bfloat16"), {torch.bfloat16})):
        out = tlstm.lstm_forward(tp, torch.from_numpy(x), torch.from_numpy(mask), **lever)
        assert out.dtype == torch.float32
        saved = out.grad_fn.saved_tensors
        stacks = [t for t in saved if t.dim() == 3 and t.shape[:2] == x.shape[:2]
                  and t.shape[2] in (H, 4 * H)]
        assert {t.shape[2] for t in stacks} == ({H} if lever.get("remat") else {H, 4 * H})
        assert {t.dtype for t in stacks} == want
