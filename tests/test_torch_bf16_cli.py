"""The ``[training] matmul_dtype = bfloat16`` key through the port's training
CLIs (``cli.trimodal``, ``cli.nstream``, ``cli.leave_one_out``) against the
JAX package's, on the CPU at a tiny width, from ``.mat`` and INI files
written by ``chip_smoke.py``'s own helpers (as tests/test_torch_cli_train.py
writes them).

For each CLI: the model config that reaches ``Trainer`` equals the JAX
CLI's field for field, ``matmul_dtype`` included (both CLIs copy the key
into the model config); the data handed to ``Trainer.fit`` is equal bit for
bit; one training loss and gradient on the first training utterances, from
JAX's initial parameters carried across, equal JAX's; and the port's CLI
runs its whole (cut) schedule with the key, every cost finite.

The gradients are held as one vector in relative norm (``FLIP_GRAD_TOL``,
as the tiny flagship's train step in tests/test_torch_bf16_models.py):
these models' 2000-1000-500-50 encoders and LSTMs make rounding flips
likely, where an operand that lies within the two packages' summation-order
difference of a bf16 rounding boundary rounds the other way and the
difference carries.  Measured here: see the constants.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ip_avsr_tpu.cli import leave_one_out as jloo
from ip_avsr_tpu.cli import nstream as jnstream
from ip_avsr_tpu.cli import trimodal as jtrimodal
from ip_avsr_tpu.train import trainer as jtr
from ip_avsr_torch import bridge
from ip_avsr_torch.cli import leave_one_out as tloo
from ip_avsr_torch.cli import nstream as tnstream
from ip_avsr_torch.cli import trimodal as ttrimodal
from ip_avsr_torch.train import trainer as ttr
from tests.test_torch_cli_train import assert_same, run
from tests.torch_trainer_lib import jax_fields

torch.set_num_threads(1)

TINY = dict(n=30, imagesize=(6, 8), dct=10, mfcc=7)
CUTS = [("training", "num_epoch", 1), ("training", "epochsize", 2),
        ("training", "batchsize", 6), ("training", "matmul_dtype", "bfloat16")]
SETS = {"trimodal": [("models", "lstm_size", 4), ("training", "windowsize", 3)] + CUTS,
        "nstream": [("lstm_classifier", "lstm_size", 6),
                    ("lstm_classifier", "windowsize", 3)] + CUTS}
CORPUS = {"trimodal": TINY, "nstream": dict(TINY, ae=(16, 8))}
MAINS = {"trimodal": (jtrimodal.main, ttrimodal.main, "trimodal", []),
         "nstream": (jnstream.main, tnstream.main, "nstream", []),
         "leave_one_out": (jloo.main, tloo.main, "trimodal", ["--test_subj", "3"])}
# one gradient as a vector, relative norm: measured 2.4e-4 (trimodal),
# 1.2e-7 (nstream) and 4.6e-4 (leave_one_out), the same parameters' float32
# gradient 2.4e-3 to 3.2e-3 away
FLIP_GRAD_TOL = 1e-3
B = 3


@pytest.fixture(scope="module")
def inis(tmp_path_factory):
    out = {}
    for kind in ("trimodal", "nstream"):
        root = tmp_path_factory.mktemp(kind)
        paths = chip_smoke.write_cli_corpus(str(root), CORPUS[kind])
        ini = str(root / f"{kind}.ini")
        chip_smoke.write_cli_ini(ini, kind,
                                 chip_smoke.cli_sets(kind, paths, CORPUS[kind]) + SETS[kind])
        out[kind] = ini
    return out


class Stop(Exception):
    pass


def _capture(monkeypatch, main, argv, trainer_cls):
    """(trainer, data) that ``main(argv)`` hands ``Trainer.fit``, the fit
    itself not run."""
    got = {}

    def fit(self, *data):
        got["v"] = self, data
        raise Stop

    monkeypatch.setattr(trainer_cls, "fit", fit)
    with pytest.raises(Stop):
        run(main, argv)
    monkeypatch.undo()
    return got["v"]


def _first_utterances(split):
    """The first B utterances of a frame-major split (streams (frames, D),
    per-frame targets, lengths) as padded (B, T, D) streams, their targets
    and mask."""
    frames, targets, lengths = split
    lens = np.asarray(lengths).reshape(-1)[:B].astype(int)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    T = int(lens.max())
    streams = []
    for x in frames:
        x = np.asarray(x, np.float32)
        out = np.zeros((B, T, x.shape[1]), np.float32)
        for i, (s0, n) in enumerate(zip(starts, lens)):
            out[i, :n] = x[s0:s0 + n]
        streams.append(out)
    y = np.asarray(targets).reshape(-1)[starts].astype(np.int32)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    return streams, y, mask


@pytest.mark.parametrize("cli", list(MAINS))
def test_bf16_cli_matches_jax(inis, monkeypatch, cli):
    jmain, tmain, kind, extra = MAINS[cli]
    argv = ["--config", inis[kind]] + extra
    jt, jdata = _capture(monkeypatch, jmain, argv, jtr.Trainer)
    tt, tdata = _capture(monkeypatch, tmain, argv + ["--device", "cpu"], ttr.Trainer)
    assert tt.config.matmul_dtype == jt.config.matmul_dtype == "bfloat16"
    assert jax_fields(tt.config) == dataclasses.asdict(jt.config)
    assert_same(tdata, jdata)

    # one loss and gradient on the first training utterances, JAX's
    # initial parameters in both packages
    jp = jt.init_params(jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    streams, y, mask = _first_utterances(jdata[0])
    cfg0 = dataclasses.replace(jt.config, streams=[dataclasses.replace(s, dropout=0.0)
                                                   for s in jt.config.streams], agg_dropout=0.0)
    jt0 = jtr.Trainer(cfg0, jtr.TrainOptions(log_fn=lambda s: None, window=jt.options.window))
    _, jg = jax.value_and_grad(jt0._loss)(jp, [jnp.asarray(s) for s in streams], jnp.asarray(y),
                                          jnp.asarray(mask), True, jax.random.PRNGKey(0))
    tcfg0 = dataclasses.replace(tt.config, streams=[dataclasses.replace(s, dropout=0.0)
                                                    for s in tt.config.streams], agg_dropout=0.0)
    args = ([torch.from_numpy(s) for s in streams], torch.from_numpy(y).long(),
            torch.from_numpy(mask))
    window = tt.options.window
    tg = ttr.loss_and_grads(tp, tcfg0, *args, window=window)[1]
    fg = ttr.loss_and_grads(tp, dataclasses.replace(tcfg0, matmul_dtype=None), *args,
                            window=window)[1]
    ref, got, f32 = (np.concatenate([np.asarray(leaf, np.float64).ravel()
                                     for leaf in jax.tree_util.tree_leaves(tree)])
                     for tree in (jax.tree_util.tree_map(np.asarray, jg),
                                  jax.tree_util.tree_map(lambda t: t.numpy(), tg),
                                  jax.tree_util.tree_map(lambda t: t.numpy(), fg)))
    err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    gap = np.linalg.norm(f32 - ref) / np.linalg.norm(ref)
    assert err <= FLIP_GRAD_TOL, f"gradient {err:.3g} from JAX's in relative norm"
    assert gap > 2 * FLIP_GRAD_TOL, f"the float32 gradient is only {gap:.3g} away"

    # the port's CLI runs its cut schedule with the key
    result, _ = run(tmain, argv + ["--device", "cpu"])
    assert np.isfinite(result.cost_train).all() and np.isfinite(result.cost_val).all()
