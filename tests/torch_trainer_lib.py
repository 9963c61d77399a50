"""Shared data and models of the port's Trainer tests against the JAX Trainer
(tests/test_torch_trainer.py, tests/test_torch_trainer_resume.py).

Both trainers start from the same parameters: the port trainer's
``init_params`` is replaced by ``bridge.params_from_jax`` of the JAX
trainer's ``init_params(PRNGKey(seed))``.  Every model here has dropout 0
(the packages' random bits differ), so with the same ``RandomState`` batch
order both fits see the same batches and take the same steps.

Tolerances, float32 over a few epochs of steps: costs (train, val, best
val) within 1e-5 relative, class rates, test rates and confusion matrices
equal, epochs run and final rate equal, best parameters within 1e-5 of each
leaf's max abs.
"""

import dataclasses

import jax
import numpy as np

from ip_avsr_torch import bridge

COST_RTOL = 1e-5
PARAM_TOL = 1e-5
CLASSES = 3


def synthetic(n_videos, dims, seed, classes=CLASSES, min_len=3, max_len=8, label_shift=0):
    """Frame-major streams ``[(sum_T, D_i)]``, per-frame targets and lengths:
    the class shifts the mean of one feature of every stream, so the task is
    learnable in a few steps.  ``label_shift`` gives each sequence the
    target of class c + shift: a split whose cost rises as training fits."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(min_len, max_len + 1, n_videos)
    y_video = rng.randint(0, classes, n_videos)
    streams = []
    for D in dims:
        frames = []
        for l, c in zip(lens, y_video):
            base = np.zeros(D)
            base[c % D] = 2.0
            frames.append(base + 0.5 * rng.randn(l, D))
        streams.append(np.concatenate(frames).astype(np.float32))
    y = np.concatenate([np.full(l, (c + label_shift) % classes)
                        for l, c in zip(lens, y_video)])
    return streams, y, lens


def splits(dims, n_train=16, n_val=12, n_test=12, val_shift=0):
    return (synthetic(n_train, dims, 0), synthetic(n_val, dims, 1, label_shift=val_shift),
            synthetic(n_test, dims, 2))


def per_step_config(zoo):
    """An encoder, the DeltaLayer, a BLSTM and the per-step head with the
    majority vote."""
    return zoo.deltanet_majority_vote(6, (5, 3), ("sigmoid", "linear"), lstm_size=4,
                                      window=2, output_classes=CLASSES)


PER_STEP_DIMS = (6,)


def flagship_config(zoo):
    """The trimodal adenet_v3 at a tiny width (encoders 5-4-3-2, stream
    LSTMs 4, BLSTM 4, W = 2), last-step head, orthogonal init, dropout 0."""
    cfg = zoo.adenet_v3(6, 4, 6, lstm_size=2, window=2, output_classes=CLASSES)
    enc = (("sigmoid", "sigmoid", "sigmoid", "linear"), (5, 4, 3, 2))
    streams = [dataclasses.replace(s, dropout=0.0,
                                   **({"encoder_shapes": enc[1],
                                       "encoder_nonlinearities": enc[0]}
                                      if s.encoder_shapes else {}))
               for s in cfg.streams]
    return dataclasses.replace(cfg, streams=streams, agg_dropout=0.0)


FLAGSHIP_DIMS = (6, 4, 6)


def quiet_options(module, **kw):
    base = dict(num_epoch=3, epochsize=3, batchsize=5, learning_rate=0.01,
                validation_window=50, seed=0, log_fn=lambda s: None)
    base.update(kw)
    return module.TrainOptions(**base)


def jax_params(trainer, seed=0):
    return jax.tree_util.tree_map(np.asarray, trainer.init_params(jax.random.PRNGKey(seed)))


def port_trainer(ttr, tcfg, options, params_np):
    """A port Trainer on the CPU whose initial parameters are ``params_np``
    (a numpy tree from the JAX package)."""
    trainer = ttr.Trainer(tcfg, options, device="cpu")
    trainer.init_params = lambda generator, **kw: bridge.params_from_jax(params_np,
                                                                         device="cpu")
    return trainer


def data_of(split):
    streams, y, lens = split
    return (list(streams), y, lens)


def fit_both(jtr, ttr, jcfg, tcfg, dims, jax_kw=None, port_kw=None, val_shift=0, **kw):
    """The JAX fit and the port's fit from the same parameters on the same
    splits -> (jax result, port result, jax trainer, port trainer)."""
    data = [data_of(s) for s in splits(dims, val_shift=val_shift)]
    jt = jtr.Trainer(jcfg, quiet_options(jtr, **kw, **(jax_kw or {})))
    jr = jt.fit(*data)
    tt = port_trainer(ttr, tcfg, quiet_options(ttr, **kw, **(port_kw or {})), jax_params(jt))
    tr = tt.fit(*data)
    return jr, tr, jt, tt


def assert_params_close(got, ref, tol=PARAM_TOL):
    """``got`` (tensors) within ``tol`` of each leaf's max abs of ``ref``
    (numpy or tensors), leaf by leaf."""
    ref_leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, ref))
    got_leaves = jax.tree_util.tree_leaves(bridge_numpy(got))
    assert len(ref_leaves) == len(got_leaves)
    for g, r in zip(got_leaves, ref_leaves):
        assert g.shape == r.shape
        err = np.abs(g - r).max() if r.size else 0.0
        assert err <= tol * np.abs(r).max(), (err, np.abs(r).max())


def bridge_numpy(tree):
    """A tree of tensors as the same tree of numpy arrays, dict keys in the
    tree's order, so ``jax.tree_util`` flattens it as the JAX tree."""
    if isinstance(tree, dict):
        return {k: bridge_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(bridge_numpy(v) for v in tree)
    return tree.detach().cpu().numpy() if hasattr(tree, "detach") else np.asarray(tree)


def assert_results_match(jr, tr):
    np.testing.assert_allclose(tr.cost_train, jr.cost_train, rtol=COST_RTOL)
    np.testing.assert_allclose(tr.cost_val, jr.cost_val, rtol=COST_RTOL)
    np.testing.assert_allclose(tr.best_val, jr.best_val, rtol=COST_RTOL)
    assert tr.class_rate == jr.class_rate
    assert tr.best_cr == jr.best_cr
    assert tr.test_cr == jr.test_cr
    np.testing.assert_array_equal(tr.test_conf, np.asarray(jr.test_conf))
    assert tr.epochs_run == jr.epochs_run
    assert tr.final_lr == jr.final_lr
    assert_params_close(tr.best_params, jr.best_params)


class CarryInit:
    """The JAX Trainer's ``init_params`` records each tree it returns; the
    port Trainer's returns those trees, in order, as tensors (monkeypatched
    for one test)."""

    def __init__(self, monkeypatch):
        from ip_avsr_tpu.train import trainer as jtr
        from ip_avsr_torch.train import trainer as ttr

        self.trees, self.used = [], 0
        jinit = jtr.Trainer.init_params

        def jax_init(trainer, key, **kw):
            out = jinit(trainer, key, **kw)
            self.trees.append(jax.tree_util.tree_map(np.asarray, out))
            return out

        def port_init(trainer, generator, **kw):
            self.used += 1
            return bridge.params_from_jax(self.trees[self.used - 1], device=trainer.device)

        monkeypatch.setattr(jtr.Trainer, "init_params", jax_init)
        monkeypatch.setattr(ttr.Trainer, "init_params", port_init)


def zoo_case(name):
    """tests/zoo_cases.py's ZOO_CASES[name] built by the port's modules: the
    case's builder runs with that file's ``zoo``, ``avnet`` and ``adenet``
    bound to the port's."""
    from ip_avsr_torch.models import adenet as tadenet, avnet as tavnet, zoo as tzoo
    from tests import zoo_cases

    held = zoo_cases.zoo, zoo_cases.avnet, zoo_cases.adenet
    zoo_cases.zoo, zoo_cases.avnet, zoo_cases.adenet = tzoo, tavnet, tadenet
    try:
        return zoo_cases.ZOO_CASES[name]()
    finally:
        zoo_cases.zoo, zoo_cases.avnet, zoo_cases.adenet = held


def jax_fields(config) -> dict:
    """``dataclasses.asdict`` of a port ``AdeNetConfig`` in the JAX
    package's fields: each field the JAX package's lack
    (``adenet.PORT_FIELDS``) is checked to hold its default and dropped."""
    from ip_avsr_torch.models.adenet import PORT_FIELDS

    def strip(d, cls):
        for f in dataclasses.fields(cls):
            if f.name in PORT_FIELDS:
                assert d.pop(f.name) == f.default, (cls.__name__, f.name)
        return d

    out = strip(dataclasses.asdict(config), type(config))
    out["streams"] = [strip(s, type(spec)) for s, spec in zip(out["streams"], config.streams)]
    return out
