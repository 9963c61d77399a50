"""The plain reference against the port's CPU path at small widths: the
trimodal pipeline, the forwards of both layouts, one training step's loss
and gradients with dropout, and three Adam steps."""

import numpy as np
import pytest
import torch

from avsr_bench.harness import drive, inputs
from avsr_bench.reference import adenet_ref as ref
from conftest import tiny_config

CPU = torch.device("cpu")
SEED = 2**31 + 11


def _leaves(tree):
    return dict(ref.leaves(tree))


def _batch(cfg, B=6, seed=SEED):
    T = cfg["input"]["frames"]
    lens = inputs.lengths(B, 2, T, seed)
    streams = inputs.frames_pool(cfg, B, lens, seed, CPU, features=True)
    y = inputs.labels(B, cfg["model"]["output_classes"], seed)
    return ([torch.as_tensor(s) for s in streams], torch.as_tensor(y),
            torch.as_tensor(inputs.masks(lens, T)))


def test_zigzag_and_dct_basis_are_the_ports():
    from ip_avsr_torch.ops.dct import dct_feature_basis_np, zigzag_indices

    for shape in [(4, 6), (26, 44), (5, 3)]:
        assert ref.zigzag(*shape) == zigzag_indices(shape).tolist()
    ours = ref.dct_basis((26, 44), 90, CPU)
    assert torch.allclose(ours, torch.as_tensor(dct_feature_basis_np((26, 44), 90),
                                                dtype=torch.float32), atol=0, rtol=0)


def test_trimodal_streams_are_the_ports():
    from ip_avsr_torch.ops import pipeline

    g = torch.Generator().manual_seed(3)
    raw = torch.randint(0, 256, (3, 7, 24), dtype=torch.uint8, generator=g)
    mask = torch.as_tensor(inputs.masks(np.array([7, 3, 1]), 7))
    raw = raw * mask[..., None].to(torch.uint8)
    theirs = pipeline.trimodal_streams(raw.float(), mask, (4, 6), 5)
    ours = ref.trimodal_streams(raw, mask, (4, 6), 5)
    for a, b in zip(ours, theirs):
        assert torch.allclose(a, b, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["adenet_v3-oulu-trimodal", "adenet-oulu-4stream"])
def test_forward_is_the_ports(name):
    from ip_avsr_torch.models import adenet

    cfg = tiny_config(name)
    params = inputs.make_weights(cfg["model"], SEED, CPU)
    streams, _, mask = _batch(cfg)
    want = adenet.adenet_forward(params, drive.adenet_config(cfg["model"]), streams, mask)
    got = ref.forward(cfg["model"], params, streams, mask)
    assert got.shape == want.shape
    assert torch.allclose(got, want, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("name", ["adenet_v3-oulu-trimodal", "adenet-oulu-4stream"])
def test_gradients_with_dropout_are_the_ports(name):
    from ip_avsr_torch.train import trainer

    cfg = tiny_config(name)
    params = inputs.make_weights(cfg["model"], SEED, CPU)
    streams, y, mask = _batch(cfg)
    loss, grads = trainer.loss_and_grads(params, drive.adenet_config(cfg["model"]), streams, y,
                                         mask, inputs.generator(SEED, "dropout", CPU))
    losses, first, _ = ref.train_steps(cfg["model"], params, [(streams, y, mask)], 0.01,
                                       [inputs.generator(SEED, "dropout", CPU)])
    assert losses[0] == pytest.approx(float(loss), rel=1e-5)
    theirs = _leaves(grads)
    assert set(first) == set(theirs)
    for path, g in first.items():
        scale = max(float(theirs[path].abs().max()), 1e-6)
        assert float((g - theirs[path]).abs().max()) <= 1e-4 * scale, path


@pytest.mark.parametrize("peep", [False, True])
@pytest.mark.parametrize("backwards", [False, True])
def test_clipped_lstm_gradients_are_the_ports(peep, backwards):
    """An upstream gradient of 40 per output pushes the gate gradients past
    the +-5 clip (checked: without the clip they differ)."""
    from ip_avsr_torch.ops import lstm as lstm_ops

    lay = {"streams": [{"name": "s", "input_dim": 5, "use_delta": False, "lstm_size": 4}],
           "lstm_size": 4, "output_classes": 2, "agg_layers": 0, "use_peepholes": peep}
    p = inputs.make_weights(lay, SEED, CPU)["streams"]["s"]["lstm"]
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, 6, 5, generator=g)
    mask = torch.as_tensor(inputs.masks(np.array([6, 4, 1]), 6))
    upstream = 40.0 * torch.randn(3, 6, 4, generator=g)

    def grads(fn):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xs = x.clone().requires_grad_(True)
        out = fn(leaves, xs)
        got = torch.autograd.grad((out * upstream).sum(), [*leaves.values(), xs])
        return dict(zip([*leaves, "x"], got))

    theirs = grads(lambda q, xs: lstm_ops.lstm_forward(q, xs, mask, backwards))
    ours = grads(lambda q, xs: ref.lstm(q, xs, mask, backwards))
    for k in theirs:
        assert torch.allclose(ours[k], theirs[k], atol=1e-4, rtol=1e-5), k
    unclipped = grads(lambda q, xs: lstm_ops.lstm_forward(q, xs, mask, backwards, 0.0))
    assert any(not torch.allclose(unclipped[k], theirs[k]) for k in theirs)


def test_three_adam_steps_are_the_trainers():
    from ip_avsr_torch.train import trainer

    cfg = tiny_config("adenet_v3-oulu-trimodal")
    params = inputs.make_weights(cfg["model"], SEED, CPU)
    batches = [_batch(cfg, seed=SEED + k) for k in range(3)]
    tr = trainer.Trainer(drive.adenet_config(cfg["model"]),
                         trainer.TrainOptions(learning_rate=0.01, log_fn=lambda _: None),
                         device="cpu")
    p, state = params, tr.optimizer.init(params)
    gen = inputs.generator(SEED, "dropout", CPU)
    losses = []
    for streams, y, mask in batches:
        p, state, loss = tr.train_step(p, state, streams, y, mask, gen, 0.01)
        losses.append(float(loss))
    got, _, after = ref.train_steps(cfg["model"], params, batches, 0.01,
                                    [inputs.generator(SEED, "dropout", CPU)] * 3)
    assert got == pytest.approx(losses, rel=1e-5)
    for path, t in _leaves(p).items():
        assert torch.allclose(after[path], t, atol=1e-5), path


def test_reference_imports_nothing_of_the_program_or_jax():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(ref))
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "contextlib", "math", "numpy", "torch"}
