"""The ResNet + BLSTM word lipreader (``models/zoo.resnet_blstm``,
``models/resnet.py``) on the port's normal path against its plain reference
(``ip_avsr_torch/reference_lipread.py``), on the CPU at a small preset: the
[3, 4, 6, 3] trunk at widths 4/8/8/16, 16 x 16 frames, T = 7, B = 3, H = 8,
5 classes, seeded random weights.

Each comparison is run twice: against the reference in float32, where it
must hold its tolerance, and against the reference with the operands of
every convolution and matrix product rounded to bf16 (the nearest precision
below float32 on the card), where the same tolerance must fail.  The
tolerances, with their reasons (gaps seen over seeds 1-7):

* probabilities, training mode: 5e-5 relative.  Batch norm normalises with
  statistics over as few as 21 values (3 x 7 frames at 1 x 1 in the last
  stages), which amplifies float32 rounding: up to 9.2e-6; bf16 gives
  2.2e-2 and more.
* probabilities, evaluation mode and served: 1e-5 relative (up to 5.7e-7;
  bf16 2.4e-3 and more).
* the loss: 1e-6 relative (up to 7.5e-8; bf16 moves it by 7.9e-6 to
  1.5e-3).
* gradients: 2e-3 of each leaf's largest value.  The backward of 36 batch
  norms at 21 rows cancels large terms: the port and the reference, both
  float32, each stand up to 2.1e-4 of a leaf's max from the reference in
  float64 (up to 2.9e-4 between them); bf16 gives 1.4 and more.  A ReLU
  whose input lies within the rounding of zero can gate its gradient
  otherwise in two correct float32 runs, and at 21 rows one such flip
  moves a leaf's gradient by up to a fifth: on seed 2 the float32
  reference flips one (an input of 1.6e-5 against -4.1e-5 in float64) and
  stands 0.19 from float64 where the port stands 1.6e-4.  The gradient
  tests take seeds 4 and 5, on which neither flips.
* running statistics: 1e-5 of each leaf's largest value (up to 3.5e-6;
  bf16 9.9e-3 and more).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ip_avsr_torch import reference_lipread as ref
from ip_avsr_torch import serve
from ip_avsr_torch.device import tree_map
from ip_avsr_torch.models import adenet, resnet, zoo
from ip_avsr_torch.ops import lstm as lstm_ops
from ip_avsr_torch.ops.voting import majority_voting_layer_masked
from ip_avsr_torch.train import trainer as tr

B, T, HW, H, C = 3, 7, 16, 8, 5
TOL_TRAIN = 5e-5
TOL_EVAL = 1e-5
TOL_LOSS = 1e-6
TOL_GRAD = 2e-3
TOL_STATE = 1e-5
LR = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(merge="concat"):
    cfg = zoo.resnet_blstm(output_classes=C, lstm_size=H, image_shape=(HW, HW),
                           frontend_widths=(4, 8, 8, 16))
    return dataclasses.replace(cfg, agg_merge=merge)


def _setup(seed, merge="concat"):
    cfg = _config(merge)
    g = torch.Generator().manual_seed(seed)
    params = adenet.init_adenet_params(g, cfg, device="cpu")
    # move the running statistics off their init, so evaluation reads them
    params["streams"]["video"]["frontend_state"] = tree_map(
        lambda t: t + 0.1 * torch.rand(t.shape, generator=g),
        params["streams"]["video"]["frontend_state"])
    frames = torch.randint(0, 256, (B, T, HW, HW), dtype=torch.uint8, generator=g)
    y = torch.randint(0, C, (B,), generator=g)
    mask = torch.ones(B, T)
    mask[1, 5:] = 0.0  # a padded tail: the LSTMs carry their state over it
    return cfg, dataclasses.asdict(cfg), params, frames, y, mask


class _Rounded:
    """The reference's convolutions and products with bf16 operands."""

    def __enter__(self):
        self.held = ref.conv, ref.matmul
        conv, mm = self.held
        r = lambda t: t.to(torch.bfloat16).to(torch.float32)  # noqa: E731
        ref.conv = lambda x, w, stride=1, padding=0: conv(r(x), r(w), stride, padding)
        ref.matmul = lambda a, b: mm(r(a), r(b))

    def __exit__(self, *exc):
        ref.conv, ref.matmul = self.held


def _both(fn):
    """``fn()`` with the reference in float32 and with bf16 operands."""
    exact = fn()
    with _Rounded():
        rounded = fn()
    return exact, rounded


def _rel(got, want) -> float:
    return float(((got - want).abs() / want.abs()).max())


def _leaf_gap(got: dict, want: dict, keys) -> float:
    return max(float((got[k] - want[k]).abs().max() / want[k].abs().max()) for k in keys)


@pytest.mark.parametrize("merge", ["concat", "sum"])
@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_the_reference(train, merge):
    cfg, model, params, frames, _, mask = _setup(1, merge)
    got, aux = adenet.adenet_forward(params, cfg, [frames], mask, train=train, return_aux=True)
    assert got.shape == (B, T, C)
    (want, states), (rounded, _) = _both(lambda: ref.forward(model, params, frames, mask, train))
    tol = TOL_TRAIN if train else TOL_EVAL
    assert _rel(got, want) <= tol < _rel(rounded, want)
    new = dict(ref.leaves(aux["frontend_state"]["video"]))
    want_state = dict(ref.leaves(states["video"]))
    assert list(new) == list(want_state) and len(new) == 72
    assert _leaf_gap(new, want_state, new) <= TOL_STATE


def test_the_concat_merge_doubles_the_second_layer_and_the_classifier():
    cfg, _, params, frames, _, mask = _setup(2)
    assert cfg.classifier_in_dim() == 2 * H
    assert params["aggregator"][1]["fwd"]["w_in"].shape == (2 * H, 4 * H)
    assert params["output"]["w"].shape == (2 * H, C)
    feats = adenet.stream_prefix(params, cfg, [frames])
    x = feats[0]
    for lp in params["aggregator"]:
        f = lstm_ops.lstm_forward(lp["fwd"], x, mask)
        b = lstm_ops.lstm_forward(lp["bwd"], x, mask, backwards=True)
        x = torch.cat([f, b], dim=-1)
    probs = torch.softmax(x @ params["output"]["w"] + params["output"]["b"], dim=-1)
    got = adenet.head_forward(params, cfg, feats, mask)
    assert torch.equal(got, probs)


def test_loss_matches_the_reference():
    cfg, model, params, frames, y, mask = _setup(3)
    loss = tr.loss_fn(params, cfg, [frames], y, mask)
    want, rounded = _both(lambda: ref.loss(ref.forward(model, params, frames, mask, True)[0],
                                           y, mask))
    assert _rel(loss, want) <= TOL_LOSS < _rel(rounded, want)


@pytest.mark.parametrize("seed", [4, 5])
def test_every_leafs_gradient_matches_the_reference(seed):
    cfg, model, params, frames, y, mask = _setup(seed)
    _, grads = tr.loss_and_grads(params, cfg, [frames], y, mask)
    got = dict(ref.leaves(grads))
    (_, want, _), (_, rounded, _) = _both(
        lambda: ref.train_steps(model, params, [(frames, y, mask)], LR))
    assert list(got) == list(want) and len(got) == 202
    keys = [k for k in want if not ref.is_state(k)]
    assert len(keys) == 108 + 4 * 5 + 2
    assert all(float(got[k].abs().max()) == 0.0 for k in want if ref.is_state(k))
    assert _leaf_gap(got, want, keys) <= TOL_GRAD < _leaf_gap(rounded, want, keys)


def test_one_train_step_moves_the_running_statistics_as_the_reference():
    cfg, model, params, frames, y, mask = _setup(6)
    trainer = tr.Trainer(cfg, tr.TrainOptions(learning_rate=LR, batchsize=B,
                                              log_fn=lambda _: None), device="cpu")
    opt_state = trainer.optimizer.init(params)
    new, _, _ = trainer.train_step(params, opt_state, [frames], y, mask,
                                   torch.Generator().manual_seed(0), LR)
    got = dict(ref.leaves(new))
    (_, _, want), (_, _, rounded) = _both(
        lambda: ref.train_steps(model, params, [(frames, y, mask)], LR))
    states = [k for k in want if ref.is_state(k)]
    assert len(states) == 72
    before = dict(ref.leaves(params))
    assert all(not torch.equal(got[k], before[k]) for k in states)
    assert _leaf_gap(got, want, states) <= TOL_STATE < _leaf_gap(rounded, want, states)


def test_scoring_through_make_server_and_the_pipelined_server():
    cfg, model, params, frames, _, mask = _setup(7)
    want, rounded = _both(lambda: ref.forward(model, params, frames, mask)[0])
    probs = serve.make_server(params, cfg, vote=False, device="cpu")([frames.numpy()],
                                                                      mask.numpy())
    assert _rel(probs, want) <= TOL_EVAL < _rel(rounded, want)
    server = serve.PipelinedServer(params, cfg, vote=False, depth=2, device="cpu")
    rows = [([frames[i:i + 1].numpy()], mask[i:i + 1].numpy()) for i in range(B)]
    got = torch.as_tensor(np.concatenate(list(server.map(rows))))
    assert _rel(got, want) <= TOL_EVAL
    voted = serve.PipelinedServer(params, cfg, vote=True, depth=2, device="cpu")
    scores = np.concatenate(list(voted.map(rows)))
    assert np.array_equal(scores, majority_voting_layer_masked(got, mask, C).numpy())


def test_the_zoo_entry_is_resnet34_with_a_two_layer_blstm():
    cfg = zoo.resnet_blstm()
    (spec,) = cfg.streams
    assert (spec.frontend, spec.input_dim) == ("resnet", 12544)
    assert (cfg.agg_layers, cfg.agg_merge, cfg.lstm_size, cfg.output_classes) == (
        2, "concat", 256, 500)
    params = adenet.init_adenet_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    front = params["streams"]["video"]["frontend"]
    assert [len(s) for s in front["layers"]] == [3, 4, 6, 3]
    assert front["stem"]["conv"].shape == (64, 1, 5, 7, 7)
    assert [sum("down_conv" in b for b in s) for s in front["layers"]] == [0, 1, 1, 1]
    leaves = list(ref.leaves(params))
    trained = sum(t.numel() for k, t in leaves if not ref.is_state(k))
    assert len(leaves) == 202 and 24_000_000 < trained < 25_500_000
    assert resnet.stage_strides() == [[1] * 3, [2, 1, 1, 1], [2] + [1] * 5, [2, 1, 1]]


def test_unsupported_front_end_settings_are_refused():
    cfg = _config()
    with pytest.raises(NotImplementedError, match="Queue 6 item 5"):
        adenet.check_supported(cfg, mesh=object())
    with pytest.raises(NotImplementedError, match="Queue 6 item 6"):
        adenet.check_supported(dataclasses.replace(cfg, matmul_dtype="bfloat16"))
    with pytest.raises(NotImplementedError, match="Queue 6 item 5"):
        tr.Trainer(cfg, tr.TrainOptions(use_mesh=True, log_fn=lambda _: None), device="cpu")
    with pytest.raises(ValueError, match="agg_merge"):
        adenet.check_supported(dataclasses.replace(cfg, agg_merge="mean"))
    spec = cfg.streams[0]
    for bad in (dict(frontend="vgg"), dict(encoder_shapes=(8,))):
        with pytest.raises(ValueError):
            adenet.check_supported(dataclasses.replace(
                cfg, streams=[dataclasses.replace(spec, **bad)]))
    with pytest.raises(ValueError, match="batch-norm"):
        tr.Trainer(cfg, tr.TrainOptions(grad_accum_steps=3, batchsize=B,
                                        log_fn=lambda _: None), device="cpu")
    adenet.check_supported(cfg)
    adenet.check_supported(dataclasses.replace(cfg, matmul_dtype="float32"))
