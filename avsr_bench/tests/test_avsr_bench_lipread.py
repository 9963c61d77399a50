"""The ``lrw-train-b128`` cell's files: the cell as ``spec`` reads it, its
configuration against the port's zoo, the benchmark's copy of the plain
reference against the port's, the seeded weights and frames, the counts of
``harness/conv_cost.py``, its readers, and a whole run of the
``lipread_train`` driver on the CPU at a small preset.  One test runs on
the card:

    python3 -m pytest avsr_bench/tests/test_avsr_bench_lipread.py -m cuda
"""

import copy
import json
import math
import os
import time

import numpy as np
import pytest
import torch

from avsr_bench.harness import conv_cost, drive, inputs, report, spec
from avsr_bench.reference import resnet_blstm_ref as bench_ref
from conftest import ROOT

CPU = torch.device("cpu")
SEED = 2**31 + 29
CELL = "lrw-train-b128"
DRIVER = spec.driver("lipread_train")
NEW_METRICS = ("frontend_ms.train", "conv_roofline.train", "lipread_mfu.train")


def _config():
    with open(os.path.join(ROOT, "avsr_bench", "configs", "resnet34-blstm-lrw.json")) as f:
        return json.load(f)


def tiny_config():
    """The cell's configuration at the CPU tests' preset: the [3, 4, 6, 3]
    trunk at widths 4/8/8/16, 16 x 16 frames, T = 7, H = 8, 5 classes."""
    cfg = copy.deepcopy(_config())
    s = cfg["model"]["streams"][0]
    s.update(frontend_widths=[4, 8, 8, 16], input_dim=256)
    cfg["input"].update(image_shape=[16, 16], frames=7)
    cfg["model"].update(lstm_size=8, output_classes=5)
    return cfg


# at 21 rows, Adam's near-sign steps on gradients within rounding of zero
# and ReLUs gated otherwise part two correct float32 runs' changes by a few
# hundredths of a leaf's norm (0.025 seen), where the losses agree to 1.5e-7
# and the running statistics after the third step to 4.4e-6 (a merge left
# out reads about 1)
TINY_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 0.1, "state_gap": 1e-3}
TINY_TRAFFIC = {"driver": "lipread_train", "batch_per_rank": 3, "ranks": 1, "lr": 3e-4,
                "min_len": 7, "max_len": 7, "pool_batches": 3, "warmup_steps": 1,
                "trace_steps": 2}


def test_the_cell_reads_its_configuration_traffic_and_limits():
    cell = spec.load_cell(CELL, ROOT)
    assert cell.chips == 1 and cell.driver == "lipread_train"
    assert cell.config["name"] == "resnet34-blstm-lrw"
    assert cell.config["precision"] == {"dtype": "float32", "tf32": False}
    assert set(cell.limits) == {"loss_gap", "grad_gap", "change_gap", "state_gap"}
    t = cell.traffic
    assert (t["batch_per_rank"], t["ranks"], t["min_len"], t["max_len"], t["lr"]) == (
        128, 1, 29, 29, 3e-4)
    assert {m["name"] for m in cell.end_to_end} == {"train_utt_per_s", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert set(NEW_METRICS) <= names and "train_mfu" not in names
    assert {"idle_share.train", "forward_ms.train", "backward_ms.train", "optimizer_ms.train",
            "launch_calls_per_step.train", "lstm_roofline.train",
            "gemm_roofline.train"} <= names
    # a batch of 128 clips is 46.6 MB of uint8 pixels
    assert t["batch_per_rank"] * 29 * 112 * 112 == 46_563_328


def test_the_configuration_is_zoo_resnet_blstm():
    from ip_avsr_torch.models import zoo

    assert drive.adenet_config(_config()["model"]) == zoo.resnet_blstm()


def _tiny_batch(cfg, seed=SEED, B=3):
    frames = torch.as_tensor(DRIVER.frames_pool(cfg, B, seed, CPU))
    g = torch.Generator().manual_seed(seed % 2**31)
    y = torch.randint(0, cfg["model"]["output_classes"], (B,), generator=g)
    return frames, y, torch.ones(B, cfg["input"]["frames"])


@pytest.mark.parametrize("train", [True, False])
def test_the_benchmarks_reference_is_the_ports(train):
    from ip_avsr_torch import reference_lipread as port_ref

    cfg = tiny_config()
    params = DRIVER.make_weights(cfg["model"], SEED, CPU)
    frames, y, mask = _tiny_batch(cfg)
    a, sa = bench_ref.forward(cfg["model"], params, frames, mask, train)
    b, sb = port_ref.forward(cfg["model"], params, frames, mask, train)
    assert torch.equal(a, b)
    assert all(torch.equal(u, v) for (_, u), (_, v) in zip(bench_ref.leaves(sa),
                                                            port_ref.leaves(sb)))
    if train:
        la, ga, pa = bench_ref.train_steps(cfg["model"], params, [(frames, y, mask)] * 2, 3e-4)
        lb, gb, pb = port_ref.train_steps(cfg["model"], params, [(frames, y, mask)] * 2, 3e-4)
        assert la == lb and list(ga) == list(gb) and list(pa) == list(pb)
        assert all(torch.equal(ga[k], gb[k]) and torch.equal(pa[k], pb[k]) for k in ga)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flat(v, path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _flat(v, path + (i,))]
    return [(path, tuple(tree.shape), tree.dtype)]


@pytest.mark.parametrize("tiny", [True, False])
def test_the_weights_have_the_programs_layout(tiny):
    from ip_avsr_torch.models import adenet

    cfg = tiny_config() if tiny else _config()
    theirs = adenet.init_adenet_params(torch.Generator().manual_seed(0),
                                       drive.adenet_config(cfg["model"]), device="cpu")
    ours = DRIVER.make_weights(cfg["model"], SEED, CPU)
    assert _flat(ours) == _flat(theirs) and len(_flat(ours)) == 202
    if not tiny:  # 24.7 M parameters besides the 72 running statistics
        trained = [s for p, s, _ in _flat(ours) if "frontend_state" not in p]
        assert sum(math.prod(s) for s in trained) == 24_699_316


def test_the_weights_and_frames_repeat_for_a_seed_and_differ_across_seeds():
    cfg = tiny_config()
    a, b, c = (DRIVER.make_weights(cfg["model"], s, CPU) for s in (SEED, SEED, SEED + 1))
    front = lambda p: p["streams"]["video"]["frontend"]  # noqa: E731
    for key in ("conv1", "bn1"):
        x = front(a)["layers"][1][0][key]
        x = x if key == "conv1" else x["gamma"]
        y = front(b)["layers"][1][0][key]
        z = front(c)["layers"][1][0][key]
        y, z = (v if key == "conv1" else v["gamma"] for v in (y, z))
        assert torch.equal(x, y) and not torch.equal(x, z)
    w = front(a)["layers"][1][0]["conv1"]
    assert float(w.abs().max()) <= math.sqrt(6.0 / (4 * 9))
    gamma = front(a)["stem"]["bn"]["gamma"]
    assert float((gamma - 1.0).abs().max()) <= inputs.VECTOR_RANGE
    state = a["streams"]["video"]["frontend_state"]["stem"]["bn"]
    assert float(state["mean"].abs().max()) == 0.0 and float(state["var"].min()) == 1.0
    f1, f2, f3 = (DRIVER.frames_pool(cfg, 4, s, CPU) for s in (SEED, SEED, SEED + 1))
    assert f1.dtype == np.uint8 and f1.shape == (4, 7, 16, 16)
    assert np.array_equal(f1, f2) and not np.array_equal(f1, f3)


def test_conv_cost_counts_a_3x3_and_the_stems_5x7x7_convolution_exactly():
    nbytes, flops = conv_cost.forward_cost((2, 64, 28, 28), (64, 64, 3, 3), (2, 64, 28, 28))
    assert flops == 2 * (2 * 64 * 28 * 28) * (64 * 9) == 115_605_504
    assert nbytes == 4 * (100_352 + 36_864 + 100_352) == 950_272
    nbytes, flops = conv_cost.forward_cost((1, 1, 29, 112, 112), (64, 1, 5, 7, 7),
                                           (1, 64, 29, 56, 56))
    assert flops == 2 * (64 * 29 * 56 * 56) * 245 == 2_852_003_840
    assert nbytes == 4 * (363_776 + 15_680 + 5_820_416) == 24_799_488
    # the stem's backward takes the weight gradient alone; a trunk conv both
    assert conv_cost.backward_cost((1, 64, 29, 56, 56), (1, 1, 29, 112, 112),
                                   (64, 1, 5, 7, 7), data=False) == (
        4 * (5_820_416 + 363_776 + 15_680), 2_852_003_840)
    assert conv_cost.backward_cost((2, 64, 28, 28), (2, 64, 28, 28), (64, 64, 3, 3)) == (
        4 * (100_352 + 2 * 100_352 + 2 * 36_864), 2 * 115_605_504)
    assert conv_cost.out_size(112, 7, 2, 3) == 56 and conv_cost.out_size(7, 3, 2, 1) == 4


def test_conv_records_read_a_profile_with_shapes():
    w3 = torch.randn(4, 1, 5, 7, 7, requires_grad=True)
    w2 = torch.randn(8, 4, 3, 3, requires_grad=True)
    x = torch.randn(2, 1, 5, 16, 16)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        y = torch.nn.functional.conv3d(x, w3, stride=(1, 2, 2), padding=(2, 3, 3))
        z = torch.nn.functional.conv2d(y.transpose(1, 2).reshape(10, 4, 8, 8), w2, stride=2,
                                       padding=1)
        z.sum().backward()
    got = sorted(r[:2] for r in conv_cost.conv_records(prof))
    want = sorted([conv_cost.forward_cost((2, 1, 5, 16, 16), (4, 1, 5, 7, 7), (2, 4, 5, 8, 8)),
                   conv_cost.forward_cost((10, 4, 8, 8), (8, 4, 3, 3), (10, 8, 4, 4)),
                   conv_cost.backward_cost((10, 8, 4, 4), (10, 4, 8, 8), (8, 4, 3, 3)),
                   conv_cost.backward_cost((2, 4, 5, 8, 8), (2, 1, 5, 16, 16),
                                           (4, 1, 5, 7, 7), data=False)])
    assert got == want
    assert conv_cost.roofline([(4e6, 0, 1e-6), None]) is None
    assert conv_cost.roofline([(3.35e6, 0.0, 2e-6)]) == pytest.approx(50.0)


def test_the_front_end_costs_a_gigaflop_and_a_half_and_more_a_frame():
    cfg = _config()
    convs = conv_cost.frontend_convs(cfg["model"]["streams"][0], [112, 112])
    assert len(convs) == 36 and convs[-1][2] == (1, 512, 4, 4)
    macs = [conv_cost.forward_cost(*c)[1] // 2 for c in convs]
    assert macs[0] == 64 * 56 * 56 * 245 == 49_172_480
    assert sum(macs) == 984_633_344
    lstm = 2 * 2 * (2 * 512 * 1024 + 2 * 256 * 1024)
    assert conv_cost.frontend_model_flops(cfg) == 2 * sum(macs) + lstm + 2 * 512 * 500
    assert conv_cost.frontend_model_flops(
        {"model": {"streams": [{"name": "raw"}], "lstm_size": 8, "agg_layers": 1}}) is None


def test_the_new_readers_read_nothing_untraced_or_off_the_card():
    run = drive.Run("train", _config(), {"trace_steps": 4}, CPU, traced=True)
    run.convs, run.window_s, run.valid_frames = [(1.0, 1.0, 1.0)], 1.0, 10
    for name in NEW_METRICS:
        assert spec.metric_reader(name)(run) is None
    run.traced, run.device = False, torch.device("cuda", 0)
    for name in NEW_METRICS:
        assert spec.metric_reader(name)(run) is None


def _tiny_root(root):
    os.makedirs(os.path.join(root, "avsr_bench", "configs"))
    for d in ("traffic", "limits"):
        os.makedirs(os.path.join(root, "avsr_bench", d))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [dict(c, file="avsr_bench/configs/tiny.json") for c in bench["configs"]
                        if c["name"] == "resnet34-blstm-lrw"]
    bench["workloads"] = [dict(w, traffic="tiny") for w in bench["workloads"]
                          if w["name"] == CELL]
    files = {"BENCHMARK.json": bench, "avsr_bench/configs/tiny.json": tiny_config(),
             "avsr_bench/traffic/tiny.json": TINY_TRAFFIC,
             f"avsr_bench/limits/{CELL}.json": TINY_LIMITS}
    for path, obj in files.items():
        with open(os.path.join(root, path), "w") as f:
            json.dump(obj, f)
    return root


@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_run_of_the_driver_is_correct(tmp_path, traced):
    torch.set_num_threads(2)
    root = _tiny_root(str(tmp_path))
    cell = spec.load_cell(CELL, root)
    code, out = report.execute(cell, root, SEED, 0.5, traced, time.perf_counter(), device=CPU)
    assert code == 0 and out["correct"], out
    assert out["attempted"] >= 1 and out["failed"] == 0
    if not traced:
        assert set(out["metrics"]) == {"train_utt_per_s", "setup_s"}
    else:
        assert {"busy_s", "window_s"} <= set(out["device"])


def test_a_tiny_run_that_leaves_the_running_statistics_unmerged_fails_state_gap(
        tmp_path, monkeypatch):
    """The running statistics have no gradient, and a training forward
    normalises with the batch's own, so a merge left out moves no loss,
    gradient or change: ``state_gap`` alone fails."""
    from ip_avsr_torch.train import trainer

    torch.set_num_threads(2)
    merge = trainer.merge_bn_state
    monkeypatch.setattr(trainer, "merge_bn_state",
                        lambda params, aux: merge(params, {"bn_state": aux["bn_state"]}))
    root = _tiny_root(str(tmp_path))
    cell = spec.load_cell(CELL, root)
    code, out = report.execute(cell, root, SEED, 0.1, False, time.perf_counter(), device=CPU)
    assert code == 0 and not out["correct"], out
    failed = {k for k, c in out["checks"].items() if not c["value"] <= c["limit"]}
    assert failed == {"state_gap"}, out["checks"]


@pytest.mark.cuda
def test_published_widths_score_through_the_pipelined_server_as_the_reference(card):
    """B = 16 at the published widths, TF32 off: the served per-frame
    probabilities within 1e-4 of the reference's log-probabilities (cuDNN's
    float32 algorithms differ between the two; the reference's convolutions
    and products rounded to bf16 move them by far more), the BLSTM's four
    recurrences of each request on the kernel (row 1)."""
    from ip_avsr_torch import serve
    from ip_avsr_torch.ops.kernels import lstm as lstm_kernels

    cfg = _config()
    drive.set_precision(cfg)
    params = DRIVER.make_weights(cfg["model"], SEED, card)
    frames = DRIVER.frames_pool(cfg, 16, SEED, card)
    mask = np.ones((16, 29), np.float32)
    server = serve.PipelinedServer(params, drive.adenet_config(cfg["model"]), vote=False,
                                   depth=2, device=card)
    before = lstm_kernels.lstm_recurrence.launches
    got = np.concatenate(list(server.map([([frames[i:i + 8]], mask[i:i + 8])
                                          for i in (0, 8)])))
    assert lstm_kernels.lstm_recurrence.launches - before == 2 * 4
    x, m = torch.as_tensor(frames, device=card), torch.as_tensor(mask, device=card)
    with torch.no_grad(), bench_ref.precision(False):
        want = bench_ref.forward(cfg["model"], params, x, m)[0]
    gap = float((torch.as_tensor(got, device=card).log() - want.log()).abs().max())
    conv, mm = bench_ref.conv, bench_ref.matmul
    r = lambda t: t.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    try:
        bench_ref.conv = lambda a, w, stride=1, padding=0: conv(r(a), r(w), stride, padding)
        bench_ref.matmul = lambda a, b: mm(r(a), r(b))
        with torch.no_grad(), bench_ref.precision(False):
            rounded = bench_ref.forward(cfg["model"], params, x, m)[0]
    finally:
        bench_ref.conv, bench_ref.matmul = conv, mm
    assert gap <= 1e-4 < float((rounded.log() - want.log()).abs().max()), gap
