"""Fixtures of the benchmark's tests: a checkout root of tiny cells (the
flagship's and the 4-stream model's layouts at small widths) that the
harness runs on the CPU, and the card, looked for inside a fixture."""

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skipped without one")


def _read(path):
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def tiny_config(name: str) -> dict:
    """The configuration file ``name`` at small widths (same layout)."""
    cfg = copy.deepcopy(_read(f"avsr_bench/configs/{name}.json"))
    m = cfg["model"]
    for s in m["streams"]:
        if s["encoder_shapes"]:
            s["encoder_shapes"] = [16, 12, 8, 4]
        if s.get("lstm_size"):
            s["lstm_size"] = 6
    m["lstm_size"] = 6 if m["lstm_size"] == 250 and m["fusiontype"] == "adasum" else 3
    if m.get("agg_size"):
        m["agg_size"] = 6
    m["window"] = 2
    if cfg["input"]["kind"] == "trimodal_raw":
        cfg["input"].update(image_shape=[4, 6], dct_coeffs=5, frames=7)
        m["streams"][0]["input_dim"] = m["streams"][2]["input_dim"] = 24
        m["streams"][1]["input_dim"] = 5
    else:
        cfg["input"]["frames"] = 7
        for s, d in zip(m["streams"], (24, 24, 5, 3)):
            s["input_dim"] = d
    return cfg


TINY_TRAFFIC = {
    "score-tiny": {"driver": "score", "batch": 5, "min_len": 2, "max_len": 7, "pool_batches": 3,
                   "depth": 2, "stack": 1, "warmup_requests": 2, "trace_requests": 4,
                   "check_requests": 2},
    "train-tiny": {"driver": "train", "batch_per_rank": 4, "ranks": 1, "lr": 0.01, "min_len": 2,
                   "max_len": 7, "pool_batches": 3, "warmup_steps": 1, "trace_steps": 2},
}
TINY_CELLS = [
    ("v3-score", "v3", "score-tiny", 1),
    ("v3-train", "v3", "train-tiny", 1),
    ("4s-train", "4s", "train-tiny", 1),
    ("v3-train-data2", "v3", "train-tiny-data2", 2),
]
TINY_LIMITS = {"score": {"score_gap": 1e-4},
               "train": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}}


def write_root(root, extra_cells=(), extra_traffic=None, extra_limits=None):
    """A checkout root at ``root`` holding a BENCHMARK.json of the tiny
    cells and their files (the real metric readers are used), with
    ``extra_cells`` and the traffic files ``extra_traffic`` besides, and the
    limits of a driver of ``extra_limits`` ({driver: limits})."""
    bench = _read("BENCHMARK.json")
    b = os.path.join(root, "avsr_bench")
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(b, d), exist_ok=True)
    configs = {"v3": tiny_config("adenet_v3-oulu-trimodal"),
               "4s": tiny_config("adenet-oulu-4stream")}
    for name, cfg in configs.items():
        with open(os.path.join(b, "configs", f"{name}.json"), "w") as f:
            json.dump(cfg, f)
    traffic = dict(TINY_TRAFFIC)
    traffic["train-tiny-data2"] = dict(TINY_TRAFFIC["train-tiny"], ranks=2)
    traffic.update(extra_traffic or {})
    for name, t in traffic.items():
        with open(os.path.join(b, "traffic", f"{name}.json"), "w") as f:
            json.dump(t, f)
    cells = list(TINY_CELLS) + list(extra_cells)
    limits = dict(TINY_LIMITS, **(extra_limits or {}))
    for name, _, tr, _ in cells:
        with open(os.path.join(b, "limits", f"{name}.json"), "w") as f:
            json.dump(limits[traffic[tr]["driver"]], f)
    bench["configs"] = [{"name": n, "source": "test", "file": f"avsr_bench/configs/{n}.json",
                         "reduced": [], "why": "test"} for n in configs]
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": k, "why": "test"}
                          for n, c, t, k in cells]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return str(write_root(tmp_path))


@pytest.fixture
def card():
    """The first CUDA device; the test is skipped without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip)")
    return torch.device("cuda", 0)
