"""The harness driven on the CPU at small widths (its look for a card
skipped): whole runs that come out correct, runs with the timed path broken
underneath that come out not correct, a new configuration, traffic mix and
driver picked up as files alone, the JAX guard, and BENCHMARK.json against
the benchmark's contract."""

import json
import os
import re
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from avsr_bench.harness import drive, report, spec
from conftest import ROOT, write_root

CPU = torch.device("cpu")
SEED = 2**31 + 101
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _run(root, name, traced=False, seconds=0.5):
    cell = spec.load_cell(name, root)
    return report.execute(cell, root, SEED, seconds, traced, time.perf_counter(), device=CPU)


@pytest.mark.parametrize("name", ["v3-score", "v3-train", "4s-train"])
@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_run_is_correct_and_prints_the_contracts_keys(tiny_root, name, traced):
    code, out = _run(tiny_root, name, traced)
    assert code == 0 and out["correct"], out
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks" and out["failed"] == 0
    assert out["device"]["count"] == 1
    if traced:
        assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
    else:
        kind = "score" if "score" in name else "train"
        assert set(out["metrics"]) == {f"{kind}_utt_per_s", "setup_s"}
        assert all(v["value"] > 0 for v in out["metrics"].values())


def _scores_altered(serve_fn):
    def serve(raw, mask):
        out = serve_fn(raw, mask).clone()
        out[0] = out[0].flip(0)
        return out
    return serve


def _half_of_the_scores(serve_fn):
    def serve(raw, mask):
        half = (raw.shape[0] + 1) // 2
        out = serve_fn(raw[:half], mask[:half])
        return torch.cat([out, out])[: raw.shape[0]]
    return serve


@pytest.mark.parametrize("fault", [_scores_altered, _half_of_the_scores])
def test_a_broken_server_comes_out_not_correct(tiny_root, fault):
    cell = spec.load_cell("v3-score", tiny_root)
    run = spec.driver("score").run(cell, SEED, 0.5, False, CPU, time.perf_counter(),
                                   wrap_server=fault)
    assert not report.result(cell, run)["correct"]


def _state_unchanged(step):
    def broken(self, params, opt_state, *args):
        _, opt_state, loss = step(self, params, opt_state, *args)
        return params, opt_state, loss
    return broken


def _half_of_the_batch(step):
    def broken(self, params, opt_state, streams, y, mask, *args):
        h = y.shape[0] // 2
        return step(self, params, opt_state, [s[:h] for s in streams], y[:h], mask[:h], *args)
    return broken


@pytest.mark.parametrize("fault", [_state_unchanged, _half_of_the_batch])
@pytest.mark.parametrize("name", ["v3-train", "4s-train"])
def test_a_broken_training_step_comes_out_not_correct(tiny_root, monkeypatch, name, fault):
    from ip_avsr_torch.train.trainer import Trainer

    monkeypatch.setattr(Trainer, "train_step", fault(Trainer.train_step))
    code, out = _run(tiny_root, name)
    assert code == 0 and not out["correct"], out["checks"]


def exchange_left_out(rank, *args):
    """A rank of the two-rank cell whose gradients' all-reduce between the
    ranks is left out (each rank steps on its own rows' gradients)."""
    from ip_avsr_torch.parallel import collectives

    whole = collectives.flat_all_reduce

    def local_only(tensors, group=None):
        tensors = list(tensors)
        if len(tensors) > 2:  # the gradients and the loss's parts
            return tensors
        return whole(tensors, group)

    collectives.flat_all_reduce = local_only
    drive.rank_main(rank, *args)


def test_two_ranks_are_correct_and_without_the_exchange_are_not(tiny_root):
    code, out = _run(tiny_root, "v3-train-data2")
    assert code == 0 and out["correct"] and out["device"]["count"] == 2, out
    cell = spec.load_cell("v3-train-data2", tiny_root)
    run, ranks = drive.launch(cell, tiny_root, SEED, 0.5, False, time.perf_counter(),
                              backend="gloo", target=exchange_left_out)
    assert not report.result(cell, run, ranks)["correct"]


def test_a_new_configuration_and_traffic_are_picked_up_as_files(tmp_path):
    """A cell of a configuration and a traffic mix that are new files, named
    in BENCHMARK.json, runs with no edit to any file of the harness."""
    root = str(tmp_path)
    new = {"driver": "score", "batch": 3, "min_len": 3, "max_len": 7, "pool_batches": 2,
           "depth": 3, "stack": 2, "warmup_requests": 1, "trace_requests": 2,
           "check_requests": 2}
    write_root(root, extra_cells=[("4s-score", "4s", "score-new", 1)],
               extra_traffic={"score-new": new})
    code, out = _run(root, "4s-score")
    assert code == 0 and out["correct"] and out["metrics"]["score_utt_per_s"]["value"] > 0


NEW_DRIVER = '''"""A driver that scores as the score driver does."""
from avsr_bench.harness import spec


def run(cell, *args, **kwargs):
    return spec.driver("score").run(cell, *args, **kwargs)


def control(cell, seed, device):
    return spec.driver("score").control(cell, seed, device)
'''


def test_a_new_driver_is_picked_up_as_a_file(tmp_path, monkeypatch):
    """A traffic mix that names a driver file the harness has never seen
    runs through it, with no edit to any file of the harness."""
    root = str(tmp_path)
    new = dict(json.load(open(os.path.join(ROOT, "avsr_bench", "traffic", "score-b256.json"))),
               driver="score_again", batch=3, min_len=3, max_len=7, pool_batches=2,
               warmup_requests=1, trace_requests=2, check_requests=2)
    write_root(root, extra_cells=[("v3-score-again", "v3", "score-again", 1)],
               extra_traffic={"score-again": new},
               extra_limits={"score_again": {"score_gap": 1e-4}})
    drivers = os.path.join(root, "avsr_bench", "drivers")
    shutil.copytree(os.path.join(ROOT, "avsr_bench", "drivers"), drivers)
    with open(os.path.join(drivers, "score_again.py"), "w") as f:
        f.write(NEW_DRIVER)
    monkeypatch.setattr(spec, "BENCH_DIR", os.path.join(root, "avsr_bench"))
    code, out = _run(root, "v3-score-again")
    assert code == 0 and out["correct"] and out["metrics"]["score_utt_per_s"]["value"] > 0
    assert spec.load_cell("v3-score-again", root).driver == "score_again"


@pytest.mark.parametrize("module", ["jaxlib", "ip_avsr_tpu", "bench", "chip_smoke"])
def test_a_run_that_loaded_jax_prints_no_result(tiny_root, monkeypatch, capsys, module):
    monkeypatch.setitem(sys.modules, module, types.ModuleType(module))
    code, out = _run(tiny_root, "v3-score")
    assert code != 0 and out is None
    assert module in capsys.readouterr().err


def test_without_a_card_the_command_fails_and_prints_nothing(tmp_path):
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "avsr_bench", "run.py"),
                           "--workload", "v3-score-b256", "--seed", str(SEED), "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_the_last_lines_are_the_checks_and_the_result(capsys):
    out = {"correct": True, "checks": {"a": {"value": 1.0, "limit": 2.0}}}
    report.emit(out)
    got = capsys.readouterr()
    assert json.loads(got.out.strip().splitlines()[-1]) == out
    assert got.err.strip().splitlines()[-1] == "check a = 1.0 (limit 2.0)"


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_to_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["avsr_bench"] and b["command"] == ["python3", "avsr_bench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    cells = {w["name"]: w for w in b["workloads"]}
    assert [w["name"] for w in b["workloads"]] == ["v3-score-b256", "4s-train-b512",
                                                   "v3-train-b256"]
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    configs = {c["name"] for c in b["configs"]}
    assert configs == {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"])) and c["file"].startswith("avsr_bench/")
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names + list(cells))
    assert {m["name"] for m in b["end_to_end"]} == {"score_utt_per_s", "train_utt_per_s",
                                                    "setup_s"}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"]) and m["better"] in (
            "lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
        assert os.path.exists(os.path.join(ROOT, "avsr_bench", "metrics", f"{m['name']}.py"))
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(
            e2e[m["moves"]].get("workloads", cells))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"], ROOT)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        assert all(len(w[k]) <= 200 for k in ("why",))
        assert os.path.exists(os.path.join(ROOT, "avsr_bench", "drivers", f"{cell.driver}.py"))
    assert len(json.dumps(b)) < 64 * 1024
