"""The port's deployment export (ip_avsr_torch.export) against the JAX
package's (ip_avsr_tpu.export), on the CPU.

The cases of tests/test_export.py that apply to the port: the same configs
built by both packages' zoos, the JAX parameters carried across by
``bridge.params_from_jax``, inputs from a numpy seed.  The port's batch
artifacts are held to the JAX live server within 1e-5 and to the port's own
live server exactly (the same operators on the same device), its streaming
artifact to the JAX streaming artifact within 2e-5, its bf16-weight
artifact to the JAX bf16-weight artifact within :data:`BF16_TOL`.  Also:
the time floor, pinned shapes, input validation, the format refusals, the
pipelined and bucketed servers over an artifact, meta.json against the JAX
one, a subprocess that loads an artifact without JAX or the model code, and
the exported graph (the ``ip_avsr::`` operators, no autograd Function, no
tensor left on the CPU).
"""

import dataclasses
import json
import os
import subprocess
import sys
import zipfile

import jax
import numpy as np
import pytest
import torch

from ip_avsr_tpu import export as jexport, serve as jserve
from ip_avsr_tpu.models import adenet as jadenet, zoo as jzoo
from ip_avsr_torch import bridge, export as texport, serve as tserve
from ip_avsr_torch.models import zoo as tzoo

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=0)
STREAM_TOL = dict(atol=2e-5, rtol=0)
EXACT = dict(atol=0, rtol=0)
# the port's bf16-weight artifact against the JAX package's.  Both round
# each weight to bf16 once and promote them against float32 activations in
# every product but the recurrent one, where both also round h_{t-1} to
# bf16 (ip_avsr_tpu/ops/lstm.py:241, ``hid_prev.astype(w_hid_mm.dtype)``;
# the port keeps the bf16 w_hid and runs the recurrence kernels' bf16
# instantiations).  Measured on the CPU at these widths: 6e-8 between the
# two bf16 artifacts, 5.2e-4 from either to the f32 server; so 1e-6 (it
# was 2e-4 while the port's recurrence kept h in float32)
BF16_TOL = dict(atol=1e-6, rtol=0)


def _cfgs(build, *args, **kw):
    """The same builder of both zoos, with the same replaced fields."""
    fields = kw.pop("replace", {})
    return [dataclasses.replace(getattr(z, build)(*args, **kw), **fields)
            for z in (jzoo, tzoo)]


def _deltanet(**fields):
    return _cfgs("deltanet_majority_vote", 12, [10, 6], ["sigmoid", "linear"], lstm_size=8,
                 window=3, output_classes=4, replace=fields)


def _params(jcfg, seed=0):
    jp = jadenet.init_adenet_params(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _ragged(rng, B, T):
    return (np.arange(T)[None] < rng.randint(1, T + 1, (B, 1))).astype(np.float32)


@pytest.fixture(scope="module")
def deltanet(tmp_path_factory):
    """The tiny deltanet, its parameters in both packages, and the port's
    symbolic artifact of it, loaded on the CPU."""
    jcfg, tcfg = _deltanet()
    jp, tp = _params(jcfg)
    path = str(tmp_path_factory.mktemp("export") / "m.ipax")
    texport.save_artifact(path, tp, tcfg, labels=list("ABCD"), device="cpu")
    return jcfg, tcfg, jp, tp, path, texport.load_server(path, device="cpu")


@pytest.mark.parametrize("B,T", [(1, 7), (5, 29), (3, 3)])
def test_symbolic_artifact_matches_the_live_servers(deltanet, B, T):
    jcfg, tcfg, jp, tp, _, srv = deltanet
    rng = np.random.RandomState(B * 100 + T)
    x = rng.randn(B, T, 12).astype(np.float32)
    mask = _ragged(rng, B, T)
    got = srv([x], mask).numpy()
    np.testing.assert_allclose(got, np.asarray(jserve.make_server(jp, jcfg)([x], mask)), **TOL)
    live = tserve.make_server(tp, tcfg, device="cpu")([x], mask).numpy()
    np.testing.assert_allclose(got, live, **EXACT)
    assert srv.labels == list("ABCD")
    assert srv.config == tcfg  # the config round-trips through meta.json
    assert srv.output_classes == 4 and srv.batch is None and srv.time is None


def test_symbolic_time_floor_is_the_delta_window(deltanet):
    """T below the window (3) is refused at call time; T = 3 serves."""
    *_, srv = deltanet
    with pytest.raises(Exception, match="3"):
        srv([np.zeros((1, 2, 12), np.float32)], np.ones((1, 2), np.float32))
    assert srv([np.zeros((1, 3, 12), np.float32)], np.ones((1, 3), np.float32)).shape == (1, 4)


def test_time_floor_is_one_without_deltas_or_min_time_when_given():
    _, tcfg = _deltanet()
    assert texport._time_floor(tcfg, None) == 3
    assert texport._time_floor(tcfg, 5) == 5
    nodelta = dataclasses.replace(tcfg, streams=[dataclasses.replace(s, use_delta=False)
                                                 for s in tcfg.streams])
    assert texport._time_floor(nodelta, None) == 1


@pytest.mark.parametrize("min_time,use_delta,floor", [(None, True, 3), (None, False, 3),
                                                     (5, True, 5), (2, True, 3)])
def test_raw_server_time_floor_is_at_least_three(min_time, use_delta, floor):
    """The raw server's frame differences have T - 1 frames, which a traced
    program must never see as 1."""
    _, tcfg = _trimodal(window=2)
    tcfg = dataclasses.replace(tcfg, streams=[dataclasses.replace(s, use_delta=use_delta)
                                              for s in tcfg.streams])
    assert texport._time_floor(tcfg, min_time, raw=True) == floor


def test_artifact_uploads_strided_requests_as_contiguous_rows(deltanet):
    """A dense request with swapped axes (a time-major array viewed as
    (B, T, D)), numpy or a tensor, scores as its contiguous copy does: the
    operators' CUDA implementations read contiguous rows and an exported
    graph holds no copy of its own."""
    *_, srv = deltanet
    rng = np.random.RandomState(11)
    x = np.ascontiguousarray(rng.randn(9, 4, 12).astype(np.float32)).swapaxes(0, 1)
    m = np.ascontiguousarray(_ragged(rng, 4, 9).T).T
    assert not x.flags.c_contiguous and not m.flags.c_contiguous
    want = srv([np.ascontiguousarray(x)], np.ascontiguousarray(m)).numpy()
    for xs, mask in (([x], m), ([torch.from_numpy(x)], torch.from_numpy(m))):
        np.testing.assert_allclose(srv(xs, mask).numpy(), want, **EXACT)
    up = srv._upload(torch.from_numpy(x))
    assert up.is_contiguous() and up.dtype == torch.float32


def test_fixed_shape_artifact_refuses_other_shapes(deltanet, tmp_path):
    jcfg, tcfg, jp, tp, *_ = deltanet
    path = str(tmp_path / "mf.ipax")
    texport.save_artifact(path, tp, tcfg, batch=4, time=16, device="cpu")
    srv = texport.load_server(path, device="cpu")
    rng = np.random.RandomState(1)
    x = rng.randn(4, 16, 12).astype(np.float32)
    m = np.ones((4, 16), np.float32)
    np.testing.assert_allclose(srv([x], m).numpy(),
                               np.asarray(jserve.make_server(jp, jcfg)([x], m)), **TOL)
    assert srv.batch == 4 and srv.time == 16
    for B, T in ((3, 16), (4, 15)):
        with pytest.raises(Exception):
            srv([x[:B, :T]], m[:B, :T])


def _trimodal(window=3):
    enc = dict(encoder_shapes=(16, 12, 6), encoder_nonlinearities=("sigmoid", "sigmoid",
                                                                     "linear"))
    out = []
    for zoo in (jzoo, tzoo):
        cfg = zoo.adenet_v3(24, 8, 24, lstm_size=6, window=window, output_classes=5)
        streams = [dataclasses.replace(s, dropout=0.0, **(enc if s.encoder_shapes else {}))
                   for s in cfg.streams]
        out.append(dataclasses.replace(cfg, streams=streams, agg_dropout=0.0))
    return out


def test_trimodal_raw_artifact_matches_jax(tmp_path):
    """Raw-pixel export: the diff, DCT and normalisations (train-split DCT
    statistics as buffers) are inside the artifact; uint8 pixels in."""
    jcfg, tcfg = _trimodal()
    jp, tp = _params(jcfg)
    rng = np.random.RandomState(3)
    tri = dict(image_shape=(4, 6), dct_coeffs=8,
               dct_mean=rng.randn(8).astype(np.float32),
               dct_std=rng.rand(8).astype(np.float32) + 0.5)
    path = str(tmp_path / "tri.ipax")
    texport.save_artifact(path, tp, tcfg, trimodal=tri, device="cpu")
    srv = texport.load_server(path, device="cpu")
    assert srv.input_kind == "raw" and srv.stream_dims == [24]
    jlive = jserve.make_trimodal_server(jp, jcfg, **tri)
    tlive = tserve.make_trimodal_server(tp, tcfg, device="cpu", **tri)
    for B, T in ((3, 7), (1, 12)):
        raw = rng.randint(0, 256, (B, T, 24)).astype(np.uint8)
        m = _ragged(rng, B, T)
        got = srv(raw, m).numpy()
        np.testing.assert_allclose(got, np.asarray(jlive(raw.astype(np.float32), m)), **TOL)
        np.testing.assert_allclose(got, tlive(raw, m).numpy(), **EXACT)
    with pytest.raises(ValueError, match="raw pixel dim"):
        srv(np.zeros((1, 4, 25), np.float32), np.ones((1, 4), np.float32))


def test_trimodal_raw_artifact_with_a_short_window_serves_from_three_frames(tmp_path):
    """Window 2: the raw artifact serves T = 3 as the JAX live server does
    and refuses T = 2 (its floor, :func:`_time_floor` with ``raw``)."""
    jcfg, tcfg = _trimodal(window=2)
    jp, tp = _params(jcfg, seed=4)
    tri = dict(image_shape=(4, 6), dct_coeffs=8)
    path = str(tmp_path / "tri2.ipax")
    texport.save_artifact(path, tp, tcfg, trimodal=tri, device="cpu")
    srv = texport.load_server(path, device="cpu")
    rng = np.random.RandomState(5)
    raw = rng.randint(0, 256, (2, 3, 24)).astype(np.uint8)
    m = np.ones((2, 3), np.float32)
    np.testing.assert_allclose(srv(raw, m).numpy(), np.asarray(
        jserve.make_trimodal_server(jp, jcfg, **tri)(raw.astype(np.float32), m)), **TOL)
    with pytest.raises(Exception, match="3"):
        srv(raw[:, :2], m[:, :2])


FAMILIES = {
    "adenet_v3": lambda: _trimodal(),
    "oulu_4stream_peephole_adasum": lambda: _cfgs(
        "adenet_nstream", [20, 20, 9, 6],
        [(("sigmoid", "rectify", "linear"), (16, 12, 6)),
         (("rectify", "sigmoid", "linear"), (16, 12, 6)), None, None],
        lstm_size=8, window=3, output_classes=10, fusiontype="adasum", use_peepholes=True),
    "adenet_v2_4": lambda: _cfgs("adenet_v2_4", 12, 12, lstm_size=6, window=3,
                                 output_classes=4),
    "lstm_classifier_baseline": lambda: _cfgs("lstm_classifier_baseline", 12, lstm_size=8,
                                              output_classes=4),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_export_across_model_families(tmp_path, name):
    """Peepholes, adasum, a forward-only per-step head, a last-step head:
    each family's feature-stream artifact against the JAX live server."""
    jcfg, tcfg = FAMILIES[name]()
    jp, tp = _params(jcfg, seed=2)
    path = str(tmp_path / f"{name}.ipax")
    texport.save_artifact(path, tp, tcfg, device="cpu")
    srv = texport.load_server(path, device="cpu")
    rng = np.random.RandomState(0)
    T = max(tcfg.window, 8)
    streams = [rng.randn(3, T, s.input_dim).astype(np.float32) for s in tcfg.streams]
    mask = (np.arange(T)[None] < rng.randint(2, T + 1, (3, 1))).astype(np.float32)
    np.testing.assert_allclose(srv(streams, mask).numpy(),
                               np.asarray(jserve.make_server(jp, jcfg)(streams, mask)), **TOL)


def test_artifact_input_validation(deltanet):
    *_, srv = deltanet
    m = np.ones((1, 8), np.float32)
    with pytest.raises(ValueError, match="streams"):
        srv([np.zeros((1, 8, 12), np.float32)] * 2, m)
    with pytest.raises(ValueError, match="stream dim"):
        srv([np.zeros((1, 8, 13), np.float32)], m)


def test_load_refuses_non_artifacts_and_jax_artifacts(deltanet, tmp_path):
    jcfg, _, jp, *_ = deltanet
    bogus = tmp_path / "b.ipax"
    with zipfile.ZipFile(bogus, "w") as z:
        z.writestr("meta.json", "{\"format\": \"something-else\"}")
    with pytest.raises(ValueError, match="format"):
        texport.load_server(str(bogus), device="cpu")
    jax_path = str(tmp_path / "jax.ipax")
    jexport.save_artifact(jax_path, jp, jcfg)
    with pytest.raises(ValueError, match="ip_avsr_tpu"):
        texport.load_server(jax_path, device="cpu")
    with pytest.raises(ValueError, match="ip_avsr_tpu"):
        texport.load_streaming_artifact(jax_path, device="cpu")


def test_jax_loader_refuses_the_ports_artifact(deltanet):
    path = deltanet[4]
    with pytest.raises(ValueError, match="format"):
        jexport.load_server(path)


def test_resolved_platforms_and_the_loader_honours_them(deltanet, tmp_path):
    assert texport.resolved_platforms(None) == ["cpu", "cuda"]
    assert texport.resolved_platforms(("cuda",)) == ["cuda"]
    for bad in (["tpu"], ["cpu", "gpu"], []):
        with pytest.raises(ValueError, match="platforms"):
            texport.resolved_platforms(bad)
    _, tcfg, _, tp, *_ = deltanet
    path = str(tmp_path / "cuda_only.ipax")
    texport.save_artifact(path, tp, tcfg, platforms=["cuda"], device="cpu")
    with pytest.raises(ValueError, match="exported for"):
        texport.load_server(path, device="cpu")


def test_pipelined_server_accepts_artifact(deltanet):
    *_, srv = deltanet
    pipe = tserve.PipelinedServer(serve_fn=srv, depth=3, device="cpu")
    rng = np.random.RandomState(0)
    reqs = [([rng.randn(1, 9, 12).astype(np.float32)], np.ones((1, 9), np.float32))
            for _ in range(7)]
    got = list(pipe.map(iter(reqs)))
    assert len(got) == 7
    for g, (s, m) in zip(got, reqs):
        np.testing.assert_allclose(g, srv(s, m).numpy(), **EXACT)


def test_bucketed_server_wraps_artifact(deltanet, tmp_path):
    jcfg, tcfg, jp, tp, *_ = deltanet
    path = str(tmp_path / "ps.ipax")
    texport.save_artifact(path, tp, tcfg, vote=False, device="cpu")
    art = texport.load_server(path, device="cpu")
    buckets = dict(batch_buckets=(2, 4), time_buckets=(8, 16))
    live = jserve.make_bucketed_server(jp, jcfg, **buckets)
    wrapped = tserve.make_bucketed_server(serve_fn=art, output_classes=tcfg.output_classes,
                                          device="cpu", **buckets)
    rng = np.random.RandomState(0)
    for B, T in ((1, 5), (3, 11), (6, 8)):
        x = rng.randn(B, T, 12).astype(np.float32)
        lens = rng.randint(3, T + 1, B)
        np.testing.assert_allclose(wrapped([x], lens).numpy(), np.asarray(live([x], lens)),
                                   **TOL)


@pytest.fixture(scope="module")
def streaming(tmp_path_factory):
    jcfg, tcfg = _deltanet(agg_bidirectional=False)
    jp, tp = _params(jcfg)
    tmp = tmp_path_factory.mktemp("stream")
    tpath, jpath = str(tmp / "t.ipax"), str(tmp / "j.ipax")
    texport.save_streaming_artifact(tpath, tp, tcfg, device="cpu")
    jexport.save_streaming_artifact(jpath, jp, jcfg)
    return jcfg, tcfg, jp, tp, tpath, jpath


def _feed(sess, x, splits):
    got, s = [], 0
    for n in splits:
        got += list(sess.feed([x[:, s:s + n]]))
        s += n
    tail, result = sess.finalize()
    return (np.concatenate([np.stack(got, axis=1), tail], axis=1) if got else tail), result


@pytest.mark.parametrize("splits", [[1, 3, 2, 7, 4, 4], [9]], ids=["chunks", "one"])
def test_streaming_artifact_round_trip_matches_jax(streaming, splits):
    """The revived session against the JAX revived session (2e-5) and the
    port's one-shot server (1e-6: chunked products sum in another order, as
    tests/test_torch_streaming.py holds the live session); a second session
    of the same artifact starts fresh."""
    jcfg, tcfg, jp, tp, tpath, jpath = streaming
    T = sum(splits)
    x = np.random.RandomState(T).randn(1, T, 12).astype(np.float32)
    art = texport.load_streaming_artifact(tpath, device="cpu")
    for _ in range(2):
        got, pred = _feed(art.new_session(), x, splits)
        want, jpred = _feed(jexport.load_streaming_session(jpath), x, splits)
        np.testing.assert_allclose(got, want, **STREAM_TOL)
        np.testing.assert_array_equal(pred, jpred)
        live = tserve.make_server(tp, tcfg, vote=False, device="cpu")
        np.testing.assert_allclose(got, live([x], np.ones((1, T), np.float32)).numpy(),
                                   atol=1e-6, rtol=0)


def test_streaming_session_loads_in_one_call(streaming):
    tpath = streaming[4]
    sess = texport.load_streaming_session(tpath, device="cpu")
    assert sess.feed([np.zeros((1, 7, 12), np.float32)]) and sess.predict().shape == (1,)


def test_streaming_loaders_refuse_mismatches(streaming, deltanet, tmp_path):
    """Each loader refuses the other kind of artifact, and a state
    structure that differs from the one the config rebuilds is refused."""
    tpath = streaming[4]
    with pytest.raises(ValueError, match="streaming"):
        texport.load_streaming_session(deltanet[4], device="cpu")
    with pytest.raises(ValueError, match="load_streaming_session"):
        texport.load_server(tpath, device="cpu")
    bad = str(tmp_path / "bad.ipax")
    with zipfile.ZipFile(tpath) as src, zipfile.ZipFile(bad, "w") as dst:
        for item in src.namelist():
            data = src.read(item)
            if item == "meta.json":
                meta = json.loads(data)
                meta["config"]["agg_layers"] = 2
                data = json.dumps(meta)
            dst.writestr(item, data)
    with pytest.raises(ValueError, match="state structure mismatch"):
        texport.load_streaming_artifact(bad, device="cpu")


def test_weights_dtype_bf16_matches_the_jax_bf16_artifact(deltanet, tmp_path):
    """bf16 weights: the port's artifact against the JAX package's bf16
    artifact within BF16_TOL, argmax-stable against the f32 server, and
    smaller than the f32 artifact."""
    jcfg, tcfg, jp, tp, *_ = deltanet
    paths = {k: str(tmp_path / f"{k}.ipax") for k in ("f32", "bf16", "jax")}
    texport.save_artifact(paths["f32"], tp, tcfg, vote=False, device="cpu")
    texport.save_artifact(paths["bf16"], tp, tcfg, vote=False, weights_dtype="bfloat16",
                          device="cpu")
    jexport.save_artifact(paths["jax"], jp, jcfg, vote=False, weights_dtype="bfloat16")
    assert os.path.getsize(paths["bf16"]) < os.path.getsize(paths["f32"])
    rng = np.random.RandomState(0)
    x = rng.randn(4, 12, 12).astype(np.float32)
    m = np.ones((4, 12), np.float32)
    got = texport.load_server(paths["bf16"], device="cpu")([x], m).numpy()
    want = np.asarray(jexport.load_server(paths["jax"])([x], m))
    np.testing.assert_allclose(got, want, **BF16_TOL)
    f32 = tserve.make_server(tp, tcfg, vote=False, device="cpu")([x], m).numpy()
    assert np.abs(got - want).max() < np.abs(got - f32).max()
    np.testing.assert_allclose(got, f32, atol=5e-2)
    np.testing.assert_array_equal(got.argmax(-1), f32.argmax(-1))
    meta = json.loads(zipfile.ZipFile(paths["bf16"]).read("meta.json"))
    assert meta["entries"][0]["weights_dtype"] == "bfloat16"


def _meta(path):
    return json.loads(zipfile.ZipFile(path).read("meta.json"))


def test_meta_json_matches_the_jax_one_field_for_field(deltanet, streaming, tmp_path):
    """Every field of the JAX meta.json, with two stated differences: the
    format tag and torch_version for jax_version; the entries' blob names
    and platforms name the port's files and devices."""
    jcfg, tcfg, jp, _, tpath, *_ = deltanet
    jpath = str(tmp_path / "j.ipax")
    jexport.save_artifact(jpath, jp, jcfg, labels=list("ABCD"))
    for t, j in ((_meta(tpath), _meta(jpath)), (_meta(streaming[4]), _meta(streaming[5]))):
        assert set(t) - {"torch_version"} == set(j) - {"jax_version"}
        assert t["format"] == "ipavsr-torch-export/1" and j["format"] == "ipavsr-export/1"
        assert t["torch_version"] == torch.__version__
        assert t["config"] == j["config"] and t["labels"] == j["labels"]
        assert [e["name"] for e in t["entries"]] == [e["name"] for e in j["entries"]]
        for te, je in zip(t["entries"], j["entries"]):
            assert set(te) == set(je)
            assert {k: v for k, v in te.items() if k not in ("blob", "platforms")} == \
                {k: v for k, v in je.items() if k not in ("blob", "platforms")}
            assert te["blob"].endswith(".pt2")
        if "streaming" in j:
            same = {k for k in j["streaming"] if k not in ("platforms", "state_treedef")}
            assert {k: t["streaming"][k] for k in same} == {k: j["streaming"][k] for k in same}
            assert set(t["streaming"]) == set(j["streaming"])


def test_artifact_loads_without_jax_or_the_model_code(deltanet, tmp_path):
    """A fresh process loads and serves the artifact with torch and
    ip_avsr_torch.export only: no jax, no models, no train."""
    *_, path, srv = deltanet
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 12).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    want = srv([x], np.ones((2, 9), np.float32)).numpy()
    script = f"""
import sys
import numpy as np
import torch
from ip_avsr_torch import export
srv = export.load_server({path!r}, device="cpu")
out = srv([np.load({str(tmp_path / 'x.npy')!r})], np.ones((2, 9), np.float32))
np.save({str(tmp_path / 'out.npy')!r}, out.numpy())
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "ip_avsr_tpu",
       "ip_avsr_torch.models", "ip_avsr_torch.train"))]
assert not bad, bad
"""
    env = {**os.environ, "PYTHONPATH": ROOT}
    subprocess.run([sys.executable, "-c", script], check=True, cwd=str(tmp_path), env=env)
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"), want, **EXACT)


def test_exported_graph_holds_the_ops_and_no_autograd_function(deltanet):
    """The program's graph: the ip_avsr:: operators (2 recurrences, 1
    delta group) as opaque nodes, no autograd Function and no parameter
    that requires grad (so lstm_forward took its inference branch)."""
    import io

    path = deltanet[4]
    with zipfile.ZipFile(path) as z:
        program = torch.export.load(io.BytesIO(z.read("entries/serve.pt2")))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("ip_avsr.lstm_recurrence.default") == 2
    assert targets.count("ip_avsr.delta_group.default") == 1
    assert not [t for t in targets if "autograd" in t or "higher_order" in t]
    assert not any(b.requires_grad for b in program.state_dict.values())


def test_exported_program_makes_no_tensor_on_the_cpu(deltanet):
    """Moved to the meta device, the program runs on meta inputs: a tensor
    the traced path made on the CPU (a bare arange or ones) would meet a
    meta tensor there and fail."""
    import io

    path = deltanet[4]
    with zipfile.ZipFile(path) as z:
        program = torch.export.load(io.BytesIO(z.read("entries/serve.pt2")))
    module = torch.export.passes.move_to_device_pass(program, "meta").module()
    out = module([torch.zeros(3, 8, 12, device="meta")], torch.ones(3, 8, device="meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (3, 4)
