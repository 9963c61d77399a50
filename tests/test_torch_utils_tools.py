"""The port's host-side tools against the JAX package's, on the same seeded
numpy inputs: ``utils/plotting`` (tiles and unit scaling bit for bit, the
``visualize_*`` family writing its PNGs and returning JAX's arrays,
``print_network``'s names and total on a tree bridged from JAX),
``utils/draw_net`` (the dot text of every INI under configs/ through both
packages' config builders, the PNG renderers, the zero-byte refusal),
``data/segmentation`` and ``utils/ffmpeg`` (HTK labels with non-digit
entries, canned ffmpeg 4 and 5 ``-show_frames`` text, ``ffprobe`` through a
stand-in executable), ``data/dct_matlab`` (bit for bit: both run the same
``scipy.fftpack`` calls), ``data/landmarking`` and ``cli.landmark`` (the
fake landmarker, in process and through the worker pool, equal CSVs; the
pool's abort on a crashed worker), ``cli.prepare_data`` (every flag: the
output ``.mat`` equal to JAX's bit for bit) and ``cli.playvid``
(``contact_sheet`` arrays, the headless sheets).  Every comparison is
exact unless it says otherwise.  Videos are written with OpenCV where a
test needs one.
"""

import contextlib
import io
import os
import stat

import jax
import numpy as np
import pytest
import scipy.io as sio
import torch

from ip_avsr_tpu.cli import landmark as jlandmark
from ip_avsr_tpu.cli import playvid as jplayvid
from ip_avsr_tpu.cli import prepare_data as jprepare
from ip_avsr_tpu.data import dct_matlab as jdct
from ip_avsr_tpu.data import landmarking as jlm
from ip_avsr_tpu.data import preprocessing as jpp
from ip_avsr_tpu.data import segmentation as jseg
from ip_avsr_tpu.io import matio as jmatio
from ip_avsr_tpu.models import adenet as jadenet
from ip_avsr_tpu.models import zoo as jzoo
from ip_avsr_tpu.train import config as jconfig
from ip_avsr_tpu.utils import draw_net as jdraw
from ip_avsr_tpu.utils import ffmpeg as jff
from ip_avsr_tpu.utils import plotting as jplot
from ip_avsr_torch import bridge
from ip_avsr_torch.cli import landmark as tlandmark
from ip_avsr_torch.cli import playvid as tplayvid
from ip_avsr_torch.cli import prepare_data as tprepare
from ip_avsr_torch.data import dct_matlab as tdct
from ip_avsr_torch.data import landmarking as tlm
from ip_avsr_torch.data import segmentation as tseg
from ip_avsr_torch.models import zoo as tzoo
from ip_avsr_torch.ops import dct as tdct_ops
from ip_avsr_torch.train import config as tconfig
from ip_avsr_torch.utils import draw_net as tdraw
from ip_avsr_torch.utils import ffmpeg as tff
from ip_avsr_torch.utils import plotting as tplot

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(f for f in os.listdir(os.path.join(ROOT, "configs")) if f.endswith(".ini"))


def _same(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# utils/plotting
# ---------------------------------------------------------------------------

def _tile_cases():
    rng = np.random.RandomState(1)
    X = rng.rand(4, 12) * 3.0 + 1.0
    return {
        "uint8": ((X, (3, 4), (2, 2)), {}),
        "raw float": ((X, (3, 4), (2, 2)), dict(scale_rows_to_unit_interval=False,
                                                output_pixel_vals=False)),
        "spacing, short X": ((X[:3], (3, 4), (2, 2)), dict(tile_spacing=(1, 2))),
        "rgba": (((X, None, None, None), (3, 4), (2, 2)), {}),
        "rgba float": (((X, X, None, None), (3, 4), (2, 2)), dict(output_pixel_vals=False)),
        "float32 rows": ((X.astype(np.float32), (3, 4), (1, 4)), dict(tile_spacing=(1, 1))),
    }


@pytest.mark.parametrize("case", list(_tile_cases()))
def test_tile_raster_images_bit_for_bit(case):
    args, kw = _tile_cases()[case]
    _same(tplot.tile_raster_images(*args, **kw), jplot.tile_raster_images(*args, **kw))


def test_scale_to_unit_interval_bit_for_bit():
    rng = np.random.RandomState(2)
    for x in (rng.randn(5, 7), rng.rand(3, 4).astype(np.float32) * 9, np.full((2, 2), 3.0)):
        _same(tplot.scale_to_unit_interval(x), jplot.scale_to_unit_interval(x))


def test_visualize_family_writes_its_files(tmp_path):
    rng = np.random.RandomState(0)
    imgs = rng.rand(9, 24)
    calls = [
        ("visualize_images", (imgs, (4, 6)), "imgs", "imgs.png"),
        ("visualize_sequence", (imgs[:5], (4, 6)), "seq", "seq.png"),
        ("visualize_layer", (rng.rand(24, 6), 4, 6, 2, 3), "filters", "filters.png"),
    ]
    for name, args, stem, written in calls:
        got = getattr(tplot, name)(*args, str(tmp_path / f"port_{stem}"))
        ref = getattr(jplot, name)(*args, str(tmp_path / f"jax_{stem}"))
        _same(got, ref)
        assert (tmp_path / f"port_{written}").stat().st_size > 0
    tplot.visualize_activations(rng.rand(24, 4), imgs[:4], (4, 6), [0, 2], str(tmp_path / "act"))
    assert (tmp_path / "act_w0.png").exists() and (tmp_path / "act_w2.png").exists()
    _same(tplot.show_image(imgs[0], (4, 6), order="f", savefilename=str(tmp_path / "one.png")),
          jplot.show_image(imgs[0], (4, 6), order="f"))
    tplot.visualize_reconstruction(imgs[:4], imgs[4:8], (4, 6), str(tmp_path / "rec.png"))
    tplot.plot_validation_cost([3, 2, 1], [3.2, 2.5, 1.8], [0.3, 0.5, 0.7],
                               savefilename=str(tmp_path / "loss.png"))
    tplot.plot_confusion_matrix_image(np.array([[5, 1], [2, 7]]), ["a", "b"],
                                      savefilename=str(tmp_path / "cm.png"))
    for name in ("one.png", "rec.png", "loss.png", "cm.png"):
        assert (tmp_path / name).stat().st_size > 0, name


def test_print_network_on_a_bridged_tree():
    cfg = jzoo.adenet_v3(12, 6, 12, lstm_size=4, window=3, output_classes=5)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jadenet.init_adenet_params(jax.random.PRNGKey(0), cfg))
    ref_lines, got_lines = [], []
    ref = jplot.print_network(tree, log_fn=ref_lines.append)
    got = tplot.print_network(bridge.params_from_jax(tree, device="cpu"),
                              log_fn=got_lines.append)
    assert got == ref > 0
    assert got_lines == ref_lines
    # numpy leaves print the same, and None is an empty subtree as in JAX
    assert tplot.print_network({"b": [np.zeros((2, 3))], "a": None}, log_fn=lambda s: None) == 6


# ---------------------------------------------------------------------------
# utils/draw_net
# ---------------------------------------------------------------------------

def _model_configs(ini):
    """The (JAX, port) AdeNetConfig of a configs/ INI: through each package's
    build_model_config, or for the legacy trimodal schema through each
    package's zoo.adenet_v3 with the INI's [data] and [models] values."""
    path = os.path.join(ROOT, "configs", ini)
    out = []
    for config, zoo in ((jconfig, jzoo), (tconfig, tzoo)):
        cp = config.load_config(path)
        streams = config.parse_streams(cp)
        if streams:
            out.append(config.build_model_config(streams, config.parse_classifier(cp)))
        else:
            h, w = (int(v) for v in cp.get("data", "imagesize").split(","))
            out.append(zoo.adenet_v3(h * w, 90, h * w, lstm_size=cp.getint("models", "lstm_size"),
                                     window=cp.getint("training", "windowsize"),
                                     output_classes=cp.getint("models", "output_classes")))
    return out


@pytest.mark.parametrize("ini", CONFIGS)
def test_config_to_dot_matches_jax(ini):
    jcfg, tcfg = _model_configs(ini)
    dot = tdraw.config_to_dot(tcfg, name=ini)
    assert dot == jdraw.config_to_dot(jcfg, name=ini)
    assert dot.startswith(f'digraph "{ini}"') and "fusion|" in dot
    assert tdraw._graph_nodes_edges(tcfg) == jdraw._graph_nodes_edges(jcfg)


def test_draw_to_file_and_notebook(tmp_path):
    jcfg, tcfg = _model_configs("oulu_4stream.ini")
    out = tdraw.draw_to_file(tcfg, str(tmp_path / "net.dot"))
    assert out.endswith(".dot")
    assert open(out).read() == jdraw.config_to_dot(jcfg)
    png = tdraw.render_png_bytes(tcfg)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    out = tdraw.draw_to_file(tcfg, str(tmp_path / "net.png"))
    assert out.endswith(".png") and open(out, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    from IPython.display import Image

    img = tdraw.draw_to_notebook(tcfg)
    assert isinstance(img, Image) and bytes(img.data[:8]) == b"\x89PNG\r\n\x1a\n"


def test_draw_to_file_leaves_no_zero_byte_png(tmp_path, monkeypatch):
    _, tcfg = _model_configs("synthetic_1stream.ini")

    def boom(*_a, **_k):
        raise ImportError("no matplotlib")

    monkeypatch.setattr(tdraw, "render_png_bytes", boom)
    target = tmp_path / "net.png"
    out = tdraw.draw_to_file(tcfg, str(target))
    assert out.endswith(".dot") and os.path.exists(out)
    assert not target.exists()


# ---------------------------------------------------------------------------
# data/segmentation and utils/ffmpeg
# ---------------------------------------------------------------------------

HTK = ("#Normal in 100ns\n"
       "1000000 3000000 zero\n"
       "3000000 4000000 sil\n"
       "5000000 8000000 three\n"
       "bad line\n"
       "8000000 9000000 nine\n"
       "#Moving\n"
       "9000000 9500000 five\n")

FFMPEG4 = """[FRAME]
media_type=video
stream_index=0
key_frame=1
pkt_pts=0
pkt_pts_time=0.000000
pkt_duration=N/A
pkt_duration_time=N/A
width=720
height=480
pict_type=I
[/FRAME]
[FRAME]
media_type=audio
stream_index=1
key_frame=1
pkt_pts=1152
pkt_pts_time=0.026122
sample_fmt=s16p
nb_samples=1152
channels=2
channel_layout=stereo
[/FRAME]
[FRAME]
media_type=video
stream_index=0
key_frame=0
pkt_pts=3003
pkt_pts_time=0.033367
width=720
height=480
[SIDE_DATA]
side_data_type=GOP timecode
pkt_pts=999
[/SIDE_DATA]
[/FRAME]
"""


def _ffmpeg5(n=20, step=0.05):
    """ffmpeg >= 5 spelling (pts, pts_time, duration): n video frames."""
    blocks = []
    for i in range(n):
        blocks += ["[FRAME]", "media_type=video", "stream_index=0", f"pts={i * 1001}",
                   f"pts_time={i * step:.6f}", "duration=N/A", "width=64", "height=48",
                   "[/FRAME]"]
    blocks += ["[FRAME]", "media_type=audio", "pts=N/A", "pts_time=N/A", "[/FRAME]"]
    return "\n".join(blocks) + "\n"


def _frames(parsed):
    return [[sorted((k, str(v)) for k, v in vars(f).items()) for f in part] for part in parsed]


@pytest.mark.parametrize("text", ["ffmpeg4", "ffmpeg5"])
def test_parse_ffprobe_output_matches_jax(text):
    text = FFMPEG4 if text == "ffmpeg4" else _ffmpeg5()
    got, ref = tff.parse_ffprobe_output(text), jff.parse_ffprobe_output(text)
    assert _frames(got) == _frames(ref)
    audio, video = got
    assert len(video) >= 2 and len(audio) == 1
    assert video[1].pkt_pts in (3003, 1001) and video[0].pkt_dts == -1


def test_htk_segmentation_matches_jax(tmp_path):
    label_file = tmp_path / "labels.txt"
    label_file.write_text(HTK)
    labels = tseg.parse_htk_labels(str(label_file))
    assert labels == jseg.parse_htk_labels(str(label_file))
    assert labels[1] == (3000000, 4000000, "sil") and len(labels) == 4
    pts = [i * 0.05 for i in range(20)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = tseg.segment_frames(pts, labels)
    ref = jseg.segment_frames(pts, labels)
    assert got == ref
    assert got[2] == [4, 6, 2] and all(isinstance(v, int) for v in got[1])
    assert "skipping non-digit label 'sil'" in out.getvalue()
    assert (tseg.to_100ns(0.25), tseg.digit_to_int("seven")) == (2500000, 7)
    # no #Normal header: no labels
    other = tmp_path / "other.txt"
    other.write_text("#Moving\n1 2 one\n")
    assert tseg.parse_htk_labels(str(other)) == jseg.parse_htk_labels(str(other)) == []


def test_ffprobe_video_and_segment_video_through_ffprobe(tmp_path, monkeypatch):
    """``ffprobe_video`` runs ``ffprobe -show_frames`` (a stand-in on PATH
    that prints canned ffmpeg 5 text) and ``segment_video`` segments its
    frames by the HTK labels, as the JAX package does."""
    canned = tmp_path / "frames.txt"
    canned.write_text(_ffmpeg5())
    probe = tmp_path / "bin" / "ffprobe"
    probe.parent.mkdir()
    probe.write_text(f"#!/bin/sh\ncat {canned}\n")
    probe.chmod(probe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{probe.parent}{os.pathsep}{os.environ['PATH']}")
    label_file = tmp_path / "labels.txt"
    label_file.write_text(HTK)
    assert _frames(tff.ffprobe_video("v.mp4")) == _frames(jff.ffprobe_video("v.mp4"))
    with contextlib.redirect_stdout(io.StringIO()):
        got = tseg.segment_video("v.mp4", str(label_file))
        ref = jseg.segment_video("v.mp4", str(label_file))
    assert got == ref and got[2] == [4, 6, 2]


# ---------------------------------------------------------------------------
# data/dct_matlab
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 6), (26, 44), (5, 5)])
def test_zigzag_copy_matches_jax(shape):
    _same(tdct_ops.zigzag_indices(shape), jpp.zigzag_indices(shape))


@pytest.mark.parametrize("order", ["F", "C"])
def test_dct_matlab_bit_for_bit(order):
    rng = np.random.RandomState(0)
    img = rng.randn(6, 8)
    _same(tdct.dct2(img), jdct.dct2(img))
    X = rng.randn(10, 24)
    _same(tdct.compute_dct_feat(X, (4, 6), no_coeff=5, order=order),
          jdct.compute_dct_feat(X, (4, 6), no_coeff=5, order=order))
    both = tdct.compute_dct_feat_and_deltas(X, (4, 6), [6, 4], no_coeff=5, w=3, order=order)
    _same(both, jdct.compute_dct_feat_and_deltas(X, (4, 6), [6, 4], no_coeff=5, w=3,
                                                 order=order))
    assert both.shape == (10, 15)


# ---------------------------------------------------------------------------
# data/landmarking and cli.landmark
# ---------------------------------------------------------------------------

def _video_dir(tmp_path):
    vids = tmp_path / "vids"
    (vids / "sub").mkdir(parents=True)
    for name in ("s1_v1_u1.mp4", "s1_v2_u1.mp4", "sub/s2_v1_u3.mp4", "notes.txt"):
        (vids / name).write_bytes(b"\x00")
    return vids


def _csvs(d):
    return {p: open(os.path.join(d, p)).read() for p in sorted(os.listdir(d))}


def test_landmark_cli_with_the_fake_landmarker(tmp_path, monkeypatch):
    vids = _video_dir(tmp_path)
    tasks = tlandmark.collect_tasks(str(vids), str(tmp_path / "out"), "s*_v1_u*.mp4")
    assert tasks == jlandmark.collect_tasks(str(vids), str(tmp_path / "out"), "s*_v1_u*.mp4")
    assert [os.path.basename(v) for v, _ in tasks] == ["s1_v1_u1.mp4", "s2_v1_u3.mp4"]
    frames = np.random.RandomState(0).randint(0, 255, (3, 8, 10)).astype(np.uint8)
    for module in (tlm, jlm):
        monkeypatch.setattr(module, "iter_video_frames", lambda path: iter(frames))
    argv = ["--input", str(vids), "--pattern", "s*_v1_u*.mp4", "--fake-landmarker"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert tlandmark.main(argv + ["--output", str(tmp_path / "port")]) == 2
        assert jlandmark.main(argv + ["--output", str(tmp_path / "jax")]) == 2
    got = _csvs(tmp_path / "port")
    assert got == _csvs(tmp_path / "jax") and sorted(got) == ["s1_v1_u1.csv", "s2_v1_u3.csv"]
    rows = got["s1_v1_u1.csv"].strip().splitlines()
    assert len(rows) == 3 and len(rows[0].split(",")) == 2 * tlm.N_LANDMARKS
    # a frame without a face is a row of -1s
    assert tlm.landmarks_to_row(None) == jlm.landmarks_to_row(None) == [-1] * 136
    fn = tlandmark._fake_landmarker_factory(None)
    assert fn(frames[0]) == jlandmark._fake_landmarker_factory(None)(frames[0])
    with pytest.raises(SystemExit):
        tlandmark.main(["--input", str(vids), "--output", str(tmp_path / "x")])


def test_landmark_pool_writes_the_jax_csvs(tmp_path):
    """Real videos decoded by OpenCV in the pool's worker processes."""
    cv2 = pytest.importorskip("cv2")
    vids = tmp_path / "vids"
    vids.mkdir()
    rng = np.random.RandomState(0)
    for i, n in enumerate((4, 6)):
        w = cv2.VideoWriter(str(vids / f"s{i}_v1_u1.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                            (32, 24))
        for _ in range(n):
            w.write((rng.rand(24, 32, 3) * 255).astype(np.uint8))
        w.release()
    argv = ["--input", str(vids), "--fake-landmarker", "--workers", "2"]
    with contextlib.redirect_stdout(io.StringIO()):
        tlandmark.main(argv + ["--output", str(tmp_path / "port")])
        jlandmark.main(argv + ["--output", str(tmp_path / "jax")])
    got = _csvs(tmp_path / "port")
    assert got == _csvs(tmp_path / "jax")
    assert [len(v.strip().splitlines()) for v in got.values()] == [4, 6]


def test_landmark_pool_aborts_on_a_crashed_worker():
    def crashing_factory(_arg):
        os._exit(3)  # a native crash before any task_done

    with pytest.raises(RuntimeError, match="crashed|pending"):
        tlm.run_landmark_pool([("v.mp4", "out.csv")], crashing_factory, None, workers=2)


def test_process_video_and_find_videos(tmp_path):
    vids = _video_dir(tmp_path)
    assert tlm.find_videos(str(vids)) == jlm.find_videos(str(vids))
    assert len(tlm.find_videos(str(vids))) == 3
    frames = list(np.zeros((2, 4, 4), np.uint8))
    faces = iter([None, [(i, 2 * i) for i in range(tlm.N_LANDMARKS)]])
    assert tlm.process_video("v.mp4", str(tmp_path / "p.csv"), lambda f: next(faces),
                             frames=frames) == 2
    rows = (tmp_path / "p.csv").read_text().splitlines()
    assert rows[0] == ",".join(["-1"] * 136) and rows[1].startswith("0,0,1,2,2,4")


# ---------------------------------------------------------------------------
# cli.prepare_data
# ---------------------------------------------------------------------------

PREPARE_FLAGS = {
    "none": [],
    "reorder": ["--imagesize", "4,6", "--reorder"],
    "resize": ["--resize", "4,6:2,3"],
    "samplewise": ["--samplewise"],
    "meanremove": ["--meanremove"],
    "diff": ["--diff"],
    "deltas": ["--deltas", "3"],
    "embed": ["--embed", "3,2"],
    "all": ["--imagesize", "4,6", "--reorder", "--meanremove", "--diff", "--samplewise",
            "--deltas", "3"],
}


@pytest.mark.parametrize("flags", list(PREPARE_FLAGS))
def test_prepare_data_matches_jax(tmp_path, flags):
    rng = np.random.RandomState(0)
    lens = np.array([6, 9, 7])
    total = int(lens.sum())
    jmatio.save_mat({"dataMatrix": rng.rand(total, 24).astype(np.float32),
                     "targetsVec": np.repeat([1, 2, 3], lens).reshape(-1, 1),
                     "subjectsVec": np.array([[1], [2], [1]]),
                     "videoLengthVec": lens.reshape(-1, 1)}, str(tmp_path / "in.mat"))
    outs = {}
    for name, module in (("port", tprepare), ("jax", jprepare)):
        outs[name] = str(tmp_path / f"{name}.mat")
        np.random.seed(0)  # --embed's factorize drops frames with np.random
        with contextlib.redirect_stdout(io.StringIO()):
            module.main(["--input", str(tmp_path / "in.mat"), "--output", outs[name]]
                        + PREPARE_FLAGS[flags])
    got, ref = sio.loadmat(outs["port"]), sio.loadmat(outs["jax"])
    keys = sorted(k for k in ref if not k.startswith("__"))
    assert sorted(k for k in got if not k.startswith("__")) == keys
    for k in keys:
        _same(got[k], ref[k])
    if flags == "embed":
        assert got["videoLengthVec"].ravel().tolist() == [3, 4, 3]  # 6, 8, 6 frames, step 2


# ---------------------------------------------------------------------------
# cli.playvid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cols", [3, 4, 10])
def test_contact_sheet_matches_jax(cols):
    frames = list(np.random.RandomState(cols).randint(0, 255, (7, 5, 6)).astype(np.uint8))
    _same(tplayvid.contact_sheet(frames, cols=cols), jplayvid.contact_sheet(frames, cols=cols))
    assert tplayvid.contact_sheet([]) is None


def test_playvid_headless_sheets_match_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    vid = tmp_path / "s1_v1_u31.mp4"
    w = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    rng = np.random.RandomState(0)
    for _ in range(12):
        w.write((rng.rand(48, 64, 3) * 255).astype(np.uint8))
    w.release()
    outs = {}
    for name, module in (("port", tplayvid), ("jax", jplayvid)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            module.main([str(vid), str(tmp_path / "nope.mp4"), "--sheet-dir",
                         str(tmp_path / name), "--step", "2"])
        outs[name] = out.getvalue().replace(str(tmp_path / name), "SHEETS")
    assert outs["port"] == outs["jax"]
    assert "12 frames" in outs["port"] and "missing, skipped" in outs["port"]
    sheet = cv2.imread(str(tmp_path / "port" / "s1_v1_u31.png"), cv2.IMREAD_GRAYSCALE)
    _same(sheet, cv2.imread(str(tmp_path / "jax" / "s1_v1_u31.png"), cv2.IMREAD_GRAYSCALE))
    assert sheet.shape == (24, 32 * 10)
    frames = list(tplayvid.iter_frames(str(vid)))
    assert len(frames) == 12 and frames[0].shape == (24, 32)
