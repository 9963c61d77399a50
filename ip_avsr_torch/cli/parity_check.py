"""One-command real-corpus accuracy-parity harness; the port of
ip_avsr_tpu/cli/parity_check.py.

The north-star check (BASELINE.json): the rebuilt trimodal/unimodal models
match the reference's word accuracy on the real corpora within a 0.5%
budget.  The reference repository does not ship the corpora (its
.gitignore lists them), so this CLI does two things:

* ``--data DIR`` — run the check against the REAL corpus: resolve the
  config's ``[streamN] data`` / ``model`` paths against DIR, train through
  the standard nstream runner with the reference schedule
  (avletters/unimodal.py:178-182 schema + schedule,
  oulu/trimodal_with_val.py:418-422), and emit a JSON comparison artifact
  with the CR, the supplied ``--reference-cr``, and the budget verdict.

      python -m ip_avsr_torch.cli.parity_check --data /corpora/avletters \
          --config configs/avletters_1stream.ini --reference-cr 0.5872

* ``--rehearse`` — validate the harness END TO END without the corpus:
  fabricate a full-scale AVLetters-shaped corpus (780 utterances = 26
  letters x 10 speakers x 3 iterations, 1200-dim 30x40 ROIs, per-frame
  targetsVec, iterVec splits — avletters/unimodal.py:178-182) and a
  pretrained-AE checkpoint in the w1..wN ABI, write them to disk as real
  ``.mat`` files, then execute the EXACT same code path as ``--data``
  (resolved config -> nstream -> report).  After a rehearsal the only
  untested variable left is the data itself.  The corpus is drawn from
  ``np.random.RandomState(seed)`` in the JAX package's order, so both
  packages write the same files.

The model trains on ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions), passed through to ``cli.nstream``.

The emitted artifact::

    {"test_cr": ..., "best_cr": ..., "best_val": ..., "reference_cr": ...,
     "delta": ..., "budget": 0.005, "within_budget": true/false, ...}
"""

from __future__ import annotations

import argparse
import configparser
import json
import os
import tempfile

import numpy as np

from ip_avsr_torch.device import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", help="directory holding the corpus .mat files "
                                   "(config paths resolve against it)")
    ap.add_argument("--config", default="configs/avletters_1stream.ini")
    ap.add_argument("--split", default="itervec",
                    choices=["itervec", "subjects"])
    ap.add_argument("--reference-cr", type=float, default=None,
                    help="the reference run's classification rate to compare "
                         "against (fraction, e.g. 0.5872)")
    ap.add_argument("--budget", type=float, default=0.005,
                    help="parity budget on |CR - reference CR| (default 0.5%%)")
    ap.add_argument("--out", default="parity_report.json")
    ap.add_argument("--rehearse", action="store_true",
                    help="fabricate a full-scale AVLetters-shaped corpus and "
                         "run the identical pipeline end to end")
    ap.add_argument("--rehearse-dir", default=None,
                    help="where to write the rehearsal corpus (default: a "
                         "fresh temp dir)")
    ap.add_argument("--rehearse-scale", type=float, default=1.0,
                    help="scale factor on the rehearsal corpus/model size "
                         "(CI smoke tests use ~0.1)")
    ap.add_argument("--num_epoch", type=int, default=None,
                    help="override the schedule's epoch count")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def resolve_config(config_path: str, data_dir: str, out_dir: str,
                   overrides=None) -> str:
    """Copy the INI with [streamN] data/model paths resolved against
    ``data_dir``; returns the path of the resolved copy."""
    cp = configparser.ConfigParser()
    with open(config_path) as f:
        cp.read_file(f)
    for section in cp.sections():
        if not section.startswith("stream"):
            continue
        for key in ("data", "model"):
            if cp.has_option(section, key):
                p = cp.get(section, key)
                if not os.path.isabs(p):
                    cp.set(section, key, os.path.join(data_dir,
                                                      os.path.basename(p)))
        if overrides:
            for key, val in overrides.get(section, {}).items():
                cp.set(section, key, val)
    if overrides:
        for section, kv in overrides.items():
            if section.startswith("stream"):
                continue
            for key, val in kv.items():
                cp.set(section, key, val)
    resolved = os.path.join(out_dir, "resolved_" + os.path.basename(config_path))
    with open(resolved, "w") as f:
        cp.write(f)
    return resolved


def make_rehearsal_corpus(out_dir: str, scale: float = 1.0, seed: int = 0):
    """Full-scale AVLetters-shaped corpus + pretrained-AE checkpoint.

    Schema parity (avletters/unimodal.py:178-182): ``dataMatrix`` (frames x
    1200, F-order 30x40 pixel vectors in [0, 1]), per-frame ``targetsVec``
    (1-based), per-frame ``subjectsVec``, per-video ``videoLengthVec`` and
    ``iterVec`` (iterations 1/2 train, 3 test).  The class signal is a
    letter-specific spatio-temporal mouth motif so the reference schedule
    genuinely has to learn; scale < 1 shrinks speakers/dims for smoke runs.
    """
    from ip_avsr_torch.io import matio

    n_classes = 26
    n_speakers = max(2, int(round(10 * scale)))
    n_iter = 3
    dim = max(64, int(round(1200 * scale)))
    if scale >= 1.0:
        dim = 1200
    rng = np.random.RandomState(seed)
    frames, targets, subjects, vidlens, iters = [], [], [], [], []
    for spk in range(1, n_speakers + 1):
        speaker_gain = 1.0 + 0.1 * rng.randn()
        for letter in range(1, n_classes + 1):
            for it in range(1, n_iter + 1):
                T = int(rng.randint(12, 30))
                # letter-specific motif: a moving activation bump whose
                # position and drift depend on the class
                t = np.arange(T)[:, None]
                centre = (letter * 37) % dim
                drift = ((letter % 7) - 3) * 1.5
                pos = (centre + drift * t) % dim
                idx = np.arange(dim)[None, :]
                d2 = np.minimum(np.abs(idx - pos), dim - np.abs(idx - pos))
                clip = np.exp(-0.5 * (d2 / (8.0 + letter % 5)) ** 2)
                clip = speaker_gain * clip + 0.35 * rng.randn(T, dim)
                clip = 1.0 / (1.0 + np.exp(-clip))  # pixel-like [0, 1]
                frames.append(clip.astype(np.float32))
                targets.append(np.full(T, letter, np.int32))
                subjects.append(np.full(T, spk, np.int32))
                vidlens.append(T)
                iters.append(it)
    corpus = {
        "dataMatrix": np.concatenate(frames),
        "targetsVec": np.concatenate(targets).reshape(-1, 1),
        "subjectsVec": np.concatenate(subjects).reshape(-1, 1),
        "videoLengthVec": np.asarray(vidlens, np.int32).reshape(-1, 1),
        "iterVec": np.asarray(iters, np.int32).reshape(-1, 1),
    }
    data_path = os.path.join(out_dir, "allData_mouthROIs.mat")
    matio.save_mat(corpus, data_path)

    # pretrained finetuned-AE checkpoint in the w1..wN ABI (encoder+decoder,
    # 8 layers like an unfolded 2000/1000/500/50 AE; load_decoder reads the
    # first 4)
    enc = [int(round(s * scale)) if scale < 1.0 else s
           for s in (2000, 1000, 500, 50)]
    enc = [max(8, s) for s in enc]
    dims = [dim] + enc
    weights, biases = [], []
    for a, b in zip(dims[:-1], dims[1:]):
        weights.append((rng.randn(a, b) * np.sqrt(2.0 / (a + b)))
                       .astype(np.float32))
        biases.append(np.zeros(b, np.float32))
    for a, b in zip(enc[::-1], (enc[-2::-1] + [dim])):
        weights.append((rng.randn(a, b) * np.sqrt(2.0 / (a + b)))
                       .astype(np.float32))
        biases.append(np.zeros(b, np.float32))
    ae_path = os.path.join(out_dir, "avletters_ae_finetuned.mat")
    matio.save_dbn_mat(weights, biases, ae_path)
    return data_path, ae_path, {"n_utterances": len(vidlens), "dim": dim,
                                "encoder": enc}


def run(argv=None):
    args = parse_args(argv)
    resolve_device(args.device)  # refuse before the corpus is written
    workdir = None
    meta = {}
    overrides = {}
    if args.rehearse:
        workdir = args.rehearse_dir or tempfile.mkdtemp(prefix="ipavsr_parity_")
        os.makedirs(workdir, exist_ok=True)
        print(f"parity_check: writing rehearsal corpus to {workdir}")
        _, _, meta = make_rehearsal_corpus(workdir, scale=args.rehearse_scale)
        data_dir = workdir
        if args.rehearse_scale < 1.0:
            overrides = {
                "stream1": {
                    "input_dimensions": str(meta["dim"]),
                    "shape": ",".join(str(s) for s in meta["encoder"]),
                    "imagesize": "",  # non-square scaled dims: skip reorder
                    "reorderdata": "false",
                },
            }
    else:
        if not args.data:
            raise SystemExit("--data DIR is required (or use --rehearse)")
        data_dir = args.data

    out_dir = workdir or tempfile.mkdtemp(prefix="ipavsr_parity_cfg_")
    resolved = resolve_config(args.config, data_dir, out_dir, overrides)
    print(f"parity_check: resolved config -> {resolved}")

    from ip_avsr_torch.cli import nstream

    run_argv = ["--config", resolved, "--split", args.split, "--device", args.device]
    if args.num_epoch is not None:  # 0 is a valid smoke value
        run_argv += ["--num_epoch", str(args.num_epoch)]
    result = nstream.main(run_argv)

    report = {
        "config": os.path.abspath(args.config),
        "data_dir": os.path.abspath(data_dir),
        "split": args.split,
        "rehearsal": bool(args.rehearse),
        **({"rehearsal_corpus": meta} if meta else {}),
        "test_cr": float(result.test_cr),
        "best_cr": float(result.best_cr),
        "best_val": float(result.best_val),
        "reference_cr": args.reference_cr,
        "budget": args.budget,
    }
    if args.reference_cr is not None:
        report["delta"] = float(result.test_cr - args.reference_cr)
        report["within_budget"] = bool(abs(report["delta"]) <= args.budget)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"parity_check: report -> {args.out}")
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    run()
