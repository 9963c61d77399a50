"""Dataset feature-preparation CLI; the port of ip_avsr_tpu/cli/prepare_data.py
(host-side numpy, no device).

Parity with {avletters,oulu,cuave}/prepare_data.py and
oulu/preprocess_images.py: take a dataset ``.mat`` (dataMatrix + targetsVec +
videoLengthVec [+ subjectsVec/iterVec]) and emit a new ``.mat`` with the
requested transforms applied, in reference order:

  --reorder       Fortran -> C pixel repacking (utils/preprocessing.py:492)
  --resize        bilinear resize (e.g. 60,80:30,40; scipy imresize semantics)
  --samplewise    per-frame z-normalization
  --meanremove    sequencewise mean-image subtraction
  --diff          difference images (first diff duplicated at t=0)
  --deltas W      append 1st+2nd order delta features (lfilter semantics)
  --embed W,S     factorize to a multiple of S then embed a temporal window
                  (utils/preprocessing.py:534-604)

Usage:
    python -m ip_avsr_torch.cli.prepare_data --input raw.mat --output prep.mat \
        --reorder --imagesize 26,44 --samplewise
"""

from __future__ import annotations

import argparse

import numpy as np

from ip_avsr_torch.data import preprocessing as pp
from ip_avsr_torch.io import matio


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--field", default="dataMatrix")
    ap.add_argument("--imagesize", help="rows,cols of the images (for --reorder/--resize)")
    ap.add_argument("--reorder", action="store_true")
    ap.add_argument("--resize", help="origH,origW:newH,newW")
    ap.add_argument("--samplewise", action="store_true")
    ap.add_argument("--meanremove", action="store_true")
    ap.add_argument("--diff", action="store_true")
    ap.add_argument("--deltas", type=int, default=0, help="window (e.g. 9)")
    ap.add_argument("--embed", help="window,step temporal embedding")
    args = ap.parse_args(argv)

    data = matio.load_mat_file(args.input)
    X = data[args.field].astype(np.float32)
    vidlens = data["videoLengthVec"].reshape(-1).astype(np.int64)
    targets = data["targetsVec"].reshape(-1)

    if args.reorder:
        shape = tuple(int(v) for v in args.imagesize.split(","))
        X = pp.reorder_data(X, shape)
    if args.resize:
        orig_s, new_s = args.resize.split(":")
        orig = tuple(int(v) for v in orig_s.split(","))
        new = tuple(int(v) for v in new_s.split(","))
        X = pp.resize_images(X, orig_dim=orig, dim=new).astype(np.float32)
    if args.meanremove:
        X = pp.sequencewise_mean_image_subtraction(X, vidlens)
    if args.diff:
        X = pp.compute_diff_images(X, vidlens)
    if args.samplewise:
        X = pp.normalize_input(X)
    if args.deltas:
        X = pp.concat_first_second_deltas(X, vidlens, w=args.deltas).astype(np.float32)
    if args.embed:
        win, step = (int(v) for v in args.embed.split(","))
        X, targets, vidlens = pp.factorize(X, targets, vidlens, step, axis_to_delete=0)
        X, targets, vidlens = pp.embed_temporal_info(X, targets, vidlens, win, step)

    out = dict(data)
    out[args.field] = X
    out["targetsVec"] = np.asarray(targets).reshape(-1, 1)
    out["videoLengthVec"] = np.asarray(vidlens).reshape(-1, 1)
    out = {k: v for k, v in out.items() if not k.startswith("__")}
    matio.save_mat(out, args.output)
    print(f"wrote {X.shape} features to {args.output}")


if __name__ == "__main__":
    main()
