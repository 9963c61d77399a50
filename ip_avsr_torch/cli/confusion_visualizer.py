"""Confusion visualizer: map misclassified utterances and render them; the
port of ip_avsr_tpu/cli/confusion_visualizer.py.

Parity with avletters/confusion_visualizer.py:167-266: load a trained model,
run the evaluation data, list every confusion as (utterance, truth,
predicted) (map_confusion :167-184), render the confusion matrix as an
annotated heatmap PNG, and tile the frames of a confused utterance next to
an utterance of the predicted class (visualize_confusion :187-190;
headless: images go to --outdir PNGs instead of plt.show windows).

The forward runs on ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions).  :func:`evaluate` is the device part and returns
the confusions and the confusion matrix before anything is rendered;
:func:`main` prints them and renders through matplotlib.

Usage:
    python -m ip_avsr_torch.cli.confusion_visualizer --config cfg.ini \\
        --model best.pkl --outdir viz/
    python -m ip_avsr_torch.cli.confusion_visualizer --config \\
        configs/synthetic_1stream.ini --synthetic 30 --outdir viz/ --device cpu
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ip_avsr_torch import bridge
from ip_avsr_torch.cli import nstream
from ip_avsr_torch.data.datagen import PaddedDataset
from ip_avsr_torch.device import resolve_device
from ip_avsr_torch.io import matio
from ip_avsr_torch.models import adenet
from ip_avsr_torch.ops.voting import masked_majority_vote
from ip_avsr_torch.train import config as config_lib
from ip_avsr_torch.train.evaluation import plot_confusion_matrix
from ip_avsr_torch.utils import plotting


def map_confusion(probs, y, mask):
    """(confusions, preds): the misclassified-utterance triples
    ``(utterance_idx, truth, predicted)`` (avletters/
    confusion_visualizer.py:167-184) plus the full prediction vector (so
    callers build the confusion matrix from the same vote, not a second
    pass).  Handles per-step majority-vote (B, T, C) and last-step (B, C)
    heads; numpy inputs."""
    probs = np.asarray(probs)
    if probs.ndim == 3:
        preds = np.asarray(masked_majority_vote(probs, np.asarray(mask)))
    else:
        preds = np.argmax(probs, axis=1)
    confusions = [(i, int(t), int(p))
                  for i, (t, p) in enumerate(zip(np.asarray(y), preds))
                  if int(t) != int(p)]
    return confusions, preds


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--model", help="pickled params from --save_best (either package)")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--outdir", default="confusion_viz")
    ap.add_argument("--imagesize", help="H,W for frame tiles (default from config)")
    ap.add_argument("--max_renders", type=int, default=4,
                    help="render at most this many confused pairs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def evaluate(args):
    """The device part: rebuild the model, run one evaluation forward over
    every utterance on ``args.device`` and vote.  Returns ``(confusions,
    conf_mat, data)``: the triples of :func:`map_confusion`, the (C, C)
    int64 confusion matrix (rows truth, columns prediction) and what
    :func:`main` renders from (``streams``, ``y_seq``, ``lens``,
    ``classnames``, ``stream_cfgs``)."""
    device = resolve_device(args.device)
    cp = config_lib.load_config(args.config)
    stream_cfgs = config_lib.parse_streams(cp)
    clf = config_lib.parse_classifier(cp)
    dims = [s.input_dimensions for s in stream_cfgs]
    # shared with nstream/demo so a trained model rebuilds identically
    cfg = config_lib.build_model_config(stream_cfgs, clf)

    if args.model:
        params = bridge.params_from_jax(matio.load_model_params(args.model), device=device)
    else:
        print("no --model given: using random init (smoke mode)")
        params = adenet.init_adenet_params(torch.Generator().manual_seed(0), cfg,
                                           device=device)

    # evaluation data: synthetic smoke mode or the config's stream .mat files
    if args.synthetic:
        data = [nstream.synthesize_dataset(args.synthetic, d, clf.output_classes, seed=i)
                for i, d in enumerate(dims)]
        raws = [d["dataMatrix"] for d in data]
        lens = data[0]["videoLengthVec"].reshape(-1)
        y = data[0]["targetsVec"].reshape(-1) - 1
    else:
        mats = matio.load_mat_files([s.data for s in stream_cfgs])
        raws = [m["dataMatrix"].astype(np.float32) for m in mats]
        lens = mats[0]["videoLengthVec"].reshape(-1).astype(np.int64)
        y = mats[0]["targetsVec"].reshape(-1).astype(np.int64)
        if clf.matlab_target_offset:
            y = y - 1

    # targetsVec is frame-major in the reference .mat schema (and in
    # synthesize_dataset); PaddedDataset picks each sequence's first frame
    ds = PaddedDataset(raws, y, lens)
    streams, y_seq, mask = ds.gather(np.arange(ds.n))
    with torch.no_grad():
        probs = adenet.adenet_forward(
            params, cfg, [torch.as_tensor(s, device=device) for s in streams],
            torch.as_tensor(mask, dtype=torch.float32, device=device), train=False)
    probs = probs.cpu().numpy()

    confusions, preds = map_confusion(probs, y_seq, mask)
    conf_mat = np.zeros((clf.output_classes, clf.output_classes), np.int64)
    np.add.at(conf_mat, (np.asarray(y_seq, np.int64), preds), 1)
    classnames = clf.output_classnames or [str(i) for i in range(clf.output_classes)]
    return confusions, conf_mat, dict(streams=streams, y_seq=y_seq, lens=lens,
                                      classnames=classnames, stream_cfgs=stream_cfgs)


def main(argv=None):
    args = parse_args(argv)
    confusions, conf_mat, data = evaluate(args)
    streams, y_seq, lens = data["streams"], data["y_seq"], data["lens"]
    classnames, stream_cfgs = data["classnames"], data["stream_cfgs"]

    print(f"{len(confusions)} / {len(y_seq)} utterances misclassified")
    for i, truth, pred in confusions:
        print(f"  utterance {i}: '{classnames[truth]}' -> '{classnames[pred]}'")
    print(plot_confusion_matrix(conf_mat, classnames, fmt="pipe"))

    os.makedirs(args.outdir, exist_ok=True)
    plotting.plot_confusion_matrix_image(
        conf_mat, classnames, os.path.join(args.outdir, "confusion_matrix.png"))

    d = stream_cfgs[0].input_dimensions
    if args.imagesize:
        shape = tuple(int(v) for v in args.imagesize.split(","))
    elif stream_cfgs[0].imagesize and int(np.prod(stream_cfgs[0].imagesize)) == d:
        shape = stream_cfgs[0].imagesize
    else:
        side = int(np.sqrt(d))
        shape = (side, d // side) if side * (d // side) == d else None

    if shape is not None:
        # render confused utterance frames next to a sample of the predicted
        # class (visualize_confusion, confusion_visualizer.py:187-190)
        by_class = {int(c): np.nonzero(np.asarray(y_seq) == c)[0]
                    for c in set(int(v) for v in np.asarray(y_seq))}
        for i, truth, pred in confusions[: args.max_renders]:
            T = int(lens[i])
            plotting.visualize_sequence(
                streams[0][i, :T], shape,
                os.path.join(args.outdir, f"utt{i}_truth_{classnames[truth]}"),
                title=f"utterance {i} (truth {classnames[truth]})")
            if len(by_class.get(pred, ())):
                j = int(by_class[pred][0])
                plotting.visualize_sequence(
                    streams[0][j, : int(lens[j])], shape,
                    os.path.join(args.outdir, f"utt{i}_confused_{classnames[pred]}"),
                    title=f"confused with {classnames[pred]} (utterance {j})")
        print(f"wrote confusion renders to {args.outdir}/")
    return confusions, conf_mat


if __name__ == "__main__":
    main()
