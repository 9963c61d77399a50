"""Separate-stage training: encode frames offline, then train the LSTM alone.
The port of ip_avsr_tpu/cli/separate_train.py.

Parity with oulu/separate_train.py:230-463: load a pretrained DBNF encoder
(w1..wN .mat), run every frame through it once (offline bottleneck
encodings), and train only a (B)LSTM classifier on the 50-dim codes — the
two-stage alternative to end-to-end finetuning.  Both stages run on
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).

Usage:
    python -m ip_avsr_torch.cli.separate_train --data rois.mat --encoder ae.mat \\
        --shape 2000,1000,500,50 --nonlinearities sigmoid,sigmoid,sigmoid,linear
    python -m ip_avsr_torch.cli.separate_train --synthetic 40 --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ip_avsr_torch.cli.nstream import _video_subjects, synthesize_dataset
from ip_avsr_torch.data import preprocessing as pp
from ip_avsr_torch.device import resolve_device, tree_to
from ip_avsr_torch.io import matio
from ip_avsr_torch.models import encoder as encoder_mod
from ip_avsr_torch.models import zoo
from ip_avsr_torch.train import config as config_lib
from ip_avsr_torch.train.trainer import Trainer, TrainOptions


@torch.no_grad()
def encode_frames(weights, biases, nonlinearities, X, batch=4096, device=None):
    """Offline frame encoding through the dense encoder on ``device``
    (default ``cuda``), ``batch`` frames per product; the codes come back
    as a float32 numpy array (the reference uses nolearn
    ``encoder.predict``)."""
    device = resolve_device(device)
    params = tree_to(encoder_mod.pretrained_encoder_params(weights, biases), device)
    outs = []
    for start in range(0, len(X), batch):
        x = torch.as_tensor(np.asarray(X[start: start + batch], np.float32), device=device)
        outs.append(encoder_mod.encoder_forward(params, x, nonlinearities).cpu().numpy())
    return np.concatenate(outs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data")
    ap.add_argument("--encoder")
    ap.add_argument("--shape", default="2000,1000,500,50")
    ap.add_argument("--nonlinearities", default="sigmoid,sigmoid,sigmoid,linear")
    ap.add_argument("--lstm_units", type=int, default=250)
    ap.add_argument("--output-classes", type=int, default=10)
    ap.add_argument("--use_blstm", action=argparse.BooleanOptionalAction, default=True,
                    help="--no-use_blstm selects a unidirectional LSTM")
    ap.add_argument("--num_epoch", type=int, default=30)
    ap.add_argument("--epochsize", type=int, default=120)
    ap.add_argument("--batchsize", type=int, default=30)
    ap.add_argument("--learning_rate", type=float, default=1e-4)
    ap.add_argument("--train_subjects_file")
    ap.add_argument("--val_subjects_file")
    ap.add_argument("--test_subjects_file")
    ap.add_argument("--save_best")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    nls = args.nonlinearities.split(",")
    if args.synthetic:
        dim = 24
        ds = synthesize_dataset(args.synthetic, dim, args.output_classes, seed=0)
        rng = np.random.RandomState(0)
        shapes = [16, 8]
        nls = ["sigmoid", "linear"]
        weights, biases = [], []
        fan = dim
        for s in shapes:
            weights.append((0.1 * rng.randn(fan, s)).astype(np.float32))
            biases.append(np.zeros(s, np.float32))
            fan = s
        args.lstm_units = 12
        args.num_epoch = min(args.num_epoch, 2)
        args.epochsize = min(args.epochsize, 6)
    else:
        ds = matio.load_mat_file(args.data)
        shapes = [int(s) for s in args.shape.split(",")]
        weights, biases = matio.load_dbn_mat(args.encoder, n_layers=len(shapes))

    X = pp.normalize_input(ds["dataMatrix"].astype(np.float32).copy())
    targets = ds["targetsVec"].reshape(-1).astype(np.int64) - 1
    subjects = ds["subjectsVec"].reshape(-1)
    vidlens = ds["videoLengthVec"].reshape(-1).astype(np.int64)

    print("encoding frames offline...")
    codes = encode_frames(weights, biases, nls, X, device=device)

    if args.synthetic:
        train_ids, val_ids, test_ids = \
            config_lib.synthetic_subject_split(subjects)
    else:
        train_ids = matio.read_data_split_file(args.train_subjects_file)
        val_ids = matio.read_data_split_file(args.val_subjects_file)
        test_ids = matio.read_data_split_file(args.test_subjects_file)

    video_subjects = (subjects if len(subjects) == len(vidlens)
                      else _video_subjects(subjects, vidlens))
    s = pp.split_seq_data(codes, targets, video_subjects, vidlens,
                          train_ids, val_ids, test_ids)

    cfg = zoo.lstm_classifier_majority_vote(
        codes.shape[1], lstm_size=args.lstm_units,
        output_classes=args.output_classes, use_blstm=args.use_blstm)
    topts = TrainOptions(num_epoch=args.num_epoch, epochsize=args.epochsize,
                         batchsize=args.batchsize, learning_rate=args.learning_rate)
    trainer = Trainer(cfg, topts, device=device)
    result = trainer.fit(([s[0]], s[1], s[2]), ([s[4]], s[5], s[6]),
                         ([s[8]], s[9], s[10]))
    print(f"CR: {result.best_cr}, val loss: {result.best_val}, Test CR: {result.test_cr}")
    if args.save_best:
        matio.save_model_params(result.best_params, args.save_best)
    return result


if __name__ == "__main__":
    main()
