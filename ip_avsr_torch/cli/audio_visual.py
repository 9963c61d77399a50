"""Audio-visual fusion runner (AVNet): the port of
ip_avsr_tpu/cli/audio_visual.py.

Parity with cuave/audio_visual_runner.py: a visual mouth-ROI stream through
a pretrained DBNF encoder substream and a precomputed audio-feature (MFCC)
stream, fused by sum, adaptive sum or concat into a BLSTM aggregator with
a per-timestep softmax and majority-vote evaluation; the streams are
force-aligned when their per-utterance lengths differ, and the audio stream
is normalized with the training split's statistics.  ``--write_results``
appends the rates and the whole cost curves
(audio_visual_runner.py:457-472); ``--save_best`` pickles the best
parameters.  The data is read and preprocessed on the host; the model
trains on ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions).

Usage:
    python -m ip_avsr_torch.cli.audio_visual --visual mouthrois.mat \\
        --audio mfcc_w3s3.mat --encoder dbnf.mat --output-classes 10
    python -m ip_avsr_torch.cli.audio_visual --synthetic 40 --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ip_avsr_torch.cli.nstream import _video_subjects, synthesize_dataset
from ip_avsr_torch.data import preprocessing as pp
from ip_avsr_torch.device import resolve_device
from ip_avsr_torch.io import matio
from ip_avsr_torch.models import avnet
from ip_avsr_torch.train import config as config_lib
from ip_avsr_torch.train.evaluation import plot_confusion_matrix
from ip_avsr_torch.train.trainer import Trainer, TrainOptions


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--visual", help="visual stream .mat")
    ap.add_argument("--audio", help="audio-feature stream .mat (e.g. MFCC)")
    ap.add_argument("--encoder", help="pretrained DBNF encoder .mat for the visual stream")
    ap.add_argument("--fusiontype", default="concat", choices=["sum", "adasum", "concat"])
    ap.add_argument("--lstm_size", type=int, default=250)
    ap.add_argument("--output-classes", type=int, default=10)
    ap.add_argument("--windowsize", type=int, default=9)
    ap.add_argument("--num_epoch", type=int, default=30)
    ap.add_argument("--epochsize", type=int, default=120)
    ap.add_argument("--batchsize", type=int, default=10)
    ap.add_argument("--learning_rate", type=float, default=1e-4)
    ap.add_argument("--train_subjects_file")
    ap.add_argument("--val_subjects_file")
    ap.add_argument("--test_subjects_file")
    ap.add_argument("--write_results")
    ap.add_argument("--save_best")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    pretrained_enc = None
    if args.synthetic:
        vis_dim, aud_dim = 48, 13
        vis = synthesize_dataset(args.synthetic, vis_dim, args.output_classes, seed=0)
        aud = synthesize_dataset(args.synthetic, aud_dim, args.output_classes, seed=1)
        args.lstm_size = min(args.lstm_size, 16)
        args.num_epoch = min(args.num_epoch, 2)
        args.epochsize = min(args.epochsize, 6)
        enc_shapes, enc_nl = (32, 16, 8), ("rectify", "rectify", "linear")
    else:
        vis = matio.load_mat_file(args.visual)
        aud = matio.load_mat_file(args.audio)
        vis_dim = vis["dataMatrix"].shape[1]
        aud_dim = aud["dataMatrix"].shape[1]
        enc_shapes, enc_nl = (2000, 1000, 500, 50), ("rectify", "rectify", "rectify", "linear")
        if args.encoder:
            w, b = matio.load_dbn_mat(args.encoder, n_layers=len(enc_shapes))
            pretrained_enc = [(w, b), None]

    targets = vis["targetsVec"].reshape(-1).astype(np.int64) - 1
    subjects = vis["subjectsVec"].reshape(-1)
    vidlens = vis["videoLengthVec"].reshape(-1).astype(np.int64)
    vis_X = vis["dataMatrix"].astype(np.float32)
    aud_X = aud["dataMatrix"].astype(np.float32)
    aud_lens = aud["videoLengthVec"].reshape(-1).astype(np.int64)

    # a per-frame subjectsVec (AVLetters layout) becomes per-video while
    # vidlens still matches its frame count: force-align pads the videos to
    # the longer stream, after which the frame offsets no longer hold
    if len(subjects) != len(vidlens):
        subjects = _video_subjects(subjects, vidlens)

    if not np.array_equal(vidlens, aud_lens):
        streams = pp.multistream_force_align([
            (vis_X, vis["targetsVec"].reshape(-1), vidlens),
            (aud_X, aud["targetsVec"].reshape(-1), aud_lens),
        ])
        vis_X, t0, vidlens = streams[0]
        aud_X, _, _ = streams[1]
        targets = t0.astype(np.int64) - 1

    vis_X = pp.normalize_input(vis_X.copy())

    if args.synthetic:
        train_ids, val_ids, test_ids = config_lib.synthetic_subject_split(subjects)
    else:
        train_ids = matio.read_data_split_file(args.train_subjects_file)
        val_ids = matio.read_data_split_file(args.val_subjects_file)
        test_ids = matio.read_data_split_file(args.test_subjects_file)

    splits = [pp.split_seq_data(m, targets, subjects, vidlens, train_ids, val_ids, test_ids)
              for m in (vis_X, aud_X)]
    train_streams = [s[0] for s in splits]
    val_streams = [s[4] for s in splits]
    test_streams = [s[8] for s in splits]

    # featurewise-normalize the audio stream with the train statistics
    train_streams[1], mean, std = pp.featurewise_normalize_sequence(train_streams[1])
    val_streams[1] = (val_streams[1] - mean) / std
    test_streams[1] = (test_streams[1] - mean) / std

    cfg = avnet.avnet_config(
        [vis_dim, aud_dim], ["visual", "audio"],
        encoder_shapes=enc_shapes, encoder_nonlinearities=enc_nl,
        lstm_size=args.lstm_size, window=args.windowsize,
        output_classes=args.output_classes, fusiontype=args.fusiontype,
        no_encoder_for=["audio"])

    topts = TrainOptions(num_epoch=args.num_epoch, epochsize=args.epochsize,
                         batchsize=args.batchsize, learning_rate=args.learning_rate,
                         window=args.windowsize)
    trainer = Trainer(cfg, topts, device=device)
    if pretrained_enc is not None:
        params0 = trainer.init_params(torch.Generator().manual_seed(topts.seed),
                                      pretrained_encoders=pretrained_enc)
        trainer.init_params = lambda generator, **kw: params0

    result = trainer.fit(
        (train_streams, splits[0][1], splits[0][2]),
        (val_streams, splits[0][5], splits[0][6]),
        (test_streams, splits[0][9], splits[0][10]))

    print("Final Model")
    print(f"CR: {result.best_cr}, val loss: {result.best_val}, Test CR: {result.test_cr}")
    names = [str(i) for i in range(args.output_classes)]
    print(plot_confusion_matrix(result.test_conf, names))

    if args.write_results:
        with open(args.write_results, "a") as f:
            f.write(f"{result.test_cr},{result.best_cr},{result.best_val}\n")
            f.write("train_costs," + ",".join(f"{c:.6f}" for c in result.cost_train) + "\n")
            f.write("val_costs," + ",".join(f"{c:.6f}" for c in result.cost_val) + "\n")
    if args.save_best:
        matio.save_model_params(result.best_params, args.save_best)
    return result


if __name__ == "__main__":
    main()
