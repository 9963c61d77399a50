"""Leave-one-subject-out trimodal runner: the port of
ip_avsr_tpu/cli/leave_one_out.py.

Parity with oulu/leave_one_out.py:240-418: one subject is held out with
``--test_subj``; every other subject trains; the held-out subject's data
serves as both the validation batch and the test set (the reference draws
its validation batch from the test split).  The model is adenet_v5
(trimodal raw + DCT + diff, adaptive-sum fusion with ``use_adascale``), the
optimizer adadelta, and the held-out subject's test rate is appended to
``--results`` as ``<subject>,<test CR>``, so a loop over the subjects
builds the leave-one-out table.  The data is read and preprocessed on the
host; the model trains on ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions).

Usage:
    python -m ip_avsr_torch.cli.leave_one_out --config configs/oulu_trimodal.ini \\
        --test_subj 7 --results loo_results.csv
    python -m ip_avsr_torch.cli.leave_one_out --synthetic 60 --test_subj 2 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ip_avsr_torch.cli.nstream import _video_subjects, synthesize_dataset
from ip_avsr_torch.data import preprocessing as pp
from ip_avsr_torch.device import resolve_device
from ip_avsr_torch.io import matio
from ip_avsr_torch.models import zoo
from ip_avsr_torch.train import config as config_lib
from ip_avsr_torch.train.evaluation import plot_confusion_matrix
from ip_avsr_torch.train.trainer import Trainer, TrainOptions


def loo_split_ids(subjects, test_subj):
    """``(train ids, [test_subj])``: every other subject trains."""
    all_subj = np.unique(np.asarray(subjects).reshape(-1))
    if test_subj not in all_subj:
        raise ValueError(f"--test_subj {test_subj} not among subjects "
                         f"{all_subj.min()}..{all_subj.max()}")
    train_ids = [int(s) for s in all_subj if s != test_subj]
    return train_ids, [int(test_subj)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config")
    ap.add_argument("--test_subj", type=int, default=1,
                    help="subject id to hold out (oulu/leave_one_out.py:232)")
    ap.add_argument("--results", help="append '<subj>,<test CR>' to this file")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--num_epoch", type=int)
    ap.add_argument("--learning_rate", type=float)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.config:
        cp = config_lib.load_config(args.config)
        legacy = config_lib.parse_legacy_config(cp)
        data_cfg, model_cfg_d, train_cfg = legacy["data"], legacy["models"], legacy["training"]
    else:
        data_cfg, model_cfg_d, train_cfg = {}, {}, {}

    synth = bool(args.synthetic)
    lstm_size = int(model_cfg_d.get("lstm_size", 16 if synth else 250))
    output_classes = int(model_cfg_d.get("output_classes", 5 if synth else 10))
    use_adascale = str(model_cfg_d.get("use_adascale", "")).lower() in ("1", "true", "yes")
    windowsize = int(train_cfg.get("windowsize", 4 if synth else 9))
    # the reference schedule: 10 epochs x 120 batches x batchsize 10;
    # `is None` (not `or`): --num_epoch 0 is a valid eval-only override
    num_epoch = (int(train_cfg.get("num_epoch", 10))
                 if args.num_epoch is None else args.num_epoch)
    epochsize = int(train_cfg.get("epochsize", 6 if synth else 120))
    batchsize = int(train_cfg.get("batchsize", 10))
    learning_rate = (float(train_cfg.get("learning_rate", 1.0))
                     if args.learning_rate is None else args.learning_rate)
    decay_rate = float(train_cfg.get("decay_rate", 0.0))
    decay_start = int(train_cfg["decay_start"]) if "decay_start" in train_cfg else None
    validation_window = int(train_cfg.get("validation_window", 4))

    pretrained = None
    if synth:
        dim, dct_dim = 48, 12
        raw = synthesize_dataset(args.synthetic, dim, output_classes, seed=0)
        dct_ds = synthesize_dataset(args.synthetic, dct_dim, output_classes, seed=1)
        data, dct = raw["dataMatrix"], dct_ds["dataMatrix"]
        imagesize = (6, 8)
        enc_shapes = (32, 24, 16, 8)
        enc_nl = ("sigmoid", "sigmoid", "sigmoid", "linear")
    else:
        raw = matio.load_mat_file(data_cfg["images"])
        dct_mat = matio.load_mat_file(data_cfg["dct"])
        data = raw["dataMatrix"].astype(np.float32)
        dct = dct_mat["dctFeatures" if "dctFeatures" in dct_mat
                      else "dataMatrix"].astype(np.float32)
        dim, dct_dim = data.shape[1], dct.shape[1]
        imagesize = tuple(int(d) for d in data_cfg.get("imagesize", "26,44").split(","))
        # the framework's [models] keys or the reference's
        # (oulu/leave_one_out.py:253-255: pretrained/finetuned/finetuned_diff)
        raw_ae = next((model_cfg_d[k] for k in ("ae_pretrained", "finetuned", "pretrained")
                       if k in model_cfg_d), None)
        diff_ae = next((model_cfg_d[k] for k in ("ae_diff_pretrained", "finetuned_diff")
                        if k in model_cfg_d), None)
        if raw_ae and diff_ae:
            w1, b1 = matio.load_dbn_mat(raw_ae, n_layers=4)
            w2, b2 = matio.load_dbn_mat(diff_ae, n_layers=4)
            pretrained = [(w1, b1), None, (w2, b2)]

    targets = raw["targetsVec"].reshape(-1).astype(np.int64) - 1
    subjects = raw["subjectsVec"].reshape(-1)
    vidlens = raw["videoLengthVec"].reshape(-1).astype(np.int64)
    if len(subjects) != len(vidlens):
        # per-frame subjectsVec (AVLetters layout) -> per-video, which is
        # what loo_split_ids and split_seq_data consume
        subjects = _video_subjects(subjects, vidlens)

    # preprocessing chain (oulu/leave_one_out.py:285-313): diff images from
    # the raw stream, mean-removed DCT, samplewise-normalized raw and diff
    diff = pp.compute_diff_images(data, vidlens)
    dct = pp.sequencewise_mean_image_subtraction(dct, vidlens)
    if not synth:
        data = pp.reorder_data(data, imagesize)
        diff = pp.reorder_data(diff, imagesize)
    data = pp.normalize_input(data.copy())
    diff = pp.normalize_input(diff.copy())

    train_ids, test_ids = loo_split_ids(subjects, args.test_subj)
    print(f"train subjects: {train_ids}")
    print(f"test subjects: {test_ids}")

    # a 2-way split: no validation ids, the held-out subject is validation
    # AND test (the reference's validation batch comes from the test split)
    splits = [pp.split_seq_data(m, targets, subjects, vidlens, train_ids, [], test_ids)
              for m in (data, dct, diff)]
    train_streams = [s[0] for s in splits]
    test_streams = [s[8] for s in splits]
    tr_y, tr_l, tr_subj = splits[0][1], splits[0][2], splits[0][3]
    te_y, te_l, te_subj = splits[0][9], splits[0][10], splits[0][11]
    if args.test_subj in set(np.asarray(tr_subj).tolist()):
        raise AssertionError("held-out subject leaked into the training split")
    if set(np.asarray(te_subj).tolist()) != {args.test_subj}:
        raise AssertionError("the test split holds other subjects than the held-out one")

    # featurewise-normalize the DCT with the train statistics
    train_streams[1], mean, std = pp.featurewise_normalize_sequence(train_streams[1])
    test_streams[1] = (test_streams[1] - mean) / std

    cfg = zoo.adenet_v5(dim, dct_dim, dim, lstm_size=lstm_size, window=windowsize,
                        output_classes=output_classes, use_adascale=use_adascale)
    if train_cfg.get("matmul_dtype"):
        cfg = dataclasses.replace(cfg, matmul_dtype=train_cfg["matmul_dtype"])
    if synth:
        cfg = dataclasses.replace(cfg, streams=[
            dataclasses.replace(s, encoder_shapes=enc_shapes, encoder_nonlinearities=enc_nl)
            if s.encoder_shapes else s for s in cfg.streams])

    topts = TrainOptions(num_epoch=num_epoch, epochsize=epochsize, batchsize=batchsize,
                         learning_rate=learning_rate, optimizer="adadelta",
                         validation_window=validation_window, window=windowsize,
                         decay_rate=decay_rate, decay_start=decay_start)
    trainer = Trainer(cfg, topts, device=device)
    if pretrained is not None:
        params0 = trainer.init_params(torch.Generator().manual_seed(topts.seed),
                                      pretrained_encoders=pretrained)
        trainer.init_params = lambda generator, **kw: params0

    print(f"begin leave-one-out training (held-out subject {args.test_subj})...")
    result = trainer.fit((train_streams, tr_y, tr_l), (test_streams, te_y, te_l),
                         (test_streams, te_y, te_l))

    print("Final Model")
    print(f"subject {args.test_subj}: CR: {result.best_cr}, "
          f"val loss: {result.best_val}, Test CR: {result.test_cr}")
    names = [str(i) for i in range(output_classes)]
    print(plot_confusion_matrix(result.test_conf, names, fmt="pipe"))

    if args.results:
        with open(args.results, "a") as f:
            f.write(f"{args.test_subj},{result.test_cr}\n")
    return result


if __name__ == "__main__":
    main()
