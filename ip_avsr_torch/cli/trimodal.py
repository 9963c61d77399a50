"""Trimodal training runner (legacy [data]/[models]/[training] INI schema):
the port of ip_avsr_tpu/cli/trimodal.py.

Parity with oulu/trimodal_with_val.py:259-529 and cuave/trimodal_with_val.py:
load the images + DCT .mat files, build diff-images and mean-removed DCT,
split by subject-id files (or leave-one-out with --test_subj,
oulu/leave_one_out.py:232), samplewise/featurewise normalize, reorder pixels
for the F-ordered pretrained encoders, build adenet_v3 with two pretrained
autoencoders, train with adadelta + LR decay, report CR / confusion matrix.

Config keys ([data]: images, dct, imagesize; [models]: fusiontype,
lstm_size, output_classes, the autoencoders as ae_pretrained /
ae_diff_pretrained or the reference's finetuned / pretrained /
finetuned_diff; [training]: learning_rate, decay_rate, decay_start,
num_epoch, epochsize, batchsize, validation_window, windowsize, the subject
files, matmul_dtype) follow the reference README.md:67-89 schema.  The data
is read and preprocessed on the host; the model trains on ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions).

Usage:
    python -m ip_avsr_torch.cli.trimodal --config configs/oulu_trimodal.ini
    python -m ip_avsr_torch.cli.trimodal --synthetic 60 --device cpu   # smoke mode
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config")
    ap.add_argument("--write_results")
    ap.add_argument("--learning_rate", type=float)
    ap.add_argument("--save_best")
    ap.add_argument("--test_subj", type=int,
                    help="leave-one-out: hold this subject out as test "
                         "(oulu/leave_one_out.py --test_subj)")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--num_epoch", type=int)
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
    fusiontype = model_cfg_d.get("fusiontype", "sum")
    lstm_size = int(model_cfg_d.get("lstm_size", 16 if synth else 250))
    output_classes = int(model_cfg_d.get("output_classes", 5 if synth else 10))
    windowsize = int(train_cfg.get("windowsize", 4 if synth else 9))
    # `is None` (not `or`): --num_epoch 0 is a valid eval-only override
    num_epoch = (int(train_cfg.get("num_epoch", 12))
                 if args.num_epoch is None else args.num_epoch)
    epochsize = int(train_cfg.get("epochsize", 6 if synth else 120))
    batchsize = int(train_cfg.get("batchsize", 10))
    learning_rate = (float(train_cfg.get("learning_rate", 1.0))
                     if args.learning_rate is None else args.learning_rate)
    decay_rate = float(train_cfg.get("decay_rate", 0.0))
    decay_start = int(train_cfg["decay_start"]) if "decay_start" in train_cfg else None
    validation_window = int(train_cfg.get("validation_window", 6))

    pretrained = None
    if args.synthetic:
        dim, dct_dim = 48, 12
        raw = synthesize_dataset(args.synthetic, dim, output_classes, seed=0)
        dct_ds = synthesize_dataset(args.synthetic, dct_dim, output_classes, seed=1)
        data = raw["dataMatrix"]
        dct = dct_ds["dataMatrix"]
        imagesize = (6, 8)
        enc_shapes = (32, 24, 16, 8)
        enc_nl = ("sigmoid", "sigmoid", "sigmoid", "linear")
    else:
        raw = matio.load_mat_file(data_cfg["images"])
        dct_mat = matio.load_mat_file(data_cfg["dct"])
        data = raw["dataMatrix"].astype(np.float32)
        dct = dct_mat["dctFeatures" if "dctFeatures" in dct_mat
                      else "dataMatrix"].astype(np.float32)
        dim = data.shape[1]
        dct_dim = dct.shape[1]
        imagesize = tuple(int(d) for d in data_cfg.get("imagesize", "26,44").split(","))
        # the reference's [models] keys are 'pretrained'/'finetuned'/
        # 'finetuned_diff' (oulu/trimodal_with_val.py:276-278: load_finetune
        # picks the finetuned AEs); the framework's own are ae_pretrained /
        # ae_diff_pretrained
        raw_ae = next((model_cfg_d[k] for k in
                       ("ae_pretrained", "finetuned", "pretrained")
                       if k in model_cfg_d), None)
        diff_ae = next((model_cfg_d[k] for k in
                        ("ae_diff_pretrained", "finetuned_diff")
                        if k in model_cfg_d), None)
        if raw_ae and diff_ae:
            w1, b1 = matio.load_dbn_mat(raw_ae, n_layers=4)
            w2, b2 = matio.load_dbn_mat(diff_ae, n_layers=4)
            pretrained = [(w1, b1), None, (w2, b2)]
        if train_cfg.get("do_finetune", "").lower() in ("true", "1", "yes"):
            print("note: do_finetune is handled by the separate ae_finetuner CLI "
                  "(python -m ip_avsr_torch.cli.ae_finetuner); training proceeds with "
                  "the given AEs")

    targets = raw["targetsVec"].reshape(-1).astype(np.int64) - 1
    subjects = raw["subjectsVec"].reshape(-1)
    vidlens = raw["videoLengthVec"].reshape(-1).astype(np.int64)
    if len(subjects) != len(vidlens):
        # per-frame subjectsVec (AVLetters layout) -> per-video, which is
        # what split_seq_data and the LOO split consume
        subjects = _video_subjects(subjects, vidlens)

    # preprocessing chain (oulu/trimodal_with_val.py:311-339):
    diff = pp.compute_diff_images(data, vidlens)
    dct = pp.sequencewise_mean_image_subtraction(dct, vidlens)
    if not args.synthetic:
        # encoders were trained on F-ordered pixels (reorder_data quirk,
        # oulu/trimodal_with_val.py:361-366)
        data = pp.reorder_data(data, imagesize)
        diff = pp.reorder_data(diff, imagesize)
    data = pp.normalize_input(data.copy())
    diff = pp.normalize_input(diff.copy())

    if args.test_subj is not None:
        # leave-one-out split (oulu/leave_one_out.py)
        all_subj = np.unique(subjects)
        test_ids = [args.test_subj]
        rest = [s for s in all_subj if s != args.test_subj]
        val_ids = rest[:max(1, len(rest) // 5)]
        train_ids = rest[max(1, len(rest) // 5):]
    elif args.synthetic:
        train_ids, val_ids, test_ids = \
            config_lib.synthetic_subject_split(subjects)
    else:
        train_ids = matio.read_data_split_file(train_cfg["train_subjects_file"])
        val_ids = matio.read_data_split_file(train_cfg["val_subjects_file"])
        test_ids = matio.read_data_split_file(train_cfg["test_subjects_file"])

    splits = [pp.split_seq_data(m, targets, subjects, vidlens, train_ids, val_ids,
                                test_ids) for m in (data, dct, diff)]
    train_streams = [s[0] for s in splits]
    val_streams = [s[4] for s in splits]
    test_streams = [s[8] for s in splits]
    tr_y, tr_l = splits[0][1], splits[0][2]
    va_y, va_l = splits[0][5], splits[0][6]
    te_y, te_l = splits[0][9], splits[0][10]

    # featurewise normalize the DCT stream with train statistics
    train_streams[1], mean, std = pp.featurewise_normalize_sequence(train_streams[1])
    val_streams[1] = (val_streams[1] - mean) / std
    test_streams[1] = (test_streams[1] - mean) / std

    cfg = zoo.adenet_v3(dim, dct_dim, dim, lstm_size=lstm_size, window=windowsize,
                        output_classes=output_classes, fusiontype=fusiontype)
    if train_cfg.get("matmul_dtype"):
        cfg = dataclasses.replace(cfg, matmul_dtype=train_cfg["matmul_dtype"])
    if args.synthetic:
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

    print("begin training adenet_v3 (trimodal raw+dct+diff)...")
    result = trainer.fit((train_streams, tr_y, tr_l), (val_streams, va_y, va_l),
                         (test_streams, te_y, te_l))

    print("Final Model")
    print(f"CR: {result.best_cr}, val loss: {result.best_val}, Test CR: {result.test_cr}")
    names = [str(i) for i in range(output_classes)]
    print(plot_confusion_matrix(result.test_conf, names, fmt="latex"))

    if args.write_results:
        with open(args.write_results, "a") as f:
            f.write(f"{result.test_cr},{result.best_cr},{result.best_val}\n")
    if args.save_best:
        matio.save_model_params(result.best_params, args.save_best)
    return result


if __name__ == "__main__":
    main()
