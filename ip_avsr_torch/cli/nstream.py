"""Generic config-driven N-stream training runner: the port of
ip_avsr_tpu/cli/nstream.py.

CLI parity with runners/{1,2,3,4}stream.py: ``--config <ini>`` plus the
standard overrides (``--write_results``, ``--learning_rate``, ``--save_best``,
``--save_plot``; runners/4stream.py:116-137), the same [streamN] /
[lstm_classifier] / [training] INI schema, the same preprocessing pipeline
(presplit: reorder / meanremove / diffimage / samplewisenormalize; force-align;
subject-based split; postsplit featurewise normalize —
runners/4stream.py:90-113,238-294), pretrained encoder loading, and the same
per-epoch report lines.

Additions over the reference, as in the JAX package: ``--synthetic N``
fabricates a dataset (for smoke-running without the corpora),
``--split itervec``, ``--checkpoint_dir``/``--resume`` (``torch.save``
train states) and ``--device_data``.  The mesh flags (``--mesh``,
``--mesh_mode``, ``--model_parallel``, ``--sequence_parallel``, ``--zero1``)
reach ``TrainOptions`` and train over the ranks of a ``torch.distributed``
group, one device each: under ``torchrun`` the CLI joins the group that
torchrun's environment describes (``nccl`` on ``cuda``, ``gloo`` on
``cpu``), and rank 0 alone writes the results; without that environment
(or a group already joined) it runs the one-process mesh.  The data is read
and preprocessed on the host, by every rank; the model trains on
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).

Usage:
    python -m ip_avsr_torch.cli.nstream --config configs/synthetic_1stream.ini \\
        --synthetic 60 --device cpu
    torchrun --nproc_per_node 2 -m ip_avsr_torch.cli.nstream \\
        --config configs/synthetic_1stream.ini --synthetic 60 --mesh
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ip_avsr_torch.data import preprocessing as pp
from ip_avsr_torch.data.datagen import compute_integral_len
from ip_avsr_torch.device import resolve_device
from ip_avsr_torch.io import matio
from ip_avsr_torch.train import config as config_lib
from ip_avsr_torch.train.evaluation import plot_confusion_matrix
from ip_avsr_torch.train.trainer import Trainer, TrainOptions


def parse_options(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", default="config/1stream.ini",
                        help="[CONFIG_FILE] config file to use")
    parser.add_argument("--write_results", help="[FILE] append results csv")
    parser.add_argument("--learning_rate", type=float, help="override learning rate")
    parser.add_argument("--save_best", help="[FILE] save the best model params")
    parser.add_argument("--save_plot", help="[FILE_PREFIX] save loss curve + confusion")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="use N synthetic videos instead of .mat datasets")
    parser.add_argument("--split", default="subjects", choices=["subjects", "itervec"],
                        help="'subjects': subject-id file split (runners/*); "
                             "'itervec': AVLetters-style iterations 1,2=train, "
                             "3=test (utils/preprocessing.py:54-74)")
    parser.add_argument("--mesh", action="store_true",
                        help="data-parallel over the ranks (torchrun's processes)")
    parser.add_argument("--mesh_mode", default="gspmd", choices=["gspmd", "shard_map"],
                        help="with --mesh: each rank draws the whole batch's dropout "
                             "masks (gspmd) or its own (shard_map)")
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="tensor parallelism: size of the 'model' mesh dim (a "
                             "data x model mesh over the ranks)")
    parser.add_argument("--zero1", action="store_true",
                        help="ZeRO-1: each rank keeps its block of the optimizer "
                             "moments (implies --mesh, gspmd only)")
    parser.add_argument("--sequence_parallel", type=int, default=1,
                        help="sequence parallelism: size of the 'seq' mesh dim (a "
                             "data x seq mesh over the ranks)")
    parser.add_argument("--device_data", action="store_true",
                        help="keep the training set on the device; each step "
                             "gathers its batch there")
    parser.add_argument("--checkpoint_dir", help="torch.save train-state checkpoints")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint in --checkpoint_dir")
    parser.add_argument("--num_epoch", type=int)
    parser.add_argument("--validation_window", type=int)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def synthesize_dataset(n_videos, dim, classes, seed=0):
    """Fabricate a dataset dict with the reference's .mat schema.

    Sequence structure (lengths / targets / subjects) is drawn from a fixed
    seed so several synthetic streams stay frame-aligned; only the feature
    noise varies with ``seed``.
    """
    struct_rng = np.random.RandomState(0)
    rng = np.random.RandomState(seed + 1)
    lens = struct_rng.randint(10, 25, n_videos)
    y = struct_rng.randint(1, classes + 1, n_videos)  # MATLAB-style 1-based
    subjects = struct_rng.randint(1, 11, n_videos)  # per video, like the .mat schema
    frames = []
    for n, c in zip(lens, y):
        base = np.zeros(dim, np.float32)
        base[(c - 1) % dim] = 2.0
        frames.append(base + 0.5 * rng.randn(n, dim).astype(np.float32))
    return {
        "dataMatrix": np.concatenate(frames),
        "targetsVec": np.repeat(y, lens).reshape(-1, 1),  # per frame
        "subjectsVec": subjects.reshape(-1, 1),
        "videoLengthVec": lens.reshape(-1, 1),
    }


def presplit_processing(data_matrix, vidlens, sc: config_lib.StreamConfig):
    """runners/4stream.py:90-105 presplit pipeline."""
    if sc.reorderdata:
        data_matrix = pp.reorder_data(data_matrix, sc.imagesize)
    if sc.meanremove:
        data_matrix = pp.sequencewise_mean_image_subtraction(data_matrix, vidlens)
    if sc.diffimage:
        data_matrix = pp.compute_diff_images(data_matrix, vidlens)
    if sc.samplewisenormalize:
        data_matrix = pp.normalize_input(data_matrix)
    return data_matrix


def _wants_mesh(options) -> bool:
    return bool(options.mesh or options.zero1 or options.model_parallel > 1
                or options.sequence_parallel > 1)


@contextlib.contextmanager
def process_group(options, device):
    """The group of torchrun's environment, joined for the run and left
    after, when a mesh flag asks for one and no group is joined yet;
    otherwise nothing (the one-process mesh, or the caller's group)."""
    if (not _wants_mesh(options) or dist.is_initialized()
            or "WORLD_SIZE" not in os.environ or "MASTER_ADDR" not in os.environ):
        yield
        return
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://")
    try:
        yield
    finally:
        dist.destroy_process_group()


def main(argv=None):
    options = parse_options(argv)
    device = resolve_device(options.device)
    with process_group(options, device):
        return _main(options, device)


def _main(options, device):
    cp = config_lib.load_config(options.config)
    stream_cfgs = config_lib.parse_streams(cp)
    clf = config_lib.parse_classifier(cp)
    tc = config_lib.parse_training(cp)

    print(f"Reading Config File: {options.config}...")
    print(f"streams: {[s.name for s in stream_cfgs]}")

    # ---- load data -------------------------------------------------------
    if options.synthetic:
        datasets = [synthesize_dataset(options.synthetic, sc.input_dimensions,
                                       clf.output_classes, seed=i)
                    for i, sc in enumerate(stream_cfgs)]
    else:
        datasets = matio.load_mat_files([sc.data for sc in stream_cfgs])

    s1 = datasets[0]
    targets_vec = s1["targetsVec"].reshape(-1).astype(np.int64)
    subjects_vec = s1["subjectsVec"].reshape(-1)
    vidlen_vec = s1["videoLengthVec"].reshape(-1).astype(np.int64)
    if clf.matlab_target_offset or options.synthetic:
        targets_vec = targets_vec - 1

    matrices = [d["dataMatrix"].astype(np.float32) for d in datasets]
    matrices = [presplit_processing(m, vidlen_vec, sc)
                for m, sc in zip(matrices, stream_cfgs)]

    if stream_cfgs[0].force_align_data and not options.synthetic:
        # reduce a per-frame subjectsVec to per-video BEFORE alignment:
        # force_align pads every video to the longest stream's length, so the
        # post-alignment vidlen_vec no longer indexes stream1's original
        # frame vector
        if len(subjects_vec) != len(vidlen_vec):
            subjects_vec = _video_subjects(subjects_vec, vidlen_vec)
        orig = []
        for d, m in zip(datasets, matrices):
            orig.append((m, d["targetsVec"].reshape(-1), d["videoLengthVec"].reshape(-1)))
        new_streams = pp.multistream_force_align(orig)
        matrices = [s[0] for s in new_streams]
        targets_vec = new_streams[0][1].astype(np.int64)
        vidlen_vec = new_streams[0][2]
        if clf.matlab_target_offset:
            targets_vec = targets_vec - 1

    # ---- split ------------------------------------------------------------
    if options.split == "itervec" and not options.synthetic:
        # AVLetters-style: frame-level boolean split from iterVec; iterations
        # 1 and 2 train, the rest test; test doubles as the validation set
        # (the avletters mains evaluate on test each epoch).
        iter_vec = s1["iterVec"].reshape(-1)
        train_mask = pp.create_split_index(len(matrices[0]), vidlen_vec, iter_vec)
        train_lens_l, test_lens_l = pp.split_videolen(vidlen_vec.tolist(),
                                                      iter_vec.tolist())
        train_streams = [m[train_mask] for m in matrices]
        test_streams = [m[~train_mask] for m in matrices]
        test_y = targets_vec[~train_mask]
        test_lens = np.asarray(test_lens_l)
        return _train_and_report(options, device, clf, tc, stream_cfgs,
                                 train_streams, targets_vec[train_mask],
                                 np.asarray(train_lens_l),
                                 list(test_streams), test_y, test_lens,
                                 test_streams, test_y, test_lens,
                                 lr_map_config=config_lib.parse_lr_map(cp))

    if options.synthetic:
        train_ids, val_ids, test_ids = \
            config_lib.synthetic_subject_split(subjects_vec)
    else:
        train_ids = matio.read_data_split_file(tc.train_subjects_file)
        val_ids = matio.read_data_split_file(tc.val_subjects_file)
        test_ids = matio.read_data_split_file(tc.test_subjects_file)

    # subjectsVec is per-video in the .mat schema; tolerate per-frame variants
    if len(subjects_vec) == len(vidlen_vec):
        video_subjects = subjects_vec
    else:
        video_subjects = _video_subjects(subjects_vec, vidlen_vec)
    split = [pp.split_seq_data(m, targets_vec, video_subjects,
                               vidlen_vec, train_ids, val_ids, test_ids)
             for m in matrices]

    return _train_and_report(options, device, clf, tc, stream_cfgs,
                             [s[0] for s in split], split[0][1], split[0][2],
                             [s[4] for s in split], split[0][5], split[0][6],
                             [s[8] for s in split], split[0][9], split[0][10],
                             lr_map_config=config_lib.parse_lr_map(cp))


def _train_and_report(options, device, clf, tc, stream_cfgs,
                      train_streams, train_y, train_lens,
                      val_streams, val_y, val_lens,
                      test_streams, test_y, test_lens,
                      lr_map_config=None):
    # ---- postsplit featurewise normalization ------------------------------
    for i, sc in enumerate(stream_cfgs):
        if sc.featurewisenormalize:
            train_streams[i], mean, std = pp.featurewise_normalize_sequence(train_streams[i])
            val_streams[i] = (val_streams[i] - mean) / std
            test_streams[i] = (test_streams[i] - mean) / std

    # ---- model ------------------------------------------------------------
    encoders = []
    pretrained = []
    for sc in stream_cfgs:
        if sc.shape and sc.use_encoder:
            encoders.append((sc.nonlinearities, sc.shape))
            if sc.model and not options.synthetic:
                w, b, _, _ = matio.load_decoder(sc.model, sc.shape,
                                                ",".join(sc.nonlinearities))
                pretrained.append((w, b))
            else:
                pretrained.append(None)
        else:
            encoders.append(None)
            pretrained.append(None)

    # the one (stream configs, classifier config) -> model builder that the
    # demo and export rebuild a trained model with
    model_cfg = config_lib.build_model_config(stream_cfgs, clf, encoders)
    if tc.matmul_dtype:
        model_cfg = dataclasses.replace(model_cfg, matmul_dtype=tc.matmul_dtype)

    # `is None` (not `or`): 0 is a legitimate explicit override
    # (--num_epoch 0 = eval-only smoke run)
    topts = TrainOptions(
        num_epoch=tc.num_epoch if options.num_epoch is None else options.num_epoch,
        epochsize=tc.epochsize,
        batchsize=tc.batchsize,
        learning_rate=(tc.learning_rate if options.learning_rate is None
                       else options.learning_rate),
        optimizer=tc.optimizer,
        validation_window=(tc.validation_window
                           if options.validation_window is None
                           else options.validation_window),
        window=clf.windowsize,
        decay_rate=tc.decay_rate,
        decay_start=tc.decay_start,
        use_mesh=options.mesh,
        mesh_mode=options.mesh_mode,
        model_parallel=options.model_parallel,
        sequence_parallel=options.sequence_parallel,
        zero1=options.zero1,
        checkpoint_dir=options.checkpoint_dir,
        resume=options.resume,
        bucket_boundaries=tc.bucket_boundaries,
        device_data=options.device_data,
        grad_accum_steps=tc.grad_accum_steps,
        lr_map_config=lr_map_config,
    )

    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    if not rank0:
        topts = dataclasses.replace(topts, log_fn=lambda *_: None)
    trainer = Trainer(model_cfg, topts, device=device)
    params0 = trainer.init_params(torch.Generator().manual_seed(topts.seed),
                                  pretrained_encoders=pretrained if any(
                                      p is not None for p in pretrained) else None)
    trainer.init_params = lambda generator, **kw: params0  # reuse the pretrained init

    print("begin training...")
    result = trainer.fit(
        (train_streams, train_y, train_lens),
        (val_streams, val_y, val_lens),
        (test_streams, test_y, test_lens),
    )

    if not rank0:
        return result
    print("Final Model")
    print(f"CR: {result.best_cr}, val loss: {result.best_val}, Test CR: {result.test_cr}")
    classnames = clf.output_classnames or [str(i) for i in range(clf.output_classes)]
    table = plot_confusion_matrix(result.test_conf, classnames, fmt="pipe")
    print("confusion matrix: ")
    print(table)

    if options.save_plot:
        _save_loss_plot(result, options.save_plot)
        with open(f"{options.save_plot}.confmat.txt", "a") as f:
            f.write(table + "\n\n")
    if options.write_results:
        with open(options.write_results, "a") as f:
            f.write(f"{result.test_cr},{result.best_cr},{result.best_val}\n")
    if options.save_best:
        matio.save_model_params(result.best_params, options.save_best)
        print(f"best model saved to {options.save_best}")
    return result


def _video_subjects(subjects_vec, vidlen_vec):
    """Frame-level subjects -> per-video subjects via frame offsets."""
    return np.asarray(subjects_vec)[np.asarray(compute_integral_len(vidlen_vec))]


def _save_loss_plot(result, prefix):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        epochs = np.arange(1, len(result.cost_train) + 1)
        plt.figure()
        plt.plot(epochs, result.cost_train, label="train")
        plt.plot(epochs, result.cost_val, label="validation")
        plt.xlabel("epoch")
        plt.ylabel("cost")
        plt.legend()
        plt.savefig(f"{prefix}.validloss.png")
        plt.close()
    except Exception as e:  # pragma: no cover
        print(f"could not save plot: {e}")


if __name__ == "__main__":
    main()
