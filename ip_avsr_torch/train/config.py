"""INI configs of both schemas, and the model they select.

The port's own copy of ip_avsr_tpu/train/config.py (that module needs no
JAX, but the port imports nothing of the JAX package).  Keys follow the
reference runners' schema (runners/*.py, e.g. runners/4stream.py:159-224):

  [stream1..N]  data, imagesize, model, input_dimensions, shape,
                nonlinearities, reorderdata, diffimage, meanremove,
                samplewisenormalize, featurewisenormalize, force_align_data,
                use_encoder, use_delta
  [lstm_classifier] fusiontype, weight_init, use_peepholes, windowsize,
                output_classes, output_classnames, lstm_size,
                matlab_target_offset, use_dropout, use_blstm, lstm_remat,
                lstm_residual_dtype
  [training]    validation_window, num_epoch, learning_rate, epochsize,
                batchsize, optimizer, decay_rate, decay_start,
                train_subjects_file, val_subjects_file, test_subjects_file,
                bucket_boundaries, matmul_dtype, grad_accum_steps
  [lr_map]      optional: parameter-path prefixes -> per-layer learning rates

Schema "legacy" ([data]/[models]/[training], oulu/trimodal_with_val.py:274-287)
is read by :func:`parse_legacy_config` for the trimodal CLI.

Every key is parsed as the JAX package parses it, so a file selects the same
model config in both packages; :func:`build_model_config` is the one
selection logic.  ``bucket_boundaries`` and ``grad_accum_steps`` reach the
Trainer, which runs both; ``lstm_remat`` and ``lstm_residual_dtype`` reach
every training recurrence of the model (``ops/lstm.lstm_forward``).
``matmul_dtype`` reaches the model config, where "bfloat16" rounds every
product's operands to bf16 with float32 sums (``models/adenet``).
"""

from __future__ import annotations

import configparser
import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class StreamConfig:
    name: str
    data: Optional[str] = None
    imagesize: Optional[tuple] = None
    model: Optional[str] = None  # path to a w1..wN/b1..bN .mat encoder
    input_dimensions: int = 0
    shape: Optional[List[int]] = None
    nonlinearities: Optional[List[str]] = None
    reorderdata: bool = False
    diffimage: bool = False
    meanremove: bool = False
    samplewisenormalize: bool = False
    featurewisenormalize: bool = False
    force_align_data: bool = False
    use_encoder: bool = True
    use_delta: bool = True


@dataclasses.dataclass
class ClassifierConfig:
    fusiontype: str = "sum"
    weight_init: str = "glorot"
    use_peepholes: bool = False
    windowsize: int = 9
    output_classes: int = 26
    output_classnames: Optional[List[str]] = None
    lstm_size: int = 250
    matlab_target_offset: bool = False
    use_dropout: bool = False
    use_blstm: bool = True
    lstm_remat: bool = False
    lstm_residual_dtype: Optional[str] = None


@dataclasses.dataclass
class TrainingConfig:
    validation_window: int = 6
    num_epoch: int = 30
    learning_rate: float = 1e-4
    epochsize: int = 120
    batchsize: int = 30
    optimizer: str = "adam"
    decay_rate: float = 0.0
    decay_start: Optional[int] = None
    train_subjects_file: Optional[str] = None
    val_subjects_file: Optional[str] = None
    test_subjects_file: Optional[str] = None
    # "auto", or ascending T upper bounds; None = global-max padding
    bucket_boundaries: Optional[object] = None
    matmul_dtype: Optional[str] = None
    grad_accum_steps: int = 1


def load_config(path: str) -> configparser.ConfigParser:
    cp = configparser.ConfigParser()
    if not cp.read(path):
        raise FileNotFoundError(f"config file not found: {path}")
    return cp


def _getboolean(cp, section, key, default=False):
    try:
        return cp.getboolean(section, key)
    except (configparser.NoOptionError, configparser.NoSectionError, ValueError):
        return default


def _get(cp, section, key, default=None):
    try:
        return cp.get(section, key)
    except (configparser.NoOptionError, configparser.NoSectionError):
        return default


def parse_stream(cp: configparser.ConfigParser, section: str) -> StreamConfig:
    shape = _get(cp, section, "shape")
    nonlin = _get(cp, section, "nonlinearities")
    imagesize = _get(cp, section, "imagesize")
    return StreamConfig(
        name=section,
        data=_get(cp, section, "data"),
        imagesize=tuple(int(d) for d in imagesize.split(",")) if imagesize else None,
        model=_get(cp, section, "model"),
        input_dimensions=int(_get(cp, section, "input_dimensions", 0)),
        shape=[int(s) for s in shape.split(",")] if shape else None,
        nonlinearities=nonlin.split(",") if nonlin else None,
        reorderdata=_getboolean(cp, section, "reorderdata"),
        diffimage=_getboolean(cp, section, "diffimage"),
        meanremove=_getboolean(cp, section, "meanremove"),
        samplewisenormalize=_getboolean(cp, section, "samplewisenormalize"),
        featurewisenormalize=_getboolean(cp, section, "featurewisenormalize"),
        force_align_data=_getboolean(cp, section, "force_align_data"),
        use_encoder=_getboolean(cp, section, "use_encoder", default=True),
        use_delta=_getboolean(cp, section, "use_delta", default=True),
    )


def parse_streams(cp: configparser.ConfigParser) -> List[StreamConfig]:
    streams = []
    i = 1
    while cp.has_section(f"stream{i}"):
        streams.append(parse_stream(cp, f"stream{i}"))
        i += 1
    return streams


def parse_classifier(cp: configparser.ConfigParser) -> ClassifierConfig:
    sec = "lstm_classifier"
    names = _get(cp, sec, "output_classnames")
    return ClassifierConfig(
        fusiontype=_get(cp, sec, "fusiontype", "sum"),
        weight_init=_get(cp, sec, "weight_init", "glorot"),
        use_peepholes=_getboolean(cp, sec, "use_peepholes"),
        windowsize=int(_get(cp, sec, "windowsize", 9)),
        output_classes=int(_get(cp, sec, "output_classes", 26)),
        output_classnames=names.split(",") if names else None,
        lstm_size=int(_get(cp, sec, "lstm_size", 250)),
        matlab_target_offset=_getboolean(cp, sec, "matlab_target_offset"),
        use_dropout=_getboolean(cp, sec, "use_dropout"),
        use_blstm=_getboolean(cp, sec, "use_blstm", default=True),
        lstm_remat=_getboolean(cp, sec, "lstm_remat"),
        lstm_residual_dtype=_get(cp, sec, "lstm_residual_dtype"),
    )


def parse_training(cp: configparser.ConfigParser) -> TrainingConfig:
    sec = "training"
    decay_start = _get(cp, sec, "decay_start")
    return TrainingConfig(
        validation_window=int(_get(cp, sec, "validation_window", 6)),
        num_epoch=int(_get(cp, sec, "num_epoch", 30)),
        learning_rate=float(_get(cp, sec, "learning_rate", 1e-4)),
        epochsize=int(_get(cp, sec, "epochsize", 120)),
        batchsize=int(_get(cp, sec, "batchsize", 30)),
        optimizer=_get(cp, sec, "optimizer", "adam"),
        decay_rate=float(_get(cp, sec, "decay_rate", 0.0)),
        decay_start=int(decay_start) if decay_start else None,
        train_subjects_file=_get(cp, sec, "train_subjects_file"),
        val_subjects_file=_get(cp, sec, "val_subjects_file"),
        test_subjects_file=_get(cp, sec, "test_subjects_file"),
        bucket_boundaries=_parse_buckets(_get(cp, sec, "bucket_boundaries")),
        matmul_dtype=_get(cp, sec, "matmul_dtype") or None,
        grad_accum_steps=int(_get(cp, sec, "grad_accum_steps", 1)),
    )


def parse_lr_map(cp: configparser.ConfigParser):
    """Optional ``[lr_map]`` section: parameter-path prefixes -> learning
    rates (e.g. ``output = 0.005`` or ``streams/s1/encoder = 0.0001``)."""
    if not cp.has_section("lr_map"):
        return None
    return {k: float(v) for k, v in cp.items("lr_map")}


def _parse_buckets(raw):
    if not raw:
        return None
    raw = raw.strip()
    if raw.lower() == "auto":
        return "auto"
    return sorted(set(int(b) for b in raw.split(",")))


def parse_legacy_config(cp: configparser.ConfigParser) -> dict:
    """[data]/[models]/[training] schema (oulu/trimodal_with_val.py:274-287):
    each section as a dict of raw strings, empty where it is missing."""
    return {name: dict(cp.items(name)) if cp.has_section(name) else {}
            for name in ("data", "models", "training")}


def build_model_config(stream_cfgs, clf: ClassifierConfig, encoders=None):
    """(stream configs, classifier config) -> ``AdeNetConfig``.

    ``encoders[i]`` is None or ``(nonlinearities, shapes)`` for stream i;
    it defaults to what the stream configs declare (the shapes of a fresh
    init).  One stream selects a single-stream builder (with an encoder,
    deltas on raw features, or neither); several select
    ``zoo.adenet_nstream``."""
    from ip_avsr_torch.models import zoo

    if encoders is None:
        encoders = [(s.nonlinearities, s.shape) if s.shape and s.use_encoder
                    else None for s in stream_cfgs]
    dims = [s.input_dimensions for s in stream_cfgs]
    common = dict(lstm_size=clf.lstm_size, output_classes=clf.output_classes,
                  w_init=clf.weight_init, use_peepholes=clf.use_peepholes,
                  use_blstm=clf.use_blstm)
    if len(stream_cfgs) == 1:
        if encoders[0] is not None:
            cfg = zoo.deltanet_majority_vote(dims[0], encoders[0][1], encoders[0][0],
                                             window=clf.windowsize, **common)
        elif stream_cfgs[0].use_delta:
            cfg = zoo.deltanet_v1(dims[0], window=clf.windowsize, **common)
        else:
            cfg = zoo.lstm_classifier_majority_vote(dims[0], **common)
        if not stream_cfgs[0].use_delta:
            cfg = dataclasses.replace(
                cfg, streams=[dataclasses.replace(cfg.streams[0], use_delta=False)])
    else:
        cfg = zoo.adenet_nstream(
            dims, encoders, window=clf.windowsize, fusiontype=clf.fusiontype,
            stream_dropout=0.5 if clf.use_dropout else 0.0,
            stream_lstm_multiplier=2 if clf.use_dropout else 1,
            use_delta=[s.use_delta for s in stream_cfgs], **common)
    if clf.lstm_remat:
        cfg = dataclasses.replace(cfg, lstm_remat=True)
    if clf.lstm_residual_dtype:
        cfg = dataclasses.replace(cfg, lstm_residual_dtype=clf.lstm_residual_dtype)
    return cfg


def synthetic_subject_split(subjects_vec):
    """The 60/20/20 split of the unique subjects that synthetic runs use:
    ``(train_ids, val_ids, test_ids)``."""
    subj_ids = np.unique(subjects_vec)
    n = len(subj_ids)
    train_ids = subj_ids[: max(1, int(0.6 * n))]
    val_ids = subj_ids[max(1, int(0.6 * n)): max(2, int(0.8 * n))]
    test_ids = subj_ids[max(2, int(0.8 * n)):]
    return train_ids, val_ids, test_ids
