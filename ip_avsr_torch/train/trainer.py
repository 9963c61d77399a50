"""Training of an AdeNet on one device: the step, evaluation and the epoch
loop.

Mirrors ip_avsr_tpu/train/trainer.py on a single device (the reference's
epoch loops, runners/4stream.py and oulu/trimodal_with_val.py):

  * an "epoch" is ``epochsize`` minibatches drawn from an infinite shuffled
    video-level stream (not a strict pass over the data); the batch order
    comes from a numpy ``RandomState`` in the same calls as in the JAX
    package, so both draw the same batches;
  * per epoch: the train cost is the cost of the last training batch
    (recomputed without updates), the val cost that of the whole validation
    split as one batch, GL (generalization loss), PQ = GL / Pk over a strip
    of three train costs, and the classification rate by majority vote
    (per-step heads) or last-step argmax;
  * the best validation cost keeps a snapshot of the parameters and
    evaluates the test split; ``early_stop2`` over a window of validation
    costs ends training; the learning rate decays after ``decay_start``;
  * optional NaN recovery, NaN checks, a torch.profiler trace, and
    checkpoint/resume of the whole train state;
  * batch-norm streams keep their running statistics in the parameter tree
    (``streams/<name>/bn_state``): they get zero gradients, so every
    optimizer state keeps the JAX package's structure, and a training
    step's moved statistics are merged after the update, as the JAX
    trainer merges them; evaluation, checkpoints, the best-parameter
    snapshot and NaN recovery carry them with the rest of the tree.

Dropout draws from a ``torch.Generator`` on the trainer's device, seeded
from ``TrainOptions.seed``; its bits differ from JAX's.  The trainer runs on
``cuda`` unless it is given ``device="cpu"``; on the card every LSTM and
delta call launches its CUDA kernel, on the CPU its plain version runs.
``make_train_step`` and ``loss_and_grads`` are the bare step the trainer's
own step is built from.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ip_avsr_torch.data.datagen import BucketedDataset, PaddedDataset
from ip_avsr_torch.device import resolve_device, tree_map, tree_to
from ip_avsr_torch.models import adenet
from ip_avsr_torch.ops import losses
from ip_avsr_torch.ops.voting import majority_voting_layer_masked
from ip_avsr_torch.train import checkpoints as ckpt_lib
from ip_avsr_torch.train import evaluation
from ip_avsr_torch.train import optimizers as opt_lib
from ip_avsr_torch.utils.data_structures import CircularList
from ip_avsr_torch.utils.regularization import early_stop2

SCALE_OUT = "ROADMAP Queue 1 item 10: scale-out"


def loss_fn(params, cfg, streams, y, mask, generator=None, train=True, parts=False,
            window=None, return_aux=False):
    """The loss of ``params`` on one batch: streams[i] (B, T, D_i), y (B,)
    int labels, mask (B, T).  Per-step heads take ``temporal_softmax_loss``,
    last-step heads ``categorical_crossentropy_masked`` with all-pad rows
    weighted 0.  ``train`` turns dropout on (draws from ``generator``) and
    normalizes batch-norm streams with the batch's statistics; ``parts``
    returns ``(numerator, count)``; ``return_aux`` returns ``(loss, aux)``
    with the forward's batch-norm aux (``models/adenet.adenet_forward``)."""
    out, aux = adenet.adenet_forward(params, cfg, streams, mask, window=window, train=train,
                                     generator=generator, return_aux=True)
    if out.dim() == 3:
        y2d = y[:, None].expand(-1, mask.shape[1])
        loss = losses.temporal_softmax_loss(out, y2d, mask, return_parts=parts)
    else:
        seq_weight = mask.sum(dim=1) > 0
        loss = losses.categorical_crossentropy_masked(out, y, seq_weight, return_parts=parts)
    return (loss, aux) if return_aux else loss


def loss_and_grads(params, cfg, streams, y, mask, generator=None, parts=False,
                   window=None, return_aux=False):
    """``(loss, grads)``: the training loss of :func:`loss_fn` (dropout on)
    and its gradient with respect to every leaf of ``params``, as a tree of
    the same structure (a leaf the loss does not reach gets zeros, as
    ``jax.grad`` gives: the batch-norm running statistics among them).
    With ``parts`` the loss is ``(numerator, count)`` and the gradient is
    the numerator's; ``return_aux`` appends the forward's aux."""
    leaves = []

    def track(p):
        leaf = p.detach().requires_grad_(True)
        leaves.append(leaf)
        return leaf

    tracked = tree_map(track, params)
    loss, aux = loss_fn(tracked, cfg, streams, y, mask, generator, parts=parts, window=window,
                        return_aux=True)
    num = loss[0] if parts else loss
    grads = iter(torch.autograd.grad(num, leaves, allow_unused=True))

    def grad_of(p):
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    loss = tuple(v.detach() for v in loss) if parts else loss.detach()
    grads = tree_map(grad_of, params)
    return (loss, grads, aux) if return_aux else (loss, grads)


def merge_bn_state(params, aux):
    """Write the moved batch-norm running statistics of a training
    forward's ``aux`` into ``params`` (after the optimizer's update, as
    the JAX trainer merges them) and return ``params``."""
    for name, new_bn in aux["bn_state"].items():
        params["streams"][name]["bn_state"] = new_bn
    return params


def make_train_step(cfg, lr=1e-4):
    """Returns ``(optimizer, train_step)`` with ``train_step(params,
    opt_state, streams, y, mask, generator) -> (params, opt_state, loss)``,
    one step of loss, gradients and Adam update, the batch-norm running
    statistics merged after the update."""
    optimizer = opt_lib.adam(lr)

    def train_step(params, opt_state, streams, y, mask, generator=None):
        loss, grads, aux = loss_and_grads(params, cfg, streams, y, mask, generator,
                                          return_aux=True)
        params, opt_state = optimizer.apply(params, grads, opt_state)
        return merge_bn_state(params, aux), opt_state, loss

    return optimizer, train_step


@dataclasses.dataclass
class TrainOptions:
    """The JAX package's options, field for field.  The mesh options
    (``use_mesh``, ``model_parallel``, ``model_parallel_rules``,
    ``sequence_parallel``, ``zero1``, ``multihost``, ``mesh_mode``) are not
    ported: any value that asks for more than one device raises."""

    num_epoch: int = 30
    epochsize: int = 120
    batchsize: int = 30
    learning_rate: float = 1e-4
    optimizer: str = "adam"
    validation_window: int = 6
    window: Optional[int] = None  # delta window override
    decay_rate: float = 0.0  # lr *= (1 - decay_rate) per epoch after decay_start
    decay_start: Optional[int] = None
    # raise FloatingPointError at the first step whose loss or updated
    # parameters are non-finite
    check_nans: bool = False
    # on a non-finite train or val cost: restore the best parameters so far,
    # reset the optimizer state, halve the learning rate, go on
    recover_on_nan: bool = False
    profile_dir: Optional[str] = None  # a torch.profiler trace of the fit
    # per-parameter learning rates, path prefix -> rate (optimizer="adam_vlr")
    lr_map_config: Optional[dict] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1  # epochs between checkpoints
    resume: bool = False  # restore the latest checkpoint before training
    seed: int = 42
    log_fn: Callable[[str], None] = print
    use_mesh: bool = False
    model_parallel: int = 1
    model_parallel_rules: Optional[Callable] = None
    sequence_parallel: int = 1
    zero1: bool = False
    mesh_mode: str = "gspmd"
    # None (pad every batch to the split's max T), "auto" (50/75/100th
    # percentile bounds) or inclusive T upper bounds
    bucket_boundaries: Optional[object] = None
    multihost: bool = False
    # vote or argmax and count the confusion matrix on the device; only the
    # (C, C) counts reach the host
    device_eval: bool = False
    # assemble the next batch on a background thread
    prefetch_batches: bool = True
    # keep the padded training set on the device and gather each batch there
    # (unbucketed runs; bucketed ones fall back to host assembly, logged)
    device_data: bool = False
    # K microbatches per step whose loss numerators' gradients are summed and
    # divided once by the batch's count: the full batch's gradient
    grad_accum_steps: int = 1


@dataclasses.dataclass
class TrainResult:
    best_params: dict  # tensors on the CPU
    best_val: float
    best_cr: float
    test_cr: float
    test_conf: np.ndarray
    cost_train: list
    cost_val: list
    class_rate: list
    epochs_run: int
    # the learning rate in effect when training ended (after any decay or
    # NaN-recovery halving)
    final_lr: float = 0.0


def _pad_rows(arrays, multiple: int) -> list:
    """Zero-pad the leading axis of each array to a multiple of
    ``multiple``."""
    b = arrays[0].shape[0]
    target = int(-(-b // multiple) * multiple)
    if target == b:
        return list(arrays)
    return [np.concatenate([a, np.zeros((target - b,) + a.shape[1:], a.dtype)])
            for a in arrays]


def _host(x) -> np.ndarray:
    """A restored tensor or number as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _clone(tree, device):
    """A detached copy of a parameter tree on ``device`` (``.to`` of a tensor
    already there would alias it)."""
    return tree_map(lambda t: t.detach().to(device, copy=True), tree)


class Trainer:
    """Trains an AdeNet-family model configured by an
    :class:`~ip_avsr_torch.models.adenet.AdeNetConfig` on ``device``
    (default ``cuda``)."""

    def __init__(self, config: adenet.AdeNetConfig, options: TrainOptions, device=None):
        self.config = config
        self.options = options
        if options.lr_map_config and options.optimizer != "adam_vlr":
            raise ValueError(
                "lr_map_config (the [lr_map] INI section) only applies to "
                f"optimizer='adam_vlr'; optimizer={options.optimizer!r} "
                "would silently ignore it")
        if options.mesh_mode not in ("gspmd", "shard_map"):
            raise ValueError(f"unknown mesh_mode: {options.mesh_mode}")
        asked = [name for name, on in (
            ("use_mesh", options.use_mesh),
            (f"model_parallel={options.model_parallel}", options.model_parallel > 1),
            (f"sequence_parallel={options.sequence_parallel}", options.sequence_parallel > 1),
            ("zero1", options.zero1),
            ("multihost", options.multihost),
            ("mesh_mode='shard_map'", options.mesh_mode == "shard_map")) if on]
        if asked:
            raise NotImplementedError(
                f"{', '.join(asked)}: the trainer runs on one device; meshes come "
                f"with {SCALE_OUT}")
        if options.grad_accum_steps > 1:
            if self._has_bn:
                raise ValueError(
                    "grad_accum_steps does not compose with batch-norm "
                    "streams: per-microbatch statistics would silently "
                    "change training semantics vs the full batch")
            if options.batchsize % options.grad_accum_steps != 0:
                raise ValueError(
                    f"grad_accum_steps={options.grad_accum_steps} must divide "
                    f"batchsize={options.batchsize}")
        self.device = resolve_device(device)
        if options.optimizer == "adam_vlr":
            # needs the parameter tree for its rate map: built in fit
            self.optimizer = None
        else:
            self.optimizer = opt_lib.select_optimizer(options.optimizer,
                                                      options.learning_rate)

    def _finalize_optimizer(self, params):
        if self.optimizer is None:
            lr_map = opt_lib.generate_lr_map(params, self.options.lr_map_config or {},
                                             self.options.learning_rate)
            self.optimizer = opt_lib.adam_vlr(lr_map, base_lr=self.options.learning_rate)

    def init_params(self, generator, pretrained_encoders=None, pretrained_stream_lstms=None):
        """The initial parameter tree on the trainer's device; callers may
        replace this attribute (a CLI seeds pretrained encoders so)."""
        return adenet.init_adenet_params(generator, self.config, device=self.device,
                                         pretrained_encoders=pretrained_encoders,
                                         pretrained_stream_lstms=pretrained_stream_lstms)

    # -- steps ----------------------------------------------------------------

    @property
    def _has_bn(self):
        return any(s.use_batchnorm for s in self.config.streams)

    def _loss(self, params, streams, y, mask, train, generator=None, parts=False):
        """The loss, and under training with batch norm ``(loss, aux)``, as
        the JAX trainer's ``_loss``."""
        aux = train and self._has_bn
        return loss_fn(params, self.config, streams, y, mask, generator, train=train,
                       parts=parts, window=self.options.window, return_aux=aux)

    def train_step(self, params, opt_state, streams, y, mask, generator, lr):
        """One step of loss, gradients and update at the rate ``lr`` ->
        ``(params, opt_state, loss)``; with ``grad_accum_steps`` > 1,
        :meth:`train_step_accum`."""
        if self.options.grad_accum_steps > 1:
            return self.train_step_accum(params, opt_state, streams, y, mask, generator, lr)
        loss, grads, aux = loss_and_grads(params, self.config, streams, y, mask, generator,
                                          window=self.options.window, return_aux=True)
        params, opt_state = self.optimizer.apply(params, grads, opt_state, learning_rate=lr)
        return merge_bn_state(params, aux), opt_state, loss

    def train_step_accum(self, params, opt_state, streams, y, mask, generator, lr):
        """K microbatches of B / K rows in order, each with its own draws of
        ``generator``: their loss numerators' gradients are summed and
        divided once by the batch's count, which gives the full batch's
        gradient (the count carries no gradient) while only one
        microbatch's residuals are live."""
        k = self.options.grad_accum_steps
        mb = y.shape[0] // k
        gsum, num_sum, den_sum = None, 0.0, 0.0
        for i in range(k):
            rows = slice(i * mb, (i + 1) * mb)
            (num, den), g = loss_and_grads(params, self.config, [s[rows] for s in streams],
                                           y[rows], mask[rows], generator, parts=True,
                                           window=self.options.window)
            gsum = g if gsum is None else tree_map(torch.add, gsum, g)
            num_sum, den_sum = num_sum + num, den_sum + den
        den = torch.clamp(den_sum, min=1.0)
        grads = tree_map(lambda g: g / den, gsum)
        params, opt_state = self.optimizer.apply(params, grads, opt_state, learning_rate=lr)
        return params, opt_state, num_sum / den

    @torch.no_grad()
    def eval_cost(self, params, streams, y, mask):
        return self._loss(params, streams, y, mask, train=False)

    @torch.no_grad()
    def predict(self, params, streams, mask):
        return adenet.adenet_forward(params, self.config, streams, mask,
                                     window=self.options.window)

    @torch.no_grad()
    def eval_confusion(self, params, streams, y, mask):
        """Probabilities -> vote or last-step argmax -> (C, C) confusion
        counts, all on the device."""
        probs = self.predict(params, streams, mask)
        C = self.config.output_classes
        scores = (majority_voting_layer_masked(probs, mask, C)
                  if self.config.output_mode == "per_step" else probs)
        valid = (mask.sum(dim=1) > 0).float()
        return evaluation.confusion_on_device(torch.argmax(scores, dim=-1), y, valid, C)

    # -- data plumbing --------------------------------------------------------

    def _host_tensor(self, a, dtype) -> torch.Tensor:
        """A host array as a CPU tensor of ``dtype``, pinned when the trainer
        runs on the card so that its copy there is asynchronous; a tensor
        passes through (:meth:`_host_batch` made it)."""
        if isinstance(a, torch.Tensor):
            return a
        t = torch.from_numpy(np.asarray(a, dtype))
        return t if self.device.type == "cpu" else t.pin_memory()

    def _host_batch(self, streams, y, mask):
        """A numpy batch as the step's host tensors: streams and mask
        float32, labels int64."""
        return ([self._host_tensor(s, np.float32) for s in streams],
                None if y is None else self._host_tensor(y, np.int64),
                self._host_tensor(mask, np.float32))

    def _device_batch(self, streams, y, mask):
        """A host batch (arrays, or tensors from :meth:`_host_batch`) on the
        device."""
        streams, y, mask = self._host_batch(streams, y, mask)
        move = lambda t: t.to(self.device, non_blocking=True)  # noqa: E731
        return [move(s) for s in streams], None if y is None else move(y), move(mask)

    def evaluate(self, params, streams, y, mask, eval_batchsize: int = 512, dev=None):
        """Classification rate and confusion matrix over a split.

        A split larger than ``eval_batchsize`` runs in chunks, each padded to
        ``eval_batchsize`` rows.  ``dev`` optionally gives the split already
        on the device, ``(streams, y, mask)``, as fit keeps the validation
        split."""
        n = len(mask)
        if self.options.device_eval:
            return self._evaluate_on_device(params, streams, y, mask, eval_batchsize, dev=dev)
        if dev is not None and n <= eval_batchsize:
            probs = self.predict(params, dev[0], dev[2]).cpu().numpy()[:n]
        elif n > eval_batchsize:
            chunks = []
            for start in range(0, n, eval_batchsize):
                sl = slice(start, start + eval_batchsize)
                valid = min(n - start, eval_batchsize)
                arrays = _pad_rows([np.asarray(s[sl]) for s in streams]
                                   + [np.asarray(mask)[sl]], eval_batchsize)
                sub_streams, _, sub_mask = self._device_batch(arrays[:-1], None, arrays[-1])
                chunks.append(self.predict(params, sub_streams, sub_mask).cpu().numpy()[:valid])
            probs = np.concatenate(chunks)
        else:
            sub_streams, _, sub_mask = self._device_batch(streams, None, mask)
            probs = self.predict(params, sub_streams, sub_mask).cpu().numpy()[:n]
        valid = np.asarray(mask).sum(axis=1) > 0
        if self.config.output_mode == "per_step":
            cr, conf, _ = evaluation.evaluate_majority_vote(
                probs[valid], np.asarray(y)[valid], np.asarray(mask)[valid])
        else:
            cr, conf, _ = evaluation.evaluate_last_step(probs[valid], np.asarray(y)[valid])
        return cr, conf

    def _evaluate_on_device(self, params, streams, y, mask, eval_batchsize: int = 512,
                            dev=None):
        """Whole-split evaluation without moving predictions to the host:
        each chunk's (C, C) counts come back, nothing else."""
        n = len(mask)
        C = self.config.output_classes
        if dev is not None and n <= eval_batchsize:
            conf = self.eval_confusion(params, *dev).cpu().numpy().astype(np.float64)
            return evaluation.cr_from_confusion(conf), conf.astype(np.int64)
        conf = np.zeros((C, C), np.float64)
        for start in range(0, n, eval_batchsize):
            sl = slice(start, start + eval_batchsize)
            rows = eval_batchsize if n > eval_batchsize else len(np.asarray(mask)[sl])
            arrays = _pad_rows([np.asarray(s[sl]) for s in streams]
                               + [np.asarray(mask)[sl], np.asarray(y)[sl]], rows)
            batch = self._device_batch(arrays[:-2], arrays[-1], arrays[-2])
            conf += self.eval_confusion(params, *batch).cpu().numpy()
        return evaluation.cr_from_confusion(conf), conf.astype(np.int64)

    # -- the loop -------------------------------------------------------------

    def fit(self, train_data: tuple, val_data: tuple, test_data: tuple) -> TrainResult:
        """Train on ``train_data`` = (list of frame-major stream arrays,
        per-frame targets, sequence lengths), select on ``val_data``, report
        on ``test_data``.  A ``profile_dir`` trace is written even when
        training raises."""
        o = self.options
        prof = None
        if o.profile_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        try:
            return self._fit_impl(train_data, val_data, test_data)
        finally:
            if prof is not None:
                prof.stop()
                os.makedirs(o.profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(o.profile_dir, "trace.json"))

    def _check_finite(self, loss, params, epoch, step):
        finite = [bool(torch.isfinite(loss).all())]
        tree_map(lambda t: finite.append(bool(torch.isfinite(t).all())), params)
        if not all(finite):
            raise FloatingPointError(
                f"check_nans: non-finite loss ({float(loss)}) or updated parameters at "
                f"epoch {epoch + 1}, step {step + 1}")

    def _fit_impl(self, train_data, val_data, test_data) -> TrainResult:
        o = self.options
        rng = np.random.RandomState(o.seed)
        generator = torch.Generator(device=self.device).manual_seed(o.seed)

        if o.bucket_boundaries is not None:
            bounds = (None if o.bucket_boundaries == "auto"
                      else [int(b) for b in o.bucket_boundaries])
            train_ds = BucketedDataset(train_data[0], train_data[1], train_data[2],
                                       boundaries=bounds)
            lens = np.asarray(train_data[2]).reshape(-1)
            global_waste = 1.0 - lens.sum() / (len(lens) * lens.max())
            o.log_fn(f"bucketed batches: boundaries={train_ds.boundaries}, "
                     f"padded-frame fraction {train_ds.padded_frame_fraction():.3f} "
                     f"(global-max padding: {global_waste:.3f})")
            n_trunc = int(np.sum(lens > train_ds.boundaries[-1]))
            if n_trunc:
                o.log_fn(
                    f"WARNING: {n_trunc} training sequences exceed the last "
                    f"bucket boundary {train_ds.boundaries[-1]} (max length "
                    f"{int(lens.max())}) and are TRUNCATED to it; raise "
                    f"bucket_boundaries to keep their full length")
        else:
            train_ds = PaddedDataset(train_data[0], train_data[1], train_data[2])
        val_ds = PaddedDataset(val_data[0], val_data[1], val_data[2])
        test_ds = PaddedDataset(test_data[0], test_data[1], test_data[2])

        params = tree_to(self.init_params(torch.Generator().manual_seed(o.seed)),
                         self.device)
        self._finalize_optimizer(params)
        opt_state = self.optimizer.init(params)
        start_epoch = 0
        restored_extra = {}
        if o.resume and o.checkpoint_dir:
            restored = ckpt_lib.restore_train_state(o.checkpoint_dir,
                                                    map_location=self.device)
            if restored is not None:
                params = restored["params"]
                opt_state = restored["opt_state"]
                start_epoch = int(restored["step"])
                restored_extra = restored.get("extra", {}) or {}
                # move the data-order and dropout streams past the completed
                # epochs, so the resumed run does not repeat epoch 0's draws
                rng = np.random.RandomState(o.seed + start_epoch)
                generator.manual_seed(o.seed + start_epoch)
                o.log_fn(f"resumed from {o.checkpoint_dir} at epoch {start_epoch}")

        # the whole validation and test splits, one fixed batch each
        val_streams, val_y, val_mask = val_ds.gather(np.arange(val_ds.n))
        test_streams, test_y, test_mask = test_ds.gather(np.arange(test_ds.n))
        val_dev = self._device_batch(val_streams, val_y, val_mask)
        test_dev_cache = []  # built on first use (best-val epochs only)

        def test_dev():
            if not test_dev_cache:
                test_dev_cache.append(self._device_batch(test_streams, test_y, test_mask))
            return test_dev_cache[0]

        cost_train = list(_host(restored_extra.get("cost_train", [])).reshape(-1))
        cost_val = list(_host(restored_extra.get("cost_val", [])).reshape(-1))
        class_rate = []
        STRIP = 3
        train_strip = np.zeros((STRIP,))
        val_window = CircularList(o.validation_window)
        # a resumed run's stop decision matches an uninterrupted one's
        for v in _host(restored_extra.get("val_window", [])).reshape(-1):
            val_window.push(float(v))
        for i, v in enumerate(_host(restored_extra.get("train_strip", np.zeros(0)))
                              .reshape(-1)[:STRIP]):
            train_strip[i] = v
        best_val = float(restored_extra.get("best_val", float("inf")))
        best_cr = float(restored_extra.get("best_cr", 0.0))
        test_cr = 0.0
        test_conf = None
        # the best parameters so far, a copy kept on the device (a copy to the
        # host per new best would cost 28 ms per 70 MB on the card); the
        # result hands back a CPU copy
        if "best_params" in restored_extra:
            best_params = _clone(restored_extra["best_params"], self.device)
        else:
            best_params = _clone(params, self.device)
        # the rate in effect (decay position and NaN-recovery halvings)
        lr = float(restored_extra.get("lr", o.learning_rate))
        epochs_run = 0

        use_device_data = o.device_data and not isinstance(train_ds, BucketedDataset)
        if o.device_data and not use_device_data:
            o.log_fn("device_data requested but unsupported with bucketed batches; "
                     "falling back to host-side batch assembly")
        if use_device_data:
            dense_dev = [torch.from_numpy(np.asarray(d, np.float32)).to(self.device)
                         for d in train_ds.dense]
            y_dev = torch.from_numpy(train_ds.y.astype(np.int64)).to(self.device)
            mask_dev = torch.from_numpy(train_ds.mask.astype(np.float32)).to(self.device)

            def gather(idxs, valid):
                # padded batch rows repeat row 0 with a zero mask: no-ops in
                # the masked losses
                return ([d[idxs] for d in dense_dev], y_dev[idxs],
                        mask_dev[idxs] * valid[:, None])

            batch_iter = self._infinite_index_batches(train_ds, o.batchsize, rng)
        else:
            # the host tensors (pinned for the card) are made where the batch
            # is assembled: on the prefetch thread when there is one
            batch_iter = (self._host_batch(*b) for b in
                          self._infinite_batches(train_ds, o.batchsize, rng))
            if o.prefetch_batches:
                from ip_avsr_torch.data.prefetch import prefetch

                batch_iter = prefetch(batch_iter, buffer_size=2)

        for epoch in range(start_epoch, o.num_epoch):
            t0 = time.time()
            last_batch = None
            for step in range(o.epochsize):
                if use_device_data:
                    batch = gather(*(self._host_tensor(a, a.dtype).to(
                        self.device, non_blocking=True) for a in next(batch_iter)))
                else:
                    batch = self._device_batch(*next(batch_iter))
                params, opt_state, loss = self.train_step(params, opt_state, *batch,
                                                          generator, lr)
                if o.check_nans:
                    self._check_finite(loss, params, epoch, step)
                last_batch = batch
            epochs_run = epoch + 1

            cost = float(self.eval_cost(params, *last_batch))
            val_cost = float(self.eval_cost(params, *val_dev))

            if o.recover_on_nan and not (np.isfinite(cost) and np.isfinite(val_cost)):
                params = _clone(best_params, self.device)
                opt_state = self.optimizer.init(params)
                lr = lr * 0.5
                o.log_fn(f"Epoch {epoch + 1}: non-finite cost "
                         f"(train={cost}, val={val_cost}); restored best "
                         f"params, reset optimizer, lr -> {lr:.3g}")
                continue

            cost_train.append(cost)
            cost_val.append(val_cost)
            train_strip[epoch % STRIP] = cost
            val_window.push(val_cost)

            gl = 100.0 * (cost_val[-1] / np.min(cost_val) - 1.0)
            strip_min = np.min(train_strip)
            pk = (1000.0 * (np.sum(train_strip) / (STRIP * strip_min) - 1.0)
                  if strip_min > 0 else 0.0)
            pq = gl / pk if pk != 0 else 0.0

            cr, _ = self.evaluate(params, val_streams, val_y, val_mask, dev=val_dev)
            class_rate.append(cr)

            if val_cost < best_val:
                best_val, best_cr = val_cost, cr
                test_cr, test_conf = self.evaluate(params, test_streams, test_y, test_mask,
                                                   dev=test_dev())
                best_params = _clone(params, self.device)
                o.log_fn(
                    f"Epoch {epoch + 1} train cost = {cost:.6f}, val cost = {val_cost:.6f}, "
                    f"GL loss = {gl:.3f}, GQ = {pq:.3f}, CR = {cr:.3f}, "
                    f"Test CR= {test_cr:.3f} ({time.time() - t0:.1f}sec)")
            else:
                o.log_fn(
                    f"Epoch {epoch + 1} train cost = {cost:.6f}, val cost = {val_cost:.6f}, "
                    f"GL loss = {gl:.3f}, GQ = {pq:.3f}, CR = {cr:.3f} "
                    f"({time.time() - t0:.1f}sec)")

            # decay before the checkpoint, so the saved rate is the one the
            # next epoch trains with and a resumed run continues the schedule
            if o.decay_start is not None and epoch + 1 >= o.decay_start and o.decay_rate:
                lr = lr * (1.0 - o.decay_rate)

            if o.checkpoint_dir and (epoch + 1) % o.checkpoint_every == 0:
                ckpt_lib.save_train_state(
                    o.checkpoint_dir, epoch + 1, params, opt_state,
                    extra={"best_val": best_val, "best_cr": best_cr,
                           "best_params": best_params,
                           "cost_train": np.asarray(cost_train),
                           "cost_val": np.asarray(cost_val),
                           "val_window": np.asarray(list(val_window)),
                           "train_strip": train_strip.copy(),
                           "lr": float(lr)})

            if epoch >= o.validation_window and early_stop2(val_window, best_val,
                                                            o.validation_window):
                break

        if test_conf is None:
            test_cr, test_conf = self.evaluate(params, test_streams, test_y, test_mask,
                                               dev=test_dev())
        return TrainResult(_clone(best_params, "cpu"), best_val, best_cr, test_cr, test_conf,
                           cost_train, cost_val, class_rate, epochs_run, final_lr=float(lr))

    def _infinite_index_batches(self, ds, batchsize: int, rng):
        """Index-only batches for device-resident data: the shuffle order of
        :meth:`_infinite_batches`, each step a (B,) int64 index array and a
        row-validity mask for the padded tail, as numpy."""
        while True:
            order = rng.permutation(ds.n)
            for start in range(0, ds.n, batchsize):
                idxs = order[start : start + batchsize]
                n_valid = len(idxs)
                if n_valid < batchsize:
                    idxs = np.concatenate([idxs, np.zeros(batchsize - n_valid, idxs.dtype)])
                valid = (np.arange(batchsize) < n_valid).astype(np.float32)
                yield idxs.astype(np.int64), valid

    def _infinite_batches(self, ds, batchsize: int, rng):
        """Shuffled video-level batches padded to ``batchsize`` rows, forever;
        from a :class:`BucketedDataset`, each batch of its bucket's T."""
        if isinstance(ds, BucketedDataset):
            while True:
                for _, streams, y, mask, _ in ds.epoch_batches(batchsize, rng=rng,
                                                               pad_to=batchsize):
                    yield streams, y, mask
        else:
            while True:
                order = rng.permutation(ds.n)
                for start in range(0, ds.n, batchsize):
                    idxs = order[start : start + batchsize]
                    yield ds.gather(idxs, pad_to=batchsize)
