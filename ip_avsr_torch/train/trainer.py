"""Training of an AdeNet: the step, evaluation and the epoch loop, on one
device or over a mesh of ranks.

Mirrors ip_avsr_tpu/train/trainer.py (the reference's epoch loops,
runners/4stream.py and oulu/trimodal_with_val.py):

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
    (``streams/<name>/bn_state``, and a conv front end's, one pair for each
    of its batch norms, ``streams/<name>/frontend_state``): they get zero
    gradients, so every optimizer state keeps the JAX package's structure,
    and a training step's moved statistics are merged after the update, as
    the JAX trainer merges them; evaluation, checkpoints, the best-parameter
    snapshot and NaN recovery carry them with the rest of the tree.

Dropout draws from a ``torch.Generator`` on the trainer's device, seeded
from ``TrainOptions.seed``; its bits differ from JAX's.  The trainer runs on
``cuda`` unless it is given ``device="cpu"``; on the card every LSTM and
delta call launches its CUDA kernel, on the CPU its plain version runs.
``make_train_step`` and ``loss_and_grads`` are the bare step the trainer's
own step is built from.

The mesh options (``use_mesh``, ``mesh_mode``, ``multihost``, ``zero1``,
``model_parallel``, ``sequence_parallel``) run the same trainer on every
rank of a ``torch.distributed`` group (``parallel/``), one rank per device,
as JAX runs one program over a mesh.  Each rank computes the loss's
(numerator, count) parts on its rows; the counts are all-reduced and the
loss is the quotient, and the numerator's gradients are summed over the
ranks in one all-reduce of one flat buffer (a mean of per-rank means would
be wrong wherever the ranks' counts differ: ragged masks, pad rows).  Under
``gspmd`` each rank draws the whole batch's dropout masks and keeps its
rows, so the mesh equals one process bit for bit; under ``shard_map`` the
rank is folded into the generator's seed.  Checkpoints hold the whole,
unsharded state, written by rank 0, and resume under any mesh shape.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ip_avsr_torch.data.datagen import BucketedDataset, PaddedDataset
from ip_avsr_torch.device import resolve_device, tree_map, tree_to
from ip_avsr_torch.models import adenet
from ip_avsr_torch.ops import losses
from ip_avsr_torch.ops.voting import majority_voting_layer_masked
from ip_avsr_torch.parallel import collectives
from ip_avsr_torch.parallel import mesh as mesh_lib
from ip_avsr_torch.parallel import sequence as seq_lib
from ip_avsr_torch.train import checkpoints as ckpt_lib
from ip_avsr_torch.train import evaluation
from ip_avsr_torch.train import optimizers as opt_lib
from ip_avsr_torch.utils import spans
from ip_avsr_torch.utils.data_structures import CircularList
from ip_avsr_torch.utils.regularization import early_stop2


def head_loss(out, y, mask, parts=False):
    """The loss of a forward's output ``out`` against y (B,) int labels
    under mask (B, T): ``temporal_softmax_loss`` for per-step heads,
    ``categorical_crossentropy_masked`` with all-pad rows weighted 0 for
    last-step heads; ``parts`` returns ``(numerator, count)``."""
    if out.dim() == 3:
        y2d = y[:, None].expand(-1, mask.shape[1])
        return losses.temporal_softmax_loss(out, y2d, mask, return_parts=parts)
    seq_weight = mask.sum(dim=1) > 0
    return losses.categorical_crossentropy_masked(out, y, seq_weight, return_parts=parts)


def loss_fn(params, cfg, streams, y, mask, generator=None, train=True, parts=False,
            window=None, return_aux=False):
    """The loss of ``params`` on one batch: streams[i] (B, T, D_i), y (B,)
    int labels, mask (B, T), through :func:`head_loss`.  ``train`` turns
    dropout on (draws from ``generator``) and normalizes batch-norm streams
    with the batch's statistics; ``parts`` returns ``(numerator, count)``;
    ``return_aux`` returns ``(loss, aux)`` with the forward's batch-norm aux
    (``models/adenet.adenet_forward``)."""
    out, aux = adenet.adenet_forward(params, cfg, streams, mask, window=window, train=train,
                                     generator=generator, return_aux=True)
    loss = head_loss(out, y, mask, parts)
    return (loss, aux) if return_aux else loss


def grads_of(fn, params):
    """``(value, grads)`` for ``fn(params) -> (objective, value)``: the
    gradient of the scalar ``objective`` with respect to every leaf of
    ``params``, as a tree of the same structure (a leaf it does not reach
    gets zeros, as ``jax.grad`` gives: the batch-norm running statistics
    among them)."""
    leaves = []

    def track(p):
        leaf = p.detach().requires_grad_(True)
        leaves.append(leaf)
        return leaf

    with spans.span("train.forward"):
        objective, value = fn(tree_map(track, params))
    with spans.span("train.backward"):
        grads = iter(torch.autograd.grad(objective, leaves, allow_unused=True))

    def grad_of(p):
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    return value, tree_map(grad_of, params)


def loss_and_grads(params, cfg, streams, y, mask, generator=None, parts=False,
                   window=None, return_aux=False):
    """``(loss, grads)``: the training loss of :func:`loss_fn` (dropout on)
    and its gradient with respect to every leaf of ``params``
    (:func:`grads_of`).  With ``parts`` the loss is ``(numerator, count)``
    and the gradient is the numerator's; ``return_aux`` appends the
    forward's aux."""
    def fn(tracked):
        loss, aux = loss_fn(tracked, cfg, streams, y, mask, generator, parts=parts,
                            window=window, return_aux=True)
        return (loss[0] if parts else loss), (loss, aux)

    (loss, aux), grads = grads_of(fn, params)
    loss = tuple(v.detach() for v in loss) if parts else loss.detach()
    return (loss, grads, aux) if return_aux else (loss, grads)


def merge_bn_state(params, aux):
    """Write the moved batch-norm running statistics of a training
    forward's ``aux`` into ``params`` (after the optimizer's update, as
    the JAX trainer merges them) and return ``params``: a stream's batch
    norm (``bn_state``) and a conv front end's tree of them
    (``frontend_state``)."""
    for key in ("bn_state", "frontend_state"):
        for name, new_state in aux.get(key, {}).items():
            params["streams"][name][key] = new_state
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
    """The JAX package's options, field for field.  The mesh options run
    over the ranks of the default ``torch.distributed`` group (one device
    each; without a group, the one-process mesh)."""

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
    # a torch.profiler trace of the fit (trace.json), with the spans of
    # utils/spans.py: ip_avsr::train.step and its .forward, .backward and
    # .optimizer, the collectives on a mesh
    profile_dir: Optional[str] = None
    # per-parameter learning rates, path prefix -> rate (optimizer="adam_vlr")
    lr_map_config: Optional[dict] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1  # epochs between checkpoints
    resume: bool = False  # restore the latest checkpoint before training
    seed: int = 42
    log_fn: Callable[[str], None] = print
    # split each batch's rows over the ranks: a 1-D 'data' mesh
    use_mesh: bool = False
    # tensor parallelism: the size of a 'model' dim; the encoders' w and b
    # are split on their output columns over it (parallel/mesh.
    # adenet_param_rules, or model_parallel_rules), the optimizer moments
    # alike; everything else is replicated.  gspmd only
    model_parallel: int = 1
    model_parallel_rules: Optional[Callable] = None
    # sequence parallelism: the size of a 'seq' dim; the frame-parallel
    # prefix runs on time blocks with halo-exchanged deltas, the head on row
    # blocks (parallel/sequence.py); the splits' padded T is rounded up to a
    # multiple.  gspmd only; excludes model_parallel, bucket_boundaries and
    # multihost
    sequence_parallel: int = 1
    # ZeRO-1: each rank keeps its block of every optimizer moment (the
    # largest dim the 'data' size divides, parallel/mesh.zero1_spec),
    # updates its block of each parameter, and the blocks are all-gathered:
    # the replicated update, with n-fold less optimizer memory a rank
    zero1: bool = False
    # "gspmd": the mesh equals one process (the whole batch's dropout masks,
    # each rank keeping its rows); "shard_map": explicit per-rank bodies with
    # per-rank dropout masks (the rank folded into the generator's seed)
    mesh_mode: str = "gspmd"
    # None (pad every batch to the split's max T), "auto" (50/75/100th
    # percentile bounds) or inclusive T upper bounds
    bucket_boundaries: Optional[object] = None
    # JAX's multi-process input (parallel/multihost.py); a rank here is
    # one process already and takes its rows of the batch as under
    # use_mesh, so the option turns device_eval on and changes nothing else
    multihost: bool = False
    # vote or argmax and count the confusion matrix on the device; only the
    # (C, C) counts reach the host (summed over the ranks on a mesh)
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


def _pad_to(arrays, multiple: int) -> list:
    return mesh_lib.pad_batch_to_multiple(arrays, multiple)[0]


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
    (default ``cuda``); with a mesh option, on every rank of the default
    process group, each rank on its ``device``."""

    def __init__(self, config: adenet.AdeNetConfig, options: TrainOptions, device=None):
        self.config = config
        self.options = options
        if options.lr_map_config and options.optimizer != "adam_vlr":
            raise ValueError(
                "lr_map_config (the [lr_map] INI section) only applies to "
                f"optimizer='adam_vlr'; optimizer={options.optimizer!r} "
                "would silently ignore it")
        # the JAX trainer's refusals, in its order (ip_avsr_tpu/train/trainer.py)
        if options.model_parallel > 1 and options.sequence_parallel > 1:
            raise ValueError("model_parallel and sequence_parallel are "
                             "mutually exclusive (pick one secondary axis)")
        n_dev = dist.get_world_size() if dist.is_initialized() else 1
        if options.model_parallel > 1:
            if options.mesh_mode == "shard_map":
                raise ValueError("model_parallel requires mesh_mode='gspmd' "
                                 "(shard_map is the explicit data-parallel path)")
            if n_dev % options.model_parallel != 0:
                raise ValueError(f"model_parallel={options.model_parallel} does "
                                 f"not divide the device count {n_dev}")
            self.mesh = mesh_lib.make_mesh_nd({"data": n_dev // options.model_parallel,
                                               "model": options.model_parallel})
        elif options.sequence_parallel > 1:
            if options.mesh_mode == "shard_map":
                raise ValueError("sequence_parallel requires mesh_mode='gspmd'")
            if options.bucket_boundaries is not None:
                raise ValueError("sequence_parallel does not compose with "
                                 "bucket_boundaries (per-bucket T would need "
                                 "per-bucket sp divisibility); pick one")
            if options.multihost:
                raise ValueError("sequence_parallel + multihost is not "
                                 "supported yet")
            if n_dev % options.sequence_parallel != 0:
                raise ValueError(f"sequence_parallel={options.sequence_parallel}"
                                 f" does not divide the device count {n_dev}")
            self.mesh = mesh_lib.make_mesh_nd({"data": n_dev // options.sequence_parallel,
                                               "seq": options.sequence_parallel})
        else:
            self.mesh = mesh_lib.make_mesh() if (options.use_mesh or options.zero1) else None
        if options.mesh_mode not in ("gspmd", "shard_map"):
            raise ValueError(f"unknown mesh_mode: {options.mesh_mode}")
        if options.zero1:
            if options.mesh_mode == "shard_map":
                raise ValueError("zero1 requires mesh_mode='gspmd' (the "
                                 "schedule is derived by the SPMD partitioner)")
            if options.model_parallel > 1:
                raise ValueError("zero1 + model_parallel is redundant: tensor "
                                 "parallelism already shards the optimizer "
                                 "moments to match the parameter shardings")
            if options.sequence_parallel > 1 or options.multihost:
                raise ValueError("zero1 with sequence_parallel/multihost is "
                                 "not supported yet")
        if options.grad_accum_steps > 1:
            if options.mesh_mode == "shard_map":
                raise ValueError("grad_accum_steps requires mesh_mode='gspmd'")
            if self._has_bn:
                raise ValueError(
                    "grad_accum_steps does not compose with batch-norm "
                    "streams: per-microbatch statistics would silently "
                    "change training semantics vs the full batch")
            if options.batchsize % options.grad_accum_steps != 0:
                raise ValueError(
                    f"grad_accum_steps={options.grad_accum_steps} must divide "
                    f"batchsize={options.batchsize}")
        adenet.check_supported(config, self.mesh)
        self.device = resolve_device(device)
        if options.optimizer == "adam_vlr":
            # needs the parameter tree for its rate map: built in fit
            self.optimizer = None
        else:
            self.optimizer = opt_lib.select_optimizer(options.optimizer,
                                                      options.learning_rate)
        self._param_sh = self._z1_dims = None
        if self.mesh is not None:
            # the dims the batch's rows are split over: the loss's counts,
            # the gradients and the confusion counts are summed over them
            self._batch_axes = ("data", "seq") if self._sp_active else ("data",)
            self._batch_group = self.mesh.group(self._batch_axes)
            self._rows = (self.mesh.axis_size("data"), self.mesh.axis_index("data"))

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
        return any(s.use_batchnorm or s.frontend for s in self.config.streams)

    @property
    def _sp_active(self) -> bool:
        return self.options.sequence_parallel > 1

    @property
    def _tp_active(self) -> bool:
        return self.options.model_parallel > 1

    def _forward(self, params, streams, mask, train, generator=None):
        """``(out, y_rows, aux)``: the model's output on this rank's rows,
        which rows of ``streams`` those are (sequence parallelism: a chunk
        of the global batch it is given; else all), and the batch-norm
        aux."""
        o = self.options
        if self._sp_active:
            out, rows, aux = seq_lib.forward_rows(params, self.config, streams, mask, self.mesh,
                                                  train=train, generator=generator,
                                                  window=o.window)
            return out, rows, aux
        kw = {}
        if self.mesh is not None:
            kw = dict(mesh=self.mesh, bn_axis=self._batch_axes if self._has_bn else None,
                      model_axis="model" if self._tp_active else None)
            if o.mesh_mode == "gspmd":
                n, r = self._rows
                B = mask.shape[0]
                kw["block"] = adenet.Block(B * n, slice(r * B, (r + 1) * B))
        out, aux = adenet.adenet_forward(params, self.config, streams, mask, window=o.window,
                                         train=train, generator=generator, return_aux=True,
                                         **kw)
        return out, slice(None), aux

    def _loss(self, params, streams, y, mask, train, generator=None, parts=False):
        """The loss, and under training with batch norm ``(loss, aux)``, as
        the JAX trainer's ``_loss``; on a mesh, of this rank's rows."""
        out, rows, aux = self._forward(params, streams, mask, train, generator)
        loss = head_loss(out, y[rows], mask[rows], parts)
        return (loss, aux) if train and self._has_bn else loss

    def train_step(self, params, opt_state, streams, y, mask, generator, lr):
        """One step of loss, gradients and update at the rate ``lr`` ->
        ``(params, opt_state, loss)``; with ``grad_accum_steps`` > 1,
        :meth:`train_step_accum`; on a mesh, :meth:`mesh_train_step`.  The
        span ``train.step`` holds the step, whichever path it takes, under
        a new step id."""
        with spans.span("train.step", ident=spans.new_id()):
            if self.mesh is not None:
                return self.mesh_train_step(params, opt_state, streams, y, mask, generator, lr)
            if self.options.grad_accum_steps > 1:
                return self.train_step_accum(params, opt_state, streams, y, mask, generator, lr)
            loss, grads, aux = loss_and_grads(params, self.config, streams, y, mask, generator,
                                              window=self.options.window, return_aux=True)
            with spans.span("train.optimizer"):
                params, opt_state = self.optimizer.apply(params, grads, opt_state,
                                                         learning_rate=lr)
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
        with spans.span("train.optimizer"):
            params, opt_state = self.optimizer.apply(params, grads, opt_state, learning_rate=lr)
        return params, opt_state, num_sum / den

    def mesh_train_step(self, params, opt_state, streams, y, mask, generator, lr):
        """The step on this rank of the mesh, on its rows (its blocks of the
        parameters and optimizer state under tensor parallelism and ZeRO-1):
        :meth:`mesh_loss_and_grads`, then the update (:meth:`_apply`) and
        the batch-norm statistics merged.  Returns the global loss."""
        loss, grads, aux = self.mesh_loss_and_grads(params, streams, y, mask, generator)
        with spans.span("train.optimizer"):
            params, opt_state = self._apply(params, grads, opt_state, lr)
            if aux is not None:
                params = merge_bn_state(params, aux)
        return params, opt_state, loss

    def mesh_loss_and_grads(self, params, streams, y, mask, generator=None):
        """``(loss, grads, aux)`` of the whole batch from this rank's rows:
        per microbatch (``grad_accum_steps``) the (numerator, count) parts
        and the numerator's gradients, then one all-reduce over the batch's
        ranks of one flat buffer of every gradient, the numerator and the
        count, the gradients divided by max(count, 1).  ``aux`` is the
        batch-norm aux (None without batch norm)."""
        k = self.options.grad_accum_steps
        mb = y.shape[0] // k
        gsum, num_sum, den_sum, aux = None, 0.0, 0.0, None

        def objective(rows):
            def fn(tracked):
                res = self._loss(tracked, [s[rows] for s in streams], y[rows], mask[rows],
                                 True, generator, parts=True)
                (num, den), a = res if self._has_bn else (res, None)
                return num, (num.detach(), den.detach(), a)

            return fn

        for i in range(k):
            (num, den, aux), g = grads_of(objective(slice(i * mb, (i + 1) * mb)), params)
            gsum = g if gsum is None else tree_map(torch.add, gsum, g)
            num_sum, den_sum = num_sum + num, den_sum + den
        leaves = []
        tree_map(leaves.append, gsum)
        summed = collectives.flat_all_reduce(
            leaves + [torch.stack([num_sum, den_sum]).to(leaves[0].dtype)], self._batch_group)
        num, den = summed[-1][0], torch.clamp(summed[-1][1], min=1.0)
        summed = iter(summed[:-1])
        return num / den, tree_map(lambda _: next(summed) / den, gsum), aux

    def _apply(self, params, grads, opt_state, lr):
        """The optimizer's update; under ZeRO-1 on this rank's block of each
        leaf with a sharded moment, whose updated blocks are then
        all-gathered over ``data`` (one buffer)."""
        if self._z1_dims is None:
            return self.optimizer.apply(params, grads, opt_state, learning_rate=lr)
        cut = lambda t, d: t if d is None else self._block(t, d)  # noqa: E731
        new, opt_state = self.optimizer.apply(tree_map(cut, params, self._z1_dims),
                                              tree_map(cut, grads, self._z1_dims),
                                              opt_state, learning_rate=lr)
        blocks, dims = [], []
        tree_map(lambda t, d: (blocks.append(t), dims.append(d)) if d is not None else None,
                 new, self._z1_dims)
        parts = iter(collectives.flat_all_gather(blocks, self.mesh.group("data")))
        dims = iter(dims)
        return tree_map(lambda t, d: t if d is None else torch.cat(next(parts), dim=next(dims)),
                        new, self._z1_dims), opt_state

    def _block(self, t, d):
        """This rank's block of ``t`` along dim ``d`` split over ``data``."""
        n, r = self._rows
        w = t.shape[d] // n
        return t.narrow(d, r * w, w)

    @torch.no_grad()
    def eval_cost(self, params, streams, y, mask):
        """The loss without dropout; on a mesh the quotient of the parts
        summed over the ranks."""
        if self.mesh is None:
            return self._loss(params, streams, y, mask, train=False)
        num, den = self._loss(params, streams, y, mask, train=False, parts=True)
        num, den = collectives.flat_all_reduce([num.reshape(1), den.reshape(1).to(num.dtype)],
                                               self._batch_group)
        return (num / torch.clamp(den, min=1.0)).reshape(())

    @torch.no_grad()
    def predict(self, params, streams, mask):
        """The probabilities of the whole batch; on a mesh the ranks' rows
        all-gathered (on every rank)."""
        out, _, _ = self._forward(params, streams, mask, train=False)
        if self.mesh is None:
            return out
        return collectives.all_gather(out, 0, self._batch_group)

    @torch.no_grad()
    def eval_confusion(self, params, streams, y, mask):
        """Probabilities -> vote or last-step argmax -> (C, C) confusion
        counts, all on the device; on a mesh, each rank counts its rows and
        the counts are summed over the ranks."""
        probs, rows, _ = self._forward(params, streams, mask, train=False)
        y, mask = y[rows], mask[rows]
        C = self.config.output_classes
        scores = (majority_voting_layer_masked(probs, mask, C)
                  if self.config.output_mode == "per_step" else probs)
        valid = (mask.sum(dim=1) > 0).float()
        conf = evaluation.confusion_on_device(torch.argmax(scores, dim=-1), y, valid, C)
        if self.mesh is None:
            return conf
        return collectives.flat_all_reduce([conf], self._batch_group)[0]

    # -- state on the mesh ----------------------------------------------------

    def _setup_tensor_parallel(self, params, opt_state):
        """This rank's blocks of the whole ``(params, opt_state)`` under the
        tensor-parallel shardings (``parallel/mesh.param_shardings`` with
        ``model_parallel_rules``; the moments mirror them)."""
        self._param_sh = mesh_lib.param_shardings(params, self.mesh,
                                                  self.options.model_parallel_rules)
        self._opt_sh = mesh_lib.opt_state_shardings(opt_state, params, self._param_sh,
                                                    self.mesh)
        return self._place_state(params, opt_state)

    def _setup_zero1(self, params, opt_state):
        """Parameters replicated, each moment leaf cut to this rank's
        ``zero1_spec`` block over ``data``."""
        n = self.mesh.shape["data"]
        self._z1_dims = tree_map(
            lambda p: next((d for d, a in enumerate(mesh_lib.zero1_spec(p, n)) if a), None),
            params)
        self._opt_sh = mesh_lib.zero1_opt_state_shardings(opt_state, params, self.mesh)
        return self._place_state(params, opt_state)

    def _place_state(self, params, opt_state):
        """The whole ``(params, opt_state)`` -> this rank's blocks."""
        return self._place_params(params), self._place_opt(opt_state)

    def _place_params(self, params):
        if self._param_sh is None:
            return params
        return tree_map(lambda t, sh: sh.local(t), params, self._param_sh)

    def _place_opt(self, opt_state):
        if self._param_sh is None and self._z1_dims is None:
            return opt_state
        return tree_map(lambda t, sh: sh.local(t), opt_state, self._opt_sh)

    def _init_opt(self, params):
        """A fresh optimizer state for this rank's ``params``."""
        opt_state = self.optimizer.init(params)
        return opt_state if self._z1_dims is None else self._place_opt(opt_state)

    def _whole(self, tree, shardings):
        """A tree of this rank's blocks -> the whole tree (the blocks of
        every sharded leaf all-gathered, one buffer per dim)."""
        if shardings is None:
            return tree
        leaves, shs = [], []
        tree_map(lambda t, sh: (leaves.append(t), shs.append(sh)), tree, shardings)
        out = list(leaves)
        for axis in self.mesh.axis_names:
            idx = [i for i, sh in enumerate(shs) if any(a is not None and axis in
                                                        mesh_lib._axes(a) for a in sh.spec)]
            if not idx:
                continue
            parts = collectives.flat_all_gather([out[i] for i in idx], self.mesh.group(axis))
            for i, ps in zip(idx, parts):
                d = next(d for d, a in enumerate(shs[i].spec)
                         if a is not None and axis in mesh_lib._axes(a))
                out[i] = torch.cat(ps, dim=d)
        it = iter(out)
        return tree_map(lambda _: next(it), tree)

    def _whole_state(self, params, opt_state):
        """This rank's ``(params, opt_state)`` -> the whole, unsharded state
        (a collective: every rank calls it)."""
        return self._whole(params, self._param_sh), self._whole(
            opt_state, self._opt_sh if (self._param_sh is not None or self._z1_dims is not None)
            else None)

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

    def _mesh_rows(self, streams, y, mask, microbatches=1):
        """This rank's share of a host batch: the rows zero-padded to a
        multiple of the row split (pad rows carry a zero mask); then the
        rank's rows (its ``data`` block; with ``microbatches`` k its block
        of each of the k microbatches, so that each microbatch is split
        over the ranks as the whole batch is), or under sequence
        parallelism the whole padded batch, from which each rank cuts its
        blocks."""
        arrays = [np.asarray(a) for a in streams] + [np.asarray(mask)] + (
            [] if y is None else [np.asarray(y)])
        n, r = self._rows
        k = 1 if self._sp_active else microbatches
        arrays, _ = mesh_lib.pad_batch_to_multiple(
            arrays, self.mesh.axis_size(self._batch_axes) * k)
        B = arrays[0].shape[0]
        if self._sp_active:
            local = arrays
        else:
            MB, mb = B // k, B // (k * n)
            idx = np.concatenate([np.arange(i * MB + r * mb, i * MB + (r + 1) * mb)
                                  for i in range(k)])
            local = [a[idx] for a in arrays]
        ns = len(streams)
        return local[:ns], (None if y is None else local[-1]), local[ns]

    def _host_share(self, streams, y, mask, microbatches=1):
        """A numpy batch as this rank's host tensors (:meth:`_host_batch` of
        :meth:`_mesh_rows` on a mesh)."""
        if self.mesh is not None:
            streams, y, mask = self._mesh_rows(streams, y, mask, microbatches)
        return self._host_batch(streams, y, mask)

    def _to_device(self, batch):
        streams, y, mask = batch
        move = lambda t: t.to(self.device, non_blocking=True)  # noqa: E731
        return [move(s) for s in streams], None if y is None else move(y), move(mask)

    def _device_batch(self, streams, y, mask, microbatches=1):
        """A numpy batch on the device; on a mesh, this rank's share
        (:meth:`_mesh_rows`)."""
        return self._to_device(self._host_share(streams, y, mask, microbatches))

    def evaluate(self, params, streams, y, mask, eval_batchsize: int = 512, dev=None):
        """Classification rate and confusion matrix over a split.

        A split larger than ``eval_batchsize`` runs in chunks, each padded to
        ``eval_batchsize`` rows.  ``dev`` optionally gives the split already
        on the device, ``(streams, y, mask)``, as fit keeps the validation
        split."""
        n = len(mask)
        if self.options.device_eval or (self.options.multihost and self.mesh is not None):
            return self._evaluate_on_device(params, streams, y, mask, eval_batchsize, dev=dev)
        if dev is not None and n <= eval_batchsize:
            probs = self.predict(params, dev[0], dev[2]).cpu().numpy()[:n]
        elif n > eval_batchsize:
            chunks = []
            for start in range(0, n, eval_batchsize):
                sl = slice(start, start + eval_batchsize)
                valid = min(n - start, eval_batchsize)
                arrays = _pad_to([np.asarray(s[sl]) for s in streams]
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
            arrays = _pad_to([np.asarray(s[sl]) for s in streams]
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
        generator = torch.Generator(device=self.device).manual_seed(self._dropout_seed(o.seed))

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
            train_ds = PaddedDataset(train_data[0], train_data[1], train_data[2],
                                     max_timesteps=self._sp_max_t(train_data[2]))
        val_ds = PaddedDataset(val_data[0], val_data[1], val_data[2],
                               max_timesteps=self._sp_max_t(val_data[2]))
        test_ds = PaddedDataset(test_data[0], test_data[1], test_data[2],
                                max_timesteps=self._sp_max_t(test_data[2]))

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
                generator.manual_seed(self._dropout_seed(o.seed + start_epoch))
                o.log_fn(f"resumed from {o.checkpoint_dir} at epoch {start_epoch}")
        if self.mesh is not None:
            # rank 0's state on every rank, then each rank's blocks
            params = mesh_lib.replicate(self.mesh, params)
            opt_state = mesh_lib.replicate(self.mesh, opt_state)
            if self._tp_active:
                params, opt_state = self._setup_tensor_parallel(params, opt_state)
            elif o.zero1:
                params, opt_state = self._setup_zero1(params, opt_state)

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
            best_params = _clone(self._place_params(restored_extra["best_params"]), self.device)
        else:
            best_params = _clone(params, self.device)
        # the rate in effect (decay position and NaN-recovery halvings)
        lr = float(restored_extra.get("lr", o.learning_rate))
        epochs_run = 0

        use_device_data = (o.device_data and self.mesh is None
                           and not isinstance(train_ds, BucketedDataset))
        if o.device_data and not use_device_data:
            o.log_fn("device_data requested but unsupported with "
                     f"{'a mesh' if self.mesh is not None else 'bucketed batches'}"
                     "; falling back to host-side batch assembly")
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
            # the host tensors (pinned for the card; on a mesh, of this
            # rank's rows) are made where the batch is assembled: on the
            # prefetch thread when there is one
            batch_iter = (self._host_share(*b, microbatches=o.grad_accum_steps) for b in
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
                    batch = self._to_device(next(batch_iter))
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
                opt_state = self._init_opt(params)
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
                # the whole state (gathered on every rank), written by rank 0
                whole_params, whole_opt = self._whole_state(params, opt_state)
                whole_best = self._whole(best_params, self._param_sh)
                if not dist.is_initialized() or dist.get_rank() == 0:
                    ckpt_lib.save_train_state(
                        o.checkpoint_dir, epoch + 1, whole_params, whole_opt,
                        extra={"best_val": best_val, "best_cr": best_cr,
                               "best_params": whole_best,
                               "cost_train": np.asarray(cost_train),
                               "cost_val": np.asarray(cost_val),
                               "val_window": np.asarray(list(val_window)),
                               "train_strip": train_strip.copy(),
                               "lr": float(lr)})
                if self.mesh is not None:
                    self.mesh.barrier()

            if epoch >= o.validation_window and early_stop2(val_window, best_val,
                                                            o.validation_window):
                break

        if test_conf is None:
            test_cr, test_conf = self.evaluate(params, test_streams, test_y, test_mask,
                                               dev=test_dev())
        return TrainResult(_clone(self._whole(best_params, self._param_sh), "cpu"), best_val,
                           best_cr, test_cr, test_conf,
                           cost_train, cost_val, class_rate, epochs_run, final_lr=float(lr))

    def _dropout_seed(self, seed: int) -> int:
        """The dropout generator's seed: under ``shard_map`` the rank folded
        in, as JAX folds the shard index into the key."""
        if self.mesh is None or self.options.mesh_mode != "shard_map":
            return seed
        return collectives.fold_seed(seed, self.mesh.axis_index(self._batch_axes))

    def _sp_max_t(self, seqlens):
        """The padded T of a split under sequence parallelism: the longest
        length rounded up to a multiple of the seq dim, the halo's
        T_local >= window checked up front; None otherwise."""
        if not self._sp_active:
            return None
        sp = self.options.sequence_parallel
        max_t = int(np.asarray(seqlens).reshape(-1).max())
        padded = int(-(-max_t // sp) * sp)
        window = self.options.window or self.config.window
        if any(s.use_delta for s in self.config.streams) and padded // sp < window:
            raise ValueError(
                f"sequence_parallel={sp} leaves T_local={padded // sp} < "
                f"window={window} (halo exchange needs T_local >= window); "
                f"use fewer seq shards or a smaller window")
        return padded

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
