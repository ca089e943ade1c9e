"""The training engine: the port of ``deepspeed_tpu/runtime/engine.py``.

``train_batch`` runs one global step as the JAX engine's compiled program
does, in eager PyTorch:

* the rank's batch is split into ``gradient_accumulation_steps``
  micro-batches in the order of the JAX ``_stack_micro_batches`` (micro i
  is rows ``i·micro … (i+1)·micro − 1``), or ``gas`` batches are drawn from
  an iterator;
* each micro-batch's loss (times the loss scale) is differentiated and its
  gradients, in the parameters' dtype, are summed into fp32 buffers; the
  reported loss is the mean of the micro losses (over the data-parallel
  world, the mean of every rank's);
* the sum is reduced over the world and divided by ``world × scale × gas``
  (or ``world × scale × predivide`` with ``prescale_gradients``), checked
  for overflow (fp16 only), its global norm taken and clipped to
  ``gradient_clipping``;
* the optimizer steps at the learning rate of the step counter before its
  increment; an fp16 overflow skips the update and does not advance the
  optimizer's step (``skipped_steps`` counts it), and the dynamic loss
  scale is updated.

bf16 and fp16 keep **fp32 master weights**: the module's parameters are
held in the compute dtype (what the forward and backward read), the
optimizer updates fp32 copies, and the parameters are recast from them
after every update (the JAX ``_keep_master``). This is not
``torch.autocast`` over fp32 parameters, which computes and stores
differently. In fp32 the optimizer updates the parameters themselves.

Data parallelism and ZeRO (``zero/policy.py``, ``zero/partition.py``).
The process mesh (``parallel.mesh``; the ``mesh`` argument, or one built
from the config's ``mesh`` block and ``zero_optimization.mics_shard_size``
over the ``torch.distributed`` world) gives the data-parallel world, and
each rank passes its own rows to ``train_batch`` (``train_batch_size`` =
micro × gas × world). The JAX engine's global micro-batch k is the ranks'
k-th micro-batches laid end to end in rank order. By stage:

* 0: every tensor whole; the fp32 gradient sums are all-reduced at the
  boundary;
* 1: each rank holds its slice of the fp32 masters and moments, reduces
  the summed gradients into its slice at the boundary, updates its slice
  and all-gathers the compute parameters;
* 2: each micro-batch's gradients are reduce-scattered into the rank's
  slice of the fp32 accumulators;
* 3: the compute parameters are sharded at rest too and gathered a block
  at a time (``zero/partition.Zero3Params``).

A tensor whose dimensions the ZeRO world divides none of stays whole
everywhere (the JAX ``zero_shard_spec``). Gradient norms sum the shards'
squares over the ZeRO group, the fp16 overflow flag is all-reduced over
the whole world, so every rank clips alike and skips the same steps.
Under MiCS the state shards within groups of ``mics_shard_size`` ranks
and the gradients are also summed across the groups. A world of one rank
with a process group calls every collective on it and computes what the
engine without one does, bit for bit.

Tensor parallelism (``sharding_rules``, or a mesh or config ``mesh``
block with ``model`` M > 1, beside ``data`` D ≥ 1; the ranks of a model
group are consecutive, the model axis innermost, as in the JAX mesh).
The rules (the caller's ``sharding_rules``, else the family's policy
rules, ``module_inject.replace_module``) are carried out on the module
before ZeRO, the optimizer and the masters see it
(``module_inject.apply_tensor_parallel``): each rank holds 1/M of every
column- and row-parallel projection (GPT-2's fused qkv split per head),
and the parallel layers' collectives run over the model group and carry
their gradients. ZeRO then partitions each rank-local tensor over the
data group only: the gradient reductions and stage 3's gathers never
cross the model axis. Every model rank computes the same loss; the
global gradient norm sums a sharded tensor's squares over the model group
and counts a tensor the group holds copies of once. Checkpoints hold the
whole tensors (the model group gathers, then the data group), so a
checkpoint saved at ``model`` 2 loads at ``model`` 1 and its names and
shapes are the one-rank model's.

The ``activation_checkpointing`` block configures
``runtime.activation_checkpointing.checkpointing`` as the JAX engine does
(an engine's non-default block, or the defaults when nothing configured
it yet).

Offload (``zero/offload.py``, ``zero/param_offload.py``; one rank only).
With ``zero_optimization.offload_optimizer.device`` ``cpu`` or ``nvme``
(Adam, AdamW or CPUAdam only) the fp32 master weights and moments live in
the host optimizer, not on the device: after the device's unscale,
overflow check, norm and clip the fp32 gradients go to the host, the host
Adam steps at the 1-indexed step of the updates so far plus this one (an
fp16 overflow skips it and counts it), and the new compute-dtype
parameters come back; the eager triple works the same way. With
``offload_param.device`` ``cpu`` or ``nvme`` the blocks stream through the
device a layer at a time and ``train_batch`` runs the parameter-offload
runner, which takes the optimizer offload with it (its clip is taken on
the host, as in JAX); the eager triple raises there.

Checkpoints are the JAX engine's single-host files
(``runtime/checkpoint_engine``): ``save_checkpoint`` writes
``<dir>/<tag>/mp_rank_00_model_states.{npz,meta}`` and ``<dir>/latest``;
the state dict has the JAX top-level keys with the port's parameter names
(``module``: the module's ``state_dict``, read back from the layer store
under parameter offload; ``master`` and each optimizer field, e.g.
``exp_avg``/``exp_avg_sq``: ``{parameter name: tensor}``, or with offload
``offload_optimizer``: the host optimizer's ``state_dict``),
``step``/``opt_step``, the loss ``scale``, ``rng`` (the model's dropout
generator state), the four counters, the world sizes, ``lr_scheduler`` and
``client_state``. Over a world every tensor is gathered whole and rank 0
writes the same layout; every rank loads the whole file and keeps its
slices, at any world size. ``load_checkpoint`` restores all of it bit for
bit; ``load_universal_checkpoint`` reads ``checkpoint.
universal_checkpoint``'s layout (the ``checkpoint.load_universal`` switch
routes there). The multi-process orbax layout is not ported.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from .. import comm
from ..accelerator.real_accelerator import resolve_device
from ..module_inject import (TPPlan, apply_tensor_parallel, gather_tensor,
                             head_dim_of, replace_module, shard_tensor,
                             tp_copies, tp_plans)
from ..ops.optimizers import OptimizerDef, get_optimizer
from ..parallel import mesh as mesh_mod
from ..utils.logging import log_dist
from ..utils.timer import (BACKWARD_GLOBAL_TIMER, FORWARD_GLOBAL_TIMER,
                           STEP_GLOBAL_TIMER, TRAIN_BATCH_TIMER,
                           SynchronizedWallClockTimer, ThroughputTimer)
from .checkpoint_engine.checkpoint_engine import (ArrayCheckpointEngine,
                                                  checkpoint_meta_path,
                                                  read_latest, write_latest)
from .config import DeepSpeedConfig
from .dataloader import DeepSpeedDataLoader, RepeatingLoader
from .fp16.loss_scaler import (LossScaleState, has_inf_or_nan,
                               make_loss_scale_state, overflow_across_ranks,
                               update_scale)
from .lr_schedules import get_lr_schedule
from .utils import clip_grads_by_global_norm, count_parameters, global_grad_norm
from .zero.offload import ADAM_TYPES, HostStepStaging, OffloadedOptimizer
from .zero.offload_config import OffloadDeviceEnum
from .zero.partition import Zero3Params, ZeroPartition
from .zero.policy import ZeroShardingPolicy

OFFLOAD_WORLD_MSG = (
    "ZeRO offload (offload_optimizer / offload_param) over a world of more "
    "than one rank (data or model) is not ported to the PyTorch/CUDA "
    "package yet (ROADMAP.md queue 1 item 3; the JAX package has it, "
    "runtime/zero/offload.py:85); offload runs on one rank")

LAMB_SLICES_MSG = (
    "LAMB's per-tensor trust ratio over ZeRO slices or tensor-parallel "
    "shards (stage >= 1 over a data-parallel world, or model > 1) is not "
    "ported (ROADMAP.md queue 1 item 4); use stage 0 on one model rank")


def _mesh_probe(config) -> tuple:
    """(mesh block, mics_shard_size) of a raw config before it is parsed
    (its batch sizes need the world, which the mesh gives)."""
    if isinstance(config, DeepSpeedConfig):
        m = config.mesh
        return ({"data": m.data, "model": m.model, "pipe": m.pipe,
                 "expert": m.expert, "seq": m.seq},
                int(config.zero_optimization.mics_shard_size))
    if isinstance(config, str):
        import json

        with open(config) as fh:
            config = json.load(fh)
    config = config if isinstance(config, dict) else {}
    return (dict(config.get("mesh") or {}),
            int((config.get("zero_optimization") or {}).get(
                "mics_shard_size", -1)))


def _to_device(batch, device):
    """numpy arrays, tensors and nested dicts/tuples of them on ``device``."""
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to_device(v, device) for v in batch)
    if isinstance(batch, torch.Tensor):
        return batch.to(device, non_blocking=True)
    return torch.as_tensor(np.asarray(batch)).to(device, non_blocking=True)


def _rows(batch, lo: int, hi: int):
    if isinstance(batch, dict):
        return {k: _rows(v, lo, hi) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_rows(v, lo, hi) for v in batch)
    return batch[lo:hi]


def _plain(value):
    """A loaded leaf as a Python value (0-d arrays to scalars, in dicts)."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, np.ndarray) and value.ndim == 0:
        return value.item()
    return value


def _leading(batch) -> int:
    if isinstance(batch, dict):
        return _leading(next(iter(batch.values())))
    if isinstance(batch, (tuple, list)):
        return _leading(batch[0])
    return len(batch)


class DeepSpeedEngine:
    """Training engine; build it with :func:`deepspeed_tpu_torch.initialize`.

    ``model`` is an ``nn.Module`` whose ``forward(batch)`` returns the loss
    (a tuple ``(loss, aux_loss, ...)`` adds the scalar ``aux_loss``), or
    ``loss_fn(model, batch)`` computes it. ``model_parameters`` is an
    optional state dict loaded into the model first. ``device`` defaults to
    ``cuda`` and must be given as ``"cpu"`` to train on the CPU.
    """

    def __init__(self, model: nn.Module = None,
                 loss_fn: Optional[Callable] = None,
                 model_parameters: Optional[Dict[str, Any]] = None,
                 config: Union[str, Dict, DeepSpeedConfig, None] = None,
                 training_data=None, lr_scheduler=None, collate_fn=None,
                 device=None, sharding_rules=None, mesh=None,
                 dist_init_required=None):
        self.device = resolve_device(device)
        comm.init_distributed(verbose=False, device=self.device,
                              dist_init_required=dist_init_required)
        dims, mics = _mesh_probe(config)
        if mesh is not None:
            mesh_mod.set_mesh(mesh)
        elif not mesh_mod.has_mesh() or \
                mesh_mod.get_mesh().size != comm.get_world_size() or \
                mesh_mod.get_model_parallel_world_size() != \
                int(dims.get("model", 1)):
            mesh_mod.initialize_mesh(
                data=dims.get("data", -1), model=dims.get("model", 1),
                pipe=dims.get("pipe", 1), expert=dims.get("expert", 1),
                seq=dims.get("seq", 1), mics_shard_size=max(mics, 0))
        self.mesh = mesh_mod.get_mesh()
        self.dp_world_size = mesh_mod.get_data_parallel_world_size()
        self.dp_rank = mesh_mod.get_data_parallel_rank()
        self.mp_world_size = mesh_mod.get_model_parallel_world_size()
        self._config = DeepSpeedConfig.load(config,
                                            world_size=self.dp_world_size)
        bad = self._config.not_ported()
        if bad:
            raise NotImplementedError(f"config keys {bad} are not ported to "
                                      f"the PyTorch/CUDA package yet")
        cl = self._config.comms_logger
        comm.configure(enabled=cl.enabled, prof_all=cl.prof_all,
                       prof_ops=cl.prof_ops, verbose=cl.verbose,
                       debug=cl.debug)
        self.zero_config = self._config.zero_optimization
        self.policy = ZeroShardingPolicy(self.zero_config, self.mesh,
                                         sharding_rules)
        if model is None:
            raise ValueError("initialize() needs a model (an nn.Module)")
        self._configure_checkpointing()

        # --- offload (module docstring) ----------------------------------
        zc = self.zero_config
        oo, op = zc.offload_optimizer, zc.offload_param
        # parameter offload streams the layers and steps on the host
        # itself, so it takes over the optimizer offload
        param_offload = op is not None and op.device != OffloadDeviceEnum.none
        offload = not param_offload and oo is not None and \
            oo.device != OffloadDeviceEnum.none
        opt_cfg = self._config.optimizer
        opt_params = dict(opt_cfg.params) if opt_cfg else {}
        opt_type = (opt_cfg.type if opt_cfg else "adam").lower()
        if (offload or param_offload) and \
                self.dp_world_size * self.mp_world_size > 1:
            raise NotImplementedError(OFFLOAD_WORLD_MSG)
        if offload and opt_type not in ADAM_TYPES:
            raise ValueError(f"offload_optimizer requires Adam/AdamW (got "
                             f"{opt_type!r}); the host step runs "
                             f"DeepSpeedCPUAdam")
        self._base_lr = float(opt_params.get("lr", 1e-3))
        opt_params.setdefault("lr", self._base_lr)
        self._offload_opt: Optional[OffloadedOptimizer] = None
        self._param_offload = None
        self._staging = None
        self.last_timings: Dict[str, float] = {}

        # --- model and precision -----------------------------------------
        self.compute_dtype = self._config.precision_dtype
        self.fp16_enabled = self._config.fp16.enabled
        self.bf16_enabled = self._config.bf16.enabled
        self._keep_master = self.compute_dtype != torch.float32
        # --- tensor parallelism (module docstring) -----------------------
        self.tp_plans = [TPPlan(1, 0)]
        self._head_dim = 0
        if self.mp_world_size > 1:
            rules = sharding_rules if sharding_rules is not None else \
                replace_module(model, tp_size=self.mp_world_size)
            self._head_dim = head_dim_of(model)
            self.tp_plans = tp_plans(model, rules, self.mesh)
            # swapped and sliced where the model lies, before the engine
            # moves it to its device
            apply_tensor_parallel(
                model, rules, self.mesh, model_parameters,
                plan=self.tp_plans[self.mesh.axis_rank(mesh_mod.MODEL_AXIS)])
        elif model_parameters is not None:
            model.load_state_dict(model_parameters)
        self.tp_plan = self.tp_plans[
            self.mesh.axis_rank(mesh_mod.MODEL_AXIS)
            if self.mp_world_size > 1 else 0]
        self.module = model
        self._loss_fn = loss_fn
        self.master = None
        self._zero3: Optional[Zero3Params] = None
        own_master = []
        if param_offload:
            from .zero.param_offload import ParamOffloadRunner, \
                check_supported

            check_supported(self)
            # the blocks' weights move to the host store and the optimizer,
            # the embeddings and head to the device (the runner's docstring)
            self._param_offload = ParamOffloadRunner(self, opt_params)
            self._offload_opt = self._param_offload.opt
        else:
            model = model.to(self.device)
            trainable = [(n, p) for n, p in model.named_parameters()
                         if p.requires_grad]
            self._part = ZeroPartition(self.policy, self.mesh, [
                (n, tuple(p.shape)) for n, p in trainable])
            # the fp32 master copies (this rank's slices) come from the
            # parameters as given, before every floating parameter is cast
            # to the compute dtype (the JAX engine casts its parameter tree
            # the same way); with offload they live on the host. In fp32 a
            # stage that shards the state but not the parameter keeps an
            # fp32 slice beside it (the reference's fp32 partition).
            if offload:
                self._offload_opt = OffloadedOptimizer(
                    dict(trainable), opt_params, oo,
                    aio_config=self._config.aio)
            else:
                own_master = [
                    lay.local(p.detach().float()).clone()
                    if self._keep_master or (lay.state_sharded
                                             and not lay.param_sharded)
                    else None
                    for lay, (_, p) in zip(self._part.layouts, trainable)]
                if self._keep_master:
                    self.master = own_master
            self.module = model.to(self.compute_dtype)
        named = [(n, p) for n, p in self.module.named_parameters()
                 if p.requires_grad]
        self._param_names = [n for n, _ in named]
        self._params = [p for _, p in named]
        # how many model ranks hold each parameter's values (the norm
        # counts them once): M for a whole tensor, 1 for a slice
        self._tp_copies = [tp_copies(self.tp_plans, self.tp_plan.rank, n,
                                     self._head_dim)
                           for n in self._param_names]
        if param_offload:
            self._part = ZeroPartition(self.policy, self.mesh, [
                (n, tuple(p.shape)) for n, p in named])
        self.checkpoint_engine = ArrayCheckpointEngine()
        if hasattr(self.module, "seed_dropout"):
            self.module.seed_dropout(self._config.seed + 1)
        self._grad_acc = [] if param_offload else \
            [torch.zeros(lay.local_shape() if lay.grad_sharded else lay.shape,
                         dtype=torch.float32, device=self.device)
             for lay in self._part.layouts]
        if self._part.stage3 and not param_offload:
            self._zero3 = Zero3Params(self.module, self._part, self._params,
                                      self._grad_acc)
        # what the optimizer updates: the fp32 master (slices), else the
        # parameters themselves
        self._targets = [m if m is not None else p for m, p in
                         zip(own_master or [None] * len(self._params),
                             self._params)]
        if offload:
            self._staging = HostStepStaging(self._params, self.compute_dtype,
                                            self.device)

        # --- optimizer, schedule, loss scale -----------------------------
        self.optimizer_def: OptimizerDef = get_optimizer(opt_type,
                                                         opt_params)
        if self.optimizer_def.name == "FusedLamb" and \
                (self._part.any_sharded or min(self._tp_copies, default=1)
                 < self.mp_world_size):
            raise NotImplementedError(LAMB_SLICES_MSG)
        self.opt_state = None if self._offload_opt is not None else \
            self.optimizer_def.init(self._opt_targets())
        sched_cfg = self._config.scheduler
        self.lr_scheduler = lr_scheduler if lr_scheduler is not None else \
            get_lr_schedule(sched_cfg.type if sched_cfg else None,
                            sched_cfg.params if sched_cfg else {})
        self.loss_scale_state = None
        if self.fp16_enabled:
            fc = self._config.fp16
            init = fc.loss_scale if fc.loss_scale > 0 \
                else 2.0 ** fc.initial_scale_power
            self.loss_scale_state = make_loss_scale_state(init, fc.hysteresis)

        # --- counters, timers, data --------------------------------------
        self.global_steps = 0       # the JAX state["step"]
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._opt_step = 0          # the JAX state["opt_step"]
        self._loss_acc = None       # eager path: summed micro losses
        self._pending = None        # eager path: forward()'s loss
        self._last_grad_norm = None
        self._t_step = None         # train_batch's start (offload timings)
        self.timers = SynchronizedWallClockTimer(self.device)
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size(),
            steps_per_output=self.steps_per_print(), device=self.device)
        self._train_iter = None
        self.training_dataloader = self.deepspeed_io(
            training_data, collate_fn) if training_data is not None else None
        log_dist(f"DeepSpeedEngine: {self.policy.describe()}, dtype="
                 f"{self.compute_dtype}, device={self.device}, "
                 f"{self.num_parameters / 1e6:.1f}M params, micro_bs="
                 f"{self.train_micro_batch_size_per_gpu()} gas="
                 f"{self.gradient_accumulation_steps()}", ranks=[0])

    # --- config accessors ------------------------------------------------
    def train_batch_size(self) -> int:
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self) -> int:
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self._config.gradient_accumulation_steps

    def steps_per_print(self) -> int:
        return self._config.steps_per_print

    def gradient_clipping(self) -> float:
        return self._config.gradient_clipping

    def zero_optimization_stage(self) -> int:
        return int(self.zero_config.stage)

    def wall_clock_breakdown(self) -> bool:
        return self._config.wall_clock_breakdown

    def get_global_grad_norm(self):
        return self._last_grad_norm

    def _lr_at(self, step: int) -> float:
        if self.lr_scheduler is not None and \
                hasattr(self.lr_scheduler, "lr_at"):
            return float(self.lr_scheduler.lr_at(step))
        return self._base_lr

    def get_lr(self):
        return [self._lr_at(self.global_steps)]

    def is_gradient_accumulation_boundary(self) -> bool:
        return (self.micro_steps + 1) % \
            self.gradient_accumulation_steps() == 0

    @property
    def num_parameters(self) -> int:
        return count_parameters(self._params)

    # --- data --------------------------------------------------------------
    def deepspeed_io(self, dataset, collate_fn=None):
        """This rank's loader: micro-batches of the samples at positions
        ``dp_rank, dp_rank + world, ...`` (the JAX loader's process
        stride), so the ranks' k-th micro-batches together hold the
        same samples at every world size."""
        return DeepSpeedDataLoader(
            dataset, batch_size=self.train_micro_batch_size_per_gpu(),
            collate_fn=collate_fn, num_shards=self.dp_world_size,
            shard_index=self.dp_rank)

    def _micro_batches(self, source):
        gas = self.gradient_accumulation_steps()
        if hasattr(source, "__next__"):
            return [next(source) for _ in range(gas)]
        n = _leading(source)
        if n % gas:
            raise ValueError(f"global batch of {n} rows does not split into "
                             f"{gas} micro-batches")
        micro = n // gas
        return [_rows(source, i * micro, (i + 1) * micro) for i in range(gas)]

    # --- the step ----------------------------------------------------------
    def _opt_targets(self):
        return self._targets

    def _scale(self) -> float:
        return self.loss_scale_state.loss_scale if self.fp16_enabled else 1.0

    def _call(self, batch):
        if self._loss_fn is not None:
            return self._loss_fn(self.module, batch)
        return self.module(batch)

    def _loss(self, batch):
        batch = _to_device(batch, self.device)
        if self._zero3 is None:
            out = self._call(batch)
        else:
            self._zero3.in_forward = True
            try:
                with self._zero3.saving():
                    out = self._call(batch)
            finally:
                self._zero3.in_forward = False
        if isinstance(out, tuple):
            loss = out[0]
            if len(out) > 1 and out[1] is not None:
                if out[1].dim() != 0:
                    raise ValueError("model returned a non-scalar aux loss "
                                     "(tuple element 1 must be a scalar)")
                loss = loss + out[1]
            return loss
        return out

    def _backward_into_acc(self, loss) -> None:
        """d(loss · scale)/dθ summed into the fp32 buffers; grads freed."""
        (loss.float() * self._scale()).backward()
        if self._zero3 is not None:
            self._zero3.after_backward()
        grads, accs = [], []
        for p, acc, lay in zip(self._params, self._grad_acc,
                               self._part.layouts):
            if p.grad is None:
                continue
            g, p.grad = p.grad, None
            if lay.grad_sharded:
                # stage >= 2: into this rank's slice, summed in fp32
                acc.add_(self._part.scatter(lay, g.float()))
            else:
                grads.append(g)
                accs.append(acc)
        if grads:
            torch._foreach_add_(accs, grads)

    @torch.no_grad()
    def _apply(self, denom: float) -> Dict[str, Any]:
        """Reduce over the world, unscale, overflow check, norm, clip,
        optimizer step, recast (and gather)."""
        cfg = self._config
        # the world's sums, in each parameter's state layout
        grads = self._part.reduce_boundary(self._grad_acc)
        scale = self._scale()
        d = scale * denom
        if cfg.prescale_gradients and cfg.gradient_predivide_factor != 1.0:
            d = scale * cfg.gradient_predivide_factor
        # the JAX grads are the global batch's mean: the world's sum over
        # the world
        torch._foreach_div_(grads, d * self.dp_world_size)
        # over the whole world: one model rank's slice can overflow alone
        overflow = bool(overflow_across_ranks(
            has_inf_or_nan(grads), group=self.mesh.axis_names)) \
            if self.fp16_enabled else False
        norm = global_grad_norm(grads, sharded=self._part.sharded_mask(),
                                group=mesh_mod.ZERO_AXES,
                                copies=self._tp_copies,
                                model_group=mesh_mod.MODEL_AXIS)
        if cfg.gradient_clipping > 0:
            clip_grads_by_global_norm(grads, cfg.gradient_clipping, norm)
        lr = self._lr_at(self.global_steps)
        if not overflow:
            if self._offload_opt is not None:
                self._host_step(lr)
            else:
                targets = self._opt_targets()
                self.optimizer_def.update(grads, self.opt_state, targets, lr,
                                          self._opt_step)
                self._publish()
            self._opt_step += 1
        else:
            self.skipped_steps += 1
        if self.fp16_enabled and not cfg.fp16.loss_scale > 0:
            fc = cfg.fp16
            self.loss_scale_state = update_scale(
                self.loss_scale_state, overflow,
                scale_window=fc.loss_scale_window,
                min_scale=fc.min_loss_scale, delayed_shift=fc.hysteresis)
        torch._foreach_zero_(self._grad_acc)
        return {"overflow": overflow, "grad_norm": norm, "lr": lr,
                "loss_scale": scale}

    def _publish(self) -> None:
        """The compute parameters from the updated targets: recast, and
        all-gathered where the rank updated a slice of a whole parameter
        (stages 1-2); a stage-3 shard is recast in place."""
        for p, t, lay in zip(self._params, self._targets,
                             self._part.layouts):
            if t is p:
                continue
            if lay.state_sharded and not lay.param_sharded:
                p.copy_(self._part.gather(lay, t.to(p.dtype)))
            else:
                p.copy_(t)

    def _configure_checkpointing(self) -> None:
        """The ``activation_checkpointing`` block into the activation
        checkpointing module (the JAX engine's rule: a non-default block
        applies; the defaults only when nothing configured it yet)."""
        from .activation_checkpointing import checkpointing as act_ckpt
        from .config import ActivationCheckpointingConfig

        if (not act_ckpt.is_configured() or
                self._config.activation_checkpointing !=
                ActivationCheckpointingConfig()):
            act_ckpt.configure(deepspeed_config=self._config)

    def _world_mean(self, loss: torch.Tensor) -> torch.Tensor:
        """The mean of every data-parallel rank's loss."""
        return comm.all_reduce(loss, op=comm.ReduceOp.AVG)

    def bytes_at_rest(self) -> Dict[str, int]:
        """The bytes this rank holds between steps: the module's
        parameters (shards under stage 3), the fp32 master weights (or
        fp32 slices), the optimizer's fields and the fp32 gradient
        accumulators; compare ``policy.bytes_at_rest``."""
        def size(ts):
            return sum(t.numel() * t.element_size() for t in ts)

        params = {id(p): p for p in self.module.parameters()}
        own = [t for t, p in zip(self._targets, self._params) if t is not p]
        opt = self.opt_state
        return dict(
            params=size(params.values()), master=size(own),
            moments=size(t for field in opt for t in field)
            if opt is not None else 0,
            accumulators=size(self._grad_acc))

    def _host_step(self, lr: float) -> None:
        """The optimizer-offload update (the JAX ``_host_optimizer_step``):
        the unscaled, clipped fp32 gradients go to the host, the host Adam
        steps (``step_num`` 1-indexed: the updates so far plus this one) and
        the new compute-dtype parameters come back (``HostStepStaging``).
        ``last_timings["fwd_bwd_s"]``: from ``train_batch``'s start to the
        device finishing the clip."""
        if self._t_step is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.last_timings["fwd_bwd_s"] = \
                time.perf_counter() - self._t_step
        self._staging.run(self._offload_opt, self._param_names,
                          self._grad_acc, lr, self._opt_step + 1)
        self.last_timings.update(self._offload_opt.last_timings)

    def offload_timings(self, reset: bool = False) -> Dict[str, float]:
        """The optimizer-offload transfers and host updates summed since the
        last reset (``HostStepStaging.totals``); ``reset`` restarts them."""
        if self._staging is None:
            return {}
        out = self._staging.totals()
        if reset:
            self._staging.reset_totals()
        return out

    def train_batch(self, data_iter=None, batch=None):
        """One global step over ``gas`` micro-batches (see the module
        docstring); returns the mean micro loss (an fp32 device scalar)."""
        if data_iter is None and batch is None and \
                self.training_dataloader is not None:
            if self._train_iter is None:
                self._train_iter = iter(RepeatingLoader(
                    self.training_dataloader))
            data_iter = self._train_iter
        if (data_iter is None) == (batch is None):
            raise ValueError("pass exactly one of data_iter / batch")
        micros = self._micro_batches(data_iter if data_iter is not None
                                     else batch)
        self.timers(TRAIN_BATCH_TIMER).start()
        self.tput_timer.start()
        gas = self.gradient_accumulation_steps()
        if self._param_offload is not None:
            metrics = self._param_offload.train_batch(
                micros, lr=self._lr_at(self.global_steps),
                step=self.global_steps)
            self._opt_step += 1
            loss = metrics["loss"]
        else:
            self._t_step = time.perf_counter()
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
            for mb in micros:
                loss = self._loss(mb)
                self._backward_into_acc(loss)
                loss_sum += loss.detach().float()
            metrics = self._apply(float(gas))
            self._t_step = None
            loss = self._world_mean(loss_sum / gas)
            metrics["loss"] = loss
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        self.micro_steps += gas
        self.tput_timer.stop(global_step=True)
        self.timers(TRAIN_BATCH_TIMER).stop()
        self._after_step(metrics)
        return loss

    def _after_step(self, metrics) -> None:
        self._last_grad_norm = metrics["grad_norm"]
        if self.global_steps % self.steps_per_print() == 0:
            log_dist(f"step={self.global_steps} "
                     f"loss={float(metrics['loss']):.4f} "
                     f"lr={metrics['lr']:.3e} "
                     f"grad_norm={float(metrics['grad_norm']):.3f}"
                     + (f" scale={metrics['loss_scale']:.0f}"
                        if self.fp16_enabled else ""), ranks=[0])
            if self.wall_clock_breakdown():
                self.timers.log([TRAIN_BATCH_TIMER, FORWARD_GLOBAL_TIMER,
                                 BACKWARD_GLOBAL_TIMER, STEP_GLOBAL_TIMER])

    # --- eager API ---------------------------------------------------------
    def _eager_allowed(self) -> None:
        if self._param_offload is not None:
            raise RuntimeError(
                "the eager forward()/backward()/step() API does not compose "
                "with offload_param streaming (the blocks' weights are never "
                "all on the device); drive training with train_batch()")

    def forward(self, batch):
        """The micro-batch's loss, its graph kept for :meth:`backward`."""
        self._eager_allowed()
        self.timers(FORWARD_GLOBAL_TIMER).start()
        loss = self._loss(batch)
        self._pending = loss
        self.timers(FORWARD_GLOBAL_TIMER).stop()
        return loss

    __call__ = forward

    def backward(self, loss=None):
        """Differentiate the pending loss into the fp32 accumulators."""
        self._eager_allowed()
        if self._pending is None:
            raise RuntimeError("backward() before forward()")
        self.timers(BACKWARD_GLOBAL_TIMER).start()
        pending, self._pending = self._pending, None
        self._backward_into_acc(pending)
        detached = pending.detach().float()
        self._loss_acc = detached if self._loss_acc is None \
            else self._loss_acc + detached
        self.micro_steps += 1
        self.timers(BACKWARD_GLOBAL_TIMER).stop()
        return loss

    def step(self):
        """The optimizer step at a gradient-accumulation boundary; a no-op
        between boundaries."""
        self._eager_allowed()
        gas = self.gradient_accumulation_steps()
        if self.micro_steps % gas != 0:
            return
        if self._loss_acc is None:
            raise RuntimeError("step() before backward()")
        self.timers(STEP_GLOBAL_TIMER).start()
        metrics = self._apply(float(gas))
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        if self.lr_scheduler is not None and \
                hasattr(self.lr_scheduler, "step"):
            self.lr_scheduler.step()
        metrics["loss"] = self._world_mean(self._loss_acc / gas)
        self._loss_acc = None
        self.timers(STEP_GLOBAL_TIMER).stop()
        self._after_step(metrics)

    def eval_batch_fn(self):
        """A loss-only function of a batch: no gradients, no dropout."""
        if self._param_offload is not None:
            return self._param_offload.eval_loss

        def eval_loss(batch):
            with torch.no_grad():
                batch = _to_device(batch, self.device)
                if self._loss_fn is not None:
                    return self._loss_fn(self.module, batch)
                return self.module(batch, deterministic=True)
        return eval_loss

    # --- checkpoints ---------------------------------------------------------
    def _tp_whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor ``name`` from this rank's tensor-parallel part
        (collective over the model group)."""
        if self.mp_world_size == 1:
            return t
        return gather_tensor(self.tp_plans, name, t, self._head_dim)

    def _tp_part(self, name: str, full) -> torch.Tensor:
        """This rank's tensor-parallel part of a whole saved tensor."""
        full = torch.as_tensor(full)
        if self.mp_world_size == 1:
            return full
        return shard_tensor(self.tp_plan, name, full, self._head_dim)

    def _named(self, tensors) -> Dict[str, torch.Tensor]:
        """{parameter name: the whole tensor}: ZeRO slices are all-gathered
        over the data group, then tensor-parallel parts over the model
        group (collective: every rank calls it)."""
        return {name: self._tp_whole(name, self._part.gather(lay, t)
                                     if tuple(t.shape) != lay.shape else t)
                for name, t, lay in
                zip(self._param_names, tensors, self._part.layouts)}

    @torch.no_grad()
    def _copy_named(self, targets, saved: Dict[str, Any]) -> None:
        """Copy ``saved[name]`` (whole arrays or tensors) into each target
        tensor, aligned with the trainable parameters' names: a target that
        is this rank's slice takes its slice."""
        for name, t, lay in zip(self._param_names, targets,
                                self._part.layouts):
            t.copy_(self._part.take(lay, self._tp_part(name, saved[name]),
                                    t))

    def _module_state_dict(self) -> Dict[str, Any]:
        """The module's state dict with every stage-3 shard and every
        tensor-parallel part gathered whole (collective), in the one-rank
        model's names and shapes."""
        sd = self.module.state_dict()
        if self._zero3 is not None:
            full = self._zero3.full_state()
            for i, t in full.items():
                sd[self._param_names[i]] = t
        return {k: self._tp_whole(k, t) for k, t in sd.items()}

    def _load_module(self, module_sd: Dict[str, torch.Tensor],
                     strict: bool = True) -> None:
        """Load a whole state dict; a tensor-parallel part and a stage-3
        shard take their slices."""
        if self.mp_world_size > 1:
            module_sd = {k: self._tp_part(k, v).contiguous()
                         for k, v in module_sd.items()}
        if self._zero3 is not None:
            module_sd = dict(module_sd)
            for i in self._zero3.index:
                lay = self._part.layouts[i]
                if lay.name in module_sd:
                    module_sd[lay.name] = lay.local(module_sd[lay.name])
        self.module.load_state_dict(module_sd, strict=strict)


    def _state_dict(self) -> Dict[str, Any]:
        """The JAX engine's checkpoint dict (module docstring); tensors stay
        on the device until the checkpoint engine copies them."""
        gen = getattr(self.module, "dropout_generator", None)
        opt = self.opt_state
        sched = self.lr_scheduler
        offload = self._offload_opt
        return {
            "module": self._param_offload.full_state_dict()
            if self._param_offload is not None else self._module_state_dict(),
            "master": self._named(self.master) if self.master is not None
            else None,
            "optimizer": {field: self._named(getattr(opt, field))
                          for field in opt._fields} if opt is not None
            else None,
            "offload_optimizer": offload.state_dict()
            if offload is not None else None,
            "onebit": None,
            "step": self.global_steps,
            "opt_step": self._opt_step,
            "scale": self.loss_scale_state._asdict()
            if self.loss_scale_state is not None else None,
            "rng": gen.get_state() if gen is not None else None,
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "micro_steps": self.micro_steps,
            "skipped_steps": self.skipped_steps,
            "dp_world_size": self.dp_world_size,
            "mp_world_size": self.mp_world_size,
            "lr_scheduler": sched.state_dict()
            if sched is not None and hasattr(sched, "state_dict") else None,
        }

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict] = None,
                        save_latest: bool = True) -> None:
        """Write the state to ``<save_dir>/<tag>/`` (tag default
        ``global_step{N}``) and, with ``save_latest``, ``tag`` to
        ``<save_dir>/latest``. Over a world every rank gathers (the model
        group, then the data group) and rank 0 writes the whole tensors;
        every rank returns after the files are complete."""
        if tag is None:
            tag = f"global_step{self.global_steps}"
        sd = self._state_dict()
        if comm.get_rank() == 0:
            self.checkpoint_engine.create(tag)
            if client_state:
                sd["client_state"] = client_state
            self.checkpoint_engine.save(
                sd, checkpoint_meta_path(save_dir, tag, "model"))
            self.checkpoint_engine.commit(tag)
            if save_latest:
                write_latest(save_dir, tag)
        comm.barrier(group=self.mesh.axis_names)
        log_dist(f"saved checkpoint {save_dir}/{tag}", ranks=[0])

    def _restore_counters(self, saved: Dict[str, Any],
                          load_lr_scheduler_states: bool = True) -> None:
        step = int(saved.get("step", 0))
        self.global_steps = int(saved.get("global_steps", step))
        self._opt_step = int(saved.get("opt_step", step))
        self.global_samples = int(saved.get("global_samples", 0))
        self.micro_steps = int(saved.get("micro_steps", 0))
        self.skipped_steps = int(saved.get("skipped_steps", 0))
        sched = self.lr_scheduler
        if load_lr_scheduler_states and sched is not None and \
                saved.get("lr_scheduler") and \
                hasattr(sched, "load_state_dict"):
            sched.load_state_dict(_plain(saved["lr_scheduler"]))

    def _clear_accumulation(self) -> None:
        if self._grad_acc:
            torch._foreach_zero_(self._grad_acc)
        self._loss_acc = None
        self._pending = None

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_module_strict: bool = True,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True,
                        load_module_only: bool = False):
        """Restore a :meth:`save_checkpoint` directory (``tag`` default: the
        one in ``latest``); returns ``(load_dir, client_state)``. With
        ``load_module_only``, or from a checkpoint without master weights,
        the master weights are re-seeded from the loaded module (as the
        JAX engine re-seeds its offloaded master), so the next step starts
        from the loaded weights. An offload engine restores its host master
        and moments from the checkpoint's ``offload_optimizer`` (an
        ``OffloadedOptimizer.state_dict``), or re-seeds the host master from
        the module when the checkpoint has none, ``load_module_only`` or
        not ``load_optimizer_states``; a parameter-offload engine installs
        the module's weights in its layer store."""
        if self._config.checkpoint.load_universal:
            return self.load_universal_checkpoint(load_dir, tag)
        if tag is None:
            tag = read_latest(load_dir)
        if os.path.isdir(os.path.join(load_dir, str(tag), "orbax_state")):
            raise NotImplementedError(
                "orbax (multi-process) checkpoints are not ported to the "
                "PyTorch/CUDA package")
        sd = self.checkpoint_engine.load(
            checkpoint_meta_path(load_dir, tag, "model"))
        module_sd = {k: torch.as_tensor(v) for k, v in sd["module"].items()}
        if self._param_offload is not None:
            self._param_offload.load_params(module_sd,
                                            strict=load_module_strict)
        else:
            self._load_module(module_sd, strict=load_module_strict)
        master = None if load_module_only else sd.get("master")
        if self.master is not None:
            self._copy_named(self.master, master if master is not None
                             else module_sd)
        elif self._offload_opt is None and self._param_offload is None:
            # fp32: the parameters, or the fp32 slices a stage keeps
            self._copy_named(self._targets, module_sd)
        offload = sd.get("offload_optimizer")
        if self._offload_opt is not None:
            if load_module_only or not load_optimizer_states or \
                    offload is None:
                self._offload_opt.sync_master_from(module_sd)
            else:
                self._offload_opt.load_state_dict(offload)
        if not load_module_only:
            opt = sd.get("optimizer")
            if load_optimizer_states and opt is not None and \
                    self.opt_state is not None:
                for field in self.opt_state._fields:
                    self._copy_named(getattr(self.opt_state, field),
                                     opt[field])
            scale = sd.get("scale")
            if scale is not None and self.loss_scale_state is not None:
                self.loss_scale_state = LossScaleState(
                    float(scale["loss_scale"]), int(scale["good_steps"]),
                    int(scale["hysteresis"]))
            gen = getattr(self.module, "dropout_generator", None)
            if sd.get("rng") is not None and gen is not None:
                gen.set_state(torch.as_tensor(sd["rng"]).to(torch.uint8))
            self._restore_counters(sd, load_lr_scheduler_states)
        self._clear_accumulation()
        log_dist(f"loaded checkpoint {load_dir}/{tag}", ranks=[0])
        return load_dir, sd.get("client_state", {})

    def load_universal_checkpoint(self, load_dir: str,
                                  tag: Optional[str] = None):
        """Load ``checkpoint.ds_to_universal``'s layout: the fp32 weights
        into the master (on the device, or the offload engine's host master,
        or the parameters in fp32), the parameters recast from them, each
        optimizer field it holds (the host moments of an offload engine),
        the counters and the schedule. Returns ``(load_dir, {})``."""
        from ..checkpoint.universal_checkpoint import (load_universal,
                                                       universal_dir)

        if tag is None:
            tag = read_latest(load_dir)
        univ = load_universal(universal_dir(load_dir, tag))
        fp32 = univ["fp32"]
        if self._offload_opt is not None:
            self._offload_opt.load_universal(fp32, univ["opt"])
        if self._param_offload is not None:
            self._param_offload.load_params(
                {k: torch.as_tensor(v) for k, v in fp32.items()})
        else:
            self._copy_named(self._targets, fp32)
            self._copy_named(self._params, fp32)
        if self.opt_state is not None:
            for field, tree in univ["opt"].items():
                if field in self.opt_state._fields:
                    self._copy_named(getattr(self.opt_state, field), tree)
        meta = univ["meta"]
        self._restore_counters(meta)
        self._clear_accumulation()
        log_dist(f"loaded universal checkpoint {load_dir}/{tag} (saved at "
                 f"dp={meta.get('source_dp_world_size')}, now "
                 f"dp={self.dp_world_size})", ranks=[0])
        return load_dir, {}
