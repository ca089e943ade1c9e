"""The training engine: the port of ``deepspeed_tpu/runtime/engine.py``
for one device.

``train_batch`` runs one global step as the JAX engine's compiled program
does, in eager PyTorch:

* the global batch is split into ``gradient_accumulation_steps``
  micro-batches in the order of the JAX ``_stack_micro_batches`` (micro i
  is rows ``i·micro … (i+1)·micro − 1``), or ``gas`` batches are drawn from
  an iterator;
* each micro-batch's loss (times the loss scale) is differentiated and its
  gradients, in the parameters' dtype, are summed into fp32 buffers; the
  reported loss is the mean of the micro losses;
* the sum is divided by ``scale × gas`` (or ``scale × predivide`` with
  ``prescale_gradients``), checked for overflow (fp16 only), its global
  norm taken and clipped to ``gradient_clipping``;
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

ZeRO stages 0-3 on one device give the same numbers (``zero/policy.py``).
The eager ``forward``/``backward``/``step`` triple accumulates the same
way. Checkpoint save and load are not ported yet and raise.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..accelerator.real_accelerator import resolve_device
from ..ops.optimizers import OptimizerDef, get_optimizer
from ..utils.logging import log_dist
from ..utils.timer import (BACKWARD_GLOBAL_TIMER, FORWARD_GLOBAL_TIMER,
                           STEP_GLOBAL_TIMER, TRAIN_BATCH_TIMER,
                           SynchronizedWallClockTimer, ThroughputTimer)
from .config import DeepSpeedConfig
from .dataloader import DeepSpeedDataLoader, RepeatingLoader
from .fp16.loss_scaler import (has_inf_or_nan, make_loss_scale_state,
                               update_scale)
from .lr_schedules import get_lr_schedule
from .utils import clip_grads_by_global_norm, count_parameters, global_grad_norm
from .zero.policy import ZeroShardingPolicy


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


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
                 device=None, sharding_rules=None, mesh=None):
        self.device = resolve_device(device)
        if sharding_rules is not None or mesh is not None:
            raise NotImplementedError("sharding rules and device meshes are "
                                      "not ported to the PyTorch/CUDA "
                                      "package yet")
        self.dp_world_size = _world_size()
        self._config = DeepSpeedConfig.load(config,
                                            world_size=self.dp_world_size)
        bad = self._config.not_ported()
        if bad:
            raise NotImplementedError(f"config keys {bad} are not ported to "
                                      f"the PyTorch/CUDA package yet")
        self.zero_config = self._config.zero_optimization
        self.policy = ZeroShardingPolicy(self.zero_config, self.dp_world_size)
        if model is None:
            raise ValueError("initialize() needs a model (an nn.Module)")

        # --- model and precision -----------------------------------------
        self.compute_dtype = self._config.precision_dtype
        self.fp16_enabled = self._config.fp16.enabled
        self.bf16_enabled = self._config.bf16.enabled
        self._keep_master = self.compute_dtype != torch.float32
        if model_parameters is not None:
            model.load_state_dict(model_parameters)
        model = model.to(self.device)
        # the fp32 master copies come from the parameters as given, before
        # every floating parameter is cast to the compute dtype (the JAX
        # engine casts its parameter tree the same way)
        self.master = [p.detach().float().clone() for p in
                       model.parameters() if p.requires_grad] \
            if self._keep_master else None
        self.module = model.to(self.compute_dtype)
        self._params = [p for p in self.module.parameters()
                        if p.requires_grad]
        self._loss_fn = loss_fn
        if hasattr(self.module, "seed_dropout"):
            self.module.seed_dropout(self._config.seed + 1)
        self._grad_acc = [torch.zeros_like(p, dtype=torch.float32)
                          for p in self._params]

        # --- optimizer, schedule, loss scale -----------------------------
        opt_cfg = self._config.optimizer
        opt_params = opt_cfg.params if opt_cfg else {}
        self.optimizer_def: OptimizerDef = get_optimizer(
            opt_cfg.type if opt_cfg else "adam", opt_params)
        self.opt_state = self.optimizer_def.init(self._opt_targets())
        self._base_lr = float(opt_params.get("lr", 1e-3))
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
        return DeepSpeedDataLoader(
            dataset, batch_size=self.train_micro_batch_size_per_gpu(),
            collate_fn=collate_fn)

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
        return self.master if self._keep_master else self._params

    def _scale(self) -> float:
        return self.loss_scale_state.loss_scale if self.fp16_enabled else 1.0

    def _loss(self, batch):
        batch = _to_device(batch, self.device)
        out = self._loss_fn(self.module, batch) if self._loss_fn is not None \
            else self.module(batch)
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
        grads, accs = [], []
        for p, acc in zip(self._params, self._grad_acc):
            if p.grad is not None:
                grads.append(p.grad)
                accs.append(acc)
                p.grad = None
        if grads:
            torch._foreach_add_(accs, grads)

    @torch.no_grad()
    def _apply(self, denom: float) -> Dict[str, Any]:
        """Unscale, overflow check, norm, clip, optimizer step, recast."""
        cfg = self._config
        grads = self._grad_acc
        scale = self._scale()
        d = scale * denom
        if cfg.prescale_gradients and cfg.gradient_predivide_factor != 1.0:
            d = scale * cfg.gradient_predivide_factor
        torch._foreach_div_(grads, d)
        overflow = bool(has_inf_or_nan(grads)) if self.fp16_enabled else False
        norm = global_grad_norm(grads)
        if cfg.gradient_clipping > 0:
            clip_grads_by_global_norm(grads, cfg.gradient_clipping, norm)
        lr = self._lr_at(self.global_steps)
        if not overflow:
            targets = self._opt_targets()
            self.optimizer_def.update(grads, self.opt_state, targets, lr,
                                      self._opt_step)
            if self._keep_master:
                for p, m in zip(self._params, self.master):
                    p.copy_(m)
            self._opt_step += 1
        else:
            self.skipped_steps += 1
        if self.fp16_enabled and not cfg.fp16.loss_scale > 0:
            fc = cfg.fp16
            self.loss_scale_state = update_scale(
                self.loss_scale_state, overflow,
                scale_window=fc.loss_scale_window,
                min_scale=fc.min_loss_scale, delayed_shift=fc.hysteresis)
        torch._foreach_zero_(grads)
        return {"overflow": overflow, "grad_norm": norm, "lr": lr,
                "loss_scale": scale}

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
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for mb in micros:
            loss = self._loss(mb)
            self._backward_into_acc(loss)
            loss_sum += loss.detach().float()
        gas = self.gradient_accumulation_steps()
        metrics = self._apply(float(gas))
        loss = loss_sum / gas
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
    def forward(self, batch):
        """The micro-batch's loss, its graph kept for :meth:`backward`."""
        self.timers(FORWARD_GLOBAL_TIMER).start()
        loss = self._loss(batch)
        self._pending = loss
        self.timers(FORWARD_GLOBAL_TIMER).stop()
        return loss

    __call__ = forward

    def backward(self, loss=None):
        """Differentiate the pending loss into the fp32 accumulators."""
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
        metrics["loss"] = self._loss_acc / gas
        self._loss_acc = None
        self.timers(STEP_GLOBAL_TIMER).stop()
        self._after_step(metrics)

    def eval_batch_fn(self):
        """A loss-only function of a batch: no gradients, no dropout."""
        def eval_loss(batch):
            with torch.no_grad():
                batch = _to_device(batch, self.device)
                if self._loss_fn is not None:
                    return self._loss_fn(self.module, batch)
                return self.module(batch, deterministic=True)
        return eval_loss

    def save_checkpoint(self, *args, **kwargs):
        raise NotImplementedError("save_checkpoint is not ported to the "
                                  "PyTorch/CUDA package yet")

    def load_checkpoint(self, *args, **kwargs):
        raise NotImplementedError("load_checkpoint is not ported to the "
                                  "PyTorch/CUDA package yet")
