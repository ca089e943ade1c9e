"""Static and dynamic loss scaling: the port of ``deepspeed_tpu/runtime/
fp16/loss_scaler.py``.

The dynamic scale's state is a small host-side tuple: the engine reads the
step's overflow flag once per optimizer step (one device sync, fp16 only)
and calls :func:`update_scale`, where the JAX package keeps the state on
the device and selects with ``jnp.where``. The arithmetic, hysteresis
(``delayed_shift``) included, is the same. Over a data-parallel world the
flag is all-reduced first (:func:`overflow_across_ranks`, over data and
model ranks), so every rank skips the same steps and keeps the same scale.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch

class LossScaleState(NamedTuple):
    loss_scale: float
    good_steps: int   # consecutive overflow-free steps
    hysteresis: int   # remaining tolerated overflows


def make_loss_scale_state(init_scale: float = 2.0 ** 16,
                          delayed_shift: int = 1) -> LossScaleState:
    return LossScaleState(float(init_scale), 0, int(delayed_shift))


def has_inf_or_nan(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """A device bool: whether any element of any tensor is inf or NaN."""
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return torch.tensor(False)
    flags = [~torch.isfinite(t.float()).all() for t in tensors]
    return torch.stack(flags).any()


def overflow_across_ranks(flag: torch.Tensor, group=None) -> torch.Tensor:
    """A device bool: whether ``flag`` holds on any rank of ``group`` (mesh
    axis names; by default the data-parallel world; the engine passes
    every axis of its mesh, since under tensor parallelism one model
    rank's slice can overflow alone; one all-reduce of the flag)."""
    from ... import comm

    f = flag.to(torch.float32).reshape(1)
    comm.all_reduce(f, op=comm.ReduceOp.MAX, group=group)
    return f[0] > 0


def update_scale(state: LossScaleState, overflow: bool, *,
                 scale_factor: float = 2.0, scale_window: int = 1000,
                 min_scale: float = 1.0, delayed_shift: int = 1,
                 consecutive_hysteresis: bool = False) -> LossScaleState:
    """One dynamic loss-scale update after a step with or without
    ``overflow``: an overflow with no hysteresis left halves the scale (not
    below ``min_scale``), otherwise spends one unit of hysteresis;
    ``scale_window`` clean steps in a row double it."""
    overflow = bool(overflow)
    scale, good, hyst = state
    drop = overflow and hyst <= 1
    new_scale = max(scale / scale_factor, min_scale) if drop else scale
    new_hyst = max(hyst - 1, 1) if overflow else hyst
    if consecutive_hysteresis and not overflow:
        new_hyst = delayed_shift
    good = 0 if overflow else good + 1
    if not overflow and good >= scale_window:
        new_scale *= scale_factor
        good = 0
        if not consecutive_hysteresis:
            new_hyst = delayed_shift
    return LossScaleState(float(new_scale), int(good), int(new_hyst))


class LossScalerBase:
    """Object-style scaler with the reference's API."""

    def __init__(self, scale: float = 1.0):
        self.cur_scale = scale

    @property
    def loss_scale(self):
        return self.cur_scale

    def scale_gradient(self, module, grad_in, grad_out):
        return tuple(g * self.cur_scale for g in grad_in)

    def update_scale(self, overflow: bool) -> None:
        pass

    def backward(self, loss, retain_graph: bool = False):
        return loss * self.cur_scale


class LossScaler(LossScalerBase):
    """Static loss scaler."""


class DynamicLossScaler(LossScalerBase):
    """Dynamic loss scaler for eager callers (the reference's class)."""

    def __init__(self, init_scale: float = 2 ** 32, scale_factor: float = 2.0,
                 scale_window: int = 1000, min_scale: float = 1.0,
                 delayed_shift: int = 1, consecutive_hysteresis: bool = False,
                 raise_error_at_min_scale: bool = True,
                 dtype=torch.float16):
        super().__init__(init_scale)
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.delayed_shift = delayed_shift
        self.cur_hysteresis = delayed_shift
        self.consecutive_hysteresis = consecutive_hysteresis
        self.raise_error_at_min_scale = raise_error_at_min_scale
        self.last_overflow_iter = -1
        self.cur_iter = 0

    def update_scale(self, overflow: bool) -> None:
        if overflow:
            if self.delayed_shift == 1 or self.cur_hysteresis == 1:
                if self.cur_scale == self.min_scale and \
                        self.raise_error_at_min_scale:
                    raise Exception("Current loss scale already at minimum - "
                                    "cannot decrease scale anymore.")
                self.cur_scale = max(self.cur_scale / self.scale_factor,
                                     self.min_scale)
            else:
                self.cur_hysteresis -= 1
            self.last_overflow_iter = self.cur_iter
        else:
            if self.consecutive_hysteresis:
                self.cur_hysteresis = self.delayed_shift
            if (self.cur_iter - self.last_overflow_iter) % \
                    self.scale_window == 0 and \
                    self.cur_iter > self.last_overflow_iter:
                if not self.consecutive_hysteresis:
                    self.cur_hysteresis = self.delayed_shift
                self.cur_scale *= self.scale_factor
        self.cur_iter += 1


def CreateLossScaler(dtype, static_loss_scale: float, dynamic_scaling: bool,
                     dynamic_loss_args: dict = None):
    if dtype == torch.float16 and dynamic_scaling:
        return DynamicLossScaler(dtype=dtype, **dict(dynamic_loss_args or {}))
    scale = static_loss_scale if dtype == torch.float16 else 1.0
    return LossScaler(scale=scale)
