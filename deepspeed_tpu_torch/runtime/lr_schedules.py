"""Learning-rate schedules: the port of ``deepspeed_tpu/runtime/
lr_schedules.py``.

``LRRangeTest``, ``OneCycle``, ``WarmupLR``, ``WarmupDecayLR`` and
``WarmupCosineLR``, each a pure function of the step (``lr_at``) wrapped
in a class with the reference's ``step()/get_lr()/state_dict()`` surface.
The engine evaluates ``lr_at`` at its step counter before the increment,
as the JAX engine does. The JAX package computes in float32 on the
device; these compute in Python floats.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"

VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR,
                      WARMUP_COSINE_LR]


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


class _Schedule:
    """Base: tracks the step count, exposes the pure ``lr_at(step)``."""

    def __init__(self, optimizer=None, last_batch_iteration: int = -1):
        self.optimizer = optimizer
        self.last_batch_iteration = last_batch_iteration

    def lr_at(self, step) -> float:
        raise NotImplementedError

    def get_lr(self) -> List[float]:
        return [float(self.lr_at(max(self.last_batch_iteration, 0)))]

    def get_last_lr(self) -> List[float]:
        return self.get_lr()

    def step(self, last_batch_iteration: Optional[int] = None) -> None:
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        if self.optimizer is not None and hasattr(self.optimizer, "set_lr"):
            self.optimizer.set_lr(self.get_lr()[0])

    def state_dict(self) -> Dict:
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd: Dict) -> None:
        self.last_batch_iteration = sd["last_batch_iteration"]


class WarmupLR(_Schedule):
    """Warmup from ``warmup_min_lr`` to ``warmup_max_lr`` over
    ``warmup_num_steps`` (on a log curve by default), then constant."""

    def __init__(self, optimizer=None, warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                 warmup_type: str = "log", last_batch_iteration: int = -1):
        super().__init__(optimizer, last_batch_iteration)
        self.warmup_min_lr = warmup_min_lr
        self.warmup_max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)

    def _warmup_frac(self, step) -> float:
        s = float(step)
        if self.warmup_type == "log":
            frac = self.inverse_log_warm_up * math.log(max(s, 1.0))
        else:
            frac = s / self.warmup_num_steps
        return _clip(frac, 0.0, 1.0)

    def lr_at(self, step) -> float:
        frac = self._warmup_frac(step)
        return self.warmup_min_lr + \
            (self.warmup_max_lr - self.warmup_min_lr) * frac


class WarmupDecayLR(WarmupLR):
    """Warmup, then linear decay to 0 at ``total_num_steps``."""

    def __init__(self, optimizer=None, total_num_steps: int = 10000,
                 warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000, warmup_type: str = "log",
                 last_batch_iteration: int = -1):
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr,
                         warmup_num_steps, warmup_type, last_batch_iteration)
        self.total_num_steps = total_num_steps

    def lr_at(self, step) -> float:
        s = float(step)
        if s < self.warmup_num_steps:
            return super().lr_at(step)
        decay = _clip((self.total_num_steps - s) / max(
            float(self.total_num_steps - self.warmup_num_steps), 1.0),
            0.0, 1.0)
        return self.warmup_max_lr * decay


class WarmupCosineLR(WarmupLR):
    """Warmup (linear by default), then cosine decay to
    ``cos_min_ratio`` × ``warmup_max_lr`` at ``total_num_steps``."""

    def __init__(self, optimizer=None, total_num_steps: int = 10000,
                 warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000, cos_min_ratio: float = 0.0001,
                 warmup_type: str = "linear", last_batch_iteration: int = -1):
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr,
                         warmup_num_steps, warmup_type, last_batch_iteration)
        self.total_num_steps = total_num_steps
        self.cos_min_ratio = cos_min_ratio

    def lr_at(self, step) -> float:
        s = float(step)
        if s < self.warmup_num_steps:
            return super().lr_at(step)
        progress = _clip((s - self.warmup_num_steps) / max(
            self.total_num_steps - self.warmup_num_steps, 1), 0.0, 1.0)
        cosine = self.cos_min_ratio + (1 - self.cos_min_ratio) * 0.5 * (
            1 + math.cos(math.pi * progress))
        return self.warmup_max_lr * cosine


class OneCycle(_Schedule):
    """1-cycle policy: lr up over ``cycle_first_step_size``, down over
    ``cycle_second_step_size``, then decay."""

    def __init__(self, optimizer=None, cycle_min_lr: float = 0.0001,
                 cycle_max_lr: float = 0.001, decay_lr_rate: float = 0.0,
                 cycle_first_step_size: int = 2000,
                 cycle_second_step_size: Optional[int] = None,
                 cycle_first_stair_count: int = 0,
                 cycle_second_stair_count: Optional[int] = None,
                 decay_step_size: int = 0, last_batch_iteration: int = -1,
                 **_momentum_kwargs):
        super().__init__(optimizer, last_batch_iteration)
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first = cycle_first_step_size
        self.second = cycle_second_step_size \
            if cycle_second_step_size is not None else self.first
        self.decay_step_size = decay_step_size

    def lr_at(self, step) -> float:
        s = float(step)
        total = self.first + self.second
        if s < total:
            if s < self.first:
                frac = _clip(s / self.first, 0.0, 1.0)
            else:
                frac = 1.0 - _clip((s - self.first) / self.second, 0.0, 1.0)
            return self.cycle_min_lr + \
                (self.cycle_max_lr - self.cycle_min_lr) * frac
        if self.decay_step_size > 0:
            decay_steps = max(s - total, 0.0) / self.decay_step_size
            return self.cycle_min_lr / (1.0 + decay_steps * self.decay_lr_rate)
        return self.cycle_min_lr


class LRRangeTest(_Schedule):
    """LR range-test sweep: ``min_lr × (1 + interval × step_rate)``."""

    def __init__(self, optimizer=None, lr_range_test_min_lr: float = 1e-3,
                 lr_range_test_step_size: int = 2000,
                 lr_range_test_step_rate: float = 1.0,
                 lr_range_test_staircase: bool = False,
                 last_batch_iteration: int = -1):
        super().__init__(optimizer, last_batch_iteration)
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase

    def lr_at(self, step) -> float:
        s = float(step)
        interval = math.floor(s / self.step_size) if self.staircase \
            else s / self.step_size
        return self.min_lr * (1.0 + interval * self.step_rate)


SCHEDULE_REGISTRY = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
    WARMUP_COSINE_LR: WarmupCosineLR,
}


def get_lr_schedule(name: Optional[str], params: Dict, optimizer=None):
    if name is None:
        return None
    if name not in SCHEDULE_REGISTRY:
        raise ValueError(f"unknown lr schedule {name}; valid: "
                         f"{VALID_LR_SCHEDULES}")
    return SCHEDULE_REGISTRY[name](optimizer=optimizer, **params)
