"""Wall-clock and throughput timers: the port of ``deepspeed_tpu/utils/
timer.py`` (``SynchronizedWallClockTimer``, ``ThroughputTimer``).

PyTorch returns from a CUDA call before the card finishes it, so a host
clock read without a synchronize measures the enqueue. Every start and
stop here synchronizes the timer's device first (``torch.cuda.
synchronize``; nothing on the CPU), which makes the recorded interval the
device's time for the enclosed work, host gaps included.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from .logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"
TRAIN_BATCH_TIMER = "train_batch"


def _sync(device: Optional[torch.device]) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class SynchronizedWallClockTimer:
    """Named interval timers that synchronize ``device`` at each start and
    stop."""

    class Timer:
        def __init__(self, name: str, device: Optional[torch.device] = None):
            self.name_ = name
            self.device = device
            self.elapsed_ = 0.0
            self.started_ = False
            self.start_time = 0.0

        def start(self):
            assert not self.started_, f"{self.name_} timer has already been started"
            _sync(self.device)
            self.start_time = time.perf_counter()
            self.started_ = True

        def stop(self, reset: bool = False):
            assert self.started_, "timer is not started"
            _sync(self.device)
            elapsed = time.perf_counter() - self.start_time
            self.elapsed_ = elapsed if reset else self.elapsed_ + elapsed
            self.started_ = False

        def reset(self):
            self.elapsed_ = 0.0
            self.started_ = False

        def elapsed(self, reset: bool = True) -> float:
            started = self.started_
            if started:
                self.stop()
            elapsed = self.elapsed_
            if reset:
                self.reset()
            if started:
                self.start()
            return elapsed

    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self.timers: Dict[str, SynchronizedWallClockTimer.Timer] = {}

    def __call__(self, name: str) -> "SynchronizedWallClockTimer.Timer":
        if name not in self.timers:
            self.timers[name] = self.Timer(name, self.device)
        return self.timers[name]

    def log(self, names: List[str], normalizer: float = 1.0,
            reset: bool = True, ranks: Optional[List[int]] = None):
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed = self.timers[name].elapsed(reset=reset) * 1000.0 \
                    / normalizer
                string += f" | {name}: {elapsed:.2f}"
        log_dist(string, ranks=ranks or [0])


class ThroughputTimer:
    """Samples per second over global steps after ``start_step`` warm-up
    steps; each timed step synchronizes ``device`` at start and stop."""

    def __init__(self, batch_size: int, start_step: int = 2,
                 steps_per_output: int = 50, logging_fn=None,
                 device: Optional[torch.device] = None):
        self.device = device
        self.start_time = 0.0
        self.started = False
        self.batch_size = max(batch_size, 1)
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.steps_per_output = steps_per_output
        self.logging = logging_fn or (lambda msg: log_dist(msg, ranks=[0]))

    def start(self):
        self.started = True
        if self.global_step_count >= self.start_step:
            _sync(self.device)
            self.start_time = time.perf_counter()

    def stop(self, global_step: bool = False, report_speed: bool = True):
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if global_step:
            self.global_step_count += 1
        if self.start_time > 0 and self.global_step_count > self.start_step:
            _sync(self.device)
            duration = time.perf_counter() - self.start_time
            self.total_elapsed_time += duration
            if global_step and report_speed and \
                    self.global_step_count % self.steps_per_output == 0:
                self.logging(
                    f"epoch={self.epoch_count}/micro_step="
                    f"{self.micro_step_count}/global_step="
                    f"{self.global_step_count}, RunningAvgSamplesPerSec="
                    f"{self.avg_samples_per_sec():.2f}, CurrSamplesPerSec="
                    f"{self.batch_size / duration:.2f}")

    def avg_samples_per_sec(self) -> float:
        if self.global_step_count > self.start_step and \
                self.total_elapsed_time > 0:
            samples = self.batch_size * (self.global_step_count
                                         - self.start_step)
            return samples / self.total_elapsed_time
        return 0.0
