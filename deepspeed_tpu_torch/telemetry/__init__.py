"""Serving telemetry (port of ``deepspeed_tpu/telemetry/``): so far the
recompile watchdog."""

from .watchdog import (RecompileAfterWarmupError,  # noqa: F401
                       RecompileWatchdog, fast_key)
