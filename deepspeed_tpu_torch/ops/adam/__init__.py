"""Host optimizers for ZeRO-Offload (``cpu_adam``)."""

from .cpu_adam import (DeepSpeedCPUAdagrad, DeepSpeedCPUAdam,  # noqa: F401
                       adagrad_step_reference, adam_step_reference)
