"""Serving front end (the port of ``deepspeed_tpu/serving/frontend/``):
host-side code, no device work of its own.

* :mod:`.priority`: :class:`PriorityScheduler` (priority classes,
  fair-share token budgets, per-tenant rate limits and quotas) with its
  :class:`PriorityConfig` and :class:`TenantPolicy` knobs.
* :mod:`.bridge`: :class:`AsyncEngineBridge`, the dedicated step thread,
  thread-safe op queue and per-request async :class:`TokenStream`.
* :mod:`.server`: :class:`ServingFrontend`, the stdlib asyncio HTTP/1.1 +
  Server-Sent-Events server over a bridge (a bare engine or a
  ``ReplicaRouter``).
"""

from .bridge import AsyncEngineBridge, TokenStream
from .priority import PriorityConfig, PriorityScheduler, TenantPolicy
from .server import ServingFrontend

__all__ = [
    "AsyncEngineBridge",
    "TokenStream",
    "PriorityConfig",
    "PriorityScheduler",
    "TenantPolicy",
    "ServingFrontend",
]
