"""Serving front end (the port of ``deepspeed_tpu/serving/frontend/``), so
far its scheduling half: :class:`PriorityScheduler` (priority classes,
fair-share token budgets, per-tenant rate limits and quotas) with its
:class:`PriorityConfig` and :class:`TenantPolicy` knobs. The HTTP/SSE
server and the step-thread bridge come with the router."""

from .priority import PriorityConfig, PriorityScheduler, TenantPolicy

__all__ = ["PriorityConfig", "PriorityScheduler", "TenantPolicy"]
