"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one: the same module names, PyTorch idiom
inside, hand-written CUDA kernels for Hopper (sm_90a) where the JAX package
wrote Pallas kernels for the TPU. It never imports JAX or ``deepspeed_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

__version__ = "0.1.0"

from .accelerator import get_accelerator  # noqa: F401
from .inference.engine import InferenceEngine  # noqa: F401
from .runtime.config import DeepSpeedConfig  # noqa: F401
from .runtime.engine import DeepSpeedEngine
from .serving.engine import ServingEngine
from .utils.logging import log_dist, logger  # noqa: F401


def initialize(args=None, model: Any = None, optimizer=None,
               model_parameters: Any = None, training_data=None,
               lr_scheduler=None, mpu=None, dist_init_required=None,
               collate_fn=None, config: Union[str, Dict, None] = None,
               config_params: Union[str, Dict, None] = None, loss_fn=None,
               sharding_rules=None, mesh=None, device: Optional[Any] = None):
    """Build the training engine; returns ``(engine, optimizer,
    training_dataloader, lr_scheduler)`` as the JAX ``initialize`` does.

    ``model`` is an ``nn.Module`` whose ``forward(batch)`` returns the loss
    (``GPT2LMHeadModel``); the optimizer comes from the config's
    ``optimizer`` block (the returned optimizer is its ``OptimizerDef``).
    ``device`` defaults to ``cuda``. A client optimizer object, a pipeline
    module and the hybrid engine are not ported and raise."""
    if config is None and config_params is not None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if config is None:
        raise ValueError("DeepSpeed requires --deepspeed_config or config=")
    if optimizer is not None:
        raise NotImplementedError("a client optimizer object is not ported; "
                                  "configure the optimizer block instead")
    if type(model).__name__ == "PipelineModule":
        raise NotImplementedError("pipeline parallelism is not ported to "
                                  "the PyTorch/CUDA package yet")
    engine = DeepSpeedEngine(model=model, loss_fn=loss_fn,
                             model_parameters=model_parameters, config=config,
                             training_data=training_data,
                             lr_scheduler=lr_scheduler, collate_fn=collate_fn,
                             device=device, sharding_rules=sharding_rules,
                             mesh=mesh)
    return (engine, engine.optimizer_def, engine.training_dataloader,
            engine.lr_scheduler)


def init_inference(model: Any = None, config: Union[Dict, None] = None,
                   **kwargs) -> InferenceEngine:
    """Build the inference engine: ``model`` is the port's
    ``TransformerLM``; ``model_parameters=`` (a state dict) and
    ``device=`` are optional; other keys configure the engine
    (``enable_cuda_graph=True``: decode steps replay captured CUDA
    graphs)."""
    return InferenceEngine(model=model, config=config, **kwargs)


# serving keys the JAX ``init_serving`` routes to the ServingEngine
SERVE_KEYS = ("policy", "do_sample", "temperature", "top_k", "top_p", "seed",
              "monitor", "prefill_chunk", "prefill_token_budget",
              "paged_kv", "strict_recompile", "overlap", "spec_decode",
              "tracer", "registry", "timeline_capacity",
              "deadline_default_ms", "step_wall_budget_ms", "guard_numerics",
              "degradation", "preempt_queue_threshold",
              "preempt_min_run_steps", "fault_injector", "slo",
              "cost_model", "flight_recorder", "dump_dir", "priority",
              "clock", "role")


def init_serving(model: Any = None, config: Union[Dict, None] = None,
                 num_slots: int = 4, max_queue_depth: int = 64,
                 device: Optional[Any] = None, **kwargs) -> ServingEngine:
    """Build a continuous-batching server: :func:`init_inference` for the
    engine, wrapped in :class:`ServingEngine` (slot-pooled KV cache, FIFO
    admission, per-request SLO metrics).

    Server-global keys: ``policy``, ``do_sample``, ``temperature``,
    ``top_k``, ``top_p``, ``seed``, ``monitor``; ``prefill_chunk`` (default
    64: stall-free chunked admission; 0: whole prompts at admission) and
    ``prefill_token_budget`` (default two chunks per step); ``paged_kv``
    (False: contiguous rows; True or ``{"num_pages", "page_size",
    "prefix_cache", "kernel"}``: the page pool with its prefix cache,
    decode reading pages in place through the paged attention kernel
    unless ``kernel="off"``); ``strict_recompile`` (a new program
    signature or decode capture after ``end_warmup()`` raises at the step
    boundary) and ``overlap`` (the pipelined step: decode issued before
    admission); ``spec_decode`` (None/False: off; True, a dict or a
    ``SpecDecodeConfig``: speculative decoding, e.g. ``{"drafter":
    "ngram", "k": 4, "max_ngram": 3}`` or ``{"drafter": "model", "k": 4,
    "draft_engine": <InferenceEngine>}``; each step verifies ``k`` draft
    tokens a slot in one (num_slots, k+1) forward, greedy tokens unchanged,
    and admission reserves ``k`` positions).

    Telemetry keys: ``tracer`` (a ``telemetry.Tracer``, or True for a
    default one; off by default), ``registry`` (a ``telemetry.
    MetricsRegistry``; one is made by default), ``timeline_capacity``
    (per-request lifecycle timelines kept, default 4096), ``slo`` (True,
    a dict or an ``SLOConfig``: windowed TTFT/gap quantiles, goodput and
    burn-rate alerts), ``flight_recorder`` (default True: a ring of
    per-step records; False, a capacity, a kwargs dict or an instance)
    and ``dump_dir`` (where its post-mortems go). Fault-tolerance keys:
    ``deadline_default_ms`` (the TTL of a submit without its own
    ``deadline_ms``), ``step_wall_budget_ms`` (the per-step wall watchdog),
    ``guard_numerics`` (fail only the slot whose decode logits hold a
    NaN/inf), ``degradation`` (True, a dict or a ``DegradationConfig``:
    the HEALTHY/PRESSURED/OVERLOADED ladder), ``preempt_queue_threshold``
    and ``preempt_min_run_steps`` (automatic pressure preemption),
    ``fault_injector`` (a ``serving.resilience.FaultInjector``, for chaos
    tests), ``priority`` (True, a dict or a ``PriorityConfig``: priority
    classes and tenant limits) and ``clock`` (the one clock every deadline,
    SLO and degradation decision reads; ``time.perf_counter`` by default).
    ``cost_model`` (False by default; True, a ``telemetry.
    ProgramCostModel`` kwargs dict or an instance): analytic flops and
    bytes per program call, read back as MFU and bandwidth utilization
    through ``srv.efficiency_snapshot()``. ``role`` (``"both"`` by
    default; ``"prefill"`` or ``"decode"`` with ``paged_kv``): the
    disaggregated replica roles a ``serving.ReplicaRouter`` moves requests
    between, their KV pages copied across pools.

    Per-request ``max_new_tokens``, ``eos_token_id``, ``deadline_ms``,
    ``priority`` and ``tenant`` ride on ``submit()``. Everything else
    configures the inference engine, among it ``enable_cuda_graph``: every
    decode step then replays a CUDA graph.

    The default serving path on the card::

        init_serving(model, config={"dtype": "bfloat16"}, num_slots=8,
                     prefill_chunk=64,
                     paged_kv={"page_size": 64, "num_pages": 128,
                               "prefix_cache": True, "kernel": "auto"})
    """
    serve_kwargs = {k: kwargs.pop(k) for k in SERVE_KEYS if k in kwargs}
    engine = init_inference(model=model, config=config, device=device,
                            **kwargs)
    return ServingEngine(engine, num_slots=num_slots,
                         max_queue_depth=max_queue_depth, **serve_kwargs)
