"""Program cost model: flops and bytes per serving program, live MFU and
bandwidth-utilization gauges, and KV-memory reconciliation (port of
``deepspeed_tpu/telemetry/costs.py``).

The JAX model harvests XLA's ``cost_analysis()`` once per ``(program,
signature)`` through the watchdog's proxies and charges it on every call.
PyTorch has no compiled program to ask, so the port COUNTS each program
analytically, once per ``(program, signature)``, from the served model's
config and the call's shapes, and caches the count as the JAX model caches
its harvest:

* flops: the projections of every layer for every token the call runs,
  the attention over the positions each query may read, and the vocabulary
  head for every position it projects (a multiply-add is two flops; norms,
  activations and rotary are left out, a few percent at served widths);
* bytes: every stored weight read once (the embedding table only for the
  rows gathered, unless the tied head reads it all), the KV rows read and
  written, and the fp32 logits written. Activations are left out.

The attention over a cache and its KV read are charged from the LIVE
lengths, the positions the kernels read, not the cache's capacity: a
program's count splits into its signature's terms (cached) and a term a
cache position read, times the positions the call's rows read before their
own tokens. A prefill chunk's offset is a host integer among its
arguments; a decode or verify step's positions are a device tensor, so the
serving loop hands the model their host copy before the step
(``ProgramCostModel.positions``), and a host value among the arguments
(an int, an array, a CPU tensor) is read directly. Only a call with
neither is charged at the cache's capacity, an upper bound. A captured
decode or verify step is charged as its eager program: the engine entry
point is the program, however it runs.

Each forward is charged once. The pool programs call the engine's
(``PagedKVPool.run_decode`` calls ``InferenceEngine.decode_paged``) and
both are watched; a watched call inside which another watched call was
charged is not charged again (``watchdog._Watched``), so the engine
program, whose signature the count reads, carries the cost. A program the
count does not know is ``unavailable`` (its calls uncosted), as a failed
harvest is in the JAX model; the serving loop is never perturbed.

``MFU`` = flops / wall / peak flops; ``bandwidth_util`` = bytes / wall /
peak bytes a second; ``tokens_per_gflop`` = tokens / (flops / 1e9). The
peaks (:func:`resolve_peaks`) are the card's published dense bf16 and
memory figures, by device name: a share of the card, not of what some
library call attains. Explicit ``peak_flops`` / ``peak_bytes_per_s`` are
taken as aggregate, as in the JAX model.

Over a model group above one rank each rank counts its own share: its
query and KV heads, its MLP columns, its block of the vocabulary head
(:func:`_rank_dims`) and the weights and KV rows it stores, against one
card's peaks. The JAX model charges the whole program against the mesh's
devices times the peak; at an even split the two ratios are equal.

KV reconciliation (:func:`kv_hbm_report`): the KV footprint predicted from
``KVCacheSpec`` math against the pool's cache tensors. A page pool's extra
scratch page (the sink of dropped writes, which holds no token's row) is
bookkeeping like the page table, left out of both sides.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.nn.utils import parametrize

from .watchdog import _key_one

# (peak_flops, peak_bytes_per_s) by a substring of the lowercased
# torch.cuda.get_device_name(), first match wins: dense bf16 tensor-core
# flop/s and memory bytes/s from NVIDIA's published data sheets
_DEVICE_PEAKS: Tuple[Tuple[str, Tuple[float, float]], ...] = (
    ("h100 80gb hbm3", (989e12, 3.35e12)),     # H100 SXM5
    ("h100 nvl", (835e12, 3.9e12)),
    ("h100 pcie", (756e12, 2.0e12)),
)
# the CPU and unknown devices get the JAX package's nominal figures, so MFU
# stays a nonzero, comparable ratio
_NOMINAL_PEAKS = (1e12, 1e11)

_MISSING = object()


def resolve_peaks(device=None) -> Tuple[float, float]:
    """(peak_flops, peak_bytes_per_s) of ``device`` (a torch device or
    name; None: the current CUDA device when there is one)."""
    name = ""
    try:
        dev = torch.device(device) if device is not None else (
            torch.device("cuda") if torch.cuda.is_available() else None)
        if dev is not None and dev.type == "cuda":
            name = torch.cuda.get_device_name(dev).lower()
    except Exception:
        pass
    for key, peaks in _DEVICE_PEAKS:
        if key in name:
            return peaks
    return _NOMINAL_PEAKS


def _cost_key(args: tuple, kwargs: Dict[str, Any]) -> tuple:
    """The watchdog's ``fast_key``, but a dict of tensors (a cache) keyed
    by its leaves' shapes: a chunk's gathered cache view grows with its
    offset, and the count reads the width."""
    def one(x):
        if isinstance(x, dict):
            return tuple((k, _key_one(v)) for k, v in x.items())
        return _key_one(x)

    return (tuple(map(one, args)),
            tuple((k, one(v)) for k, v in sorted(kwargs.items())))


# ----------------------------------------------------------------------
# analytic counts
# ----------------------------------------------------------------------
def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _stored(module) -> int:
    return sum(map(_nbytes, module.state_dict().values()))


def _rank_dims(module) -> Tuple[int, int, int, int]:
    """(query heads, KV heads, MLP hidden units, vocabulary rows) that this
    rank's forward computes: the model's own at one rank, the layers'
    shares over a model group (``module_inject.apply_tensor_parallel``)."""
    cfg = module.config
    H, KV = cfg.n_head, cfg.kv_heads
    F, V = int(cfg.mlp_ratio * cfg.n_embd), cfg.vocab_size
    blocks = getattr(module, "blocks", None)
    if blocks:
        H = getattr(blocks[0].attn, "heads", H)
        KV = getattr(blocks[0].attn, "kv_heads", KV)
        F = getattr(blocks[0].mlp.up_proj, "out_features", F)
    head = getattr(module, "lm_head", None)
    if getattr(head, "group", None) is not None:   # a vocab-parallel head
        V = getattr(head, "out_features", None) or \
            head.local_weight().shape[0]
    return H, KV, F, V


def _model_terms(module) -> Dict[str, float]:
    """The model's terms of the count (this rank's share of them over a
    model group)."""
    cfg = module.config
    C, D = cfg.n_embd, cfg.head_dim
    H, KV, F, V = _rank_dims(module)
    mlp = (3 if cfg.activation == "swiglu" else 2) * C * F
    item = torch.empty((), dtype=cfg.dtype).element_size()
    # embedding tables are gathered a row a token, unless stored int8
    # (the storage tier dequantizes a table whole) or read whole by a
    # tied head
    tables = [getattr(module, name) for name in ("embed_tokens", "embed_pos")
              if hasattr(module, name)]
    gathered = [t for t in tables if not parametrize.is_parametrized(t)]
    weights = _stored(module) - sum(map(_stored, gathered))
    if cfg.tie_word_embeddings and module.embed_tokens in gathered:
        weights += _stored(module.embed_tokens)
    quant = cfg.kv_cache_quant
    return dict(
        # flops a token, all layers: q, k, v, o and the MLP
        proj=2.0 * cfg.n_layer * (2 * C * H * D + 2 * C * KV * D + mlp),
        # flops a (query, key) pair, all layers: scores and the PV product
        pair=4.0 * cfg.n_layer * H * D,
        head=2.0 * C * V,
        vocab=float(V),
        weights=float(weights),
        row=float(C * item * len(gathered)),
        kv_token=float(cfg.n_layer * 2 * KV * (D * (1 if quant else item)
                                               + (4 if quant else 0))),
    )


def _forward(module, B: int, T: int, pairs_per_row: float, read: int,
             head_rows: int) -> Dict[str, float]:
    """A forward of (B, T) tokens: ``pairs_per_row`` attention pairs a
    row, ``read`` cache positions read a row, ``head_rows`` positions
    projected a row."""
    m = _model_terms(module)
    flops = (B * T * m["proj"] + B * pairs_per_row * m["pair"]
             + B * head_rows * m["head"])
    byts = (m["weights"] + B * T * m["row"]
            + B * (read + T) * m["kv_token"] + B * head_rows * m["vocab"] * 4)
    return {"flops": float(flops), "bytes": float(byts)}


def _cached(module, B: int, T: int, head_rows: int, live: tuple,
            capacity: int) -> Dict[str, Any]:
    """A forward of (B, T) tokens after a cache prefix: the signature's
    terms (the tokens' own causal pairs and KV writes) and the terms a
    prefix position read (its T pairs, its KV row). ``live`` says where a
    call's prefix lengths are (:func:`_prefix`); ``capacity`` is the
    prefix a row when they are unknown."""
    m = _model_terms(module)
    cost: Dict[str, Any] = _forward(module, B, T, T * (T + 1) / 2, 0,
                                    head_rows)
    cost.update(pos_flops=T * m["pair"], pos_bytes=m["kv_token"],
                live=live, rows=B, capacity=B * capacity)
    return cost


def _cache_len(cache: Dict[str, torch.Tensor]) -> int:
    return int(cache["k"].shape[-2])


def _rows(ids) -> Tuple[int, int]:
    shape = np.shape(ids)
    return (1, shape[0]) if len(shape) == 1 else tuple(shape[-2:])


def _count(program: str, owner, args: tuple,
           kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """The analytic cost of ``program`` (the entry point's method name)
    bound to ``owner`` at this call's signature; raises for a program it
    does not know. A program that reads a cache prefix also carries the
    terms a prefix position read (:func:`_cached`): :func:`charge` adds
    them for a call's live lengths."""
    a = args
    if program == "prefill_at":           # (input_ids, last_pos, cache, ..)
        B, T = _rows(a[0])
        return _forward(owner.module, B, T, T * (T + 1) / 2, 0, 1)
    if program == "prefill_chunk":        # (cache, input_ids, slot, start,.)
        B, T = _rows(a[1])
        return _cached(owner.module, B, T, 1, ("start", 3), _cache_len(a[0]))
    if program in ("decode", "verify_k"):     # (cache, tokens, pos, ...)
        B, T = _rows(a[1])
        return _cached(owner.module, B, T, T, ("pos", 2),
                       _cache_len(a[0]) - T)
    if program == "decode_paged":         # (pages, tokens, pos, table, ..)
        B, T = _rows(a[1])
        return _cached(owner.module, B, T, T, ("pos", 2),
                       int(a[3].shape[1]) * _cache_len(a[0]) - T)
    if program in ("sample", "_finite"):  # (logits, ...): a pass over them
        n = a[0][:, -1].numel() if program == "sample" else a[0].numel()
        return {"flops": float(n), "bytes": float(n * 4)}
    if program == "_copy_page":           # a page of every leaf, read + write
        return {"flops": 0.0, "bytes": 2.0 * owner.page_nbytes}
    if program == "admit_rows":           # (cache, slots, lengths)
        if not hasattr(owner, "num_pages"):
            return {"flops": 0.0, "bytes": 0.0}   # a host record
        return {"flops": 0.0,
                "bytes": 2.0 * sum(map(_nbytes, a[0].values()))}
    raise KeyError(f"no analytic count for program {program!r}")


def _prefix(cost: Dict[str, Any], args: tuple,
            positions: Optional[np.ndarray]) -> float:
    """The cache positions a call's rows read before their own tokens,
    summed over the rows: a chunk's host offset, or a step's positions
    (a host value among the arguments, else ``positions``, the serving
    loop's host copy of the device tensor), else the capacity."""
    kind, i = cost["live"]
    x = args[i]
    if kind == "start":
        return float(x)
    if isinstance(x, (int, np.integer)):
        return float(x) * cost["rows"]
    if isinstance(x, np.ndarray) or (torch.is_tensor(x)
                                     and x.device.type == "cpu"):
        return float(np.asarray(x).sum())
    if positions is not None and len(positions) == cost["rows"]:
        return float(np.asarray(positions).sum())
    return float(cost["capacity"])


def charge(cost: Dict[str, Any], args: tuple,
           positions: Optional[np.ndarray] = None) -> Tuple[float, float]:
    """(flops, bytes) of one call of a counted program (:func:`_count`)
    with these arguments."""
    if "live" not in cost:
        return cost["flops"], cost["bytes"]
    n = _prefix(cost, args, positions)
    return (cost["flops"] + n * cost["pos_flops"],
            cost["bytes"] + n * cost["pos_bytes"])


class ProgramCostModel:
    """Per-``(program, signature)`` flops/bytes with running totals and
    per-step window gauges, subscribed to the watchdog's proxies (every
    watched call lands in :meth:`account`)."""

    def __init__(self, registry=None, peak_flops: Optional[float] = None,
                 peak_bytes_per_s: Optional[float] = None,
                 hbm_tolerance: float = 0.01, kv_every: int = 16,
                 num_devices: Optional[int] = None, device=None):
        pf, pb = resolve_peaks(device)
        # one card unless told otherwise (the port has no device mesh);
        # explicit peaks are taken as already aggregate
        self.num_devices = max(1, int(num_devices or 1))
        self.peak_flops = (float(peak_flops) if peak_flops
                           else pf * self.num_devices)
        self.peak_bytes_per_s = (float(peak_bytes_per_s)
                                 if peak_bytes_per_s
                                 else pb * self.num_devices)
        self.hbm_tolerance = float(hbm_tolerance)
        self.kv_every = max(1, int(kv_every))
        self.registry = registry
        # the host copy of the running decode or verify step's (B,) cache
        # positions, set by the serving loop before the step: the live
        # lengths its attention reads (:func:`_prefix`)
        self.positions: Optional[np.ndarray] = None
        self._handles: Optional[Tuple[Any, ...]] = None
        # (program, signature) -> cost terms, or None when uncountable
        self.programs: Dict[Tuple[str, Any], Optional[Dict[str, Any]]] = {}
        self.flops_total = 0.0
        self.bytes_total = 0.0
        self.calls_total = 0
        self.uncosted_calls = 0
        self.harvests = 0
        self.unavailable = 0
        self.wall_total_s = 0.0
        self.tokens_total = 0
        self.overhead_ns = 0
        self.harvest_ns = 0
        self._win_flops = 0.0
        self._win_bytes = 0.0
        self.mfu = 0.0
        self.bandwidth_util = 0.0
        self.tokens_per_gflop = 0.0
        self.hbm: Dict[str, float] = {}
        self._hbm_drifted = False

    # -- per-call accounting (hot path) --------------------------------
    def account(self, program: str, fn, args, kwargs) -> None:
        t0 = time.perf_counter_ns()
        key = (program, _cost_key(args, kwargs))
        cost = self.programs.get(key, _MISSING)
        if cost is _MISSING:
            self.overhead_ns += time.perf_counter_ns() - t0
            cost = self._harvest(key, fn, args, kwargs)
            t0 = time.perf_counter_ns()
        self.calls_total += 1
        try:
            f, b = charge(cost, args, self.positions)
            self._win_flops += f
            self._win_bytes += b
        except Exception:       # uncountable: None, or unreadable lengths
            self.uncosted_calls += 1
        self.overhead_ns += time.perf_counter_ns() - t0

    # -- the count (cold path, once per signature) ---------------------
    def _harvest(self, key, fn, args, kwargs) -> Optional[Dict[str, Any]]:
        t0 = time.perf_counter_ns()
        try:
            cost = _count(key[0].rsplit(".", 1)[-1],
                          getattr(fn, "__self__", None), args, kwargs)
            self.harvests += 1
        except Exception:
            # an unknown program (or one whose arguments the count cannot
            # read) stays uncosted; serving goes on
            cost = None
            self.unavailable += 1
            if self.registry is not None:
                self.registry.gauge(
                    "telemetry/cost_model_unavailable").set(self.unavailable)
        self.programs[key] = cost
        self.harvest_ns += time.perf_counter_ns() - t0
        return cost

    # -- per-step gauges -----------------------------------------------
    def step_update(self, wall_s: float, tokens: int = 0,
                    tracer=None) -> None:
        """Fold the window's flops/bytes into gauges against ``wall_s``
        (the step's wall time). Called once per serving step."""
        f, b = self._win_flops, self._win_bytes
        self._win_flops = 0.0
        self._win_bytes = 0.0
        self.wall_total_s += wall_s
        self.tokens_total += int(tokens)
        self.flops_total += f
        self.bytes_total += b
        if wall_s > 0:
            self.mfu = f / wall_s / self.peak_flops
            self.bandwidth_util = b / wall_s / self.peak_bytes_per_s
        self.tokens_per_gflop = tokens / (f / 1e9) if f > 0 else 0.0
        if self.registry is not None:
            if self._handles is None:
                # resolve the metric objects once: registry lookups take a
                # lock each
                g, c = self.registry.gauge, self.registry.counter
                self._handles = (g("telemetry/mfu"),
                                 g("telemetry/bandwidth_util"),
                                 g("telemetry/tokens_per_gflop"),
                                 c("telemetry/flops_total"),
                                 c("telemetry/bytes_accessed_total"))
            h = self._handles
            h[0].set(self.mfu)
            h[1].set(self.bandwidth_util)
            h[2].set(self.tokens_per_gflop)
            h[3].inc(f)
            h[4].inc(b)
        if tracer is not None:
            tracer.counter("telemetry/efficiency", mfu=self.mfu,
                           bandwidth_util=self.bandwidth_util)

    # -- KV reconciliation ---------------------------------------------
    def reconcile_kv(self, pool, monitor=None, step: int = 0,
                     tracer=None) -> Dict[str, float]:
        """Predicted KV bytes against the pool's cache tensors (and the
        allocator's stats); emits ``telemetry/hbm_drift`` when the drift
        crosses the tolerance. The serving loop calls this every
        ``kv_every`` steps; ``efficiency_snapshot`` calls it fresh."""
        rep = kv_hbm_report(pool)
        rep.update(device_memory_report())
        if not rep.get("hbm_peak_bytes"):
            # the CPU has no allocator stats: the pool is the allocation
            # this layer tracks
            rep["hbm_peak_bytes"] = rep["kv_bytes_actual"]
        drifted = rep["hbm_drift"] > self.hbm_tolerance
        if self.registry is not None:
            g = self.registry.gauge
            g("telemetry/kv_bytes_predicted").set(rep["kv_bytes_predicted"])
            g("telemetry/kv_bytes_actual").set(rep["kv_bytes_actual"])
            g("telemetry/hbm_drift").set(rep["hbm_drift"])
            g("telemetry/hbm_peak_bytes").set(rep["hbm_peak_bytes"])
        if drifted and not self._hbm_drifted:
            if tracer is not None:
                tracer.instant("telemetry/hbm_drift", **rep)
            if monitor is not None and getattr(monitor, "enabled", False):
                monitor.write_events([
                    ("telemetry/hbm_drift", rep["hbm_drift"], int(step))])
        self._hbm_drifted = drifted
        self.hbm = rep
        return rep

    # -- lifecycle -----------------------------------------------------
    def reset_totals(self) -> None:
        """Zero the running totals (the counted programs are kept), so a
        measured window starts after warmup."""
        self.flops_total = 0.0
        self.bytes_total = 0.0
        self.calls_total = 0
        self.uncosted_calls = 0
        self.wall_total_s = 0.0
        self.tokens_total = 0
        self.overhead_ns = 0
        self._win_flops = 0.0
        self._win_bytes = 0.0

    @property
    def overhead_s(self) -> float:
        return self.overhead_ns / 1e9

    def summary(self) -> Dict[str, Any]:
        wall = self.wall_total_s
        flops, byts = self.flops_total, self.bytes_total
        return {
            "programs": len(self.programs),
            "harvests": self.harvests,
            "unavailable": self.unavailable,
            "calls_total": self.calls_total,
            "uncosted_calls": self.uncosted_calls,
            "flops_total": flops,
            "bytes_accessed_total": byts,
            "tokens_total": self.tokens_total,
            "wall_s": wall,
            "mfu": flops / wall / self.peak_flops if wall > 0 else 0.0,
            "bandwidth_util": (byts / wall / self.peak_bytes_per_s
                               if wall > 0 else 0.0),
            "tokens_per_gflop": (self.tokens_total / (flops / 1e9)
                                 if flops > 0 else 0.0),
            "peak_flops": self.peak_flops,
            "peak_bytes_per_s": self.peak_bytes_per_s,
            "num_devices": self.num_devices,
            "overhead_s": self.overhead_s,
            "harvest_s": self.harvest_ns / 1e9,
            "hbm": dict(self.hbm),
        }


# ----------------------------------------------------------------------
# KV memory math
# ----------------------------------------------------------------------
_KV_LEAVES = ("k", "v", "k_scale", "v_scale")


def kv_hbm_report(pool) -> Dict[str, float]:
    """Predicted against actual KV-cache bytes of a ``SlotPool`` or
    ``PagedKVPool``. Predicted comes from ``KVCacheSpec`` math alone:
    bytes a token times capacity tokens (``num_pages * page_size`` paged,
    ``max_seq_len`` times the slots the cache holds contiguous, a data
    rank's share over a ``(data, model)`` mesh). Actual sums the pool's k/v
    (and scale) tensors, the page pool's scratch page left out."""
    spec = pool.spec
    item = 1 if spec.quant else torch.empty((), dtype=spec.dtype) \
        .element_size()
    per_token = spec.n_layer * spec.kv_heads * spec.head_dim * 2 * item
    if spec.quant:
        per_token += spec.n_layer * spec.kv_heads * 2 * 4  # fp32 scales
    paged = hasattr(pool, "num_pages")
    if paged:
        tokens = pool.num_pages * pool.page_size
        page_bytes = per_token * pool.page_size
    else:
        lo, hi = pool.shard
        tokens = (hi - lo) * spec.max_seq_len
        page_bytes = 0.0
    predicted = float(per_token * tokens)
    actual = 0.0
    for name in _KV_LEAVES:
        leaf = pool.cache.get(name)
        if leaf is not None:
            leaf = leaf[:, :pool.num_pages] if paged else leaf
            actual += float(_nbytes(leaf))
    drift = abs(actual - predicted) / predicted if predicted > 0 else 0.0
    rep = {
        "kv_bytes_predicted": predicted,
        "kv_bytes_actual": actual,
        "kv_bytes_per_token": float(per_token),
        "kv_capacity_tokens": float(tokens),
        "hbm_drift": drift,
        "layout": "paged" if paged else "contiguous",
    }
    if paged:
        rep["pages_total"] = float(pool.num_pages)
        rep["page_bytes"] = float(page_bytes)
    return rep


def device_memory_report() -> Dict[str, float]:
    """The CUDA caching allocator's bytes in use, their peak and the
    card's memory (zeros without an initialized card)."""
    stats: Dict[str, Any] = {}
    limit = 0
    try:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            stats = torch.cuda.memory_stats()
            limit = torch.cuda.get_device_properties(
                torch.cuda.current_device()).total_memory
    except Exception:
        pass
    return {
        "hbm_bytes_in_use": float(stats.get("allocated_bytes.all.current",
                                            0) or 0),
        "hbm_peak_bytes": float(stats.get("allocated_bytes.all.peak", 0)
                                or 0),
        "hbm_bytes_limit": float(limit or 0),
    }
