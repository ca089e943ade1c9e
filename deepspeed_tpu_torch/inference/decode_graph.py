"""Captured decode steps: one CUDA graph per decode signature, replayed at
every step.

The JAX engine compiles its whole decode step with ``jax.jit``
(``deepspeed_tpu/inference/engine.py:369-382``) and its whole ``generate()``
loop into one program, cached per signature (``_decode_scan_execs``,
``:437-440``). PyTorch dispatches a step op by op from the host, hundreds of
launches for a 12-layer model, so the port records one decode step in a
``torch.cuda.CUDAGraph`` and replays it: one launch a step. A
:class:`DecodeGraphs` holds one captured step per signature: the route
(``"contiguous"``, ``TransformerLM.decode`` over a stacked cache, or
``"paged"``, ``decode_paged`` over a page pool and its table), the batch
and query rows a slot (one for a decode step, K+1 for a speculative verify
forward), the cache leaves' shapes and dtypes and, for the pool, the
table's width.

A captured step owns static inputs, tokens (B, T) long (T = 1 for a
decode step, K+1 for verify), positions (B,) long and for the pool the
table (B, pages_per_slot) int32, which each call fills before the replay,
and a static fp32 logits output (B, T, V). It
updates the cache leaves it was captured on in place, so it is bound to
those tensors too: a cache of the same signature at another address gets a
graph of its own, and a graph whose leaves were freed is dropped. Sampling
runs after the replay, outside the graph, greedy or drawn from the caller's
``torch.Generator``: one graph serves every sampling mode, sampled tokens
equal the eager path's for the same seed, and no generator state is
captured. Speculative acceptance (``serving/spec_decode/verify.py``) runs
after a verify replay the same way. A contiguous verify forward's writes
past the allocation are dropped without a host sync
(``models/transformer_lm._row_writes``), a paged one's go to the pool's
scratch page.

Capture: the step first runs eagerly once on a side stream (which builds
the kernels at first use, never inside a capture, and computes this step),
then is recorded. Every kernel wrapper counts its launches on the host
(``.launches``, ``.int8_launches``, ``.prefill_launches``), which a replay
never touches; so the capture records each counter's change, undoes it
(recording runs nothing), and every replay adds it. The counters keep
counting kernel executions.

On a CPU engine nothing is captured: the same static-buffer step body runs
eagerly at every call, as every kernel wrapper of the port takes its plain
version for CPU tensors, so the CPU tests drive all of this but the capture
call itself.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, Optional

import torch

from ..ops.attention.decode_attention import decode_attention
from ..ops.attention.flash_attention import flash_attention
from ..ops.attention.paged_attention import paged_decode_attention
from ..ops.quantization.int8_matmul import int8_matmul

ROUTES = ("contiguous", "paged")

# every kernel launch counter a decode step can move: (wrapper, attribute)
LAUNCH_COUNTERS = ((decode_attention, "launches"),
                   (decode_attention, "int8_launches"),
                   (paged_decode_attention, "launches"),
                   (paged_decode_attention, "int8_launches"),
                   (int8_matmul, "launches"),
                   (int8_matmul, "prefill_launches"),
                   (flash_attention, "launches"))


def _read_counters() -> list:
    return [getattr(fn, attr) for fn, attr in LAUNCH_COUNTERS]


def _write_counters(values) -> None:
    for (fn, attr), value in zip(LAUNCH_COUNTERS, values):
        setattr(fn, attr, value)


def decode_signature(route: str, cache: Dict[str, torch.Tensor],
                     tokens, table=None) -> str:
    """A decode step's signature: route, tokens' shape (the batch, and the
    query rows a slot: one for decode), each cache leaf's dtype and shape,
    and the table's width on the paged route."""
    leaves = " ".join(
        f"{name}:{str(leaf.dtype).replace('torch.', '')}"
        f"[{','.join(map(str, leaf.shape))}]"
        for name, leaf in sorted(cache.items()))
    width = f" table={table.shape[1]}" if table is not None else ""
    return f"{route} tokens={list(tokens.shape)} {leaves}{width}"


class DecodeGraph:
    """One decode step, captured on a CUDA device (run eagerly on the
    CPU), with its static inputs and output."""

    def __init__(self, module: Any, route: str, cache: Dict[str, Any],
                 tokens_shape: tuple, table_width: Optional[int], device):
        if route not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
        self.module = module
        self.route = route
        self._leaves = {name: weakref.ref(leaf)
                        for name, leaf in cache.items()}
        self._ptrs = {name: leaf.data_ptr() for name, leaf in cache.items()}
        batch = tokens_shape[0]
        self.tokens = torch.zeros(tokens_shape, dtype=torch.long,
                                  device=device)
        self.pos = torch.zeros((batch,), dtype=torch.long, device=device)
        self.table = (torch.zeros((batch, table_width), dtype=torch.int32,
                                  device=device)
                      if route == "paged" else None)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self._deltas = None

    def bound_to(self, cache: Dict[str, Any]) -> bool:
        """Whether this step was captured on exactly these leaves."""
        return set(cache) == set(self._leaves) and all(
            self._leaves[name]() is leaf for name, leaf in cache.items())

    def alive(self) -> bool:
        return all(ref() is not None and ref().data_ptr() == self._ptrs[name]
                   for name, ref in self._leaves.items())

    def load(self, tokens, pos, table=None) -> None:
        """Fill the static inputs (stream-ordered copies, no host sync for
        tensors already on the device; ``pos`` may be an int)."""
        self.tokens.copy_(tokens)
        if isinstance(pos, int):
            self.pos.fill_(pos)
        else:
            self.pos.copy_(pos)
        if self.table is not None:
            self.table.copy_(table)

    def _body(self, cache: Dict[str, Any]) -> torch.Tensor:
        if self.route == "paged":
            return self.module.decode_paged(self.tokens, self.pos, cache,
                                            self.table, scratch_page=True)
        return self.module.decode(self.tokens, self.pos, cache)

    def capture(self, cache: Dict[str, Any]) -> torch.Tensor:
        """Run the step once on a side stream (it builds every kernel and
        computes this step's logits, which it returns), then record it.
        On the CPU only the eager run happens. Raises if the step cannot
        be captured: it never falls back to running eagerly on the card."""
        device = self.tokens.device
        if device.type != "cuda":
            return self._body(cache)
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            first = self._body(cache)
        current.wait_stream(side)
        before = _read_counters()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                self.logits = self._body(cache)
        finally:
            after = _read_counters()
            _write_counters(before)
        self._deltas = [a - b for a, b in zip(after, before)]
        self.graph = graph
        return first

    def replay(self, cache: Dict[str, Any]) -> torch.Tensor:
        """One step: replay the graph (the CPU: run the body) and count
        the kernels it launched. The logits are the static output, valid
        until the next step of this graph."""
        if self.graph is None:
            return self._body(cache)
        self.graph.replay()
        _write_counters([v + d for v, d in
                         zip(_read_counters(), self._deltas)])
        return self.logits


class DecodeGraphs:
    """The captured decode steps of one model on one device, one per
    signature and cache (the JAX engine's decode compile cache), and the
    static caches ``generate()`` prefills into.

    :meth:`capture` is the one place a step is recorded; the serving
    engine's recompile watchdog watches it, so a new decode signature after
    warmup counts as a recompile. ``captures`` counts them."""

    def __init__(self, module: Any, device):
        self.module = module
        self.device = torch.device(device)
        self.captures = 0
        self._graphs: Dict[tuple, DecodeGraph] = {}
        self._caches: Dict[tuple, Dict[str, torch.Tensor]] = {}

    def static_cache(self, batch: int) -> Dict[str, torch.Tensor]:
        """The (L, batch, KV, S, D) cache that ``generate()`` at this batch
        prefills into and decodes over: one per batch and cache spec, kept,
        so every call replays the same graph. Prefill writes positions
        [0, T) and each step its own position; attention never reads past
        a row's length, so what an earlier call left there is never
        seen."""
        spec = self.module.kv_cache_spec()
        key = (batch, spec)
        if key not in self._caches:
            self._caches[key] = spec.stacked_cache(batch, self.device)
        return self._caches[key]

    def capture(self, signature: str, graph: DecodeGraph,
                cache: Dict[str, Any]) -> torch.Tensor:
        """Record ``graph`` (whose inputs are loaded) on ``cache``; returns
        this step's logits. ``signature`` names the step for the
        watchdog."""
        del signature
        logits = graph.capture(cache)
        self.captures += 1
        return logits

    def run(self, route: str, cache: Dict[str, Any], tokens, pos,
            table=None) -> torch.Tensor:
        """One decode step of ``route`` on ``cache`` (updated in place):
        replays the step captured for this signature and cache, capturing
        it first if there is none. ``tokens`` (B, T) long (T = 1 for
        decode) and, for the
        pool, ``table`` (B, pages_per_slot) int32 on the device; ``pos``
        (B,) or an int. Returns the (B, T, V) fp32 logits: the graph's
        static output, valid until its next step."""
        key = (route, tuple(tokens.shape),
               table.shape[1] if table is not None else None,
               tuple((name, tuple(leaf.shape), leaf.dtype, leaf.data_ptr())
                     for name, leaf in sorted(cache.items())))
        graph = self._graphs.get(key)
        if graph is not None and not graph.bound_to(cache):
            graph = None            # same address, another tensor
        if graph is None:
            # graphs whose leaves are gone free their memory pools
            self._graphs = {k: g for k, g in self._graphs.items()
                            if g.alive()}
            graph = DecodeGraph(self.module, route, cache,
                                tuple(tokens.shape),
                                None if table is None else table.shape[1],
                                self.device)
            graph.load(tokens, pos, table)
            logits = self.capture(
                decode_signature(route, cache, tokens, table), graph, cache)
            self._graphs[key] = graph
            return logits
        graph.load(tokens, pos, table)
        return graph.replay(cache)
