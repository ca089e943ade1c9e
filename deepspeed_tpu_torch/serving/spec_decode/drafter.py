"""Drafters: propose K tokens per live slot for one verify forward (port of
``deepspeed_tpu/serving/spec_decode/drafter.py``).

A drafter is host-side policy with a fixed-shape contract: given one
history per slot (``None`` for dead slots AND for slots still
``PREFILLING`` under stall-free chunked admission: the serving engine
withholds their histories, so no draft is proposed against a half-written
cache row), return ``(tokens, counts)`` where ``tokens`` is ``(num_slots,
K)`` int32 and ``counts`` is ``(num_slots,)`` int32 with ``counts[i]`` real
proposals in row ``i`` (the rest is padding the verifier masks). A slot
with ``counts == 0`` gets a plain decode step inside the same verify
forward: no shape change, no new capture, zero accepted drafts.

Correctness never depends on the drafter: verification accepts exactly the
prefix the target model reproduces (greedy) or rejection-samples
losslessly (``do_sample``), so a bad proposal costs verify width, never
wrong output.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_MIN_DRAFT_BUCKET = 16


def bucket_width(n: int, cap: int) -> int:
    """Next power of two >= n (min 16), capped at ``cap``: the serving
    engine's prefill bucketing, which bounds the draft prefill's shapes at
    log2(capacity) across arbitrary history lengths."""
    b = _MIN_DRAFT_BUCKET
    while b < n:
        b *= 2
    return min(b, cap)


class Drafter:
    """Proposal interface (see the module docstring's contract)."""

    name = "drafter"

    def propose(self, histories: List[Optional[np.ndarray]], k: int
                ) -> Tuple[np.ndarray, np.ndarray]:
        """``histories[slot]`` is prompt + generated tokens (int32, the
        not-yet-decoded current token included) or ``None`` for a dead or
        prefilling slot. Returns ``(tokens (num_slots, k) int32, counts
        (num_slots,) int32)``.

        Failure contract: ``propose`` runs inside the serving engine's
        exception-safe step, so a drafter that raises aborts the step
        cleanly (``ServingEngine._abort_step``: no slot leaks, running
        requests FAIL with ``finish_reason="error"``, the error propagates).
        A drafter that cannot draft should return zero ``counts`` instead:
        zero-draft rows make verify a plain decode step."""
        raise NotImplementedError


class NGramDrafter(Drafter):
    """Prompt-lookup decoding: propose the continuation of the most recent
    earlier occurrence of the history's own suffix (Saxena 2023, prompt
    lookup; the assisted-generation candidate strategy). No model runs, so
    its draft overhead is microseconds of host time. It wins on repetitive
    or extractive traffic; on text that does not repeat, acceptance tends
    to zero and throughput falls back to plain decode's."""

    name = "ngram"

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not (1 <= min_ngram <= max_ngram):
            raise ValueError(f"need 1 <= min_ngram({min_ngram}) <= "
                             f"max_ngram({max_ngram})")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def _continuation(self, h: np.ndarray, k: int) -> Optional[np.ndarray]:
        T = len(h)
        # longest suffix first: a longer matched context extrapolates
        # better; fall through to shorter n on no match
        for n in range(min(self.max_ngram, T - 1), self.min_ngram - 1, -1):
            pat = h[T - n:]
            # candidate windows h[s:s+n] must end before the final position
            # so at least one continuation token exists
            win = np.lib.stride_tricks.sliding_window_view(h[:T - 1], n)
            hits = np.nonzero((win == pat).all(axis=1))[0]
            if len(hits):
                s = int(hits[-1])  # most recent occurrence
                return h[s + n:s + n + k]
        return None

    def propose(self, histories, k):
        B = len(histories)
        tokens = np.zeros((B, k), np.int32)
        counts = np.zeros((B,), np.int32)
        for i, h in enumerate(histories):
            if h is None:
                continue
            h = np.asarray(h, np.int32)
            if len(h) < self.min_ngram + 1:
                continue
            cont = self._continuation(h, k)
            if cont is not None and len(cont):
                tokens[i, :len(cont)] = cont
                counts[i] = len(cont)
        return tokens, counts


class SmallModelDrafter(Drafter):
    """Draft with a second (smaller) ``InferenceEngine`` sharing the
    target's tokenizer: the classic two-model speculative setup.

    Per step: one bucketed batched ``prefill_at`` over every live slot's
    history (per-slot last position, right-padded to a power-of-two width),
    then ``k-1`` one-token greedy ``decode`` steps. Both run into ONE draft
    cache per ``(num_slots, capacity)`` signature, kept and overwritten in
    place (the JAX drafter seeds a fresh cache each step): the prefill
    rewrites each row from position 0 and the rows' lengths mask the
    padding's and earlier steps' leftovers, so nothing stale is read, and a
    draft engine built with ``enable_cuda_graph`` replays one captured
    decode step instead of capturing one per call. On the card each step
    runs the flash forward (the prefill) and the decode kernel. The
    prefill is O(history) a step, worth it only when the draft model is
    much smaller than the target; for repetitive traffic prefer
    :class:`NGramDrafter`.

    Proposals are greedy, i.e. deterministic given the context, so the
    verifier's point-mass rejection sampling stays lossless for
    ``do_sample`` too.
    """

    name = "model"

    def __init__(self, engine):
        self.engine = engine
        self._caches: Dict[tuple, Dict[str, torch.Tensor]] = {}

    def _cache(self, batch: int, spec) -> Dict[str, torch.Tensor]:
        key = (batch, spec)
        if key not in self._caches:
            self._caches[key] = spec.stacked_cache(batch, self.engine.device)
        return self._caches[key]

    @torch.no_grad()
    def propose(self, histories, k):
        eng = self.engine
        spec = eng.kv_cache_spec()
        if spec is None:
            raise ValueError("SmallModelDrafter requires the draft module "
                             "to declare kv_cache_spec()")
        cap = int(spec.max_seq_len)
        B = len(histories)
        # keep the most recent window that still leaves room for k draft
        # positions; truncation only shifts the absolute positions the
        # draft model sees (draft quality, never correctness)
        keep = max(cap - k - 1, 1)
        rows = [None if h is None else np.asarray(h, np.int32)[-keep:]
                for h in histories]
        lens = np.array([0 if r is None else len(r) for r in rows], np.int64)
        W = bucket_width(max(int(lens.max()), 1), cap)
        ids = np.zeros((B, W), np.int64)
        for i, r in enumerate(rows):
            if r is not None:
                ids[i, :len(r)] = r
        last_pos = np.maximum(lens - 1, 0)
        cache = self._cache(B, spec)
        logits, _ = eng.prefill_at(torch.as_tensor(ids, device=eng.device),
                                   last_pos, cache=cache)
        cur = logits[:, -1].float().argmax(dim=-1)
        toks = [cur]
        pos = torch.as_tensor(lens, device=eng.device)
        for _ in range(k - 1):
            logits = eng.decode(cache, cur[:, None], pos)
            cur = logits[:, -1].float().argmax(dim=-1)
            toks.append(cur)
            pos = pos + 1
        tokens = torch.stack(toks, dim=1).cpu().numpy().astype(np.int32)
        counts = np.where(lens > 0, k, 0).astype(np.int32)
        return tokens, counts
