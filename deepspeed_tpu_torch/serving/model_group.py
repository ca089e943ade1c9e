"""A server above one rank of a model group: one clock for the group and
the contiguous pool's slots over the data ranks.

Over an engine whose model group has more than one rank, every rank of the
world runs its own :class:`~.engine.ServingEngine` over its shard, fed the
same submissions in the same order, and every decision must come out the
same on every rank: a branch taken on a rank-local value would part the
ranks, and the next collective would hang.

:class:`GroupClock` makes the server's clock one clock: every reading is
rank 0's, gathered over the world at the read, whatever clock each rank
was built with (``time.perf_counter`` or ``clock=``). The server reads its
clock in program order, and the ranks run the same program, so the reads
meet; deadline stamps, queue expiry, the wall budget, degradation windows,
SLO latencies and priority buckets then decide alike on every rank. Each
read carries the place in the code it was made at, so a read that one rank
makes where the others do not meets a read made elsewhere and raises
:class:`RankDivergenceError` on every rank, instead of pairing silently.
A read made by one rank alone on purpose (a front end's ``/metrics`` on
rank 0) takes the rank's own reading inside :func:`local_reads`.

:class:`DataShardedRows` runs the contiguous pool's forwards over a
``(data, model)`` mesh: data rank ``d`` holds slots ``[d·S/D, (d+1)·S/D)``
of the ``S`` slots (the JAX ``STACKED_CACHE_AXES``: ``slots`` over
``data``; :func:`slot_rows`), runs the prefill, chunk, decode and verify
forwards for those slots only, on its model group, and the step's fp32
logits are assembled
over the data group: a decode step's blocks all-gathered, an admission's
rows summed with zeros where another data rank owns the row (exact: every
row has one nonzero term). Every rank then samples the whole batch from
the same logits with the same generator, so the tokens, finished flags and
the numerics guard's rows are the same on every rank, and equal those of a
server over one data rank, sampled or greedy. The paged pool keeps its
pages whole on every data rank (the JAX ``("pages", None)``) and every data
rank computes every slot, so no page write has to travel.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import zlib
from typing import Callable, Sequence

import numpy as np
import torch

from .. import comm
from ..parallel.mesh import DATA_AXIS
from ..utils.logging import log_dist


_reads = threading.local()


@contextlib.contextmanager
def local_reads():
    """Every :class:`GroupClock` read on this thread inside the block is
    the rank's own reading, with no collective: reads that one rank makes
    alone."""
    prev = getattr(_reads, "local", False)
    _reads.local = True
    try:
        yield
    finally:
        _reads.local = prev


class RankDivergenceError(RuntimeError):
    """The ranks of a model group disagreed on a step's decisions."""


class GroupClock:
    """Rank 0's reading of ``clock``, on every rank of the world (module
    docstring). ``reads`` counts the reads that went over the world."""

    def __init__(self, clock: Callable[[], float]):
        self.clock = clock
        self.reads = 0

    def __call__(self) -> float:
        t = float(self.clock())
        if getattr(_reads, "local", False):
            return t
        self.reads += 1
        # the read's place: caller's file, function and line, the same
        # string on every rank of one checkout
        f = sys._getframe(1)
        site = (f"{os.path.basename(f.f_code.co_filename)}:"
                f"{f.f_code.co_name}:{f.f_lineno}")
        seen = comm.all_gather_host(np.array(
            [t, zlib.crc32(site.encode())], np.float64)).reshape(-1, 2)
        if (seen[:, 1] != seen[0, 1]).any():
            raise RankDivergenceError(
                f"the ranks read the server's clock at different places: "
                f"rank {comm.get_rank()} at {site} (read {self.reads}), "
                f"another rank elsewhere; a read one rank makes alone "
                f"belongs inside model_group.local_reads()")
        return float(seen[0, 0])


def group_size(srv) -> int:
    """The ranks a server (or a router's replicas) runs in lockstep over:
    the world above one model rank, else 1."""
    reps = getattr(srv, "replicas", None)
    server = reps[0] if reps else srv
    return comm.get_world_size() if getattr(server, "_group", False) else 1


def slot_rows(engine, num_slots: int, paged: bool) -> tuple:
    """Where a server's slots live over the data ranks: ``(shard, rows)``,
    the ``[lo, hi)`` block of slots whose K/V rows this rank's pool holds
    and the object that runs the pool's forwards. The contiguous pool is
    split when the data ranks divide ``num_slots`` (rows: a
    :class:`DataShardedRows`); the paged pool, or slots the data ranks do
    not divide, stay whole on every data rank (the JAX resolver replicates
    an indivisible dimension), run by the engine itself."""
    D = int(getattr(engine, "dp_world_size", 1))
    if paged and D > 1:
        log_dist(f"paged server over {D} data ranks: the pages and slots "
                 f"stay whole on every data rank, so each data rank "
                 f"computes every slot ({D}x the compute of one data rank, "
                 f"no throughput gain); the contiguous pool splits its "
                 f"slots over the data ranks", ranks=[0])
    if paged or D == 1 or num_slots % D:
        return (0, num_slots), engine
    k = num_slots // D
    shard = (engine.dp_rank * k, (engine.dp_rank + 1) * k)
    return shard, DataShardedRows(engine, *shard)


class DataShardedRows:
    """The contiguous pool's forwards for this data rank's slots
    ``[lo, hi)``, with each step's logits assembled over the data group
    (module docstring). ``engine`` is the rank's ``InferenceEngine``; the
    pool's cache holds ``hi - lo`` rows. The methods take the engine's
    arguments, rows and slots numbered over the whole pool."""

    def __init__(self, engine, lo: int, hi: int):
        self.engine = engine
        self.lo, self.hi = int(lo), int(hi)
        self.vocab = int(engine.module.config.vocab_size)

    def _mine(self, rows: Sequence[int]) -> np.ndarray:
        rows = np.asarray(rows, np.int64).reshape(-1)
        return np.flatnonzero((rows >= self.lo) & (rows < self.hi))

    def _assemble(self, n: int, keep: np.ndarray, logits):
        """(n, T, V) fp32: this rank's rows ``keep`` from ``logits``, the
        other rows from the data ranks that own them."""
        T = 1 if logits is None else logits.shape[1]
        out = torch.zeros((n, T, self.vocab), dtype=torch.float32,
                          device=self.engine.device)
        if logits is not None:
            out[torch.as_tensor(keep, device=out.device)] = logits.float()
        return comm.all_reduce(out, group=DATA_AXIS)

    def prefill_at(self, input_ids, last_pos, cache=None, rows=None):
        keep = self._mine(rows)
        logits = None
        if len(keep):
            idx = torch.as_tensor(keep, device=input_ids.device)
            logits, _ = self.engine.prefill_at(
                input_ids[idx], np.asarray(last_pos)[keep], cache=cache,
                rows=[int(r) - self.lo for r in np.asarray(rows)[keep]])
        return self._assemble(len(rows), keep, logits), cache

    def prefill_chunk(self, cache, input_ids, slot, start, last_idx):
        keep = self._mine([slot])
        logits = (self.engine.prefill_chunk(cache, input_ids, slot - self.lo,
                                            start, last_idx)
                  if len(keep) else None)
        return self._assemble(1, keep, logits)

    def _block(self, x):
        return x[self.lo:self.hi] if torch.is_tensor(x) and x.dim() else x

    def decode(self, cache, tokens, pos):
        """Every slot's decode: this rank's block, the others gathered."""
        logits = self.engine.decode(cache, self._block(tokens),
                                    self._block(pos))
        return comm.all_gather_into_tensor(logits.float().contiguous(),
                                           group=DATA_AXIS)

    def verify_k(self, cache, tokens, pos, draft, draft_len, generator,
                 temperature, greedy, top_k, top_p):
        """``InferenceEngine.verify_k`` with the forward over the data
        ranks' blocks: acceptance reads the assembled logits, so it draws
        from the generator as one rank over every slot does."""
        from ..inference.engine import _filter_logits
        from .spec_decode.verify import make_verify_fn

        verify = make_verify_fn(self.decode, _filter_logits)
        return verify(cache, tokens, pos, torch.as_tensor(draft),
                      torch.as_tensor(draft_len), generator, temperature,
                      greedy, top_k, top_p)
