"""Speculative decoding over the fixed-shape slot pool (port of
``deepspeed_tpu/serving/spec_decode/``).

Draft-verify decode (Leviathan et al. 2023; Chen et al. 2023): a cheap
drafter proposes up to K tokens per live slot, ONE fixed-shape verify
forward scores all ``(num_slots, K+1)`` positions against the target model,
and the longest draft prefix the target reproduces is accepted: up to K+1
tokens emitted per decode step, with greedy output identical to plain
decoding through the same forward (the corrected token at the first
mismatch IS the token plain decode would have produced). In bf16 the
one-row decode step computes the same logits with other kernels and
product shapes, so its tokens can part from these where two logits tie.

The serving engine's shape discipline holds: verify always runs at batch =
``num_slots`` and width ``K+1`` (dead and non-speculating slots ride along
with ``draft_len`` 0, a plain decode step for that row), and rejected draft
positions are rolled back through the per-slot length
(:meth:`~deepspeed_tpu_torch.serving.slot_pool.SlotPool.advance`) inside
the same cache tensors, never by a reshape. With ``enable_cuda_graph`` the
verify forward is one more captured step (``inference/decode_graph.py``)
and acceptance runs after its replay.

Pieces:

* :class:`~.config.SpecDecodeConfig`: the ``spec_decode`` block accepted by
  ``ServingEngine`` / ``init_serving``.
* :class:`~.drafter.Drafter`: the proposal interface;
  :class:`~.drafter.NGramDrafter` (prompt lookup: suffix-match the slot's
  own history, no model) and :class:`~.drafter.SmallModelDrafter` (a second
  ``InferenceEngine`` sharing the tokenizer).
* :mod:`~.verify`: the verification and acceptance function behind
  ``InferenceEngine.verify_k`` and ``PagedKVPool.run_verify`` (greedy
  accept-prefix, rejection-sampling accept for ``do_sample``).
"""

from .config import SpecDecodeConfig, make_drafter  # noqa: F401
from .drafter import (Drafter, NGramDrafter,  # noqa: F401
                      SmallModelDrafter)
from .verify import make_verify_fn  # noqa: F401

__all__ = ["SpecDecodeConfig", "make_drafter", "Drafter", "NGramDrafter",
           "SmallModelDrafter", "make_verify_fn"]
