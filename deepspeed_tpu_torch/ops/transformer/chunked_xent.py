"""Streaming (chunked) softmax cross-entropy over a large vocabulary: the
port of ``deepspeed_tpu/ops/transformer/chunked_xent.py``.

The loss tail of a language model is its largest activation: the (B, T, V)
logits and their log-softmax, at TinyLlama's B=4, T=2048, V=32000 about
1 GB each in fp32, and the backward holds as many again. This computes the
same masked cross-entropy without ever holding all of them: positions
stream through in chunks of ``chunk_size``; each chunk projects onto the
vocabulary, reduces to ``(logsumexp − target logit) · mask`` and is summed.
Each chunk body runs under non-reentrant ``torch.utils.checkpoint``, so the
backward recomputes that chunk's logits in turn, as ``jax.checkpoint`` on
the JAX chunk body does, and peak memory is O(B · chunk_size · V) in both
passes.

The per-position arithmetic is the dense path's: the projection runs in
``compute_dtype`` (the model's dtype for a tied head, fp32 for an untied
one) and the reductions in fp32; only the summation order differs. The JAX
function is a ``lax.scan`` over ``jnp.dot``s with no Pallas kernel, so this
port uses stock PyTorch operations.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["chunked_softmax_xent"]


def _chunk_nll_sum(w, xc, tc, mc, compute_dtype):
    logits = (xc.to(compute_dtype) @ w.t()).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, tc[..., None])[..., 0]
    return ((lse - tgt) * mc).sum()


def chunked_softmax_xent(x, w, targets, mask, chunk_size: int,
                         compute_dtype=torch.float32):
    """Masked cross-entropy summed over positions, streaming over T.

    ``x`` (B, T, C) final hidden states; ``w`` (V, C) the projection (the
    tied embedding table or the untied head's ``weight``); ``targets``
    (B, T) integer ids, already shifted; ``mask`` (B, T) float, 0 where a
    position is ignored; ``chunk_size`` positions a chunk (clamped to T; T
    is padded up to a multiple of it with masked positions). Returns the
    SUM of the masked per-position losses (fp32 scalar); the caller divides
    by the mask's sum for the mean."""
    B, T, C = x.shape
    chunk_size = min(int(chunk_size), T)
    pad = (-T) % chunk_size
    targets = targets.long()
    mask = mask.float()
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    # one cast of the table for every chunk (a no-op when it is in
    # compute_dtype already)
    w = w.to(compute_dtype)
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, T + pad, chunk_size):
        hi = lo + chunk_size
        loss = loss + checkpoint(_chunk_nll_sum, w, x[:, lo:hi],
                                 targets[:, lo:hi], mask[:, lo:hi],
                                 compute_dtype, use_reentrant=False)
    return loss
