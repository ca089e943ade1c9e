"""The verification and acceptance function (port of
``deepspeed_tpu/serving/spec_decode/verify.py``).

One fixed-shape forward scores the current token plus K draft positions
for ALL ``num_slots`` rows (``(B, K+1)`` tokens at per-slot cache offsets),
then acceptance runs on its logits:

* **greedy**: accept the longest draft prefix whose tokens equal the target
  model's own argmax continuations; the token at the first mismatch is the
  argmax the target would have produced anyway, so the emitted output is
  identical to plain decoding.
* **do_sample**: rejection sampling (Leviathan et al. 2023, section 2.3).
  Both drafters are deterministic given the context, so the draft
  distribution q is a point mass and ``min(1, p/q)`` reduces to ``p(d_j)``
  under the serving sampler's filtered distribution; at the first rejection
  the replacement is drawn from the residual (p with the rejected token
  removed, renormalized), which keeps the output distribution exactly the
  target model's. Draws come from the caller's ``torch.Generator``
  (``torch.rand`` for the accept tests, ``torch.multinomial`` over the
  residual); the JAX RNG stream is not reproduced.

The JAX package compiles forward and acceptance into one program. Here the
forward is the engine's (a captured CUDA graph with ``enable_cuda_graph``)
and :func:`accept` runs after it on the logits, as sampling runs after a
replayed decode step: one graph serves greedy and sampled verify and no
generator state is captured. Nothing here reads a tensor on the host.

The cache comes back with all K+1 positions written for every row (dead
and prefilling rows included; a position past the allocation is dropped).
Rolling back the rejected positions is the caller's per-slot length update
(:meth:`~deepspeed_tpu_torch.serving.slot_pool.SlotPool.advance`): what
lies past a slot's length is masked and overwritten by its next write.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


@torch.no_grad()
def accept(logits, draft, draft_len, generator, temperature, greedy: bool,
           top_k: int, top_p: float, filter_fn):
    """Acceptance over a verify forward's ``logits`` (B, K+1, V).

    ``draft`` (B, K) and ``draft_len`` (B,) in [0, K] (0: plain decode for
    that row) are integer tensors on the logits' device; ``filter_fn`` is
    the serving sampler's ``(logits, temperature, top_k, top_p)`` filter,
    so acceptance probabilities match the distribution plain decode would
    have sampled from. Returns ``(out (B, K+1) long, n_emit (B,) long)``:
    row ``i`` emits ``out[i, :n_emit[i]]``, the accepted draft prefix plus
    the bonus or correction token (``n_emit >= 1``)."""
    last = logits.float()
    B, T, V = last.shape
    K = T - 1
    dev = last.device
    draft = draft.to(dev).long()
    draft_len = draft_len.to(dev).long()
    in_draft = torch.arange(K, device=dev)[None] < draft_len[:, None]
    if greedy:
        targets = last.argmax(dim=-1)                       # (B, K+1)
        accepted = (draft == targets[:, :K]) & in_draft
    else:
        filt = filter_fn(last, temperature, top_k, top_p)
        p_draft = torch.softmax(filt[:, :K], dim=-1).gather(
            -1, draft[..., None])[..., 0]
        u = torch.rand((B, K), generator=generator, device=dev)
        accepted = (u < p_draft) & in_draft
    n_acc = accepted.long().cumprod(dim=1).sum(dim=1)       # (B,) in [0, K]
    if greedy:
        bonus = targets.gather(1, n_acc[:, None])[:, 0]
    else:
        # the residual at position n_acc: p with the rejected draft token
        # removed when the stop was a rejection (not the draft's end)
        at = filt.gather(1, n_acc[:, None, None].expand(B, 1, V))[:, 0]
        rejected = draft.gather(1, n_acc.clamp(max=K - 1)[:, None])
        drop = (torch.arange(V, device=dev)[None] == rejected) \
            & (n_acc < draft_len)[:, None]
        residual = torch.where(drop, torch.full_like(at, -1e30), at)
        bonus = torch.multinomial(torch.softmax(residual, dim=-1), 1,
                                  generator=generator)[:, 0]
    j = torch.arange(K + 1, device=dev)[None]
    out = torch.where(j < n_acc[:, None], F.pad(draft, (0, 1)),
                      torch.where(j == n_acc[:, None], bonus[:, None],
                                  torch.zeros_like(j)))
    return out, n_acc + 1


def make_verify_fn(decode_fn, filter_fn):
    """The verify body over a forward ``decode_fn(cache, tokens, pos) ->
    (B, K+1, V) logits`` (writing the cache in place) and the sampling
    ``filter_fn``: ``verify(cache, tokens, pos, draft, draft_len, generator,
    temperature, greedy, top_k, top_p) -> (out, n_emit)``.

    ``tokens`` (B, K+1): [current token, draft_0 .. draft_{K-1}] per row;
    ``pos`` (B,): per-slot cache offsets; see :func:`accept` for the
    rest."""

    def verify(cache, tokens, pos, draft, draft_len, generator,
               temperature, greedy, top_k, top_p):
        logits = decode_fn(cache, tokens, pos)
        return accept(logits, draft, draft_len, generator, temperature,
                      greedy, top_k, top_p, filter_fn)

    return verify
