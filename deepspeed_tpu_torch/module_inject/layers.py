"""Tensor-parallel layers: what GSPMD does for a sharded placement in the
JAX package, written out for one rank of a model group (the reference
DeepSpeed's ``LinearLayer`` / ``LinearAllreduce`` idiom).

* a column-parallel projection is a plain ``nn.Linear`` over a slice of
  the output features (and its bias slice): it communicates nothing, so it
  needs no class of its own;
* :class:`RowParallelLinear` holds a slice of the input features, sums the
  partial products over the group with one ``all_reduce``, then adds the
  whole bias once, after the sum;
* :class:`VocabParallelEmbedding` holds a block of vocabulary rows: an id
  outside the block gives a zero row, and one ``all_reduce`` sums the
  group's rows (exactly: every position has one nonzero term);
* :class:`VocabParallelHead` projects onto this rank's block of the
  vocabulary, in fp32 as ``TransformerLM._project_head`` does, and
  gathers the whole vocabulary on every rank with one
  ``all_gather_into_tensor``; a tied head reads the embedding's block.

Every collective goes through the port's ``comm`` over the model group
(``parallel.mesh``'s ``model`` axis). A group of one rank calls nothing,
so these layers at one rank compute what the plain ones do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import comm
from ..parallel.mesh import MODEL_AXIS


class RowParallelLinear(nn.Linear):
    """A slice of a linear layer's input features; the output is the
    group's sum plus the whole bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 group: str = MODEL_AXIS, device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias,
                         device=device, dtype=dtype)
        self.group = group

    def forward(self, x):
        y = comm.all_reduce(F.linear(x, self.weight), group=self.group)
        return y if self.bias is None else y + self.bias


class VocabParallelEmbedding(nn.Embedding):
    """Vocabulary rows ``[lo, lo + num_embeddings)`` of an embedding."""

    def __init__(self, num_embeddings: int, embedding_dim: int, lo: int,
                 group: str = MODEL_AXIS, device=None, dtype=None):
        super().__init__(num_embeddings, embedding_dim, device=device,
                         dtype=dtype)
        self.lo, self.group = lo, group

    def forward(self, ids):
        local = ids - self.lo
        outside = (local < 0) | (local >= self.num_embeddings)
        rows = F.embedding(local.masked_fill(outside, 0), self.weight)
        rows = rows.masked_fill(outside[..., None], 0)
        return comm.all_reduce(rows, group=self.group)


class VocabParallelHead(nn.Module):
    """The vocabulary projection over a block of ``n`` vocabulary rows:
    untied, its own ``weight`` (n, C) projected in fp32; tied (``tied``,
    the model's :class:`VocabParallelEmbedding`), the embedding's block
    projected in its dtype (flax ``Embed.attend``'s promotion), the logits
    in fp32. Either way the group's slices are gathered along the last
    dimension, so every rank holds the whole (..., V) logits."""

    vocab_parallel = True

    def __init__(self, n: int, embed_dim: int,
                 tied: Optional[VocabParallelEmbedding] = None,
                 group: str = MODEL_AXIS, device=None, dtype=None):
        super().__init__()
        self.group = group
        # the tied embedding is the model's own submodule: kept out of this
        # module's registry, so the state dict names its weight once
        self.__dict__["tied"] = tied
        if tied is None:
            self.weight = nn.Parameter(torch.empty(n, embed_dim,
                                                   device=device,
                                                   dtype=dtype))

    def forward(self, x):
        if self.tied is not None:
            w = self.tied.weight
            part = F.linear(x.to(w.dtype), w).float()
        else:
            part = F.linear(x.float(), self.weight.float())
        return comm.all_gather_into_tensor(part.contiguous(),
                                           group=self.group,
                                           axis=part.dim() - 1)
