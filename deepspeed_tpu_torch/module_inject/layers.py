"""Tensor-parallel layers: what GSPMD does for a sharded placement in the
JAX package, written out for one rank of a model group (the reference
DeepSpeed's ``LinearLayer`` / ``LinearAllreduce`` idiom).

* a column-parallel projection is a plain ``nn.Linear`` over a slice of
  the output features (and its bias slice) behind ``copy_to_group`` (in
  the attention and MLP modules, once for all the projections that read
  one input): it communicates nothing forward, so it needs no class of
  its own;
* :class:`RowParallelLinear` holds a slice of the input features, sums the
  partial products over the group (``reduce_from_group``: one
  ``all_reduce`` forward, none backward), then adds the whole bias once,
  after the sum;
* :class:`VocabParallelEmbedding` holds a block of vocabulary rows: an id
  outside the block gives a zero row, and ``reduce_from_group`` sums the
  group's rows (exactly: every position has one nonzero term);
* :class:`VocabParallelHead` projects its input (behind
  ``copy_to_group``) onto this rank's block of the vocabulary, in fp32 as
  ``TransformerLM._project_head`` does, and gathers the whole vocabulary
  on every rank (``gather_from_group``: one ``all_gather_into_tensor``
  forward, this rank's slice of the gradient backward); a tied head reads
  the embedding's block.

An ``int8_weights`` model's projections are ``QuantDense`` layers (an
int8 weight (N, K) and an fp32 scale per output channel): a
column-parallel one is a plain ``QuantDense`` over the output channels'
slice of the weight, the scales and the bias;
:class:`RowParallelQuantDense` holds the input features' slice of the
weight and the whole scale vector, each rank's ``int8_matmul`` output
(cast to the layer's dtype) is summed over the group, and the bias is
added once after the sum; :class:`VocabParallelQuantHead` is the
``int8_head`` head over a block of the vocabulary.

Every collective goes through the port's ``comm`` over the model group
(``parallel.mesh``'s ``model`` axis) and carries its gradient
(``mappings``). A group of one rank calls nothing, so these layers at one
rank compute what the plain ones do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quantization.linear import QuantDense
from ..parallel.mesh import MODEL_AXIS
from .mappings import (copy_to_group, gather_from_group, reduce_from_group,
                       sum_grad_over_group)


class RowParallelLinear(nn.Linear):
    """A slice of a linear layer's input features; the output is the
    group's sum plus the whole bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 group: str = MODEL_AXIS, device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias,
                         device=device, dtype=dtype)
        self.group = group

    def forward(self, x):
        w = self.weight if self.weight.dtype == x.dtype \
            else self.weight.to(x.dtype)
        y = reduce_from_group(F.linear(x, w), self.group)
        if self.bias is None:
            return y
        return y + (self.bias if self.bias.dtype == y.dtype
                    else self.bias.to(y.dtype))


class RowParallelQuantDense(QuantDense):
    """A slice of an int8 projection's input features, its scales whole:
    the group's sum of the per-rank products, then the whole bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 group: str = MODEL_AXIS, dtype=torch.bfloat16,
                 kernel_mode: str = "auto", device=None):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype,
                         kernel_mode=kernel_mode, device=device)
        self.group = group

    def forward(self, x):
        y = reduce_from_group(self.product(x), self.group)
        return y if self.bias is None else y + self.bias


class VocabParallelQuantHead(QuantDense):
    """The ``int8_head`` vocabulary projection over a block of ``n``
    vocabulary rows: fp32 logits of this rank's block through the int8
    kernel, the group's blocks gathered along the last dimension."""

    def __init__(self, n: int, embed_dim: int, group: str = MODEL_AXIS,
                 kernel_mode: str = "auto", device=None):
        super().__init__(embed_dim, n, bias=False, dtype=torch.float32,
                         kernel_mode=kernel_mode, device=device)
        self.group = group

    def forward(self, x):
        part = self.product(copy_to_group(x, self.group)).float()
        return gather_from_group(part, self.group)


class SharedHeadsLinear(nn.Linear):
    """A column-parallel projection onto KV heads that other ranks of the
    group hold too (their query heads read the same KV head): rows
    ``span`` of the (``total``, in) projection. In training its weight's
    and bias's gradients are summed over the ranks that hold them
    (``sum_grad_over_group``), so every copy takes the same update."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 span, total: int, group: str = MODEL_AXIS, device=None,
                 dtype=None):
        super().__init__(in_features, out_features, bias=bias,
                         device=device, dtype=dtype)
        self.span, self.total, self.group = tuple(span), int(total), group

    def forward(self, x):
        if not torch.is_grad_enabled():
            return super().forward(x)
        w = sum_grad_over_group(self.weight, self.span, self.total,
                                self.group)
        b = None if self.bias is None else sum_grad_over_group(
            self.bias, self.span, self.total, self.group)
        return F.linear(x, w, b)


class VocabParallelEmbedding(nn.Embedding):
    """Vocabulary rows ``[lo, lo + num_embeddings)`` of an embedding."""

    def __init__(self, num_embeddings: int, embedding_dim: int, lo: int,
                 group: str = MODEL_AXIS, device=None, dtype=None):
        super().__init__(num_embeddings, embedding_dim, device=device,
                         dtype=dtype)
        self.lo, self.group = lo, group

    def forward(self, ids, dtype=None):
        """The group's rows of ``ids``, in ``dtype`` (default: the
        weight's)."""
        local = ids - self.lo
        outside = (local < 0) | (local >= self.num_embeddings)
        w = self.weight if dtype is None or dtype == self.weight.dtype \
            else self.weight.to(dtype)
        rows = F.embedding(local.masked_fill(outside, 0), w)
        rows = rows.masked_fill(outside[..., None], 0)
        return reduce_from_group(rows, self.group)


class VocabParallelHead(nn.Module):
    """The vocabulary projection over a block of ``n`` vocabulary rows:
    untied, its own ``weight`` (n, C) projected in fp32; tied (``tied``,
    the model's :class:`VocabParallelEmbedding`), the embedding's block
    projected in its dtype (flax ``Embed.attend``'s promotion), the logits
    in fp32. Either way the group's slices are gathered along the last
    dimension, so every rank holds the whole (..., V) logits."""

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

    def forward(self, x, dtype=None):
        """Whole (..., V) fp32 logits of ``x``; ``dtype`` (a tied head's
        default: the embedding's dtype, an untied head's: fp32) is the
        dtype the projection runs in."""
        x = copy_to_group(x, self.group)
        w = self.tied.weight if self.tied is not None else self.weight
        if dtype is None:
            dtype = w.dtype if self.tied is not None else torch.float32
        part = F.linear(x.to(dtype), w.to(dtype)).float()
        return gather_from_group(part, self.group)

    def local_weight(self) -> torch.Tensor:
        """This rank's (n, C) block of the vocabulary projection."""
        return self.tied.weight if self.tied is not None else self.weight
