"""Model adapters for the layer-streamed parameter-offload training path
(the port of ``deepspeed_tpu/runtime/zero/stream_adapters.py``).

The runner (``param_offload.py``) streams a model's blocks through the card
one layer at a time and keeps the rest (embeddings, final norm, head)
resident. An adapter says how, over the port's ``nn.Module``s, whose blocks
are a ``ModuleList`` (``blocks.<i>.<name>``):

* ``embed(batch)`` -> (x, ctx): the resident computation before the
  blocks, with its autograd graph (ctx: what every block needs besides x,
  e.g. the positions);
* ``block_apply(weights, x, ctx, seed)``: one layer, by
  ``torch.func.functional_call`` on a block built on the ``meta`` device
  over a layer's weights (views of its buffer on the card); ``seed`` (None:
  no dropout) seeds the block's dropout masks, so the recompute in the
  backward draws the forward's masks;
* ``head_loss(xL, batch)``: the final norm and the DENSE shifted
  cross-entropy, as the JAX adapter computes it: a tied head in the compute
  dtype, an untied head in fp32 (the model's own dense loss).

Supported: ``TransformerLM`` (every preset; not the int8 weight tier) and
``GPT2LMHeadModel``. The JAX package's MoE adapter waits for the MoE models'
port; :func:`make_adapter` raises for any other module.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch.func import functional_call

BLOCKS = "blocks."


class StreamedModelAdapter:
    """The protocol (module docstring) and what every adapter shares."""

    def __init__(self, module, compute_dtype: torch.dtype, block):
        self.module = module
        self.cfg = module.config
        self.n_layer = self.cfg.n_layer
        self.dropout = self.cfg.dropout
        self.compute_dtype = compute_dtype
        self.block = block          # on the meta device
        self.leaf_names: List[str] = [n for n, _ in
                                      block.named_parameters()]

    def layer_keys(self, i: int) -> List[str]:
        """Layer ``i``'s parameter names in the module."""
        return [f"{BLOCKS}{i}.{n}" for n in self.leaf_names]

    def block_apply(self, weights: Dict[str, torch.Tensor], x, ctx,
                    seed: Optional[int]):
        raise NotImplementedError

    def embed(self, batch):
        raise NotImplementedError

    def head_loss(self, xL, batch):
        raise NotImplementedError

    def _ids(self, batch):
        return torch.as_tensor(batch["input_ids"],
                               device=self.module.device).long()


class TransformerLMAdapter(StreamedModelAdapter):
    """``models.transformer_lm.TransformerLM``."""

    def __init__(self, module, compute_dtype: torch.dtype):
        from ...models.transformer_lm import TransformerBlock

        if module.config.int8_weights:
            raise ValueError("offload_param streaming does not train the "
                             "int8 weight tier")
        cfg = dataclasses.replace(module.config, dtype=compute_dtype)
        super().__init__(module, compute_dtype,
                         TransformerBlock(cfg, dtype=compute_dtype,
                                          device="meta"))

    def embed(self, batch):
        m = self.module
        ids = self._ids(batch)
        positions = m._positions(*ids.shape)
        return m._embed(ids, positions), positions

    def block_apply(self, weights, x, ctx, seed):
        block = self.block
        if self.cfg.pos_emb == "alibi" and block.attn.alibi.is_meta:
            from ...models.transformer_lm import alibi_slopes

            block.attn.alibi = alibi_slopes(self.cfg.n_head).to(x.device)
        return functional_call(block, weights, (x, ctx), {"seed": seed})

    def head_loss(self, xL, batch):
        m = self.module
        return m.loss_from_hidden(m.ln_f(xL), batch, chunk=0)


class GPT2Adapter(StreamedModelAdapter):
    """``models.gpt2.GPT2LMHeadModel`` (the tied head in ``dtype``)."""

    def __init__(self, module, compute_dtype: torch.dtype):
        from ...models.gpt2 import Block

        cfg = dataclasses.replace(module.config, dtype=compute_dtype)
        super().__init__(module, compute_dtype,
                         Block(cfg, dtype=compute_dtype, device="meta"))

    def embed(self, batch):
        return self.module.embed(self._ids(batch)), None

    def block_apply(self, weights, x, ctx, seed):
        return functional_call(self.block, weights, (x,), {"seed": seed})

    def head_loss(self, xL, batch):
        m = self.module
        return m.loss_from_hidden(m.final_norm(xL), batch, chunk=0)


def make_adapter(module, compute_dtype: torch.dtype) -> StreamedModelAdapter:
    """The adapter for ``module``; raises ``ValueError`` naming the
    supported families for anything else."""
    from ...models.gpt2 import GPT2LMHeadModel
    from ...models.transformer_lm import TransformerLM

    if isinstance(module, TransformerLM):
        return TransformerLMAdapter(module, compute_dtype)
    if isinstance(module, GPT2LMHeadModel):
        return GPT2Adapter(module, compute_dtype)
    raise ValueError(
        "offload_param streaming supports TransformerLM and "
        f"GPT2LMHeadModel modules (got {type(module).__name__}); the MoE "
        "adapter waits for the MoE models' port")
