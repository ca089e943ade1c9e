"""Decoder-only transformer covering the JAX package's model families, as
PyTorch modules (port of ``deepspeed_tpu/models/transformer_lm.py``).

Every family is a point in the same feature space as in the JAX package:
position encoding (learned | rotary | alibi | none) x norm (layernorm |
rmsnorm) x activation (gelu | relu | swiglu) x residual topology x GQA, with
the same presets (``FAMILY_PRESETS``) and the same config field names, so a
JAX ``TransformerConfig`` carries over field by field.

Parameters are created in ``config.dtype`` and every activation stays in it,
as the flax modules compute (flax promotes parameters to ``dtype``). Two
numerics points follow the JAX package exactly: a tied head projects in
``dtype`` (flax ``Embed.attend`` promotes both operands to it), an untied
``lm_head`` projects in fp32; and ``gelu`` is the tanh approximation.

KV cache: per-layer K/V live in one stacked tensor per side,
``(L, B, KV, S, D)`` in the compute dtype, positions-major. The JAX package
stores positions-minor ``(L, B, KV, D, S)`` for TPU lane tiling; the CUDA
decode kernel reads contiguous rows instead. The paged pool
(``KVCacheSpec.paged_cache``) is ``(L, P, KV, page_size, D)`` on the same
principle. With ``kv_cache_quant`` the K/V leaves are int8 and two more,
``k_scale``/``v_scale`` (the same shapes without D, fp32), hold one scale
per cached row (``quantize_kv_rows``); every write quantizes the rows it
stores, attention folds the scales into its scores and probabilities, and
fresh prefill attention still reads the full-precision K/V, as in the JAX
package. Caches are updated IN PLACE (``prefill`` writes the prompt rows
it is given, ``decode``/``prefill_chunk`` the step's positions of each
sequence, ``decode_paged`` the step's positions through the page table);
the JAX package returns new arrays instead.

Attention takes the three CUDA kernels on CUDA tensors: the fresh causal
forward (training-style ``logits`` and ``prefill``) goes through
``ops.attention.flash_attention`` for T > 1 without ALiBi, the T=1 cached
decode through ``ops.attention.decode_attention``, and ``decode_paged``
through ``ops.attention.paged_attention``. Multi-token decode against the
cache (``prefill_chunk``) is the window-masked einsum, which has no kernel
in the JAX package either. On CPU tensors every wrapper takes its plain
version.

Int8 weights (``int8_weights``): every projection is a ``QuantDense``
(int8 weight, fp32 scale per output channel) running the CUDA
``int8_matmul`` kernel; the vocabulary head stays full precision unless
``int8_head``.

Training: ``forward(batch, deterministic=False)`` (``CausalLMTraining``,
shared with GPT-2) is the JAX ``TransformerLM.__call__``, the engine's
model convention: the causal shift, ``mask = targets >= 0`` and the mean
cross-entropy over the kept positions, dense (the head's logits, then ``log_softmax``) or, with
``loss_chunk > 0``, streamed through ``ops.transformer.
chunked_softmax_xent`` (a tied head in ``dtype``, an untied one in fp32,
as the JAX head computes). ``hidden`` runs the blocks with gradients:
``remat=True`` checkpoints each block whole (non-reentrant
``torch.utils.checkpoint``, the JAX ``nn.remat`` of the block), and
``dropout > 0`` drops attention probabilities and the MLP's output, masks
drawn from a ``torch.Generator`` seeded per block and forward (from
``dropout_generator``), so a recomputed block draws the same masks. The
fresh attention takes the flash kernel under the JAX ``_use_flash`` rule
(not with ALiBi, nor with dropout in training), K/V at their own
``n_kv_head`` heads: the kernels map grouped heads and the dk/dv kernel sums
each group, so nothing is repeated on the card. ``logits`` is the same
fresh forward without gradients; the cached serving methods run the blocks
through ``_transform``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention.decode_attention import (alibi_slopes,
                                              decode_attention,
                                              decode_attention_reference,
                                              quantize_kv_rows,
                                              window_attention_reference)
from ..ops.attention.flash_attention import NEG_INF, flash_attention
from ..ops.attention.paged_attention import (page_writes,
                                             paged_decode_attention)
from ..ops.quantization.linear import QuantDense
from ..ops.transformer.chunked_xent import chunked_softmax_xent
from ..module_inject.mappings import copy_to_group, model_parallel_generator

__all__ = ["TransformerConfig", "FAMILY_PRESETS", "transformer_config",
           "transformer_logical_axes", "transformer_sharding_rules",
           "apply_rotary", "alibi_slopes", "CachedAttention",
           "TransformerMLP", "TransformerBlock", "KVCacheSpec",
           "TransformerLM"]


def to_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a name ("bfloat16") or any
    numpy-compatible dtype object (a JAX config's ``jnp.float32``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name.replace("torch.", ""), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    max_seq_len: int = 2048
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_kv_head: Optional[int] = None     # < n_head => grouped-query attention
    pos_emb: str = "learned"            # learned | rotary | alibi | none
    rotary_pct: float = 1.0             # fraction of head_dim rotated (neox)
    rope_theta: float = 10000.0
    norm: str = "layernorm"             # layernorm | rmsnorm
    activation: str = "gelu"            # gelu | relu | swiglu
    mlp_ratio: float = 4.0
    parallel_residual: bool = False     # gptj/neox: x + attn(ln1 x) + mlp(ln2 x)
    qkv_bias: bool = True
    mlp_bias: bool = True
    embed_layernorm: bool = False       # bloom
    tie_word_embeddings: bool = True
    layer_norm_epsilon: float = 1e-5
    dropout: float = 0.0                # training only (module docstring)
    dtype: Any = torch.bfloat16
    # "auto" | "on" | True: the flash kernel for every fresh causal forward
    # with T > 1 and no ALiBi (no TPU-tuned length crossover on CUDA);
    # False | "off": the plain attention
    use_flash_attention: Any = "auto"
    remat: bool = False                 # training: checkpoint each block
    # "auto" | "on": the decode kernel for T=1 cached attention; "off": the
    # plain einsum math
    decode_kernel: str = "auto"
    # TPU block granule of the decode kernel; the CUDA kernel reads exactly
    # lengths[b] rows, so it has no granule and this is kept for config
    # compatibility only
    decode_block: Optional[int] = None
    # int8 K/V rows with an fp32 scale per row
    kv_cache_quant: bool = False
    # the TPU's int32 container for int8 rows (lossless packing for its
    # sublane tiling): the port keeps plain int8 rows; compatibility only
    kv_cache_packed: Optional[bool] = None
    int8_weights: bool = False          # projections as QuantDense
    # "auto" | "on": the int8_matmul kernel on CUDA tensors; "off": the
    # plain version (only with int8_weights)
    int8_kernel: str = "auto"
    int8_head: bool = False             # only with int8_weights
    loss_chunk: int = 0                 # > 0: the streaming training loss

    def __post_init__(self):
        object.__setattr__(self, "dtype", to_torch_dtype(self.dtype))

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head or self.n_head


FAMILY_PRESETS = {
    "gpt2": dict(pos_emb="learned", norm="layernorm", activation="gelu"),
    "gpt-neo": dict(pos_emb="learned", norm="layernorm", activation="gelu"),
    "gptj": dict(pos_emb="rotary", norm="layernorm", activation="gelu",
                 parallel_residual=True, tie_word_embeddings=False),
    "gpt-neox": dict(pos_emb="rotary", rotary_pct=0.25, norm="layernorm",
                     activation="gelu", parallel_residual=True,
                     tie_word_embeddings=False),
    "llama": dict(pos_emb="rotary", norm="rmsnorm", activation="swiglu",
                  qkv_bias=False, mlp_bias=False, tie_word_embeddings=False,
                  layer_norm_epsilon=1e-6),
    "opt": dict(pos_emb="learned", norm="layernorm", activation="relu"),
    "bloom": dict(pos_emb="alibi", norm="layernorm", activation="gelu",
                  embed_layernorm=True),
    "megatron-gpt": dict(pos_emb="learned", norm="layernorm",
                         activation="gelu"),
}


def transformer_config(family: str, **overrides) -> TransformerConfig:
    """A config from a family preset plus overrides."""
    if family not in FAMILY_PRESETS:
        raise ValueError(f"unknown family {family!r}; know "
                         f"{sorted(FAMILY_PRESETS)}")
    return TransformerConfig(**{**FAMILY_PRESETS[family], **overrides})


def transformer_logical_axes():
    """Logical axis names of the parameters, by JAX parameter path pattern
    (the JAX function): a block's leaf carries the leading ``layers`` dim
    of the scanned stack, ``heads`` is the fused heads * head_dim width and
    ``ffn`` the MLP's hidden width. ``checkpoint.flax_import.flax_paths``
    names the port's parameters by these paths."""
    return [
        (r"embed_tokens/embedding", ("vocab", "embed")),
        (r"embed_pos/embedding", ("positions", "embed")),
        (r"attn/(q_proj|k_proj|v_proj)/kernel", ("layers", "embed", "heads")),
        (r"attn/o_proj/kernel", ("layers", "heads", "embed")),
        (r"attn/(q_proj|k_proj|v_proj)/bias", ("layers", "heads")),
        (r"mlp/(up_proj|gate_proj)/kernel", ("layers", "embed", "ffn")),
        (r"mlp/(up_proj|gate_proj)/bias", ("layers", "ffn")),
        (r"mlp/down_proj/kernel", ("layers", "ffn", "embed")),
        (r"lm_head/kernel", ("embed", "vocab")),
    ]


def transformer_sharding_rules(rules=None):
    """Megatron-style tensor-parallel rules for these paths (the JAX
    function): :func:`transformer_logical_axes` resolved through the
    axis-rules table (``rules``, a ``LogicalAxisRules``; default the
    default table), as ``(pattern, mesh-axis entries)`` pairs: column-
    parallel q/k/v and up/gate projections, row-parallel o and down
    projections, the vocab-parallel embedding and head."""
    from ..parallel.axis_rules import default_axis_rules

    rules = rules if rules is not None else default_axis_rules()
    return [(pat, rules.spec_entries(axes))
            for pat, axes in transformer_logical_axes()]


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary(x, positions, *, rotary_dim: int, theta: float):
    """NeoX-style rotary embedding on the first ``rotary_dim`` channels,
    computed in fp32. x: (B, T, H, D); positions: (B, T)."""
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    inv_freq = 1.0 / (theta ** (torch.arange(0, rotary_dim, 2,
                                             dtype=torch.float32,
                                             device=x.device) / rotary_dim))
    angles = positions[..., None].float() * inv_freq        # (B, T, rd/2)
    angles = torch.cat([angles, angles], dim=-1)[:, :, None, :]
    rot32 = rot.float()
    out = rot32 * angles.cos() + _rotate_half(rot32) * angles.sin()
    return torch.cat([out.to(x.dtype), rest], dim=-1)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight, computed in fp32 (flax
    ``RMSNorm`` promotes to fp32 for the statistics)."""

    def __init__(self, dim: int, eps: float, dtype=None, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype,
                                              device=device))

    def forward(self, x):
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


def _norm(cfg: TransformerConfig, **fk) -> nn.Module:
    if cfg.norm == "rmsnorm":
        return RMSNorm(cfg.n_embd, cfg.layer_norm_epsilon, **fk)
    return nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon, **fk)


def _dense(cfg: TransformerConfig, in_features: int, out_features: int,
           bias: bool, **fk) -> nn.Module:
    """nn.Linear, or its int8-at-rest serving twin when ``cfg.int8_weights``
    (the JAX ``_dense``): a QuantDense whose int8 weights and fp32 scales
    the inference engine's int8 tier or the weight bridge fill in."""
    if cfg.int8_weights:
        return QuantDense(in_features, out_features, bias=bias,
                          kernel_mode=cfg.int8_kernel, **fk)
    return nn.Linear(in_features, out_features, bias=bias, **fk)


def _write_rows(kv: Dict[str, Any], idx, k_rows, v_rows,
                keep=None) -> None:
    """Store K/V rows (..., D) at ``buf[idx]`` in one layer's cache leaves;
    an int8 cache quantizes them per row and stores their scales at the same
    index of ``k_scale``/``v_scale``. With ``keep`` (a bool per row) a row
    it marks False writes back the value already at its index, so the
    cache is unchanged there (see :func:`_row_writes`)."""
    for side, rows in (("k", k_rows), ("v", v_rows)):
        buf = kv[side]
        if f"{side}_scale" in kv:
            rows, sc = quantize_kv_rows(rows)
            scales = kv[f"{side}_scale"]
            if keep is not None:
                sc = torch.where(keep[:, None], sc, scales[idx])
            scales[idx] = sc
        rows = rows.to(buf.dtype)
        if keep is not None:
            rows = torch.where(keep[:, None, None], rows, buf[idx])
        buf[idx] = rows


def _dropout(x, p: float, gen: Optional[torch.Generator]):
    """Inverted dropout of ``x`` at rate ``p`` with masks from ``gen``
    (None, or ``p`` 0: ``x`` unchanged)."""
    if gen is None or p == 0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


class CausalLMTraining:
    """The training half of ``GPT2LMHeadModel`` and ``TransformerLM``:
    per-forward dropout seeds and the engine's loss ``forward``. The model
    gives ``config`` (``n_layer``, ``dropout``, ``loss_chunk``),
    ``dropout_generator``, ``device``, ``hidden(ids, deterministic)``,
    ``_loss_head()`` (the (V, C) projection and its dtype for the streamed
    loss), ``_dense_logits(x)`` and ``_vocab_layer()`` (the module whose
    vocabulary a model group may split)."""

    def _loss_group(self):
        """The model group the vocabulary layer (``_vocab_layer()``) is
        split over, or None when it is whole: a vocab-parallel layer of
        ``module_inject.layers`` carries its ``group``, a plain one none."""
        return getattr(self._vocab_layer(), "group", None)

    def seed_dropout(self, seed: int) -> None:
        self.dropout_generator.manual_seed(seed)

    def _block_seeds(self, deterministic: bool):
        """One dropout seed a block for this forward (None: no dropout),
        so a recomputed block draws the same masks."""
        if deterministic or self.config.dropout == 0:
            return [None] * self.config.n_layer
        base = int(torch.randint(0, 2 ** 62, (1,),
                                 generator=self.dropout_generator))
        return [base + i for i in range(self.config.n_layer)]

    def forward(self, batch, deterministic: bool = False):
        """The mean next-token cross-entropy of ``batch`` = {"input_ids":
        (B, T) ints, optional "labels": (B, T), negative = ignored}
        (arrays or tensors; moved to the model's device)."""
        if self.config.loss_chunk:
            self._loss_head()       # refuses an int8 head before the blocks
        ids = torch.as_tensor(batch["input_ids"], device=self.device).long()
        return self.loss_from_hidden(self.hidden(ids, deterministic), batch)

    def loss_from_hidden(self, h, batch, chunk: Optional[int] = None):
        """The loss tail of :meth:`forward` over the final hidden states
        ``h`` (B, T, C), after the final norm: streamed when ``chunk``
        (default ``config.loss_chunk``) is set, else dense."""
        chunk = self.config.loss_chunk if chunk is None else chunk
        if chunk:
            w, cd = self._loss_head()
        ids = torch.as_tensor(batch["input_ids"], device=h.device).long()
        labels = batch.get("labels") if hasattr(batch, "get") else None
        labels = ids if labels is None else \
            torch.as_tensor(labels, device=h.device).long()
        targets = labels[:, 1:]
        mask = (targets >= 0).float()
        targets = targets.clamp(min=0)
        # causal shift: position t predicts token t+1 (the last position's
        # logits are never used, so they are not computed)
        x = h[:, :-1]
        if chunk:
            nll_sum = chunked_softmax_xent(x, w, targets, mask, chunk,
                                           compute_dtype=cd,
                                           group=self._loss_group())
        else:
            logp = F.log_softmax(self._dense_logits(x), dim=-1)
            nll = -logp.gather(-1, targets[..., None])[..., 0]
            nll_sum = (nll.float() * mask).sum()
        return nll_sum / mask.sum().clamp(min=1.0)


def _scales(kv: Dict[str, Any], sel=None) -> Dict[str, Any]:
    """An int8 cache's ``k_scale``/``v_scale`` keywords (rows ``sel`` of
    them when given); empty for a full-precision cache."""
    if "k_scale" not in kv:
        return {}
    return {name: kv[name] if sel is None else kv[name][sel]
            for name in ("k_scale", "v_scale")}


def _fresh_reference(q, k, v, slopes=None, dropout: float = 0.0, gen=None):
    """Plain causal attention over fresh q/k/v (B, T, H|KV, D) in fp32,
    with optional ALiBi ``slope·(kpos − qpos)`` and, with ``gen``, dropout
    of the probabilities: the JAX einsum path."""
    B, T, H, D = q.shape
    KV = k.shape[2]
    k32, v32 = k.float(), v.float()
    if KV != H:
        k32 = k32.repeat_interleave(H // KV, dim=2)
        v32 = v32.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k32) / math.sqrt(D)
    pos = torch.arange(T, device=q.device)
    if slopes is not None:
        s = s + slopes.to(q.device)[None, :, None, None] \
            * (pos[None, :] - pos[:, None]).float()[None, None]
    s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    p = _dropout(torch.softmax(s, dim=-1), dropout, gen)
    return torch.einsum("bhts,bshd->bthd", p, v32).to(q.dtype)


def _row_writes(positions, rows, S: int):
    """Cache writes of a multi-token step into contiguous rows: token t of
    row b goes to ``buf[rows[b], :, positions[b, t]]``, where ``positions
    [b]`` is ``start[b] + arange(T)`` (T <= S); positions past the
    allocation ``S`` are dropped, as the JAX scatter drops them. Returns
    ``(None, row ids, positions, keep)`` over the flattened (B*T) tokens,
    the ``write`` of :class:`CachedAttention`.

    A dropped token is written too, with the value already there
    (:func:`_write_rows`' ``keep``), at a position of its row that no kept
    token of this step writes: ``min(start[b], S) + t - T``, which lies
    before the row's first kept position. So no write is selected on the
    host, the forward never syncs with it and can be captured in a CUDA
    graph, and the cache ends as if the dropped tokens were never
    written."""
    B, T = positions.shape
    keep = positions < S
    back = positions[:, :1].clamp(max=S) - T \
        + torch.arange(T, device=positions.device)[None]
    target = torch.where(keep, positions, back.clamp(min=0))
    return (None, rows[:, None].expand(B, T).reshape(-1), target.reshape(-1),
            keep.reshape(-1))


class CachedAttention(nn.Module):
    """Multi-head / grouped-query attention with an optional KV cache.

    Modes: ``"fresh"`` (causal self-attention over the given tokens, no
    cache), ``"prefill"`` (fresh attention, and the tokens' K/V written to
    cache rows ``rows`` at positions [0, T)), ``"decode"`` (token t of row b
    written at position ``start[b] + t`` and attending positions ``<=
    start[b] + t``), ``"paged"`` (as decode, over one layer's page pool
    through the page ``table``).

    ``kv`` is one layer's cache leaves (``k``, ``v`` and, for an int8 cache,
    ``k_scale``, ``v_scale``). ``write`` is ``(sel, a, b, keep)`` from
    :func:`_row_writes` or ``page_writes``, computed once per forward for
    every layer: the flattened token rows ``sel`` that land in the cache
    (None: all), where (``buf[a, :, b]``), and ``keep`` (None, or the
    tokens whose rows are stored; the others write back what is there).

    ``heads`` and ``kv_heads`` are the query and KV heads this module
    computes: the config's, or under tensor parallelism this rank's share
    (``module_inject`` sets them with the projections it swaps in, and
    ``group``, the model group: the input then passes ``copy_to_group``,
    whose backward sums the input gradient over the group, and training's
    probability dropout draws its masks per rank, from a generator folded
    with the rank, so the heads of two ranks drop independently)."""

    def __init__(self, cfg: TransformerConfig, **fk):
        super().__init__()
        self.config = cfg
        H, KV, D, C = cfg.n_head, cfg.kv_heads, cfg.head_dim, cfg.n_embd
        self.heads, self.kv_heads = H, KV
        self.group = None
        self.q_proj = _dense(cfg, C, H * D, cfg.qkv_bias, **fk)
        self.k_proj = _dense(cfg, C, KV * D, cfg.qkv_bias, **fk)
        self.v_proj = _dense(cfg, C, KV * D, cfg.qkv_bias, **fk)
        self.o_proj = _dense(cfg, H * D, C, cfg.qkv_bias, **fk)
        if cfg.pos_emb == "alibi":
            # built once on the module's device, not per forward: a copy
            # from host memory cannot be captured in a CUDA graph; not
            # persistent, so the state dict and the weight bridge are
            # unchanged
            self.register_buffer("alibi", alibi_slopes(H).to(fk.get("device")),
                                 persistent=False)

    def _use_flash(self, T: int, deterministic: bool = True) -> bool:
        """The JAX rule without its TPU length crossover: ALiBi has no bias
        hook in the kernel and probability dropout no kernel twin, so both
        stay on the einsum path (forcing the kernel with them raises)."""
        cfg = self.config
        use = cfg.use_flash_attention
        if use is False or use == "off":
            return False
        alibi = cfg.pos_emb == "alibi"
        drop_ok = cfg.dropout == 0 or deterministic
        if use == "auto":
            return T > 1 and not alibi and drop_ok
        if alibi:
            raise ValueError("use_flash_attention=True does not compose with "
                             "pos_emb='alibi' (no bias hook in the kernel)")
        if not drop_ok:
            raise ValueError("use_flash_attention=True does not support "
                             "attention-probability dropout in train mode")
        return True

    def _attend_cache(self, q, kv, lengths, slopes):
        """One query row per sequence, (B, 1, H, D), over the first
        ``lengths[b]`` positions of cache row b: the decode kernel, or its
        plain version with ``decode_kernel="off"``."""
        if self.config.decode_kernel == "off":
            return decode_attention_reference(
                q[:, 0], kv["k"], kv["v"], lengths,
                1.0 / math.sqrt(q.shape[-1]), slopes, **_scales(kv))
        return decode_attention(q[:, 0].contiguous(), kv["k"], kv["v"],
                                lengths, alibi_slopes=slopes, **_scales(kv))

    def forward(self, x, positions, mode: str = "fresh", kv=None,
                rows=None, start=None, table=None, write=None, gen=None):
        """``gen`` (fresh mode, training): the block's dropout generator."""
        cfg = self.config
        B, T, _ = x.shape
        H, KV, D = self.heads, self.kv_heads, cfg.head_dim
        if self.group is not None:
            x = copy_to_group(x, self.group)
            gen = model_parallel_generator(gen, self.group)
        q = self.q_proj(x).view(B, T, H, D)
        k = self.k_proj(x).view(B, T, KV, D)
        v = self.v_proj(x).view(B, T, KV, D)
        if cfg.pos_emb == "rotary":
            rd = int(cfg.rotary_pct * D) // 2 * 2
            q = apply_rotary(q, positions, rotary_dim=rd, theta=cfg.rope_theta)
            k = apply_rotary(k, positions, rotary_dim=rd, theta=cfg.rope_theta)
        slopes = self.alibi.float() if cfg.pos_emb == "alibi" else None
        if mode == "prefill" and T == 1 and cfg.kv_cache_quant:
            # the JAX module attends a one-token prompt through its cache,
            # which for an int8 cache means the quantized row: write it, then
            # attend over the rows written (a subset of the cache's batch)
            _write_rows(kv, (rows, slice(None), 0), k[:, 0], v[:, 0])
            y = self._attend_cache(
                q, {key: leaf[rows] for key, leaf in kv.items()},
                torch.ones(B, dtype=torch.int32, device=x.device), slopes)
            return self.o_proj(y.to(x.dtype).reshape(B, 1, H * D))

        if mode == "paged" or (mode == "decode" and T > 1):
            sel, a, b, keep = write
            k_rows, v_rows = k.reshape(B * T, KV, D), v.reshape(B * T, KV, D)
            if sel is not None:
                k_rows, v_rows = k_rows[sel], v_rows[sel]
            _write_rows(kv, (a, slice(None), b), k_rows, v_rows, keep)
            if mode == "paged":
                sc = {f"{name}_pages": val
                      for name, val in _scales(kv).items()}
                y = paged_decode_attention(
                    q.contiguous(), kv["k"], kv["v"], table,
                    start.to(torch.int32), alibi_slopes=slopes, **sc)
            else:
                y = window_attention_reference(
                    q, kv["k"][rows], kv["v"][rows], start,
                    1.0 / math.sqrt(D), slopes, **_scales(kv, rows))
            return self.o_proj(y.to(x.dtype).reshape(B, T, H * D))

        if mode == "decode":
            _write_rows(kv, (rows, slice(None), start), k[:, 0], v[:, 0])
            y = self._attend_cache(q, kv, (start + 1).to(torch.int32), slopes)
            return self.o_proj(y.to(x.dtype).reshape(B, 1, H * D))

        if mode == "prefill":
            _write_rows(kv, (rows, slice(None), slice(0, T)),
                        k.transpose(1, 2), v.transpose(1, 2))
        if self._use_flash(T, deterministic=gen is None):
            y, _ = flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True)
        else:
            y = _fresh_reference(q, k, v, slopes, cfg.dropout, gen)
        return self.o_proj(y.to(x.dtype).reshape(B, T, H * D))


class TransformerMLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, **fk):
        super().__init__()
        self.config = cfg
        hidden = int(cfg.mlp_ratio * cfg.n_embd)
        if cfg.activation == "swiglu":
            self.gate_proj = _dense(cfg, cfg.n_embd, hidden, cfg.mlp_bias,
                                    **fk)
        self.up_proj = _dense(cfg, cfg.n_embd, hidden, cfg.mlp_bias, **fk)
        self.down_proj = _dense(cfg, hidden, cfg.n_embd, cfg.mlp_bias, **fk)
        # the model group when the hidden units are split (module_inject)
        self.group = None

    def forward(self, x, gen=None):
        act = self.config.activation
        if self.group is not None:
            x = copy_to_group(x, self.group)
        if act == "swiglu":
            h = F.silu(self.gate_proj(x)) * self.up_proj(x)
        elif act == "gelu":
            h = F.gelu(self.up_proj(x), approximate="tanh")
        else:
            h = F.relu(self.up_proj(x))
        return _dropout(self.down_proj(h), self.config.dropout, gen)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, **fk):
        super().__init__()
        self.config = cfg
        self.ln_1 = _norm(cfg, **fk)
        self.attn = CachedAttention(cfg, **fk)
        self.ln_2 = _norm(cfg, **fk)
        self.mlp = TransformerMLP(cfg, **fk)

    def forward(self, x, positions, mode="fresh", kv=None, rows=None,
                start=None, table=None, write=None, seed=None):
        """``seed`` (None: no dropout) seeds this block's dropout masks."""
        gen = None
        if seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(seed)
        a = self.attn(self.ln_1(x), positions, mode, kv, rows, start, table,
                      write, gen)
        if self.config.parallel_residual:
            return x + a + self.mlp(self.ln_2(x), gen)
        x = x + a
        return x + self.mlp(self.ln_2(x), gen)


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """The model's KV-cache contract: engines and the serving slot pool
    size and allocate caches through this."""

    n_layer: int
    kv_heads: int
    head_dim: int
    dtype: torch.dtype
    max_seq_len: int
    quant: bool = False     # int8 K/V rows + fp32 k_scale/v_scale leaves

    def _leaves(self, shape, device) -> Dict[str, Any]:
        if not self.quant:
            return {side: torch.zeros(shape, dtype=self.dtype, device=device)
                    for side in ("k", "v")}
        out = {side: torch.zeros(shape, dtype=torch.int8, device=device)
               for side in ("k", "v")}
        out.update({f"{side}_scale": torch.zeros(
            shape[:-1], dtype=torch.float32, device=device)
            for side in ("k", "v")})
        return out

    def stacked_cache(self, batch_size: int, device=None) -> Dict[str, Any]:
        """Zeroed layer-stacked k/v: (L, B, KV, S, D) each (int8 with
        (L, B, KV, S) fp32 scales when ``quant``)."""
        return self._leaves((self.n_layer, batch_size, self.kv_heads,
                             self.max_seq_len, self.head_dim), device)

    def paged_cache(self, num_pages: int, page_size: int,
                    device=None) -> Dict[str, Any]:
        """Zeroed page pool k/v: (L, P, KV, page_size, D) each, no batch
        axis (int8 with (L, P, KV, page_size) fp32 scale pages when
        ``quant``). A per-slot page table maps positions to pages;
        :meth:`dense_from_pages` reassembles the stacked layout."""
        return self._leaves((self.n_layer, num_pages, self.kv_heads,
                             page_size, self.head_dim), device)

    def dense_from_pages(self, paged: Dict[str, Any],
                         table) -> Dict[str, Any]:
        """The dense (L, B, KV, pages_per_slot * page_size, D) view of a
        page pool for a (B, pages_per_slot) table, as a new tensor per
        leaf (scales: (L, B, KV, pages_per_slot * page_size)). Unmapped
        entries (sentinel ``P``) are clipped to page ``P - 1``: only
        positions past a slot's length map there, and attention masks
        them."""
        B, max_pages = table.shape
        out = {}
        for key, leaf in paged.items():             # (L, P, KV, ps[, D])
            L, P, KV, ps = leaf.shape[:4]
            rest = leaf.shape[4:]
            ids = table.to(leaf.device).long().clamp(0, P - 1).reshape(-1)
            g = leaf[:, ids].reshape(L, B, max_pages, KV, ps, *rest)
            out[key] = g.transpose(2, 3).reshape(L, B, KV, max_pages * ps,
                                                 *rest)
        return out


class TransformerLM(CausalLMTraining, nn.Module):
    """Causal LM over any family preset: the training loss ``forward`` and
    ``hidden``; ``logits``, ``prefill``, ``prefill_last``,
    ``prefill_chunk``, ``decode`` and ``decode_paged`` (see the module
    docstring)."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        fk = dict(dtype=cfg.dtype, device=device)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.n_embd, **fk)
        if cfg.pos_emb == "learned":
            self.embed_pos = nn.Embedding(cfg.max_seq_len, cfg.n_embd, **fk)
        if cfg.embed_layernorm:
            self.embed_ln = _norm(cfg, **fk)
        self.blocks = nn.ModuleList(TransformerBlock(cfg, **fk)
                                    for _ in range(cfg.n_layer))
        self.ln_f = _norm(cfg, **fk)
        if cfg.int8_weights and cfg.int8_head and \
                not cfg.tie_word_embeddings:
            # fp32 logits from the int8 kernel, as the JAX head
            self.lm_head = QuantDense(cfg.n_embd, cfg.vocab_size, bias=False,
                                      dtype=torch.float32,
                                      kernel_mode=cfg.int8_kernel,
                                      device=device)
        elif not cfg.tie_word_embeddings:
            # full precision, the default of the int8 tier too
            self.lm_head = nn.Linear(cfg.n_embd, cfg.vocab_size, bias=False,
                                     **fk)
        self.dropout_generator = torch.Generator().manual_seed(0)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator,
                     std: float = 0.02) -> None:
        """Random weights from ``generator``: N(0, std) for every linear
        and embedding weight, zero biases, unit norm scales."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, RMSNorm)):
                mod.weight.fill_(1.0)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()

    def replace_config(self, **changes) -> TransformerConfig:
        """Give the model and every submodule ``dataclasses.replace(config,
        **changes)``, and every QuantDense the config's ``int8_kernel`` as
        its ``kernel_mode``: the config owns the kernel switches. Changes
        that alter parameter shapes are not supported. Returns the new
        config."""
        cfg = dataclasses.replace(self.config, **changes)
        for mod in self.modules():
            if isinstance(mod, QuantDense):
                mod.kernel_mode = cfg.int8_kernel
            elif hasattr(mod, "config"):
                mod.config = cfg
        return cfg

    def kv_cache_spec(self) -> KVCacheSpec:
        """The cache contract; under tensor parallelism its KV heads are
        this rank's share."""
        cfg = self.config
        kv = self.blocks[0].attn.kv_heads if len(self.blocks) \
            else cfg.kv_heads
        return KVCacheSpec(n_layer=cfg.n_layer, kv_heads=kv,
                           head_dim=cfg.head_dim, dtype=cfg.dtype,
                           max_seq_len=cfg.max_seq_len,
                           quant=cfg.kv_cache_quant)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def _embed(self, input_ids, positions):
        cfg = self.config
        x = self.embed_tokens(input_ids)
        if cfg.pos_emb == "learned":
            x = x + self.embed_pos(positions)
        if cfg.embed_layernorm:
            x = self.embed_ln(x)
        return x

    def hidden(self, input_ids, deterministic: bool = True):
        """Final hidden states (B, T, C) after ``ln_f``, with gradients,
        ``remat`` and dropout (the module docstring's training path)."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        B, T = ids.shape
        positions = self._positions(B, T)
        x = self._embed(ids, positions)
        remat = self.config.remat and torch.is_grad_enabled()
        for block, seed in zip(self.blocks, self._block_seeds(deterministic)):
            if remat:
                x = checkpoint(block, x, positions, seed=seed,
                               use_reentrant=False)
            else:
                x = block(x, positions, seed=seed)
        return self.ln_f(x)

    def _loss_head(self):
        """The streamed loss's projection: a tied head in ``dtype``, an
        untied one in fp32 (the JAX head's ``cd``); over a vocab-parallel
        head, this rank's block of it."""
        cfg = self.config
        if self._loss_group() is not None:
            return self.lm_head.local_weight(), \
                cfg.dtype if cfg.tie_word_embeddings else torch.float32
        if cfg.tie_word_embeddings:
            return self.embed_tokens.weight, cfg.dtype
        if cfg.int8_weights and cfg.int8_head:
            raise ValueError(
                "loss_chunk does not compose with an int8-quantized "
                "untied lm_head (QuantDense stores an int8 kernel + "
                "scale; the streaming loss reads a plain kernel). "
                "Serve int8 with the dense loss, keep the head fp32, "
                "or tie the embeddings.")
        return self.lm_head.weight, torch.float32

    def _transform(self, input_ids, positions, mode, cache, rows=None,
                   start=None, table=None, scratch_page=False):
        """The blocks against a cache: ``mode`` "prefill", "decode" or
        "paged" (the fresh forward is :meth:`hidden`)."""
        x = self._embed(input_ids, positions)
        write = None
        if mode == "paged":
            _, P, _, ps, _ = cache["k"].shape
            write = page_writes(positions, table, P - scratch_page, ps,
                                scratch=scratch_page) + (None,)
        elif mode == "decode" and input_ids.shape[1] > 1:
            write = _row_writes(positions, rows, cache["k"].shape[3])
        for li, block in enumerate(self.blocks):
            kv = {key: leaf[li] for key, leaf in cache.items()}
            x = block(x, positions, mode, kv, rows, start, table, write)
        return self.ln_f(x)

    def _project_head(self, x):
        """Vocabulary projection, fp32 logits. Tied: in ``dtype`` (flax
        ``Embed.attend`` promotes both operands to it); untied: in fp32, or
        through the int8 kernel with bf16 inputs when the head is a
        QuantDense (``int8_head``). A vocab-parallel head
        (``module_inject.layers.VocabParallelHead``) projects this rank's
        slice by the same rule and gathers the whole vocabulary."""
        if self._loss_group() is not None:
            return self.lm_head(x)
        if self.config.tie_word_embeddings:
            w = self.embed_tokens.weight
            return F.linear(x.to(w.dtype), w).float()
        if isinstance(self.lm_head, QuantDense):
            return self.lm_head(x).float()
        return F.linear(x.float(), self.lm_head.weight.float())

    _dense_logits = _project_head

    def _vocab_layer(self):
        return getattr(self, "lm_head", None)

    def _positions(self, B: int, T: int, offset=None):
        pos = torch.arange(T, device=self.device)[None].expand(B, T)
        return pos if offset is None else pos + offset[:, None]

    @torch.no_grad()
    def logits(self, input_ids):
        """(B, T) token ids -> (B, T, V) fp32 logits, no cache."""
        return self._project_head(self.hidden(input_ids))

    def _prefill_hidden(self, input_ids, cache, rows):
        B, T = input_ids.shape
        if cache is None:
            cache = self.kv_cache_spec().stacked_cache(B, self.device)
        if rows is None:
            rows = torch.arange(B, device=self.device)
        x = self._transform(input_ids, self._positions(B, T), "prefill",
                            cache, rows)
        return x, cache

    @torch.no_grad()
    def prefill(self, input_ids, cache=None, rows=None):
        """Run the prompt (start 0), writing its K/V into ``cache`` rows
        ``rows`` (default: a new (L, B, ...) cache, rows 0..B-1). Returns
        ``((B, T, V) logits, cache)``."""
        x, cache = self._prefill_hidden(input_ids, cache, rows)
        return self._project_head(x), cache

    @torch.no_grad()
    def prefill_last(self, input_ids, last_pos=None, cache=None, rows=None):
        """:meth:`prefill` that projects only one position per row onto
        the vocabulary: T-1, or ``last_pos`` (int or (B,)) when the prompt
        was right-padded to a bucket width (causal attention keeps that
        position independent of the padding). Returns ((B, 1, V), cache)."""
        x, cache = self._prefill_hidden(input_ids, cache, rows)
        x = x[:, -1:] if last_pos is None else self._pick(x, last_pos)
        return self._project_head(x), cache

    def _starts(self, start_pos, B: int):
        start = torch.as_tensor(start_pos, device=self.device).long()
        return start.expand(B) if start.dim() == 0 else start

    def _pick(self, x, idx):
        """(B, 1, C) rows of ``x`` at per-row index ``idx`` (int or (B,))."""
        B = x.shape[0]
        idx = self._starts(idx, B)
        return x[torch.arange(B, device=self.device), idx][:, None]

    @torch.no_grad()
    def decode(self, input_ids, start_pos, cache):
        """T tokens per row against ``cache`` (updated in place):
        ``start_pos`` is the current cache length, an int for a uniform
        batch or (B,) for slot-pooled decode; token t of row b is written
        at ``start[b] + t`` and sees the positions up to it. Returns
        (B, T, V) logits."""
        B, T = input_ids.shape
        start = self._starts(start_pos, B)
        rows = torch.arange(B, device=self.device)
        x = self._transform(input_ids, self._positions(B, T, start),
                            "decode", cache, rows, start)
        return self._project_head(x)

    @torch.no_grad()
    def prefill_chunk(self, input_ids, start_pos, last_idx, cache,
                      rows=None):
        """Chunked serving prefill: a (B, C) chunk against ``cache`` rows
        ``rows`` (default 0..B-1) at per-row offsets ``start_pos``, i.e.
        :meth:`decode`'s multi-token path, projecting only chunk position
        ``last_idx`` (int or (B,)). Right-padding past the true length
        writes masked garbage that the next chunk or decode overwrites.
        Returns (B, 1, V) logits."""
        B, T = input_ids.shape
        start = self._starts(start_pos, B)
        if rows is None:
            rows = torch.arange(B, device=self.device)
        x = self._transform(input_ids, self._positions(B, T, start),
                            "decode", cache, rows, start)
        return self._project_head(self._pick(x, last_idx))

    @torch.no_grad()
    def decode_paged(self, input_ids, start_pos, pages, table,
                     scratch_page: bool = False):
        """:meth:`decode` over a page pool: ``pages`` is
        :meth:`KVCacheSpec.paged_cache`'s dict, ``table`` the (B,
        pages_per_slot) int32 page table on the device (sentinel =
        ``P``, the pages' count). The step's K/V rows are written through
        the table in place (sentinel and out-of-range entries are dropped)
        and attention reads the pages where they lie, through
        ``paged_decode_attention``. With ``scratch_page`` the last of the
        pages is a scratch page and the sentinel is its id (``P - 1``):
        dropped rows are written there, which needs no host sync
        (``page_writes``), so the step can be captured in a CUDA graph;
        the serving pool allocates its pages so. 1 <= T <=
        ``MAX_QUERY_ROWS``. Returns (B, T, V) logits."""
        B, T = input_ids.shape
        start = self._starts(start_pos, B)
        x = self._transform(input_ids, self._positions(B, T, start),
                            "paged", pages, None, start, table,
                            scratch_page)
        return self._project_head(x)
