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
principle. Caches are updated IN PLACE (``prefill`` writes the prompt rows
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

Not in this port yet (each raises ``NotImplementedError``): ``int8_weights``
and ``kv_cache_quant``. This port serves only; there is no training loss,
so ``dropout``, ``remat`` and ``loss_chunk`` have no effect here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention.decode_attention import (alibi_slopes,
                                              decode_attention,
                                              decode_attention_reference,
                                              window_attention_reference)
from ..ops.attention.flash_attention import NEG_INF, flash_attention
from ..ops.attention.paged_attention import (page_writes,
                                             paged_decode_attention)

__all__ = ["TransformerConfig", "FAMILY_PRESETS", "transformer_config",
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
    dropout: float = 0.0                # serving is deterministic: no effect
    dtype: Any = torch.bfloat16
    # "auto" | "on" | True: the flash kernel for every fresh causal forward
    # with T > 1 and no ALiBi (no TPU-tuned length crossover on CUDA);
    # False | "off": the plain attention
    use_flash_attention: Any = "auto"
    remat: bool = False                 # training only: no effect here
    # "auto" | "on": the decode kernel for T=1 cached attention; "off": the
    # plain einsum math
    decode_kernel: str = "auto"
    # TPU block granule of the decode kernel; the CUDA kernel reads exactly
    # lengths[b] rows, so it has no granule and this is kept for config
    # compatibility only
    decode_block: Optional[int] = None
    kv_cache_quant: bool = False        # not ported yet: raises
    kv_cache_packed: Optional[bool] = None  # TPU int32 container: unused
    int8_weights: bool = False          # not ported yet: raises
    int8_kernel: str = "auto"           # only with int8_weights
    int8_head: bool = False             # only with int8_weights
    loss_chunk: int = 0                 # training only: no effect here

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


def _fresh_reference(q, k, v, slopes=None):
    """Plain causal attention over fresh q/k/v (B, T, H|KV, D) in fp32,
    with optional ALiBi ``slope·(kpos − qpos)``: the JAX einsum path."""
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
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v32).to(q.dtype)


def _row_writes(positions, rows, S: int):
    """Cache writes of a multi-token step into contiguous rows: token t of
    row b goes to ``buf[rows[b], :, positions[b, t]]``; positions past the
    allocation ``S`` are dropped. Returns ``(sel, row ids, positions)``
    over the flattened (B*T) tokens (one host sync, once per forward)."""
    B, T = positions.shape
    sel = (positions < S).reshape(-1).nonzero()[:, 0]
    return (sel, rows[:, None].expand(B, T).reshape(-1)[sel],
            positions.reshape(-1)[sel])


class CachedAttention(nn.Module):
    """Multi-head / grouped-query attention with an optional KV cache.

    Modes: ``"fresh"`` (causal self-attention over the given tokens, no
    cache), ``"prefill"`` (fresh attention, and the tokens' K/V written to
    cache rows ``rows`` at positions [0, T)), ``"decode"`` (token t of row b
    written at position ``start[b] + t`` and attending positions ``<=
    start[b] + t``), ``"paged"`` (as decode, over one layer's page pool
    through the page ``table``).

    ``write`` is ``(sel, a, b)`` from :func:`_row_writes` or
    ``page_writes``, computed once per forward for every layer: the
    flattened token rows ``sel`` that land in the cache, and where
    (``buf[a, :, b]``)."""

    def __init__(self, cfg: TransformerConfig, **fk):
        super().__init__()
        self.config = cfg
        H, KV, D, C = cfg.n_head, cfg.kv_heads, cfg.head_dim, cfg.n_embd
        self.q_proj = nn.Linear(C, H * D, bias=cfg.qkv_bias, **fk)
        self.k_proj = nn.Linear(C, KV * D, bias=cfg.qkv_bias, **fk)
        self.v_proj = nn.Linear(C, KV * D, bias=cfg.qkv_bias, **fk)
        self.o_proj = nn.Linear(H * D, C, bias=cfg.qkv_bias, **fk)

    def _use_flash(self, T: int) -> bool:
        use = self.config.use_flash_attention
        if use is False or use == "off":
            return False
        alibi = self.config.pos_emb == "alibi"
        if use == "auto":
            return T > 1 and not alibi
        if alibi:
            raise ValueError("use_flash_attention=True does not compose with "
                             "pos_emb='alibi' (no bias hook in the kernel)")
        return True

    def forward(self, x, positions, mode: str = "fresh", kv=None,
                rows=None, start=None, table=None, write=None):
        cfg = self.config
        B, T, _ = x.shape
        H, KV, D = cfg.n_head, cfg.kv_heads, cfg.head_dim
        q = self.q_proj(x).view(B, T, H, D)
        k = self.k_proj(x).view(B, T, KV, D)
        v = self.v_proj(x).view(B, T, KV, D)
        if cfg.pos_emb == "rotary":
            rd = int(cfg.rotary_pct * D) // 2 * 2
            q = apply_rotary(q, positions, rotary_dim=rd, theta=cfg.rope_theta)
            k = apply_rotary(k, positions, rotary_dim=rd, theta=cfg.rope_theta)
        slopes = alibi_slopes(H).to(x.device) \
            if cfg.pos_emb == "alibi" else None

        if mode == "paged" or (mode == "decode" and T > 1):
            k_buf, v_buf = kv
            sel, a, b = write
            k_buf[a, :, b] = k.reshape(B * T, KV, D)[sel].to(k_buf.dtype)
            v_buf[a, :, b] = v.reshape(B * T, KV, D)[sel].to(v_buf.dtype)
            if mode == "paged":
                y = paged_decode_attention(
                    q.contiguous(), k_buf, v_buf, table,
                    start.to(torch.int32), alibi_slopes=slopes)
            else:
                y = window_attention_reference(q, k_buf[rows], v_buf[rows],
                                               start, 1.0 / math.sqrt(D),
                                               slopes)
            return self.o_proj(y.to(x.dtype).reshape(B, T, H * D))

        if mode == "decode":
            k_buf, v_buf = kv
            k_buf[rows, :, start] = k[:, 0].to(k_buf.dtype)
            v_buf[rows, :, start] = v[:, 0].to(v_buf.dtype)
            lengths = (start + 1).to(torch.int32)
            if cfg.decode_kernel == "off":
                y = decode_attention_reference(q[:, 0], k_buf, v_buf, lengths,
                                               1.0 / math.sqrt(D), slopes)
            else:
                y = decode_attention(q[:, 0].contiguous(), k_buf, v_buf,
                                     lengths, alibi_slopes=slopes)
            return self.o_proj(y.to(x.dtype).reshape(B, 1, H * D))

        if mode == "prefill":
            k_buf, v_buf = kv
            k_buf[rows, :, :T] = k.transpose(1, 2).to(k_buf.dtype)
            v_buf[rows, :, :T] = v.transpose(1, 2).to(v_buf.dtype)
        if self._use_flash(T):
            y, _ = flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True)
        else:
            y = _fresh_reference(q, k, v, slopes)
        return self.o_proj(y.to(x.dtype).reshape(B, T, H * D))


class TransformerMLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, **fk):
        super().__init__()
        self.config = cfg
        hidden = int(cfg.mlp_ratio * cfg.n_embd)
        if cfg.activation == "swiglu":
            self.gate_proj = nn.Linear(cfg.n_embd, hidden, bias=cfg.mlp_bias,
                                       **fk)
        self.up_proj = nn.Linear(cfg.n_embd, hidden, bias=cfg.mlp_bias, **fk)
        self.down_proj = nn.Linear(hidden, cfg.n_embd, bias=cfg.mlp_bias,
                                   **fk)

    def forward(self, x):
        act = self.config.activation
        if act == "swiglu":
            h = F.silu(self.gate_proj(x)) * self.up_proj(x)
        elif act == "gelu":
            h = F.gelu(self.up_proj(x), approximate="tanh")
        else:
            h = F.relu(self.up_proj(x))
        return self.down_proj(h)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, **fk):
        super().__init__()
        self.config = cfg
        self.ln_1 = _norm(cfg, **fk)
        self.attn = CachedAttention(cfg, **fk)
        self.ln_2 = _norm(cfg, **fk)
        self.mlp = TransformerMLP(cfg, **fk)

    def forward(self, x, positions, mode="fresh", kv=None, rows=None,
                start=None, table=None, write=None):
        a = self.attn(self.ln_1(x), positions, mode, kv, rows, start, table,
                      write)
        if self.config.parallel_residual:
            return x + a + self.mlp(self.ln_2(x))
        x = x + a
        return x + self.mlp(self.ln_2(x))


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """The model's KV-cache contract: engines and the serving slot pool
    size and allocate caches through this."""

    n_layer: int
    kv_heads: int
    head_dim: int
    dtype: torch.dtype
    max_seq_len: int

    def stacked_cache(self, batch_size: int, device=None) -> Dict[str, Any]:
        """Zeroed layer-stacked k/v: (L, B, KV, S, D) each."""
        shape = (self.n_layer, batch_size, self.kv_heads, self.max_seq_len,
                 self.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=device),
                "v": torch.zeros(shape, dtype=self.dtype, device=device)}

    def paged_cache(self, num_pages: int, page_size: int,
                    device=None) -> Dict[str, Any]:
        """Zeroed page pool k/v: (L, P, KV, page_size, D) each, no batch
        axis. A per-slot page table maps positions to pages;
        :meth:`dense_from_pages` reassembles the stacked layout."""
        shape = (self.n_layer, num_pages, self.kv_heads, page_size,
                 self.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=device),
                "v": torch.zeros(shape, dtype=self.dtype, device=device)}

    def dense_from_pages(self, paged: Dict[str, Any],
                         table) -> Dict[str, Any]:
        """The dense (L, B, KV, pages_per_slot * page_size, D) view of a
        page pool for a (B, pages_per_slot) table, as a new tensor per
        side. Unmapped entries (sentinel ``P``) are clipped to page
        ``P - 1``: only positions past a slot's length map there, and
        attention masks them."""
        B, max_pages = table.shape
        out = {}
        for key in ("k", "v"):
            leaf = paged[key]                       # (L, P, KV, ps, D)
            L, P, KV, ps, D = leaf.shape
            ids = table.to(leaf.device).long().clamp(0, P - 1).reshape(-1)
            g = leaf[:, ids].reshape(L, B, max_pages, KV, ps, D)
            out[key] = g.permute(0, 1, 3, 2, 4, 5).reshape(
                L, B, KV, max_pages * ps, D)
        return out


class TransformerLM(nn.Module):
    """Causal LM over any family preset: ``logits``, ``prefill``,
    ``prefill_last``, ``prefill_chunk``, ``decode`` and ``decode_paged``
    (see the module docstring)."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        cfg = config
        if cfg.int8_weights:
            raise NotImplementedError("int8_weights (the int8_matmul slice) "
                                      "is not ported yet")
        if cfg.kv_cache_quant:
            raise NotImplementedError("kv_cache_quant (int8 KV cache) is not "
                                      "ported yet")
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
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.n_embd, cfg.vocab_size, bias=False,
                                     **fk)

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

    def kv_cache_spec(self) -> KVCacheSpec:
        cfg = self.config
        return KVCacheSpec(n_layer=cfg.n_layer, kv_heads=cfg.kv_heads,
                           head_dim=cfg.head_dim, dtype=cfg.dtype,
                           max_seq_len=cfg.max_seq_len)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def _transform(self, input_ids, positions, mode="fresh", cache=None,
                   rows=None, start=None, table=None):
        cfg = self.config
        x = self.embed_tokens(input_ids)
        if cfg.pos_emb == "learned":
            x = x + self.embed_pos(positions)
        if cfg.embed_layernorm:
            x = self.embed_ln(x)
        write = None
        if mode == "paged":
            _, P, _, ps, _ = cache["k"].shape
            write = page_writes(positions, table, P, ps)
        elif mode == "decode" and input_ids.shape[1] > 1:
            write = _row_writes(positions, rows, cache["k"].shape[3])
        for li, block in enumerate(self.blocks):
            kv = (cache["k"][li], cache["v"][li]) if cache is not None \
                else None
            x = block(x, positions, mode, kv, rows, start, table, write)
        return self.ln_f(x)

    def _project_head(self, x):
        """Vocabulary projection, fp32 logits. Tied: in ``dtype`` (flax
        ``Embed.attend`` promotes both operands to it); untied: in fp32."""
        if self.config.tie_word_embeddings:
            w = self.embed_tokens.weight
            return F.linear(x.to(w.dtype), w).float()
        return F.linear(x.float(), self.lm_head.weight.float())

    def _positions(self, B: int, T: int, offset=None):
        pos = torch.arange(T, device=self.device)[None].expand(B, T)
        return pos if offset is None else pos + offset[:, None]

    @torch.no_grad()
    def logits(self, input_ids):
        """(B, T) token ids -> (B, T, V) fp32 logits, no cache."""
        B, T = input_ids.shape
        return self._project_head(
            self._transform(input_ids, self._positions(B, T)))

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
    def decode_paged(self, input_ids, start_pos, pages, table):
        """:meth:`decode` over a page pool: ``pages`` is
        :meth:`KVCacheSpec.paged_cache`'s dict, ``table`` the (B,
        pages_per_slot) int32 page table on the device (sentinel =
        ``P``). The step's K/V rows are written through the table in
        place (sentinel and out-of-range entries are dropped) and
        attention reads the pages where they lie, through
        ``paged_decode_attention``. 1 <= T <= ``MAX_QUERY_ROWS``. Returns
        (B, T, V) logits."""
        B, T = input_ids.shape
        start = self._starts(start_pos, B)
        x = self._transform(input_ids, self._positions(B, T, start),
                            "paged", pages, None, start, table)
        return self._project_head(x)
