"""GPT-2 for training: the port of ``deepspeed_tpu/models/gpt2.py``.

``GPT2LMHeadModel(config)(batch)`` returns the mean next-token
cross-entropy, the engine's model convention; ``hidden`` and ``logits``
are the JAX model's. Numerics follow the flax modules:

* every activation is in ``config.dtype``; parameters are cast to it where
  they are used (flax promotes its fp32 parameters the same way), so a
  model whose parameters the engine holds in the compute dtype casts
  nothing;
* LayerNorm reduces in fp32 and returns ``dtype`` (flax's LayerNorm with
  ``dtype=bf16`` promotes its statistics to fp32; so does
  ``F.layer_norm`` on bf16 input);
* GELU is the tanh approximation;
* the tied head projects in ``dtype`` (flax ``Embed.attend`` promotes both
  operands to it), so the logits are in ``dtype``; the loss shifts by one
  position and ignores negative labels (-100), averaging over the rest;
* the plain attention arm scales by ``1 / sqrt(D)`` rounded to ``dtype``,
  masks with ``finfo(dtype).min`` and takes the softmax in fp32.

Attention has the JAX model's two arms, chosen by ``use_flash_attention``:
``True`` runs ``ops.attention.flash_attention`` (its CUDA kernels on a
card, its plain version on the CPU), ``False`` the plain einsum arm, and
``"auto"`` the kernel on CUDA tensors when dropout is 0 (no TPU crossover)
and the einsum arm otherwise. ``fused_ln_linear=True`` runs the ln_1→qkv
and ln_2→fc pairs through ``ops.transformer.ln_linear`` over the same
parameters; ``"auto"`` stays off, as in the JAX package, until an A/B on
the H100 says otherwise.

Activation checkpointing (``remat``) wraps each block in non-reentrant
``torch.utils.checkpoint``. ``remat_policy="full"`` recomputes the whole
block in the backward; ``"dots"`` keeps the matrix products' outputs and
the outputs of the flash, block-sparse and ln_linear operators (the JAX
``ATTN_SAVE_NAMES`` and ``LN_SAVE_NAMES``), so no forward kernel runs again;
``"dots_plain"`` keeps the products only. Dropout draws its masks from a
``torch.Generator`` seeded per block and forward, so a recomputed block
draws the same masks.

``sparse_attention`` (a ``SparsityConfig`` from ``ops.sparse_attention``)
takes the JAX model's route ahead of both arms: every layer attends only
its layout's blocks, causally, through the block-sparse kernel operator
(``ops.sparse_attention.block_sparse_kernel``: its CUDA kernels on a card,
its plain versions on the CPU) when ``supports_pallas(block, T)`` holds,
else through the gather formulation. The JAX model takes its kernel on a
TPU only; both routes compute the same function.

``loss_chunk > 0`` streams the loss: the hidden states (the last position
dropped) go through ``ops.transformer.chunked_softmax_xent`` against
``wte.weight`` in ``dtype``, ``loss_chunk`` positions at a time, so the
(B, T, V) logits are never held whole; the dense path is unchanged.

``scan_unroll`` is accepted for config compatibility and has no effect:
the blocks are a Python loop in eager PyTorch, not a ``lax.scan``.
``sequence_parallel`` is not ported and raises unless off.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.attention.flash_attention import FLASH_OP, flash_attention
from ..ops.sparse_attention.block_sparse_kernel import (
    SPARSE_OP, block_sparse_flash_attention, supports_pallas)
from ..ops.sparse_attention.sparse_self_attention import \
    block_sparse_attention
from ..ops.transformer.ln_linear import LN_LINEAR_OP, ln_linear
from .transformer_lm import CausalLMTraining, _dropout, to_torch_dtype

__all__ = ["GPT2Config", "GPT2_SIZES", "gpt2_config", "GPT2LMHeadModel",
           "REMAT_POLICIES"]

REMAT_POLICIES = ("full", "dots", "dots_plain")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
# what each policy keeps; everything else is recomputed ("full" keeps
# nothing and runs without a policy)
_SAVED_OPS = {"dots": frozenset(_DOTS + (FLASH_OP, SPARSE_OP,
                                         LN_LINEAR_OP)),
              "dots_plain": frozenset(_DOTS)}


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    dtype: Any = torch.bfloat16  # activation/compute dtype
    remat: bool = False
    remat_policy: str = "full"   # full | dots | dots_plain
    use_flash_attention: Any = "auto"   # True | False | "auto"
    sequence_parallel: Optional[str] = None     # not ported
    scan_unroll: int = 1         # accepted, no effect (module docstring)
    sparse_attention: Optional[Any] = None      # a SparsityConfig
    fused_ln_linear: Any = "auto"   # True | False | "auto" (= off)
    loss_chunk: int = 0          # > 0: the streaming loss, this many a chunk

    def __post_init__(self):
        object.__setattr__(self, "dtype", to_torch_dtype(self.dtype))
        if self.sparse_attention is not None and self.sequence_parallel:
            raise ValueError("sparse_attention does not compose with "
                             "sequence_parallel (the layout is over the "
                             "full sequence)")
        if self.sequence_parallel not in (None, False):
            raise NotImplementedError(
                "GPT2Config.sequence_parallel is not ported to the "
                "PyTorch/CUDA package yet")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                             f"got {self.remat_policy!r}")
        for key in ("use_flash_attention", "fused_ln_linear"):
            if getattr(self, key) not in (True, False, "auto"):
                raise ValueError(f"{key} must be True, False or 'auto'")
        if self.n_embd % self.n_head:
            raise ValueError("n_embd must be a multiple of n_head")
        if self.use_flash_attention is True and self.dropout > 0:
            raise ValueError("use_flash_attention does not support "
                             "attention-probability dropout (dropout>0); "
                             "use the plain arm or dropout=0")

    @property
    def fused(self) -> bool:
        """The fused ln_linear switch resolved: "auto" is off."""
        return self.fused_ln_linear is True


GPT2_SIZES = {
    "gpt2-125m": dict(n_embd=768, n_layer=12, n_head=12),
    "gpt2-medium": dict(n_embd=1024, n_layer=24, n_head=16),
    "gpt2-large": dict(n_embd=1280, n_layer=36, n_head=20),
    "gpt2-xl": dict(n_embd=1600, n_layer=48, n_head=25),
    "gpt2-1.3b": dict(n_embd=2048, n_layer=24, n_head=16),
}


def gpt2_config(name: str = "gpt2-125m", **overrides) -> GPT2Config:
    return GPT2Config(**{**GPT2_SIZES[name], **overrides})


def _cast(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return p if p.dtype == dtype else p.to(dtype)


def _linear(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, _cast(mod.weight, x.dtype), _cast(mod.bias, x.dtype))


def _layer_norm(mod: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, mod.normalized_shape, _cast(mod.weight, x.dtype),
                        _cast(mod.bias, x.dtype), mod.eps)


def _ln_linear(ln: nn.LayerNorm, dense: nn.Linear, x: torch.Tensor):
    return ln_linear(x, ln.weight, ln.bias, dense.weight, dense.bias,
                     eps=ln.eps)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPT2Config, **fk):
        super().__init__()
        self.config = cfg
        C = cfg.n_embd
        self.qkv = nn.Linear(C, 3 * C, **fk)
        self.proj = nn.Linear(C, C, **fk)

    def _use_flash(self, x) -> bool:
        use = self.config.use_flash_attention
        if use == "auto":
            return x.device.type == "cuda" and self.config.dropout == 0
        return bool(use)

    def _sparse(self, q, k, v, gen):
        """The JAX model's sparse route (gpt2.py:194-222): the kernel
        operator where the granule tiles, else the gather formulation."""
        if gen is not None:      # dropout > 0 and not deterministic
            raise ValueError("sparse_attention does not support "
                             "attention-probability dropout")
        scfg = self.config.sparse_attention
        T = q.shape[1]
        layout = scfg.make_layout(T)
        if supports_pallas(scfg.block, T):
            return block_sparse_flash_attention(q, k, v, layout, scfg.block,
                                                causal=True)
        return block_sparse_attention(q, k, v, layout, scfg.block,
                                      causal=True)

    def forward(self, x, gen=None, ln: Optional[nn.LayerNorm] = None):
        """``x`` is LN'd already, or (with ``ln``) raw for the fused
        ln_linear kernel."""
        cfg = self.config
        B, T, C = x.shape
        H, D = cfg.n_head, C // cfg.n_head
        qkv = _ln_linear(ln, self.qkv, x) if ln is not None \
            else _linear(self.qkv, x)
        q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(C, dim=-1))
        if cfg.sparse_attention is not None:
            y = self._sparse(q, k, v, gen)
        elif self._use_flash(x):
            # the split leaves strided views; the kernels take contiguous
            y, _ = flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True)
        else:
            dt = x.dtype
            # 1 / sqrt(D) with sqrt(D) and the quotient rounded to dtype,
            # as the JAX model computes it
            root = torch.tensor(float(D)).sqrt().to(dt)
            scale = (1.0 / root).to(dt).item()
            att = torch.einsum("bthd,bshd->bhts", q, k) * scale
            mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            att = att.masked_fill(~mask, torch.finfo(dt).min)
            att = torch.softmax(att.float(), dim=-1).to(dt)
            att = _dropout(att, cfg.dropout, gen)
            y = torch.einsum("bhts,bshd->bthd", att, v)
        y = _linear(self.proj, y.reshape(B, T, C))
        return _dropout(y, cfg.dropout, gen)


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, **fk):
        super().__init__()
        self.config = cfg
        self.fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd, **fk)
        self.proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd, **fk)

    def forward(self, x, gen=None, ln: Optional[nn.LayerNorm] = None):
        h = _ln_linear(ln, self.fc, x) if ln is not None \
            else _linear(self.fc, x)
        h = _linear(self.proj, F.gelu(h, approximate="tanh"))
        return _dropout(h, self.config.dropout, gen)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, **fk):
        super().__init__()
        self.config = cfg
        eps = cfg.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(cfg.n_embd, eps=eps, **fk)
        self.attn = CausalSelfAttention(cfg, **fk)
        self.ln_2 = nn.LayerNorm(cfg.n_embd, eps=eps, **fk)
        self.mlp = MLP(cfg, **fk)

    def forward(self, x, seed: Optional[int] = None):
        """``seed`` (None: no dropout) seeds this block's dropout masks."""
        gen = None
        if seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(seed)
        if self.config.fused:
            x = x + self.attn(x, gen, ln=self.ln_1)
            return x + self.mlp(x, gen, ln=self.ln_2)
        x = x + self.attn(_layer_norm(self.ln_1, x), gen)
        return x + self.mlp(_layer_norm(self.ln_2, x), gen)


def _policy(saved):
    def fn(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved \
            else CheckpointPolicy.PREFER_RECOMPUTE
    return fn


class GPT2LMHeadModel(CausalLMTraining, nn.Module):
    """Causal LM with the tied embedding head. ``forward(batch)`` returns
    the mean cross-entropy; ``batch`` = {"input_ids": (B, T) ints, optional
    "labels": (B, T)} (arrays or tensors; moved to the model's device)."""

    def __init__(self, config: GPT2Config, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        cfg = config
        self.config = cfg
        fk = dict(device=device, dtype=param_dtype or cfg.dtype)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd, **fk)
        self.wpe = nn.Embedding(cfg.n_positions, cfg.n_embd, **fk)
        self.blocks = nn.ModuleList(Block(cfg, **fk)
                                    for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon,
                                 **fk)
        self.dropout_generator = torch.Generator().manual_seed(0)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator,
                     std: float = 0.02) -> None:
        """GPT-2's published initialisation from ``generator``: N(0, std)
        for every linear and embedding weight, the two projections that
        write into the residual stream (``attn.proj``, ``mlp.proj``) scaled
        by 1/sqrt(2 · n_layer), zero biases, unit LayerNorm scales."""
        residual = std / (2 * self.config.n_layer) ** 0.5
        for name, mod in self.named_modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, residual if name.endswith(".proj")
                                   else std, generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def replace_config(self, **changes) -> GPT2Config:
        """Give the model and every block ``dataclasses.replace(config,
        **changes)`` (the kernel switches; not shapes). Returns it."""
        cfg = dataclasses.replace(self.config, **changes)
        for mod in self.modules():
            if hasattr(mod, "config"):
                mod.config = cfg
        return cfg

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def hidden(self, input_ids, deterministic: bool = True):
        """Final hidden states (B, T, C) after ``ln_f``."""
        cfg = self.config
        ids = torch.as_tensor(input_ids, device=self.device).long()
        T = ids.shape[1]
        pos = torch.arange(T, device=self.device)
        x = _cast(self.wte.weight, cfg.dtype)[ids] + \
            _cast(self.wpe.weight, cfg.dtype)[pos][None]
        remat = cfg.remat and torch.is_grad_enabled()
        context_fn = None
        if remat and cfg.remat_policy in _SAVED_OPS:
            context_fn = functools.partial(
                create_selective_checkpoint_contexts,
                _policy(_SAVED_OPS[cfg.remat_policy]))
        for block, seed in zip(self.blocks, self._block_seeds(deterministic)):
            if not remat:
                x = block(x, seed)
            elif context_fn is None:
                x = checkpoint(block, x, seed, use_reentrant=False)
            else:
                x = checkpoint(block, x, seed, use_reentrant=False,
                               context_fn=context_fn)
        return _layer_norm(self.ln_f, x)

    def _attend(self, x):
        """The tied head in ``dtype``."""
        return x @ _cast(self.wte.weight, x.dtype).t()

    def logits(self, input_ids, deterministic: bool = True):
        return self._attend(self.hidden(input_ids, deterministic))

    _dense_logits = _attend

    def _loss_head(self):
        """The streamed loss's projection: the tied table in ``dtype``."""
        return self.wte.weight, self.config.dtype
