"""Module injection: the port of ``deepspeed_tpu/module_inject/__init__.py``,
and the module swap that carries its rules out on one rank.

The JAX package turns injection into :class:`ShardingRules` that GSPMD
carries out. The port computes the same rules:

* :func:`get_policy_rules`: per-family rules (the policy path);
* :func:`auto_tp_rules`: AutoTP's shape and name heuristics over the
  parameters under their JAX paths (``checkpoint.flax_import.flax_paths``
  for a port module): down/output projections row-parallel, other kernels
  and their biases column-parallel, embeddings vocab-parallel;
* a caller's truthy ``injection_policy`` (pattern -> spec entries),

and carries them out itself for a ``TransformerLM`` over a model group of
N ranks (:func:`apply_tensor_parallel`). Each rule is resolved per JAX
leaf against the mesh (``parallel.axis_rules.physical_spec``: size-1 axes
dropped, the divisibility fallback), which gives the dimension the model
axis splits, and the layers are swapped by unit (``module_inject.layers``):

* attention splits by whole heads when q/k/v are column-parallel, o is
  row-parallel and N divides the query heads: H/N query heads a rank.
  The KV heads split with them when N divides them; else each rank keeps
  the whole KV heads its query heads read, a KV head replicated across
  the ranks sharing it, so the grouped-query ratio the kernels see stays
  an integer. Where whole heads do not divide N (GSPMD then splits half
  heads) attention stays whole on every rank;
* the MLP splits when up (and gate) are column-parallel and down is
  row-parallel;
* the embedding is vocab-parallel when its vocabulary dimension is split,
  the head when its own is (a tied head with the embedding).

A placement may differ from GSPMD's; the results may not.
:func:`shard_state_dict` slices a full state dict for one rank by the same
plan, so a rank's card never holds the whole model.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..parallel import mesh as mesh_mod
from ..parallel.axis_rules import model_dim, physical_spec
from ..parallel.mesh import MODEL_AXIS
from ..runtime.zero.policy import ShardingRules
from .layers import (RowParallelLinear, VocabParallelEmbedding,
                     VocabParallelHead)

# name fragments marking the SECOND linear of a pair (row-parallel: the
# input dim split, the output all-reduced), as AutoTP's heuristics
ROW_PARALLEL_PAT = re.compile(
    r"(o_proj|out_proj|down_proj|dense_4h_to_h|attention/dense|fc2|proj_out"
    r"|c_proj|wo)(/|$)", re.IGNORECASE)
EMBED_PAT = re.compile(r"(embedding|wte|embed_tokens)(/|$)", re.IGNORECASE)
POS_EMBED_PAT = re.compile(r"(wpe|embed_pos|position)", re.IGNORECASE)

GPT2_TP_MSG = (
    "tensor-parallel GPT2LMHeadModel is not ported to the PyTorch/CUDA "
    "package yet: its fused qkv projection must be split per head, which "
    "comes with tensor-parallel training (serve a TransformerLM, or GPT-2 "
    "on one rank)")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = val
    return out


def _leaves(params: Any) -> List[Tuple[str, Tuple[int, ...]]]:
    """(JAX path, JAX leaf shape) of every parameter leaf, sorted by path:
    a port module through ``flax_paths``, or a flax tree (nested dicts of
    arrays or shapes)."""
    if isinstance(params, nn.Module):
        from ..checkpoint.flax_import import flax_paths

        leaves = dict(flax_paths(params).values())
    else:
        leaves = {p: tuple(v) if isinstance(v, (tuple, list))
                  else tuple(np.shape(v)) for p, v in
                  _flatten(params).items()}
    return sorted(leaves.items())


def auto_tp_rules(params: Any, tp_size: int,
                  exclude: Sequence[str] = ()) -> ShardingRules:
    """Tensor-parallel rules inferred for any parameters (AutoTP, the JAX
    function), ``params`` a port module or a flax tree. Per leaf, on its
    rightmost dims (a leading layer dim stays whole): an embedding
    vocab-parallel (dim -2) unless positional; a kernel matching
    :data:`ROW_PARALLEL_PAT` split on its input dim (-2); any other kernel
    of rank >= 2 on its output dim (-1), and so its bias; a dimension
    ``tp_size`` does not divide stays whole."""
    rules: List[Tuple[str, tuple]] = []
    for p, shape in _leaves(params):
        if any(x in p for x in exclude):
            continue
        nd = len(shape)
        spec: Optional[tuple] = None
        if EMBED_PAT.search(p) and not POS_EMBED_PAT.search(p) and nd >= 2:
            if shape[-2] % tp_size == 0:
                spec = (None,) * (nd - 2) + (MODEL_AXIS, None)
        elif p.endswith("kernel") and nd >= 2:
            if ROW_PARALLEL_PAT.search(p):
                if shape[-2] % tp_size == 0:
                    spec = (None,) * (nd - 2) + (MODEL_AXIS, None)
            else:
                if shape[-1] % tp_size == 0:
                    spec = (None,) * (nd - 1) + (MODEL_AXIS,)
        elif p.endswith("bias") and nd >= 1 and not ROW_PARALLEL_PAT.search(p):
            if shape[-1] % tp_size == 0:
                spec = (None,) * (nd - 1) + (MODEL_AXIS,)
        if spec is not None:
            rules.append((re.escape(p) + "$", spec))
    return ShardingRules(rules)


def get_policy_rules(model: Any, tp_size: int = 1
                     ) -> Optional[ShardingRules]:
    """The family's explicit rules (the policy path): ``TransformerLM``'s,
    or GPT-2's on one rank (above one it raises, :data:`GPT2_TP_MSG`);
    None for another module."""
    from ..models.gpt2 import GPT2LMHeadModel, gpt2_sharding_rules
    from ..models.transformer_lm import (TransformerLM,
                                         transformer_sharding_rules)

    if isinstance(model, TransformerLM):
        return ShardingRules(transformer_sharding_rules())
    if isinstance(model, GPT2LMHeadModel):
        if tp_size > 1:
            raise NotImplementedError(GPT2_TP_MSG)
        return ShardingRules(gpt2_sharding_rules())
    return None


def replace_module(model: Any, params: Any = None, tp_size: int = 1,
                   injection_policy=None) -> ShardingRules:
    """The injection entry (the JAX function): a truthy
    ``injection_policy`` (a dict or pairs of pattern -> spec entries) as
    the rules, else the family's policy rules, else AutoTP over
    ``params`` (default: the model's own parameters)."""
    if injection_policy:
        pairs = injection_policy.items() \
            if hasattr(injection_policy, "items") else injection_policy
        return ShardingRules(list(pairs))
    rules = get_policy_rules(model, tp_size)
    if rules is not None:
        return rules
    return auto_tp_rules(model if params is None else params, tp_size)


# ---------------------------------------------------------------------------
# carrying the rules out on one rank
# ---------------------------------------------------------------------------
Span = Optional[Tuple[int, int]]      # [lo, hi), or None: whole


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """One rank's share of a ``TransformerLM`` over a model group of
    ``size`` ranks: the embedding's vocabulary rows, the head's, the
    query and KV heads of every attention layer, the MLP's hidden units
    (each ``[lo, hi)``, or None where the unit stays whole)."""

    size: int
    rank: int
    vocab: Span = None
    head: Span = None
    q_heads: Span = None
    kv_heads: Span = None
    ffn: Span = None

    def cut(self, key: str, head_dim: int) -> Optional[Tuple[int, int, int]]:
        """(dim, lo, hi) of the port parameter ``key`` this rank holds, or
        None for the whole tensor."""
        attn = re.search(r"attn\.(q|k|v|o)_proj\.(weight|bias)$", key)
        if key == "embed_tokens.weight" and self.vocab:
            return (0,) + self.vocab
        if key == "lm_head.weight" and self.head:
            return (0,) + self.head
        if attn and self.q_heads:
            which, leaf = attn.groups()
            heads = self.q_heads if which in "qo" else self.kv_heads
            lo, hi = heads[0] * head_dim, heads[1] * head_dim
            if which != "o":
                return 0, lo, hi
            return (1, lo, hi) if leaf == "weight" else None
        mlp = re.search(r"mlp\.(gate|up|down)_proj\.(weight|bias)$", key)
        if mlp and self.ffn:
            which, leaf = mlp.groups()
            if which != "down":
                return (0,) + self.ffn
            return (1,) + self.ffn if leaf == "weight" else None
        return None


def _split(n: int, size: int, rank: int) -> Tuple[int, int]:
    k = n // size
    return rank * k, (rank + 1) * k


def _kv_span(H: int, KV: int, q: Tuple[int, int]) -> Span:
    """The KV heads query heads ``q`` read, if every local query head reads
    local KV head ``j // (Hl / KVl)`` (an integer grouped-query ratio);
    None otherwise."""
    g = H // KV
    lo, hi = q[0] // g, (q[1] - 1) // g + 1
    Hl, KVl = q[1] - q[0], hi - lo
    if Hl % KVl:
        return None
    ratio = Hl // KVl
    if any((q[0] + j) // g - lo != j // ratio for j in range(Hl)):
        return None
    return lo, hi


def tp_plan(model: nn.Module, rules: ShardingRules, mesh: Any = None
            ) -> TPPlan:
    """This rank's :class:`TPPlan` for ``model`` (a ``TransformerLM``)
    under ``rules`` on ``mesh`` (default: the global mesh)."""
    from ..checkpoint.flax_import import flax_paths

    mesh = mesh if mesh is not None else mesh_mod.get_mesh()
    size, rank = mesh.axis_size(MODEL_AXIS), mesh.axis_rank(MODEL_AXIS)
    if size == 1:
        return TPPlan(1, 0)
    cfg = model.config
    paths = dict(flax_paths(model).values())

    def split_dim(path: str) -> Optional[int]:
        """The JAX leaf's dim the model axis splits (None: whole, or a
        leaf the model lacks)."""
        shape = paths.get(path)
        spec = rules.spec_for(path) if shape is not None else None
        if spec is None or len(spec) != len(shape):
            return None
        return model_dim(physical_spec(tuple(spec), shape, mesh))

    blk = "blocks/block/"
    vocab = _split(cfg.vocab_size, size, rank) \
        if split_dim("embed_tokens/embedding") == 0 else None
    if cfg.tie_word_embeddings:
        head = vocab
    else:
        head = _split(cfg.vocab_size, size, rank) \
            if split_dim("lm_head/kernel") == 1 else None
    q_heads = kv_heads = None
    attn_split = all(split_dim(f"{blk}attn/{p}_proj/kernel") == 2
                     for p in "qkv") and \
        split_dim(f"{blk}attn/o_proj/kernel") == 1
    if attn_split and cfg.n_head % size == 0:
        # every rank's split must hold, or every rank keeps attention whole
        spans = [_kv_span(cfg.n_head, cfg.kv_heads,
                          _split(cfg.n_head, size, r)) for r in range(size)]
        if all(spans):
            q_heads, kv_heads = _split(cfg.n_head, size, rank), spans[rank]
    ffn = None
    ins = ("up", "gate") if cfg.activation == "swiglu" else ("up",)
    if all(split_dim(f"{blk}mlp/{p}_proj/kernel") == 2 for p in ins) and \
            split_dim(f"{blk}mlp/down_proj/kernel") == 1:
        ffn = _split(int(cfg.mlp_ratio * cfg.n_embd), size, rank)
    return TPPlan(size, rank, vocab, head, q_heads, kv_heads, ffn)


def shard_state_dict(plan: TPPlan, state_dict: Mapping[str, torch.Tensor],
                     head_dim: int) -> Dict[str, torch.Tensor]:
    """This rank's slice of a full state dict by ``plan``: each cut tensor
    a contiguous copy of its slice, every other tensor a copy, so nothing
    keeps the full tensors alive."""
    out = {}
    for key, t in state_dict.items():
        cut = plan.cut(key, head_dim)
        if cut is not None:
            dim, lo, hi = cut
            t = t.narrow(dim, lo, hi - lo)
        out[key] = t.detach().clone(memory_format=torch.contiguous_format)
    return out


def _swap_block(block: nn.Module, plan: TPPlan, cfg, group: str) -> None:
    fk = dict(device="meta", dtype=cfg.dtype)
    attn, mlp, D, C = block.attn, block.mlp, cfg.head_dim, cfg.n_embd
    if plan.q_heads:
        (qlo, qhi), (klo, khi) = plan.q_heads, plan.kv_heads
        bias = cfg.qkv_bias
        attn.q_proj = nn.Linear(C, (qhi - qlo) * D, bias, **fk)
        attn.k_proj = nn.Linear(C, (khi - klo) * D, bias, **fk)
        attn.v_proj = nn.Linear(C, (khi - klo) * D, bias, **fk)
        attn.o_proj = RowParallelLinear((qhi - qlo) * D, C, bias, group, **fk)
        attn.heads, attn.kv_heads = qhi - qlo, khi - klo
        if cfg.pos_emb == "alibi":
            attn.alibi = attn.alibi[qlo:qhi].clone()
    if plan.ffn:
        lo, hi = plan.ffn
        bias = cfg.mlp_bias
        if cfg.activation == "swiglu":
            mlp.gate_proj = nn.Linear(C, hi - lo, bias, **fk)
        mlp.up_proj = nn.Linear(C, hi - lo, bias, **fk)
        mlp.down_proj = RowParallelLinear(hi - lo, C, bias, group, **fk)


def apply_tensor_parallel(model: nn.Module, rules: ShardingRules,
                          mesh: Any = None,
                          state_dict: Optional[Mapping[str, torch.Tensor]]
                          = None) -> TPPlan:
    """Carry ``rules`` out on this rank of the mesh's model group: swap
    ``model``'s layers for the parallel ones of its :class:`TPPlan` and
    load this rank's slice of ``state_dict`` (default: the model's own,
    full, weights) into it, in place and on the model's device. Only a
    ``TransformerLM`` without int8 weights is taken above one rank."""
    from ..models.transformer_lm import TransformerLM

    mesh = mesh if mesh is not None else mesh_mod.get_mesh()
    if mesh.axis_size(MODEL_AXIS) == 1:
        if state_dict is not None:
            model.load_state_dict(state_dict)
        return TPPlan(1, 0)
    if not isinstance(model, TransformerLM):
        raise NotImplementedError(
            f"tensor-parallel injection is ported for TransformerLM only, "
            f"not {type(model).__name__}")
    cfg = model.config
    if cfg.int8_weights:
        raise NotImplementedError(
            "an int8_weights model over a model group above one rank is "
            "not ported yet: its per-channel scales would be cut by the "
            "shard boundaries")
    plan = tp_plan(model, rules, mesh)
    full = state_dict if state_dict is not None else model.state_dict()
    local = shard_state_dict(plan, full, cfg.head_dim)
    del full
    group = MODEL_AXIS
    fk = dict(device="meta", dtype=cfg.dtype)
    C = cfg.n_embd
    if plan.vocab:
        lo, hi = plan.vocab
        model.embed_tokens = VocabParallelEmbedding(hi - lo, C, lo, group,
                                                    **fk)
    if plan.head:
        lo, hi = plan.head
        tied = model.embed_tokens if cfg.tie_word_embeddings else None
        model.lm_head = VocabParallelHead(hi - lo, C, tied, group, **fk)
    for block in model.blocks:
        _swap_block(block, plan, cfg, group)
    model.load_state_dict(local, assign=True)
    return plan
