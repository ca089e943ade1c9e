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

and carries them out itself for a ``TransformerLM`` or a
``GPT2LMHeadModel`` over a model group of N ranks
(:func:`apply_tensor_parallel`), for serving and for training (the
layers' collectives carry their gradients, ``mappings``). Each rule is
resolved per JAX leaf against the mesh (``parallel.axis_rules.
physical_spec``: size-1 axes dropped, the divisibility fallback), which
gives the dimension the model axis splits, and the layers are swapped
by unit (``module_inject.layers``):

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

GPT-2's fused ``attn.qkv`` (C -> 3C, laid out q | k | v, each head-major)
splits per head: a rank keeps columns ``[h·D, (h+1)·D)`` of each of the
q, k and v blocks for its heads, and the bias likewise, where the JAX rule
``attn/qkv/kernel (None, None, M)`` is a contiguous column split that
GSPMD reshards before attention.

A placement may differ from GSPMD's; the results may not.
:func:`shard_state_dict` slices a full state dict for one rank by the same
plan, so a rank's card never holds the whole model, and
:func:`gather_tensor` is its inverse over the model group: a checkpoint
holds the whole tensors in the one-rank layout, whatever the placement.
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
from ..ops.quantization.linear import QuantDense
from .layers import (RowParallelLinear, RowParallelQuantDense,
                     SharedHeadsLinear, VocabParallelEmbedding,
                     VocabParallelHead, VocabParallelQuantHead)

# name fragments marking the SECOND linear of a pair (row-parallel: the
# input dim split, the output all-reduced), as AutoTP's heuristics
ROW_PARALLEL_PAT = re.compile(
    r"(o_proj|out_proj|down_proj|dense_4h_to_h|attention/dense|fc2|proj_out"
    r"|c_proj|wo)(/|$)", re.IGNORECASE)
EMBED_PAT = re.compile(r"(embedding|wte|embed_tokens)(/|$)", re.IGNORECASE)
POS_EMBED_PAT = re.compile(r"(wpe|embed_pos|position)", re.IGNORECASE)

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
    """The family's explicit rules (the policy path): ``TransformerLM``'s
    or GPT-2's (the JAX ``gpt2_sharding_rules``; ``tp_size`` is the JAX
    signature's and changes nothing); None for another module."""
    from ..models.gpt2 import GPT2LMHeadModel, gpt2_sharding_rules
    from ..models.transformer_lm import (TransformerLM,
                                         transformer_sharding_rules)

    if isinstance(model, TransformerLM):
        return ShardingRules(transformer_sharding_rules())
    if isinstance(model, GPT2LMHeadModel):
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
Pieces = Optional[Tuple[int, Tuple[Tuple[int, int], ...]]]


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """One rank's share of a ``TransformerLM`` or ``GPT2LMHeadModel`` over
    a model group of ``size`` ranks: the embedding's vocabulary rows, the
    head's, the query and KV heads of every attention layer, the MLP's
    hidden units (each ``[lo, hi)``, or None where the unit stays whole).
    ``fused_qkv`` is GPT-2's q | k | v block width (C; 0 for a
    ``TransformerLM``, whose q, k and v are separate projections). An
    ``int8_weights`` projection's per-channel ``scale`` is cut with its
    output channels (a column-parallel one, the head) and stays whole
    where the input features are cut (a row-parallel one)."""

    size: int
    rank: int
    vocab: Span = None
    head: Span = None
    q_heads: Span = None
    kv_heads: Span = None
    ffn: Span = None
    fused_qkv: int = 0

    def pieces(self, key: str, head_dim: int) -> Pieces:
        """(dim, ((lo, hi), ...)) of the port parameter ``key`` this rank
        holds, the pieces concatenated along ``dim`` in order, or None for
        the whole tensor."""
        if self.fused_qkv:
            return self._gpt2_pieces(key, head_dim)
        attn = re.search(r"attn\.(q|k|v|o)_proj\.(weight|bias|scale)$", key)
        if key == "embed_tokens.weight" and self.vocab:
            return 0, (self.vocab,)
        if key in ("lm_head.weight", "lm_head.scale") and self.head:
            return 0, (self.head,)
        if attn and self.q_heads:
            which, leaf = attn.groups()
            heads = self.q_heads if which in "qo" else self.kv_heads
            span = (heads[0] * head_dim, heads[1] * head_dim)
            if which != "o":
                return 0, (span,)
            return (1, (span,)) if leaf == "weight" else None
        mlp = re.search(r"mlp\.(gate|up|down)_proj\.(weight|bias|scale)$",
                        key)
        if mlp and self.ffn:
            which, leaf = mlp.groups()
            if which != "down":
                return 0, (self.ffn,)
            return (1, (self.ffn,)) if leaf == "weight" else None
        return None

    def _gpt2_pieces(self, key: str, head_dim: int) -> Pieces:
        if key == "wte.weight" and self.vocab:
            return 0, (self.vocab,)
        attn = re.search(r"attn\.(qkv|proj)\.(weight|bias)$", key)
        if attn and self.q_heads:
            which, leaf = attn.groups()
            lo, hi = self.q_heads[0] * head_dim, self.q_heads[1] * head_dim
            if which == "qkv":
                C = self.fused_qkv
                return 0, tuple((j * C + lo, j * C + hi) for j in range(3))
            return (1, ((lo, hi),)) if leaf == "weight" else None
        mlp = re.search(r"mlp\.(fc|proj)\.(weight|bias)$", key)
        if mlp and self.ffn:
            which, leaf = mlp.groups()
            if which == "fc":
                return 0, (self.ffn,)
            return (1, (self.ffn,)) if leaf == "weight" else None
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


def tp_plans(model: nn.Module, rules: ShardingRules, mesh: Any = None
             ) -> List[TPPlan]:
    """Every rank's :class:`TPPlan` for ``model`` (a ``TransformerLM`` or
    a ``GPT2LMHeadModel``, as built: before any swap) under ``rules`` on
    ``mesh`` (default: the global mesh), in model-group order."""
    from ..checkpoint.flax_import import flax_paths
    from ..models.gpt2 import GPT2LMHeadModel

    mesh = mesh if mesh is not None else mesh_mod.get_mesh()
    size = mesh.axis_size(MODEL_AXIS)
    if size == 1:
        return [TPPlan(1, 0)]
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
    H = cfg.n_head
    if isinstance(model, GPT2LMHeadModel):
        vocab = split_dim("wte/embedding") == 0
        attn = split_dim(f"{blk}attn/qkv/kernel") == 2 and \
            split_dim(f"{blk}attn/proj/kernel") == 1 and H % size == 0
        ffn = split_dim(f"{blk}mlp/fc/kernel") == 2 and \
            split_dim(f"{blk}mlp/proj/kernel") == 1
        out = []
        for r in range(size):
            v = _split(cfg.vocab_size, size, r) if vocab else None
            q = _split(H, size, r) if attn else None
            out.append(TPPlan(size, r, v, v, q, q,
                              _split(4 * cfg.n_embd, size, r)
                              if ffn else None, cfg.n_embd))
        return out
    vocab = split_dim("embed_tokens/embedding") == 0
    head = vocab if cfg.tie_word_embeddings else \
        split_dim("lm_head/kernel") == 1
    spans = [None] * size
    attn_split = all(split_dim(f"{blk}attn/{p}_proj/kernel") == 2
                     for p in "qkv") and \
        split_dim(f"{blk}attn/o_proj/kernel") == 1
    if attn_split and H % size == 0:
        # every rank's split must hold, or every rank keeps attention whole
        kv = [_kv_span(H, cfg.kv_heads, _split(H, size, r))
              for r in range(size)]
        if all(kv):
            spans = kv
    ins = ("up", "gate") if cfg.activation == "swiglu" else ("up",)
    ffn = all(split_dim(f"{blk}mlp/{p}_proj/kernel") == 2 for p in ins) and \
        split_dim(f"{blk}mlp/down_proj/kernel") == 1
    hidden = int(cfg.mlp_ratio * cfg.n_embd)
    return [TPPlan(size, r,
                   _split(cfg.vocab_size, size, r) if vocab else None,
                   _split(cfg.vocab_size, size, r) if head else None,
                   _split(H, size, r) if spans[r] else None, spans[r],
                   _split(hidden, size, r) if ffn else None)
            for r in range(size)]


def tp_plan(model: nn.Module, rules: ShardingRules, mesh: Any = None
            ) -> TPPlan:
    """This rank's :class:`TPPlan` (:func:`tp_plans`)."""
    mesh = mesh if mesh is not None else mesh_mod.get_mesh()
    plans = tp_plans(model, rules, mesh)
    return plans[mesh.axis_rank(MODEL_AXIS) if len(plans) > 1 else 0]


def head_dim_of(model: nn.Module) -> int:
    cfg = model.config
    return cfg.n_embd // cfg.n_head


def shard_tensor(plan: TPPlan, key: str, t: torch.Tensor,
                 head_dim: int) -> torch.Tensor:
    """This rank's part of the full tensor ``t`` named ``key`` (a view
    where it is one slice, the pieces' concatenation where it is more,
    ``t`` itself where it stays whole)."""
    got = plan.pieces(key, head_dim)
    if got is None:
        return t
    dim, spans = got
    parts = [t.narrow(dim, lo, hi - lo) for lo, hi in spans]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def local_shapes(plan: TPPlan, shapes: Mapping[str, Sequence[int]],
                 head_dim: int) -> Dict[str, Tuple[int, ...]]:
    """Each full parameter shape of ``shapes`` as this rank holds it under
    ``plan`` (what ``ZeroShardingPolicy.bytes_at_rest`` partitions over the
    data group at a ``(data, model)`` mesh)."""
    out = {}
    for key, shape in shapes.items():
        shape = list(shape)
        got = plan.pieces(key, head_dim)
        if got is not None:
            dim, spans = got
            shape[dim] = sum(hi - lo for lo, hi in spans)
        out[key] = tuple(shape)
    return out


def shard_state_dict(plan: TPPlan, state_dict: Mapping[str, torch.Tensor],
                     head_dim: int) -> Dict[str, torch.Tensor]:
    """This rank's slice of a full state dict by ``plan``: each cut tensor
    a contiguous copy of its pieces, every other tensor a copy, so nothing
    keeps the full tensors alive."""
    return {key: shard_tensor(plan, key, t, head_dim).detach().clone(
        memory_format=torch.contiguous_format)
        for key, t in state_dict.items()}


def gather_tensor(plans: Sequence[TPPlan], key: str, t: torch.Tensor,
                  head_dim: int, group: str = MODEL_AXIS) -> torch.Tensor:
    """The whole tensor ``key`` from every rank's part ``t`` (the inverse
    of :func:`shard_tensor`): one all-gather over the model group where
    the plans cut it (every rank of the group calls it for the same keys
    in the same order), ``t`` itself where it stays whole."""
    from .. import comm

    mine = plans[0].pieces(key, head_dim)
    if mine is None:
        return t
    dim = mine[0]
    parts = comm.all_gather_into_tensor(t.contiguous(), group=group,
                                        tiled=False)
    shape = list(t.shape)
    shape[dim] = max(hi for p in plans
                     for _, hi in p.pieces(key, head_dim)[1])
    full = t.new_empty(shape)
    for plan, part in zip(plans, parts.unbind(0)):
        at = 0
        for lo, hi in plan.pieces(key, head_dim)[1]:
            full.narrow(dim, lo, hi - lo).copy_(
                part.narrow(dim, at, hi - lo))
            at += hi - lo
    return full


def tp_copies(plans: Sequence[TPPlan], rank: int, key: str,
              head_dim: int) -> int:
    """How many ranks of the group hold what rank ``rank`` holds of
    ``key``: the group's size for a whole tensor, 1 for a slice no other
    rank holds, more for a KV head that several ranks' query heads read
    (the gradient norm counts such a tensor once)."""
    mine = plans[rank].pieces(key, head_dim)
    return sum(p.pieces(key, head_dim) == mine for p in plans)


def _swap_block(block: nn.Module, plan: TPPlan, cfg, group: str,
                fk: dict) -> None:
    attn, mlp, D, C = block.attn, block.mlp, cfg.head_dim, cfg.n_embd
    col, row = nn.Linear, RowParallelLinear
    if cfg.int8_weights:
        q8 = dict(kernel_mode=cfg.int8_kernel)

        def col(i, o, bias, **kw):
            return QuantDense(i, o, bias, **q8, **kw)

        def row(i, o, bias, group, **kw):
            return RowParallelQuantDense(i, o, bias, group, **q8, **kw)
    if plan.q_heads:
        (qlo, qhi), (klo, khi) = plan.q_heads, plan.kv_heads
        bias = cfg.qkv_bias
        attn.q_proj = col(C, (qhi - qlo) * D, bias, **fk)
        if (khi - klo) * plan.size > cfg.kv_heads and not cfg.int8_weights:
            # ranks whose query heads read one KV head each hold it
            kv = dict(span=(klo * D, khi * D), total=cfg.kv_heads * D,
                      group=group)
            attn.k_proj = SharedHeadsLinear(C, (khi - klo) * D, bias, **kv,
                                            **fk)
            attn.v_proj = SharedHeadsLinear(C, (khi - klo) * D, bias, **kv,
                                            **fk)
        else:
            attn.k_proj = col(C, (khi - klo) * D, bias, **fk)
            attn.v_proj = col(C, (khi - klo) * D, bias, **fk)
        attn.o_proj = row((qhi - qlo) * D, C, bias, group, **fk)
        attn.heads, attn.kv_heads, attn.group = qhi - qlo, khi - klo, group
        if cfg.pos_emb == "alibi":
            attn.alibi = attn.alibi[qlo:qhi].clone()
    if plan.ffn:
        lo, hi = plan.ffn
        bias = cfg.mlp_bias
        if cfg.activation == "swiglu":
            mlp.gate_proj = col(C, hi - lo, bias, **fk)
        mlp.up_proj = col(C, hi - lo, bias, **fk)
        mlp.down_proj = row(hi - lo, C, bias, group, **fk)
        mlp.group = group


def _swap_gpt2_block(block: nn.Module, plan: TPPlan, cfg, group: str,
                     fk: dict) -> None:
    attn, mlp, C = block.attn, block.mlp, cfg.n_embd
    if plan.q_heads:
        lo, hi = plan.q_heads
        w = (hi - lo) * (C // cfg.n_head)
        attn.qkv = nn.Linear(C, 3 * w, **fk)
        attn.proj = RowParallelLinear(w, C, True, group, **fk)
        attn.heads, attn.group = hi - lo, group
    if plan.ffn:
        lo, hi = plan.ffn
        mlp.fc = nn.Linear(C, hi - lo, **fk)
        mlp.proj = RowParallelLinear(hi - lo, C, True, group, **fk)
        mlp.group = group


def apply_tensor_parallel(model: nn.Module, rules: ShardingRules,
                          mesh: Any = None,
                          state_dict: Optional[Mapping[str, torch.Tensor]]
                          = None, plan: Optional[TPPlan] = None) -> TPPlan:
    """Carry ``rules`` out on this rank of the mesh's model group: swap
    ``model``'s layers for the parallel ones of its :class:`TPPlan`
    (``plan``, default :func:`tp_plan`'s) and load this rank's slice of
    ``state_dict`` (default: the model's own, full, weights) into it, in
    place and on the model's device, each slice in its full tensor's
    dtype. A ``TransformerLM`` (``int8_weights`` too: its int8 weights
    and scales are sliced as the plan says) or a ``GPT2LMHeadModel`` is
    taken above one rank."""
    from ..models.gpt2 import GPT2LMHeadModel
    from ..models.transformer_lm import TransformerLM

    mesh = mesh if mesh is not None else mesh_mod.get_mesh()
    if mesh.axis_size(MODEL_AXIS) == 1:
        if state_dict is not None:
            model.load_state_dict(state_dict)
        return TPPlan(1, 0)
    gpt2 = isinstance(model, GPT2LMHeadModel)
    if not gpt2 and not isinstance(model, TransformerLM):
        raise NotImplementedError(
            f"tensor-parallel injection is ported for TransformerLM and "
            f"GPT2LMHeadModel, not {type(model).__name__}")
    cfg = model.config
    plan = plan if plan is not None else tp_plan(model, rules, mesh)
    full = state_dict if state_dict is not None else model.state_dict()
    local = shard_state_dict(plan, full, head_dim_of(model))
    del full
    group = MODEL_AXIS
    # built on meta: load_state_dict(assign=True) puts the slices in, each
    # in its own dtype (a GPT-2 may hold fp32 weights for a bf16 forward)
    fk = dict(device="meta", dtype=next(model.parameters()).dtype)
    C = cfg.n_embd
    if gpt2:
        if plan.vocab:
            lo, hi = plan.vocab
            model.wte = VocabParallelEmbedding(hi - lo, C, lo, group, **fk)
        for block in model.blocks:
            _swap_gpt2_block(block, plan, cfg, group, fk)
    else:
        if plan.vocab:
            lo, hi = plan.vocab
            model.embed_tokens = VocabParallelEmbedding(hi - lo, C, lo, group,
                                                        **fk)
        if plan.head and isinstance(getattr(model, "lm_head", None),
                                    QuantDense):
            lo, hi = plan.head      # int8_head: the int8 kernel's block
            model.lm_head = VocabParallelQuantHead(
                hi - lo, C, group, kernel_mode=cfg.int8_kernel,
                device="meta")
        elif plan.head:
            lo, hi = plan.head
            tied = model.embed_tokens if cfg.tie_word_embeddings else None
            model.lm_head = VocabParallelHead(hi - lo, C, tied, group, **fk)
        for block in model.blocks:
            _swap_block(block, plan, cfg, group, fk)
    model.load_state_dict(local, assign=True)
    return plan
