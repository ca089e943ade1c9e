"""Inference engine (port of ``deepspeed_tpu/inference/engine.py``).

The JAX engine compiles its programs with ``jax.jit``; PyTorch runs
eagerly, so each program here is a plain method: ``prefill_at`` (the
serving path's bucketed prefill, projecting one position),
``prefill_chunk`` (one chunk of a long prompt into a slot's cache row),
``decode`` (one token per row against a cache updated in place),
``decode_paged`` (the same over a page pool), ``verify_k`` (speculative
verification of K draft tokens a row), ``sample`` and ``generate``. The
model is moved to the engine's device once; its parameters are already in
the config dtype (the engine checks), as the JAX engine's
``_finalize_params`` casts them.

With ``enable_cuda_graph`` the decode step is what the JAX engine's
whole-step ``jax.jit`` makes it, one program: ``decode``, ``decode_paged``,
``verify_k``'s forward and ``generate()``'s loop replay a step captured in
a CUDA graph per
signature (``decode_graph.DecodeGraphs``, :attr:`InferenceEngine.
decode_graphs`), and ``generate()`` prefills into a static cache the
signature owns and replays one step per token with no host sync between
tokens (the counterpart of the JAX ``_compile_decode_scan``). A step that
cannot be captured raises; on a CUDA engine no decode step then runs
eagerly. On a CPU engine the same static-buffer step runs eagerly. Prefill
(whole-prompt and chunked) stays eager.

Weight-only int8 (``dtype="int8"`` or ``quant.enabled`` with 8 bits) on a
``TransformerLM`` in bf16 on one device is the JAX engine's int8 COMPUTE
tier: every projection named in ``DENSE_KEYS`` (the vocabulary head only
with ``int8_head``) is swapped, in place and on the device, for a
``QuantDense`` running the CUDA ``int8_matmul`` kernel, and the model's
config becomes ``int8_weights=True``. Every other quantized case (fp32 or
fp16, ``bits != 8``, a module that is not a ``TransformerLM``, an
``int8_weights`` model) is the JAX engine's int8 STORAGE tier
(``_maybe_quantize``/``_dequant`` there): every floating leaf of rank >= 2
of the JAX parameter tree, the embeddings included, is stored as int8 with
one fp32 scale per group (``quant.group_size`` elements of the flattened
leaf, or one group when the size does not divide) and dequantized to the
compute dtype at each use by a parametrization of the module that owns it
(:class:`GroupDequant`), so one weight at a time is live in the compute
dtype, and the dequantization records inside a captured decode step. No
Pallas kernel exists for it in the JAX package, and it runs on stock torch
ops here.

The groups are those of the JAX leaf, which has another layout: an
``nn.Linear`` weight (out, in) is the flax Dense kernel (in, out)
transposed (the weight bridge's rule, ``checkpoint/flax_import.py``), and
the blocks of a model with a ``blocks`` list are one scanned leaf with a
leading layer axis, so a block's biases and norm scales are leaves of rank
2 there and a group may span layers (one group spans them all). Each
parameter is quantized as the JAX leaf it belongs to, its int8 values
stored in the torch layout beside the scales of the groups it touches; the
dequantized weight then equals the JAX ``_dequant`` output, through the
bridge, bit for bit. A module without ``blocks`` is grouped parameter by
parameter (the Linear rule still holds). In an ``int8_weights`` model the
projections are int8 already and stay as they are, their per-channel
scales in fp32 (the JAX tier requantizes its scale rows, padded to 128
lanes, which the port does not store); its embeddings and norms are
quantized.

A module with no ``logits`` method runs through :meth:`InferenceEngine.
forward` as a plain call (the JAX ``_generic_forward``).

Tensor parallelism (``tensor_parallel.tp_size`` / ``mp_size`` N > 1, or a
``mesh`` whose ``model`` axis is N): the engine runs on every rank of a
model group of N ranks, each with the same inputs (SPMD). The sharding
rules come from ``module_inject.replace_module`` (the caller's
``injection_policy``, the family's rules, or AutoTP), as in the JAX engine
(``engine.py:84-90,127-150``), and ``module_inject.apply_tensor_parallel``
carries them out before the model reaches the card: the layers are
swapped for column-, row- and vocab-parallel ones and the full weights
(``model_parameters``, or the model's own, on the host) are sliced for
this rank, so each rank's card holds 1/N of every sharded weight and of
the KV heads (``kv_cache_spec``). The head gathers the whole vocabulary on
every rank, so sampling, ``generate()`` and a server's decisions are the
same on every rank. A ``mesh`` with ``data`` D > 1 beside ``model`` N > 1
(ranks data-major, the model axis innermost, as the JAX mesh) gives each
data rank its own model group (:attr:`InferenceEngine.dp_world_size`,
:attr:`~InferenceEngine.dp_rank`); a server spreads its contiguous slots
over them (``serving/model_group.py``).

Above one rank the int8 tier is the STORAGE tier, as the JAX engine keeps
its compute tier to one device (JAX ``engine.py:189-198``): each leaf is
quantized whole on the host with the JAX grouping (the full weights, as
above), then each rank keeps its shard of the int8 values and the scales
of the groups its elements fall in (both groups where a shard boundary
cuts one), so every element dequantizes to the JAX ``_dequant`` value and
a rank's weight bytes at rest are about 1/N of one rank's
(:func:`storage_dequant`: :class:`GroupDequant`, a reshape against the
scales, where the shard is one run of the flattened leaf or its cut runs
along whole groups; :class:`ShardDequant`, which indexes each element's
group, only where the cut breaks groups). An ``int8_weights`` model is
sliced as it is: ``QuantDense`` weights and per-channel scales with their output channels
where the columns are cut, the scales whole where the input features are
(``module_inject.layers.RowParallelQuantDense``: the per-rank
``int8_matmul`` products summed, the bias once after the sum).

Above one rank these raise ``NotImplementedError``: ``enable_cuda_graph``
(the port runs a model group as gloo processes on one card, whose
collectives run on the host and cannot be captured; NCCL capture needs a
card per rank), a truthy ``zero`` config (ZeRO-Inference: the JAX package
streams its layers to one device too and never reads ``zero`` in its
engine), and any module but a ``TransformerLM`` or a ``GPT2LMHeadModel``
(whose fused qkv splits per head; it has ``logits``, so ``forward``, and
no cache, in both packages).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from .. import comm
from ..accelerator import resolve_device
from ..module_inject import (TPPlan, apply_tensor_parallel, head_dim_of,
                             replace_module, shard_tensor)
from ..module_inject.layers import VocabParallelHead
from ..ops.quantization.convert import DENSE_KEYS, quantize_lm_params
from ..parallel import mesh as mesh_mod
from ..runtime.weight_quantizer import WeightQuantization
from ..utils.logging import log_dist
from .config import DeepSpeedInferenceConfig
from .decode_graph import DecodeGraphs


def _filter_logits(last, temperature: float, top_k: int, top_p: float):
    """Temperature/top-k/top-p filtering of fp32 logits (..., V); masked
    entries become -1e30."""
    V = last.shape[-1]
    scaled = last / max(float(temperature), 1e-6)
    top_k = min(int(top_k), V)
    if top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[..., -top_k][..., None]
        scaled = torch.where(scaled < kth, torch.full_like(scaled, -1e30),
                             scaled)
    if top_p < 1.0:
        sorted_ = torch.sort(scaled, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_, dim=-1), dim=-1)
        # smallest prefix with mass >= top_p
        cutoff_idx = (cum < top_p).sum(dim=-1).clamp(max=V - 1)
        cutoff = torch.gather(sorted_, -1, cutoff_idx[..., None])
        scaled = torch.where(scaled < cutoff, torch.full_like(scaled, -1e30),
                             scaled)
    return scaled


class GroupDequant(nn.Module):
    """The storage tier's parametrization of one weight: its int8 values,
    read in the JAX leaf's order (transposed for an ``nn.Linear`` weight),
    fall in runs of ``group_len`` values of a leaf quantized in groups of
    ``group_len``, the first run starting ``offset`` values before the
    weight's first, and each run in one group: ``scale`` (k, 1) holds the
    k runs' scales in order (one row: one scale for every value). Each
    value times its group's scale, in fp32, then the compute dtype (the
    JAX ``_dequant``: the same products, so the same bits)."""

    def __init__(self, scale: torch.Tensor, offset: int, group_len: int,
                 transposed: bool, dtype: torch.dtype):
        super().__init__()
        self.register_buffer("scale", scale)
        self.offset, self.group_len = int(offset), int(group_len)
        self.transposed = transposed
        self.dtype = dtype

    def forward(self, q):
        src = q.t() if self.transposed else q
        flat = src.float().reshape(-1)
        n = flat.numel()
        if self.scale.shape[0] == 1:
            flat = flat * self.scale[0]
        elif self.offset == 0 and n % self.group_len == 0:
            flat = flat.reshape(-1, self.group_len) * self.scale
        else:       # groups that straddle this weight's ends
            idx = (torch.arange(n, device=flat.device) + self.offset) \
                // self.group_len
            flat = flat * self.scale[idx, 0]
        w = flat.reshape(src.shape).to(self.dtype)
        return w.t() if self.transposed else w


def shard_places(shape, dim: int, spans, device=None) -> torch.Tensor:
    """Each element's place in a flattened tensor of ``shape`` whose shard
    holds along axis ``dim`` the elements ``spans`` (each ``[lo, hi)``,
    concatenated) and along the others all of them: int64, the shard's
    shape."""
    place = torch.zeros((), dtype=torch.int64, device=device)
    for k, size in enumerate(shape):
        ix = torch.cat([torch.arange(lo, hi, device=device)
                        for lo, hi in spans]) if k == dim \
            else torch.arange(size, device=device)
        place = place + (ix * int(np.prod(shape[k + 1:]))).view(
            [-1 if j == k else 1 for j in range(len(shape))])
    return place


class ShardDequant(nn.Module):
    """The storage tier's parametrization of a rank's shard of a weight:
    the shard, read in the JAX leaf's order (shape ``shape`` there), holds
    along axis ``dim`` the whole weight's elements ``spans`` (each
    ``[lo, hi)``, concatenated) and along the others all of them, so an
    element's place in the flattened leaf is ``base + Σ index_k·stride_k``
    and its group that over ``group_len``. ``scale`` holds the groups the
    shard touches: groups ``g0 ..`` when they run unbroken, else those of
    the sorted ``gids``. Each value times its group's scale in fp32, then
    the compute dtype: the JAX ``_dequant``'s products, so the same
    bits."""

    def __init__(self, scale: torch.Tensor, gids, g0: int, shape, dim: int,
                 spans, base: int, group_len: int, transposed: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.register_buffer("scale", scale)
        self.register_buffer("gids", gids)
        self.g0, self.shape, self.dim = int(g0), tuple(shape), int(dim)
        self.spans = [tuple(map(int, sp)) for sp in spans]
        self.base, self.group_len = int(base), int(group_len)
        self.transposed, self.dtype = transposed, dtype

    def forward(self, q):
        src = q.t() if self.transposed else q
        gid = (self.base + shard_places(self.shape, self.dim, self.spans,
                                        q.device)) // self.group_len
        pos = gid - self.g0 if self.gids is None else \
            torch.searchsorted(self.gids, gid.to(self.gids.dtype))
        w = (src.float() * self.scale[pos]).to(self.dtype)
        return w.t() if self.transposed else w


def storage_dequant(scale: np.ndarray, base: int, shape, dim: int, spans,
                    group_len: int, transposed: bool,
                    dtype: torch.dtype) -> nn.Module:
    """The storage tier's parametrization of one weight whose int8 values
    are the elements ``spans`` along axis ``dim`` (all of them along the
    others) of a tensor of JAX-layout ``shape``, which starts at element
    ``base`` of a leaf quantized in groups of ``group_len`` with
    ``scale`` (groups, 1): a :class:`GroupDequant` where the weight is one
    run of the flattened leaf (a whole weight, a cut along the first axis)
    or every ``group_len`` values of it fall in one group (a column cut
    along whole groups), a :class:`ShardDequant` only where a cut breaks
    the groups."""
    inner = int(np.prod(shape[dim + 1:]))
    if dim == 0 and len(spans) == 1:
        lo = base + spans[0][0] * inner
        g0, g1 = lo // group_len, (base + spans[0][1] * inner - 1) \
            // group_len
        return GroupDequant(torch.from_numpy(scale[g0:g1 + 1]),
                            lo - g0 * group_len, group_len, transposed,
                            dtype)
    gid = ((base + shard_places(shape, dim, spans).numpy()) // group_len) \
        .reshape(-1)
    if gid.size % group_len == 0:
        runs = gid.reshape(-1, group_len)
        if (runs == runs[:, :1]).all():
            return GroupDequant(torch.from_numpy(scale[runs[:, 0]]), 0,
                                group_len, transposed, dtype)
    gids = np.unique(gid)
    if len(gids) == 1:
        return GroupDequant(torch.from_numpy(scale[gids]), 0, group_len,
                            transposed, dtype)
    unbroken = gids[-1] - gids[0] + 1 == len(gids)
    idt = torch.int32 if gids[-1] < 2 ** 31 else torch.int64
    return ShardDequant(
        torch.from_numpy(scale[gids, 0]),
        None if unbroken else torch.from_numpy(gids).to(idt),
        int(gids[0]), shape, dim, spans, base, group_len, transposed, dtype)


def _storage_leaves(module: nn.Module) -> Dict[str, list]:
    """The JAX parameter tree's leaves as lists of (owner module, name,
    parameter, state-dict key): a ``blocks`` list's parameters stacked by
    name over its layers (keys ``blocks.*.``), every other parameter
    alone."""
    blocks = getattr(module, "blocks", None)
    stacked = isinstance(blocks, nn.ModuleList) and len(blocks) > 0
    skip = set(map(id, blocks.parameters())) if stacked else set()
    leaves: Dict[str, list] = {}
    for path, mod in module.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            if id(p) not in skip:
                key = f"{path}.{name}" if path else name
                leaves[key] = [(mod, name, p, key)]
    if stacked:
        for path, mod in blocks[0].named_modules():
            for name, _ in mod.named_parameters(recurse=False):
                sub = f"{path}.{name}" if path else name
                leaves[f"blocks.*.{sub}"] = [
                    (blk.get_submodule(path), name,
                     getattr(blk.get_submodule(path), name),
                     f"blocks.{li}.{sub}")
                    for li, blk in enumerate(blocks)]
    return leaves


class InferenceEngine:
    """Construct via :func:`deepspeed_tpu_torch.init_inference`.

    ``model`` is the port's ``TransformerLM`` (or any module with the same
    ``prefill_last``/``decode``/``logits``/``kv_cache_spec`` surface);
    ``model_parameters`` an optional state dict to load into it (for example
    from ``checkpoint.flax_import.state_dict_from_flax``). ``device``
    defaults to ``cuda``; the CPU runs only when asked for. ``mesh`` (a
    ``parallel.ProcessMesh``) fixes the mesh; else a ``tp_size`` N > 1
    builds one with ``model`` N over the world (module docstring).
    """

    def __init__(self, model: nn.Module = None,
                 config: Union[Dict, DeepSpeedInferenceConfig, None] = None,
                 model_parameters: Optional[Dict[str, torch.Tensor]] = None,
                 device: Union[str, torch.device, None] = None, mesh=None,
                 **kwargs):
        if isinstance(config, DeepSpeedInferenceConfig):
            if kwargs:
                raise ValueError(f"pass either a config object or keys, not "
                                 f"both: {sorted(kwargs)}")
            self._config = config
        else:
            self._config = DeepSpeedInferenceConfig.from_dict(
                {**dict(config or {}), **kwargs})
        if not isinstance(model, nn.Module):
            raise ValueError("init_inference needs the port's TransformerLM "
                             "(a torch.nn.Module) as model=")
        self.device = resolve_device(device)
        self.dtype = self._config.torch_dtype()
        model_dtype = getattr(getattr(model, "config", None), "dtype", None)
        if model_dtype is not None and model_dtype != self.dtype:
            raise ValueError(
                f"config dtype {self.dtype} differs from the model config's "
                f"{model_dtype}: the port computes in the parameters' dtype, "
                f"so build the model with dtype={self.dtype}")
        self._init_mesh(mesh)
        # the storage tier above one rank groups each leaf whole: the full
        # weights on the host (references, not copies)
        full = None
        if self.mp_world_size > 1:
            rules = replace_module(
                model, tp_size=self.mp_world_size,
                injection_policy=self._config.injection_policy)
            self._refuse_above_one_rank()
            if self._config.quant_enabled:
                full = (model_parameters if model_parameters is not None
                        else model.state_dict())
            # swapped and sliced on the host, before the card sees it
            self.tp_plan = apply_tensor_parallel(model, rules, self.mesh,
                                                 model_parameters)
        else:
            self.tp_plan = TPPlan(1, 0)
            if model_parameters is not None:
                model.load_state_dict(model_parameters)
        # a TransformerLM's parameters are in its config dtype already; a
        # cast would also reach an int8 model's fp32 scales
        self.module = (model.to(device=self.device) if model_dtype is not None
                       else model.to(device=self.device, dtype=self.dtype))
        self.module.eval()
        if self._config.quant_enabled:
            if self._use_int8_compute():
                self._quantize_structured()
            else:
                self._quantize_storage(full)
        del full
        # the decode steps captured so far (enable_cuda_graph), else None
        self.decode_graphs = (DecodeGraphs(self.module, self.device)
                              if self._config.enable_cuda_graph else None)
        log_dist(f"InferenceEngine: device={self.device} "
                 f"dtype={self._config.dtype} tp={self.mp_world_size} "
                 f"cuda_graph={self.decode_graphs is not None}", ranks=[0])

    def _init_mesh(self, mesh) -> None:
        """The mesh and ``mp_world_size`` (the JAX engine's rule: a given
        mesh is installed; else a ``tp_size`` above 1 builds one with that
        ``model`` axis over the world; else an installed mesh is read). A
        one-rank engine with neither touches no global state."""
        mp = self._config.mp_size
        if mesh is not None or mp > 1:
            comm.init_distributed(verbose=False, device=self.device)
        if mesh is not None:
            mesh_mod.set_mesh(mesh)
        elif mp > 1 and (not mesh_mod.has_mesh() or
                         mesh_mod.get_model_parallel_world_size() != mp or
                         mesh_mod.get_mesh().size != comm.get_world_size()):
            mesh_mod.initialize_mesh(model=mp)
        self.mesh = mesh_mod.get_mesh() if mesh_mod.has_mesh() else None
        self.mp_world_size = mesh_mod.get_model_parallel_world_size() \
            if self.mesh is not None else 1
        # the data ranks beside a model group above one rank, each with
        # its own model group (the serving slots spread over them)
        tp = self.mp_world_size > 1
        self.dp_world_size = mesh_mod.get_data_parallel_world_size() \
            if tp else 1
        self.dp_rank = mesh_mod.get_data_parallel_rank() if tp else 0

    def _refuse_above_one_rank(self) -> None:
        """What a model group above one rank does not run (module
        docstring)."""
        n = self.mp_world_size
        if self._config.enable_cuda_graph:
            raise NotImplementedError(
                f"enable_cuda_graph over a model group of {n} ranks: the "
                f"port runs a model group as gloo processes sharing one "
                f"card, whose collectives run on the host and cannot be "
                f"captured in a CUDA graph; NCCL capture needs a card per "
                f"rank")
        if self._config.zero:
            raise NotImplementedError(
                f"ZeRO-Inference over a model group of {n} ranks: the JAX "
                f"package streams its layers to one device too "
                f"(ZeroInferenceEngine) and its InferenceEngine never reads "
                f"zero; run ZeroInferenceEngine on one rank")

    # ------------------------------------------------------------------
    # int8 compute tier (JAX engine.py:189-219)
    # ------------------------------------------------------------------
    def _use_int8_compute(self) -> bool:
        cfg = getattr(self.module, "config", None)
        return (self._config.quant_enabled
                and int(self._config.quant["bits"]) == 8
                and self.mp_world_size == 1
                and self.dtype == torch.bfloat16
                and hasattr(self.module, "replace_config")
                and not cfg.int8_weights)

    def _quantize_structured(self) -> None:
        """Swap the model's projections for QuantDense in place (the head
        only with ``int8_head``) and mark its config ``int8_weights``; the
        config's ``int8_kernel`` reaches the new layers through
        ``replace_config``."""
        cfg = self.module.config
        head = set() if cfg.int8_head else {"lm_head"}
        _, n_dense = quantize_lm_params(self.module, DENSE_KEYS - head)
        self.module.replace_config(int8_weights=True)
        log_dist(f"inference int8 compute tier: {n_dense} linear layers -> "
                 f"QuantDense (CUDA int8_matmul)", ranks=[0])

    # ------------------------------------------------------------------
    # int8 storage tier (JAX engine.py:221-262)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _quantize_storage(self, full=None) -> None:
        """Store every floating JAX leaf of rank >= 2 as int8 + per-group
        fp32 scales, quantized whole on the host with
        ``WeightQuantization`` as the JAX engine does (stacked over the
        layers for ``blocks.*``, flattened in the JAX layout), and
        dequantized at each use through a parametrization (module
        docstring, :func:`storage_dequant`). Above one rank ``full`` holds
        the whole weights, and each layer keeps its shard of the int8
        values (``shard_tensor``, as the weights were cut)."""
        qcfg = self._config.quant
        gs = int(qcfg["group_size"])
        wq = WeightQuantization(num_bits=int(qcfg["bits"]))
        plan = self.tp_plan
        hd = head_dim_of(self.module) if self.mp_world_size > 1 else 0
        n_leaves = 0
        for key, parts in _storage_leaves(self.module).items():
            p0 = parts[0][2]
            stacked = key.startswith("blocks.*.")
            if not p0.is_floating_point() or p0.dim() + stacked < 2:
                continue
            transposed = isinstance(parts[0][0], (nn.Linear,
                                                  VocabParallelHead)) \
                and parts[0][1] == "weight"
            n_leaves += 1
            # the values the module holds: the full weights in its dtype
            src = np.stack([
                (w.t() if transposed else w).detach().to(p0.dtype).float()
                .cpu().numpy()
                for w in (full[k] if full is not None else p
                          for _, _, p, k in parts)])
            groups = src.size // gs if gs and src.size % gs == 0 else 1
            q, scale = wq.quantize_value(src, groups)
            jshape = src.shape[1:]
            cut = plan.pieces(parts[0][3], hd)
            if cut is None:
                dim, spans = 0, ((0, jshape[0]),)
            else:                       # the cut axis in the JAX layout
                dim, spans = cut
                dim = src.ndim - 2 - dim if transposed else dim
            for li, (mod, name, p, key) in enumerate(parts):
                ql = torch.from_numpy(np.ascontiguousarray(
                    q[li].T if transposed else q[li]))
                ql = shard_tensor(plan, key, ql, hd).contiguous()
                dq = storage_dequant(scale, li * src[0].size, jshape, dim,
                                     spans, src.size // groups, transposed,
                                     self.dtype)
                setattr(mod, name, nn.Parameter(ql.to(p.device),
                                                requires_grad=False))
                parametrize.register_parametrization(
                    mod, name, dq.to(p.device), unsafe=True)
        log_dist(f"inference weight quantization: int{qcfg['bits']}, "
                 f"{n_leaves} kernels, group_size={gs}", ranks=[0])

    # ------------------------------------------------------------------
    def kv_cache_spec(self):
        """The served module's KV-cache contract, or None for a module
        that declares none (the JAX engine's answer for foreign
        modules)."""
        spec_fn = getattr(self.module, "kv_cache_spec", None)
        return spec_fn() if callable(spec_fn) else None

    def _ids(self, input_ids) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(input_ids) if not
                              torch.is_tensor(input_ids) else input_ids)
        ids = ids.to(self.device, torch.long)
        return ids[None] if ids.dim() == 1 else ids

    @torch.no_grad()
    def forward(self, input_ids, *args, **kwargs):
        """Full-context (B, T, V) fp32 logits, no cache (the JAX engine's
        ``forward`` for LM modules). A module with no ``logits`` method is
        called with the arguments as given, tensors and arrays moved to
        the engine's device (the JAX ``_generic_forward``)."""
        if not hasattr(self.module, "logits"):
            def dev(a):
                if torch.is_tensor(a) or isinstance(a, np.ndarray):
                    return torch.as_tensor(a).to(self.device)
                return a
            return self.module(*map(dev, (input_ids,) + args),
                               **{k: dev(v) for k, v in kwargs.items()})
        return self.module.logits(self._ids(input_ids))

    __call__ = forward

    @torch.no_grad()
    def prefill_at(self, input_ids, last_pos=None, cache=None, rows=None):
        """Prefill ``input_ids`` (B, T) into ``cache`` rows ``rows`` (a new
        cache when None) and project position ``last_pos`` (T-1 when None):
        returns ((B, 1, V) fp32 logits, cache)."""
        if rows is not None:
            rows = torch.as_tensor(rows, device=self.device).long()
        return self.module.prefill_last(self._ids(input_ids), last_pos,
                                        cache, rows)

    @torch.no_grad()
    def prefill_chunk(self, cache, input_ids, slot, start, last_idx):
        """One fixed-width prefill chunk (1, C), right-padded, into row
        ``slot`` of the slot-pooled ``cache`` at offset ``start``
        (updated in place), projecting chunk position ``last_idx``:
        returns (1, 1, V) fp32 logits. The caller records the slot's new
        length (``start`` + the chunk's true token count)."""
        rows = torch.as_tensor([slot], device=self.device).long()
        return self.module.prefill_chunk(self._ids(input_ids), [start],
                                         last_idx, cache, rows)

    def _pos(self, pos):
        """Decode positions as an int or a tensor on the engine's device."""
        if isinstance(pos, (int, np.integer)):
            return int(pos)
        return torch.as_tensor(pos).to(self.device)

    def _decode(self, cache, tokens, pos) -> torch.Tensor:
        """The contiguous decode forward of ``tokens`` (B, T) long on the
        device: replayed (the graph's static logits) or eager."""
        if self.decode_graphs is not None:
            return self.decode_graphs.run("contiguous", cache, tokens,
                                          self._pos(pos))
        return self.module.decode(tokens, pos, cache)

    @torch.no_grad()
    def decode(self, cache, tokens, pos) -> torch.Tensor:
        """One token per row: ``tokens`` (B, 1), ``pos`` the current cache
        lengths (int or (B,)). Writes ``cache`` in place; returns (B, 1, V)
        fp32 logits. With ``enable_cuda_graph`` the step replays the one
        captured for this signature and cache."""
        logits = self._decode(cache, self._ids(tokens), pos)
        return logits.clone() if self.decode_graphs is not None else logits

    @torch.no_grad()
    def verify_k(self, cache, tokens, pos, draft, draft_len,
                 generator: Optional[torch.Generator], temperature: float,
                 greedy: bool, top_k: int, top_p: float):
        """Speculative verification on a contiguous cache: score K draft
        positions for every row in ONE (B, K+1) forward, then accept
        (greedy accept-prefix, or lossless rejection sampling under the
        serving sampler's filtered distribution when not ``greedy``,
        drawing from ``generator``; ``serving/spec_decode/verify.py``).

        ``tokens`` (B, K+1): [current token, draft_0 .. draft_{K-1}] per
        row; ``pos`` (B,) per-slot cache offsets; ``draft`` (B, K);
        ``draft_len`` (B,) in [0, K] (0: a plain decode step for that row;
        dead slots ride along so). The forward is ``TransformerLM.decode``
        with T = K+1, the window-masked attention the JAX chunked decode
        runs (no kernel there either), and with ``enable_cuda_graph`` it
        replays the step captured for this signature and cache; acceptance
        runs after it, outside the graph. ``cache`` comes back with all K+1
        positions written for every row (a position past the allocation is
        dropped); the caller rolls back the rejected ones through the
        per-slot lengths (``SlotPool.advance``).

        Returns ``(out (B, K+1) long, n_emit (B,) long)``: row ``i`` emits
        ``out[i, :n_emit[i]]``, the accepted prefix plus the bonus or
        correction token (``n_emit >= 1``)."""
        from ..serving.spec_decode.verify import make_verify_fn

        tokens = self._ids(tokens)
        if tokens.shape[1] < 2:
            raise ValueError(f"verify_k wants (B, K+1) tokens with K >= 1, "
                             f"got {tuple(tokens.shape)}")
        verify = make_verify_fn(self._decode, _filter_logits)
        return verify(cache, tokens, pos, torch.as_tensor(draft),
                      torch.as_tensor(draft_len), generator, temperature,
                      greedy, top_k, top_p)

    @torch.no_grad()
    def decode_paged(self, pages, tokens, pos, table,
                     scratch_page: bool = False) -> torch.Tensor:
        """:meth:`decode` over a page pool (``KVCacheSpec.paged_cache``)
        through the (B, pages_per_slot) int32 page ``table``: the step's
        K/V rows are written into the pages in place and attention reads
        them there. ``scratch_page``: the last page is the pool's scratch
        page (``TransformerLM.decode_paged``), which a captured step needs.
        Returns (B, 1, V) fp32 logits."""
        tokens = self._ids(tokens)
        if self.decode_graphs is not None:
            if not scratch_page:
                raise ValueError(
                    "a captured paged decode step writes its dropped rows "
                    "to the pool's scratch page: pass pages allocated with "
                    "one (PagedKVPool does) and scratch_page=True")
            return self.decode_graphs.run("paged", pages, tokens,
                                          self._pos(pos), table).clone()
        return self.module.decode_paged(tokens, pos, pages, table,
                                        scratch_page)

    @torch.no_grad()
    def sample(self, logits, generator: torch.Generator, temperature: float,
               top_k: int, top_p: float, greedy: bool) -> torch.Tensor:
        """Next token per row from (B, T, V) logits' last position: argmax
        when ``greedy``, else a draw from the filtered distribution."""
        last = logits[:, -1, :].float()
        if greedy:
            return last.argmax(dim=-1)
        probs = torch.softmax(_filter_logits(last, temperature, top_k,
                                             top_p), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: Optional[float] = None,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 **kwargs: Any) -> np.ndarray:
        """Autoregressive generation with the KV cache. Returns int32
        (B, T_prompt + n_generated): prompt + new tokens, cut when every
        row has emitted ``eos_token_id``, with everything after a row's
        first eos set to eos (the JAX engine's output exactly)."""
        if kwargs:
            raise TypeError(f"unexpected generate() arguments "
                            f"{sorted(kwargs)}")
        ids = self._ids(input_ids)
        B, T = ids.shape
        if max_new_tokens <= 0:
            return ids.cpu().numpy().astype(np.int32)
        cap = self.kv_cache_spec().max_seq_len
        if T + max_new_tokens > cap:
            raise ValueError(
                f"prompt({T}) + max_new_tokens({max_new_tokens}) exceeds the "
                f"model's max_seq_len({cap}) KV-cache capacity")
        cfg = self._config
        temperature = cfg.temperature if temperature is None else temperature
        top_k = cfg.top_k if top_k is None else top_k
        top_p = cfg.top_p if top_p is None else top_p
        gen = torch.Generator(device=self.device).manual_seed(seed)
        sample = lambda lg: self.sample(  # noqa: E731
            lg, gen, temperature, top_k, top_p, not do_sample)

        graphs = self.decode_graphs
        # captured: prefill into the signature's own cache and replay one
        # step per token (static logits, sampled before the next replay)
        logits, cache = self.prefill_at(
            ids, cache=graphs.static_cache(B) if graphs is not None else None)
        token = sample(logits)
        out = [token]
        finished = np.zeros((B,), bool)
        pos = T
        for _ in range(max_new_tokens - 1):
            if graphs is not None:
                logits = graphs.run("contiguous", cache, token[:, None], pos)
            else:
                logits = self.decode(cache, token[:, None], pos)
            nxt = sample(logits)
            if eos_token_id is not None:
                finished |= token.cpu().numpy() == eos_token_id
                if finished.all():
                    break
            token = nxt
            out.append(token)
            pos += 1
        toks = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        if eos_token_id is not None:
            hit = np.cumsum(toks == eos_token_id, axis=1) > 0
            after = np.roll(hit, 1, axis=1)
            after[:, 0] = False
            toks = np.where(after, eos_token_id, toks)
        return np.concatenate([ids.cpu().numpy().astype(np.int32), toks],
                              axis=1)

    def throughput(self, input_ids,
                   max_new_tokens: int = 64) -> Dict[str, float]:
        """Decode throughput of :meth:`generate` (the JAX engine's probe):
        new tokens a second over the whole batch, and the seconds it took
        (the tokens come back to the host, so the time is the device's
        too)."""
        t0 = time.perf_counter()
        toks = self.generate(input_ids, max_new_tokens=max_new_tokens)
        dt = time.perf_counter() - t0
        n_new = toks.shape[1] - np.shape(input_ids)[-1]
        return {"tokens_per_sec": n_new * toks.shape[0] / dt, "elapsed_s": dt}
