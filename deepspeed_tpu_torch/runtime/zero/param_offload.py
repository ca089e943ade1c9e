"""ZeRO-Infinity parameter offload for TRAINING: models larger than the
card (the port of ``deepspeed_tpu/runtime/zero/param_offload.py``).

``zero_optimization.offload_param.device: "cpu" | "nvme"`` makes the engine
train through :class:`ParamOffloadRunner`. The blocks' weights live off the
card, in the compute dtype, one packed buffer a layer
(``utils/streaming.LayerWireFormat``: :class:`LayerParamStore`, in pinned
host memory or in one file a layer under ``nvme_path``), and stream through
the card twice a micro-batch; the embeddings, final norm and head stay on
it. The fp32 master and moments of EVERY parameter live in the host
optimizer (``offload.OffloadedOptimizer``, placed as
``offload_optimizer`` says, host memory by default).

A micro-batch, in PyTorch:

* forward: each layer's buffer is copied to one of ``prefetch + 2`` device
  slots on a copy stream (the staging discipline of ``inference/
  zero_inference.py``: a slot is refilled only after the compute that read
  it, a host buffer only after its last copy's event; the NVMe tier reads
  ``prefetch + 1`` layers ahead into pinned aligned buffers), the layer runs
  without gradients through ``functional_call`` on a meta-device block over
  views of the slot, and only the L+1 boundary activations stay on the card;
* head: the final norm and dense loss on the last activation, which is made
  a leaf that requires grad, backward: d(loss)/dx_L and the head's
  gradients;
* backward, layers in reverse: the layer's buffer again, its weights as
  detached leaf views that require grad, the block's forward recomputed
  from its saved input (a leaf that requires grad) with the forward's
  dropout seed (one seed a (micro-batch, layer), drawn from ``seed`` and
  the step, as the JAX package folds its keys), ``torch.autograd.backward
  (y, dy)``; dx goes on, and the layer's gradients are copied (a side
  stream, pinned staging in the wire layout) into the host fp32 rows of
  :class:`GradRowStore`, summed over the micro-batches there (files a layer
  with read-modify-write in the NVMe tier) one layer behind the card;
* the embedding's backward from dx_0; the resident gradients are summed in
  fp32 on the card.

The step (the JAX ``train_batch`` finalize): the global norm from the
summed gradients' squares (each layer's taken as its last micro-batch
lands) times 1/gas; ``grad_scale = 1/gas``, times ``clip / (norm + 1e-6)``
when the norm exceeds ``gradient_clipping``; the learning rate of the step
before its increment and the host Adam's 1-indexed ``step_num = step + 1``;
the resident parameters first, then one layer at a time: ``step(keys=<its
names>)`` writes the new compute-dtype values straight into the layer's
packed host buffer (or the NVMe tier's write buffer, whose file write
overlaps the next layer's update), and the layer's gradient rows are freed.
Host memory for gradients stays O(layer) in the NVMe tier.

Device memory: the resident pieces and their fp32 gradient sums,
``prefetch + 2`` layer slots, the L+1 boundary activations, one layer's
recompute and the head's fp32 logits. Not here: fp16 (no loss scaling on
this path), optimizers other than Adam/AdamW, more than one process, the
eager ``forward``/``backward``/``step`` API (``check_supported``); the JAX
package's ``HeteroLayerStore`` serves its MoE models only, whose port waits.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch

from ...utils.logging import log_dist
from ...utils.streaming import LayerWireFormat
from .offload import (ADAM_TYPES, OffloadedOptimizer, host_f32, make_aio,
                      nvme_dir)
from .offload_config import (DeepSpeedZeroOffloadOptimizerConfig,
                             OffloadDeviceEnum)
from .stream_adapters import BLOCKS, make_adapter


def check_supported(engine) -> None:
    """Refuse, at ``initialize()``, what the streamed path does not do."""
    make_adapter(engine.module, engine.compute_dtype)
    opt = engine._config.optimizer
    opt_type = (opt.type if opt else "adam").lower()
    if opt_type not in ADAM_TYPES:
        raise ValueError(f"offload_param requires Adam/AdamW (got "
                         f"{opt_type!r}); the host step runs "
                         f"DeepSpeedCPUAdam")
    if engine.fp16_enabled:
        raise ValueError("offload_param streaming supports bf16/fp32 only "
                         "(no dynamic loss scaling on the host-step path)")
    if engine.dp_world_size != 1:
        raise ValueError("offload_param streaming runs in one process")
    if engine._loss_fn is not None:
        raise ValueError("offload_param streaming computes the model's own "
                         "loss; a loss_fn does not compose with it")


def _events(n: int, cuda: bool) -> list:
    return [torch.cuda.Event() if cuda else None for _ in range(n)]


class _PackedWriteBuffers:
    """Two aligned host buffers for the NVMe tier's layer writes: packing
    layer i+1 overlaps the write of layer i; a buffer's write is waited for
    only when the buffer is reused (or at ``flush``)."""

    def __init__(self, aio, nbytes: int):
        from ...ops.aio import aligned_array

        self._aio = aio
        self._bufs = [aligned_array(nbytes) for _ in range(2)]
        self._tickets: List[Optional[int]] = [None, None]
        self._turn = 0

    def target(self) -> torch.Tensor:
        turn = self._turn
        if self._tickets[turn] is not None:
            self._aio.wait_ticket(self._tickets[turn])
            self._tickets[turn] = None
        return self._bufs[turn]

    def commit(self, path: str) -> None:
        turn = self._turn
        self._tickets[turn] = self._aio.async_pwrite(self._bufs[turn], path)
        self._turn = 1 - turn

    def flush(self) -> None:
        for t, ticket in enumerate(self._tickets):
            if ticket is not None:
                self._aio.wait_ticket(ticket)
                self._tickets[t] = None


class LayerParamStore:
    """The blocks' weights off the card, one packed compute-dtype buffer a
    layer (pinned host memory, or a file a layer in the NVMe tier), served
    through ``prefetch + 2`` device slots (module docstring).

    ``begin_pass(order)`` declares the visit order (ascending for the
    forward, descending for the backward); ``next_layer()`` returns
    (layer, slot, {leaf name: view on the card}) after making the compute
    stream wait for the copy; ``release(slot)`` after the compute that
    reads it has been issued. ``write_target(i)`` / ``commit(i)`` install a
    layer's new weights (views to write into, then the write), ``read(i)``
    gives them back."""

    def __init__(self, layers: List[Dict[str, torch.Tensor]],
                 compute_dtype: torch.dtype, tier: OffloadDeviceEnum,
                 device: torch.device, nvme_path: Optional[str] = None,
                 aio_config=None, prefetch: int = 1):
        self.n_layer = len(layers)
        self.prefetch = max(0, prefetch)
        self.nvme = tier == OffloadDeviceEnum.nvme
        self.device = device
        self.cuda = device.type == "cuda"
        self.wire = LayerWireFormat(layers[0], compute_dtype)
        self.dtype = self.wire.uniform_dtype
        self.layer_nbytes = self.wire.total_nbytes
        n_slots = self.prefetch + 2
        self._dev = [torch.empty(self.layer_nbytes, dtype=torch.uint8,
                                 device=device) for _ in range(n_slots)]
        self._copied = _events(n_slots, self.cuda)
        self._used = _events(n_slots, self.cuda)
        self._stream = torch.cuda.Stream(device) if self.cuda else None
        self._slot = 0
        self.streamed_bytes = 0
        if self.nvme:
            from ...ops.aio import aligned_array

            self.dir = nvme_dir(nvme_path, "dstorch_param_nvme")
            ac = aio_config
            self._aio = make_aio(ac, self.dir, ac.thread_count if ac else 2)
            self._staging = [aligned_array(self.layer_nbytes,
                                           pin_memory=self.cuda)
                             for _ in range(n_slots)]
            self._staging_done = [None] * n_slots
            self._packer = _PackedWriteBuffers(self._aio, self.layer_nbytes)
            self.layers = None
            for i, layer in enumerate(layers):
                self.wire.pack_into(layer, self.write_target(i, typed=False))
                self.commit(i)
            self.flush_writes()
        else:
            self._aio = None
            self.layers = [torch.zeros(self.layer_nbytes, dtype=torch.uint8,
                                       pin_memory=self.cuda)
                           for _ in range(self.n_layer)]
            for buf, layer in zip(self.layers, layers):
                self.wire.pack_into(layer, buf)
        self._order: List[int] = []
        self._pos = 0
        self._inflight: Dict[int, Any] = {}

    def layer_file(self, i: int) -> str:
        return os.path.join(self.dir, f"layer_{i:05d}.bin")

    # --- streaming -----------------------------------------------------------
    def begin_pass(self, order: List[int]) -> None:
        assert not self._inflight, "the previous pass was not drained"
        self._order = list(order)
        self._pos = 0
        for j in range(min(self.prefetch + 1, len(self._order))):
            self._issue(j)

    def _to_slot(self, slot: int, src: torch.Tensor) -> None:
        """Copy a host buffer into device slot ``slot`` once the compute
        that read the slot's previous layer is done."""
        self.streamed_bytes += self.layer_nbytes
        if not self.cuda:
            self._dev[slot].copy_(src)      # a real copy, never an alias
            return
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(self._used[slot])
            self._dev[slot].copy_(src, non_blocking=True)
            self._copied[slot].record(self._stream)

    def _issue(self, pos: int) -> None:
        i = self._order[pos]
        slot = self._slot
        self._slot = (slot + 1) % len(self._dev)
        if self.nvme:
            done = self._staging_done[slot]
            if done is not None:        # the pinned buffer's last copy
                done.synchronize()
            ticket = self._aio.async_pread(self._staging[slot],
                                           self.layer_file(i))
            self._inflight[pos] = (slot, ticket)
        else:
            self._to_slot(slot, self.layers[i])
            self._inflight[pos] = (slot, None)

    def next_layer(self):
        pos = self._pos
        self._pos += 1
        i = self._order[pos]
        slot, ticket = self._inflight.pop(pos)
        if self.nvme:
            self._aio.wait_ticket(ticket)
            self._to_slot(slot, self._staging[slot])
            if self.cuda:
                self._staging_done[slot] = self._copied[slot]
        nxt = pos + self.prefetch + 1
        if nxt < len(self._order):
            self._issue(nxt)
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(
                self._copied[slot])
        return i, slot, self.wire.unpack_typed(self._dev[slot].view(
            self.dtype))

    def release(self, slot: int) -> None:
        if self.cuda:
            self._used[slot].record(torch.cuda.current_stream(self.device))

    def sync(self) -> None:
        """Wait for every copy out of the host buffers (before rewriting
        them)."""
        if self.cuda:
            self._stream.synchronize()

    # --- installing and reading layers -------------------------------------
    def write_target(self, i: int, typed: bool = True):
        """Where layer ``i``'s new weights go: its packed host buffer, or the
        NVMe tier's free write buffer (views by leaf name when ``typed``,
        else the raw bytes); :meth:`commit` after filling it."""
        buf = self._packer.target() if self.nvme else self.layers[i]
        return self.wire.unpack_typed(buf.view(self.dtype)) if typed else buf

    def commit(self, i: int) -> None:
        if self.nvme:
            self._packer.commit(self.layer_file(i))

    def flush_writes(self) -> None:
        if self.nvme:
            self._packer.flush()

    def install(self, i: int, layer: Dict[str, torch.Tensor]) -> None:
        self.sync()
        self.wire.pack_into(layer, self.write_target(i, typed=False))
        self.commit(i)

    def read(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s weights as host tensors of their own."""
        if not self.nvme:
            return self.wire.unpack_host(self.layers[i])
        from ...ops.aio import aligned_array

        buf = aligned_array(self.layer_nbytes)
        self._aio.sync_pread(buf, self.layer_file(i))
        return self.wire.unpack_host(buf)


class GradRowStore:
    """The layers' gradients summed over a step's micro-batches in host
    fp32, one flat row a layer in the layer's wire layout (element offsets;
    the alignment gaps stay 0). The card's compute-dtype gradients come down
    through two pinned staging buffers on a side stream (``stage``) and are
    added one layer behind (``accumulate``); the last micro-batch records
    the layer's sum of squares, so the global norm never needs every row at
    once. In the NVMe tier each layer's row is a file, read, added to and
    written back per micro-batch, so host memory stays O(layer)."""

    def __init__(self, wire: LayerWireFormat, n_layer: int,
                 device: torch.device, nvme_path: Optional[str] = None,
                 aio=None):
        self.wire = wire
        self.n_layer = n_layer
        self.device = device
        self.cuda = device.type == "cuda"
        item = wire.uniform_dtype.itemsize
        self.total = wire.total_nbytes // item
        self._spans = [(off // item, int(torch.Size(s).numel()), s)
                       for off, s in zip(wire.offsets, wire.shapes)]
        self._staging = [torch.zeros(self.total, dtype=wire.uniform_dtype,
                                     pin_memory=self.cuda)
                         for _ in range(2)]
        self._staged = _events(2, self.cuda)
        self._turn = 0
        self._slot_of: Dict[int, int] = {}
        self._stream = torch.cuda.Stream(device) if self.cuda else None
        self.nvme = nvme_path is not None
        self.sq: Dict[int, float] = {}
        if self.nvme:
            from ...ops.aio import aligned_array

            self.dir = os.path.join(nvme_path, "grads")
            os.makedirs(self.dir, exist_ok=True)
            self._aio = aio
            self._buf = aligned_array(self.total * 4, torch.float32)
            self._have = set()
        else:
            self.rows: Dict[int, Optional[torch.Tensor]] = {}

    def _file(self, li: int) -> str:
        return os.path.join(self.dir, f"grad_{li:05d}.bin")

    def views(self, flat: torch.Tensor, names: List[str]):
        return {name: flat[off:off + n].view(shape)
                for name, (off, n, shape) in zip(names, self._spans)}

    def stage(self, li: int, grads: List[torch.Tensor]) -> None:
        """Start layer ``li``'s gradients' copy (leaf order of the wire)."""
        slot = self._turn
        self._turn = 1 - slot
        self._slot_of[li] = slot
        dst = self._staging[slot]
        if not self.cuda:
            for (off, n, _), g in zip(self._spans, grads):
                dst[off:off + n].copy_(g.reshape(-1))
            return
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            for (off, n, _), g in zip(self._spans, grads):
                dst[off:off + n].copy_(g.reshape(-1), non_blocking=True)
                g.record_stream(stream)
            self._staged[slot].record(stream)

    def accumulate(self, li: int, is_last: bool) -> None:
        """Add layer ``li``'s staged gradients into its fp32 row."""
        slot = self._slot_of.pop(li)
        if self.cuda:
            self._staged[slot].synchronize()
        src = self._staging[slot]
        if not self.nvme:
            row = self.rows.get(li)
            if row is None:     # a copy: in fp32 the staging buffer is fp32
                self.rows[li] = row = src.to(torch.float32, copy=True)
            else:
                row.add_(src)
        else:
            row = self._buf
            if li in self._have:
                self._aio.sync_pread(row, self._file(li))
                row.add_(src)
            else:
                row.copy_(src)
                self._have.add(li)
        if is_last:
            self.sq[li] = float(torch.dot(row, row))
        if self.nvme:
            self._aio.sync_pwrite(row, self._file(li))

    def total_sq(self) -> float:
        return float(sum(self.sq.values()))

    def read_row(self, li: int) -> torch.Tensor:
        if not self.nvme:
            return self.rows[li]
        self._aio.sync_pread(self._buf, self._file(li))
        return self._buf

    def free(self, li: int) -> None:
        if not self.nvme:
            self.rows[li] = None

    def reset(self) -> None:
        self.sq = {}
        if self.nvme:
            self._have = set()
        else:
            self.rows = {}


def layer_seeds(seed: int, step: int, micros: int, n_layer: int):
    """One dropout seed a (micro-batch, layer) of step ``step``."""
    gen = torch.Generator().manual_seed(seed * 1_000_003 + step)
    return torch.randint(0, 2 ** 62, (micros, n_layer),
                         generator=gen).tolist()


class ParamOffloadRunner:
    """The engine's ``offload_param`` training path (module docstring):
    ``train_batch``, ``eval_loss``, ``full_state_dict``, ``load_params``.
    Built from ``engine.module`` (its parameters on any device): the blocks'
    weights go to the store and their module parameters to the ``meta``
    device, the other parameters to the card in the compute dtype."""

    def __init__(self, engine, opt_params: Dict):
        module = engine.module
        self.module = module
        self.device = engine.device
        self.cuda = self.device.type == "cuda"
        self.compute_dtype = engine.compute_dtype
        self.adapter = make_adapter(module, self.compute_dtype)
        self.clip = engine.gradient_clipping()
        self.seed = engine._config.seed
        zc = engine.zero_config
        self.op_cfg = zc.offload_param
        L = self.adapter.n_layer
        self._state_keys = list(module.state_dict())
        named = {n: p for n, p in module.named_parameters()
                 if p.requires_grad}
        oo = zc.offload_optimizer
        if oo is None or oo.device == OffloadDeviceEnum.none:
            oo = DeepSpeedZeroOffloadOptimizerConfig(device="cpu")
        self.opt = OffloadedOptimizer(named, opt_params, oo,
                                      aio_config=engine._config.aio)
        self.layer_keys = [self.adapter.layer_keys(i) for i in range(L)]
        leaf = self.adapter.leaf_names
        self.store = LayerParamStore(
            [{k: named[key] for k, key in zip(leaf, keys)}
             for keys in self.layer_keys],
            self.compute_dtype, self.op_cfg.device, self.device,
            nvme_path=self.op_cfg.nvme_path, aio_config=engine._config.aio,
            prefetch=max(1, min(self.op_cfg.buffer_count - 1, 4)))
        with torch.no_grad():
            module.blocks.to("meta")
            for name, child in module.named_children():
                if name != "blocks":
                    child.to(device=self.device, dtype=self.compute_dtype)
        self.resident = [(n, p) for n, p in module.named_parameters()
                         if p.requires_grad and not n.startswith(BLOCKS)]
        self._res_acc = [torch.zeros_like(p, dtype=torch.float32)
                         for _, p in self.resident]
        self.grads = GradRowStore(
            self.store.wire, L, self.device,
            nvme_path=self.store.dir if self.store.nvme else None,
            aio=self.store._aio)
        self.last_timings: Dict[str, float] = {}
        log_dist(f"ZeRO param offload: device={self.op_cfg.device.value}, "
                 f"{L} layers x {self.store.layer_nbytes / 1e6:.1f} MB "
                 f"streamed (prefetch {self.store.prefetch}), optimizer "
                 f"{'nvme' if self.opt.nvme else 'cpu'}"
                 + ("" if self.opt.swap_master or not self.opt.nvme
                    else " (moments only)"), ranks=[0])

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _to_device(self, batch):
        from ..engine import _to_device

        return _to_device(batch, self.device)

    @torch.no_grad()
    def _forward_stream(self, x, ctx, seeds) -> List[torch.Tensor]:
        """The boundary activations x_0 .. x_L (no gradients)."""
        store, adapter = self.store, self.adapter
        acts = [x]
        store.begin_pass(list(range(adapter.n_layer)))
        for li in range(adapter.n_layer):
            _, slot, w = store.next_layer()
            x = adapter.block_apply(w, x, ctx, seeds[li])
            store.release(slot)
            acts.append(x)
        return acts

    def _add_resident_grads(self) -> None:
        """The resident parameters' gradients into their fp32 sums."""
        for acc, (_, p) in zip(self._res_acc, self.resident):
            if p.grad is not None:
                acc.add_(p.grad)
                p.grad = None

    # --- the step ------------------------------------------------------------
    def train_batch(self, micro_batches, lr: float, step: int
                    ) -> Dict[str, Any]:
        """One global step over the micro-batches (module docstring) at
        learning rate ``lr``; ``step`` is the engine's step counter before
        it. Returns the engine's metrics (``loss`` an fp32 device scalar)."""
        t0 = time.perf_counter()
        adapter, store, grads = self.adapter, self.store, self.grads
        L = adapter.n_layer
        grads.reset()
        dropout = adapter.dropout > 0
        seeds = layer_seeds(self.seed, step, len(micro_batches), L) \
            if dropout else [[None] * L] * len(micro_batches)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        t_fwd = t_bwd = 0.0
        for mi, mb in enumerate(micro_batches):
            mb = self._to_device(mb)
            tf = time.perf_counter()
            x0, ctx = adapter.embed(mb)
            acts = self._forward_stream(x0.detach(), ctx, seeds[mi])
            xL = acts[-1].requires_grad_()
            loss = adapter.head_loss(xL, mb)
            loss.backward()
            dy = xL.grad
            self._add_resident_grads()
            loss_sum += loss.detach().float()
            self._sync()
            tb = time.perf_counter()
            t_fwd += tb - tf
            is_last = mi == len(micro_batches) - 1
            pending = deque()
            store.begin_pass(list(range(L - 1, -1, -1)))
            for li in range(L - 1, -1, -1):
                _, slot, w = store.next_layer()
                leaves = {k: v.detach().requires_grad_() for k, v in
                          w.items()}
                xin = acts[li].requires_grad_()
                y = adapter.block_apply(leaves, xin, ctx, seeds[mi][li])
                torch.autograd.backward(y, dy)
                store.release(slot)
                dy = xin.grad
                acts[li] = acts[li + 1] = y = None
                grads.stage(li, [leaves[k].grad for k in adapter.leaf_names])
                del leaves, w
                pending.append(li)
                if len(pending) > 1:
                    grads.accumulate(pending.popleft(), is_last)
            while pending:
                grads.accumulate(pending.popleft(), is_last)
            x0.backward(dy)
            self._add_resident_grads()
            acts = dy = None
            self._sync()
            t_bwd += time.perf_counter() - tb

        # --- the host step: norm, clip, Adam, write the store back -------
        t2 = time.perf_counter()
        res = {n: host_f32(acc) for (n, _), acc in
               zip(self.resident, self._res_acc)}
        torch._foreach_zero_(self._res_acc)
        sq = grads.total_sq() + sum(float(torch.dot(g.view(-1), g.view(-1)))
                                    for g in res.values())
        inv_gas = 1.0 / len(micro_batches)
        grad_norm = sq ** 0.5 * inv_gas
        scale = inv_gas
        if self.clip > 0 and grad_norm > self.clip:
            scale *= self.clip / (grad_norm + 1e-6)
        step_num = step + 1
        cd = self.compute_dtype
        new = self.opt.step(res, lr, step_num, cd, grad_scale=scale,
                            release_grads=True, keys=set(res))
        with torch.no_grad():
            for n, p in self.resident:
                p.copy_(new[n])
        del new, res
        t3 = time.perf_counter()
        store.sync()
        leaf = adapter.leaf_names
        adam_s = 0.0
        for li in range(L):
            keys = self.layer_keys[li]
            rows = grads.views(grads.read_row(li), keys)
            target = store.write_target(li)
            ta = time.perf_counter()
            self.opt.step(rows, lr, step_num, cd, grad_scale=scale,
                          release_grads=True, keys=set(keys),
                          out={key: target[k] for k, key in
                               zip(leaf, keys)})
            adam_s += time.perf_counter() - ta
            grads.free(li)
            store.commit(li)
        store.flush_writes()
        t4 = time.perf_counter()
        self.last_timings = {
            "forward_stream_s": t_fwd, "backward_stream_s": t_bwd,
            "grad_finalize_s": t2 - t0 - t_fwd - t_bwd,
            # the host Adam over every parameter; the rest of the layer
            # loop (reading gradient rows, NVMe writes) is the writeback
            "host_adam_s": t3 - t2 + adam_s,
            "param_writeback_s": t4 - t3 - adam_s,
            **{f"adam_{k}": v for k, v in self.opt.last_timings.items()}}
        return {"loss": loss_sum / len(micro_batches),
                "grad_norm": torch.tensor(grad_norm), "lr": lr,
                "overflow": False, "loss_scale": 1.0}

    # --- evaluation and checkpoints -----------------------------------------
    @torch.no_grad()
    def eval_loss(self, batch) -> torch.Tensor:
        """The streamed forward and the dense loss, without gradients or
        dropout."""
        mb = self._to_device(batch)
        x0, ctx = self.adapter.embed(mb)
        acts = self._forward_stream(x0, ctx, [None] * self.adapter.n_layer)
        return self.adapter.head_loss(acts[-1], mb)

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The module's ``state_dict`` (compute dtype), the layers read back
        from the store."""
        out = {n: p.detach() for n, p in self.module.named_parameters()
               if not n.startswith(BLOCKS)}
        for li, keys in enumerate(self.layer_keys):
            layer = self.store.read(li)
            out.update({key: layer[k] for k, key in
                        zip(self.adapter.leaf_names, keys)})
        return {k: out[k] for k in self._state_keys if k in out}

    @torch.no_grad()
    def load_params(self, sd: Dict[str, Any], strict: bool = True) -> None:
        """Install loaded weights ({module name: tensor or array}): the
        resident ones on the card, every layer in the store. The caller
        restores the optimizer (``load_state_dict`` or
        ``sync_master_from``)."""
        if strict:
            missing = sorted(set(self._state_keys) - set(sd))
            unexpected = sorted(set(sd) - set(self._state_keys))
            if missing or unexpected:
                raise RuntimeError(f"load_params: missing {missing}, "
                                   f"unexpected {unexpected}")
        for n, p in self.resident:
            if n in sd:
                p.copy_(torch.as_tensor(sd[n]))
        leaf = self.adapter.leaf_names
        for li, keys in enumerate(self.layer_keys):
            if all(key in sd for key in keys):
                self.store.install(li, {k: torch.as_tensor(sd[key])
                                        for k, key in zip(leaf, keys)})
        self.store.flush_writes()
