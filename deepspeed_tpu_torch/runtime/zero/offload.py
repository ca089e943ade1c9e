"""ZeRO-Offload and ZeRO-Infinity optimizer-state tiers (the port of
``deepspeed_tpu/runtime/zero/offload.py``).

:class:`OffloadedOptimizer` keeps the fp32 master weights and both Adam
moments in HOST memory, keyed by the port's parameter names (the module's
``named_parameters``): the master in each parameter's shape, the moments
flat. ``step`` runs the host Adam (``ops/adam/cpu_adam.py``, the native op
``ops/csrc/cpu_adam.cpp``) leaf by leaf over the gradients the caller hands
over and returns each leaf's new value in the compute dtype (bf16 through the
op's round-to-nearest-even), so the device holds only the compute-dtype
parameters and the gradient accumulators.

With ``device: nvme`` the moments (and, with ``swap_master``, the master)
live between steps in one file per parameter and kind under ``nvme_path``
(``<name>.{m,v,master}.bin``, fp32 bytes exactly), moved by the async I/O op
(``ops/aio``): ``step`` submits every leaf's reads up front and waits per
leaf, so leaf i's Adam runs while later leaves stream in, and submits each
leaf's writes as soon as its update is done, with one drain at the end. An
exception mid-step drains the writes already in flight and drops the leaves
whose reads never completed, so a retry reads them from disk again.
``swap_master: false`` keeps the master in host memory and swaps the moments
only.

The JAX package also updates ONE row of a stacked leaf (``step_rows``,
``drain_row_writes``, byte-offset I/O into whole-leaf files), because its
blocks are one scanned leaf with a layer axis. The port's blocks are a
``ModuleList``, one set of parameters per layer, so the layer-streamed
finalize of parameter offload calls ``step(keys=<that layer's names>)`` and
every file stays per parameter; host memory stays O(layer) either way.
Trainable parameters are floating point, so the JAX package's integer-leaf
passthrough has nothing to carry.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from ...ops.adam.cpu_adam import DeepSpeedCPUAdam
from ...utils.logging import log_dist, logger
from .offload_config import (DeepSpeedZeroOffloadOptimizerConfig,
                             OffloadDeviceEnum)

ADAM_TYPES = ("adam", "adamw", "cpuadam")


def host_f32(value, shape=None) -> torch.Tensor:
    """An fp32 CPU tensor with storage of its own (a tensor of any dtype or
    device, or an array), reshaped to ``shape``."""
    t = value if torch.is_tensor(value) else \
        torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
    t = t.detach().to("cpu", torch.float32, copy=True)
    return t.reshape(shape).contiguous() if shape is not None \
        else t.contiguous()


def make_aio(aio_config, target_dir: str, num_threads: int):
    """An ``AioHandle`` for ``target_dir`` from the ``aio`` config block,
    ``O_DIRECT`` when the filesystem takes it (``DS_AIO_NO_ODIRECT=1``
    forces the buffered path)."""
    from ...ops.aio import AioHandle, o_direct_supported

    use_od = os.environ.get("DS_AIO_NO_ODIRECT") != "1" and \
        o_direct_supported(target_dir)
    ac = aio_config
    return AioHandle(num_threads=max(1, num_threads),
                     block_size=ac.block_size if ac else 1 << 20,
                     queue_depth=ac.queue_depth if ac else 0,
                     o_direct=use_od)


def nvme_dir(path: Optional[str], default: str) -> str:
    """The NVMe tier's directory (under the temporary directory by
    default), one per rank when several processes train."""
    import torch.distributed as dist

    out = path or os.path.join(tempfile.gettempdir(), default)
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        out = os.path.join(out, f"rank{dist.get_rank()}")
    os.makedirs(out, exist_ok=True)
    return out


class OffloadedOptimizer:
    """Host Adam over fp32 master weights and moments (module docstring).

    ``params``: {name: tensor} of the trainable parameters, on any device
    and in any float dtype (their values become the fp32 master; nothing is
    aliased). ``opt_params``: the optimizer block's ``params`` (``lr``,
    ``betas``, ``eps``, ``weight_decay``, ``adam_w_mode`` default True,
    ``bias_correction``)."""

    def __init__(self, params: Mapping[str, torch.Tensor], opt_params: Dict,
                 config: DeepSpeedZeroOffloadOptimizerConfig,
                 aio_config=None):
        self.config = config
        self.nvme = config.device == OffloadDeviceEnum.nvme
        self.opt = DeepSpeedCPUAdam(
            lr=opt_params.get("lr", 1e-3),
            betas=tuple(opt_params.get("betas", (0.9, 0.999))),
            eps=opt_params.get("eps", 1e-8),
            weight_decay=opt_params.get("weight_decay", 0.0),
            adamw_mode=opt_params.get("adam_w_mode", True),
            bias_correction=opt_params.get("bias_correction", True))
        self.swap_master = bool(config.swap_master)
        self._aio = None
        if self.nvme:
            self.nvme_dir = nvme_dir(config.nvme_path, "dstorch_nvme")
            # the aio block's thread_count when set away from its default
            # of 1, else buffer_count threads (the JAX package's sizing)
            ac = aio_config
            threads = ac.thread_count if ac is not None and \
                ac.thread_count != 1 else config.buffer_count
            self._aio = make_aio(ac, self.nvme_dir, threads)
        self.master: Dict[str, Optional[torch.Tensor]] = {}
        self.m: Dict[str, Optional[torch.Tensor]] = {}
        self.v: Dict[str, Optional[torch.Tensor]] = {}
        self._shapes: Dict[str, tuple] = {}
        for name, value in params.items():
            if not value.is_floating_point():
                raise ValueError(f"{name}: offloaded parameters are "
                                 f"floating point, got {value.dtype}")
            self._shapes[name] = tuple(value.shape)
            self.master[name] = host_f32(value)
            self.m[name] = torch.zeros(value.numel())
            self.v[name] = torch.zeros(value.numel())
            if self.nvme:
                # one leaf at a time: host memory stays O(largest leaf)
                self._submit_leaf_swap_out(name)
                self._aio.wait()
                self._drop(name)
        self.last_timings: Dict[str, float] = {}
        log_dist(f"ZeRO-Offload optimizer: device={config.device.value}, "
                 f"{len(self.master)} tensors, "
                 f"{self.numel() / 1e6:.1f}M fp32 master + 2 moments on the "
                 f"host" + (f", files under {self.nvme_dir}" +
                            ("" if self.swap_master else
                             " (moments only)") if self.nvme else ""),
                 ranks=[0])

    def numel(self, keys: Optional[Iterable[str]] = None) -> int:
        keys = self._shapes if keys is None else keys
        return sum(int(np.prod(self._shapes[k], dtype=np.int64))
                   for k in keys)

    # --- the nvme tier ---------------------------------------------------
    def leaf_file(self, name: str, kind: str) -> str:
        return os.path.join(self.nvme_dir, f"{name}.{kind}.bin")

    def _drop(self, name: str) -> None:
        self.m[name] = self.v[name] = None
        if self.swap_master:
            self.master[name] = None

    def _submit_leaf_swap_out(self, name: str) -> None:
        """Queue one leaf's moment (and master) writes; the caller drains."""
        self._aio.async_pwrite(self.m[name], self.leaf_file(name, "m"))
        self._aio.async_pwrite(self.v[name], self.leaf_file(name, "v"))
        if self.swap_master:
            self._aio.async_pwrite(self.master[name].reshape(-1),
                                   self.leaf_file(name, "master"))

    def _drop_stores(self) -> None:
        for name in self.m:
            self._drop(name)

    def _swap_out_all(self) -> None:
        for name in self.m:
            if self.m[name] is not None:
                self._submit_leaf_swap_out(name)
        self._aio.wait()
        self._drop_stores()

    def _alloc(self, n: int) -> torch.Tensor:
        """A 4096-aligned fp32 buffer, so its reads can take O_DIRECT."""
        from ...ops.aio import aligned_array

        return aligned_array(n * 4, torch.float32)

    def _submit_swap_in(self, keys=None) -> Dict[str, list]:
        """Allocate and SUBMIT the reads of every swapped-out leaf (of
        ``keys``); returns {name: tickets}. A leaf whose host copy is live
        (a failed drain kept it) is authoritative and not read."""
        tickets: Dict[str, list] = {}
        for name, shape in self._shapes.items():
            if (keys is not None and name not in keys) or \
                    self.m[name] is not None:
                continue
            n = int(np.prod(shape, dtype=np.int64))
            self.m[name] = self._alloc(n)
            self.v[name] = self._alloc(n)
            tickets[name] = [
                self._aio.async_pread(self.m[name],
                                      self.leaf_file(name, "m")),
                self._aio.async_pread(self.v[name],
                                      self.leaf_file(name, "v"))]
            if self.swap_master:
                self.master[name] = self._alloc(n).view(shape)
                tickets[name].append(self._aio.async_pread(
                    self.master[name].reshape(-1),
                    self.leaf_file(name, "master")))
        return tickets

    def _swap_in_all(self) -> None:
        self._submit_swap_in()
        self._aio.wait()

    def read_leaf(self, kind: str, name: str) -> Optional[torch.Tensor]:
        """ONE leaf (``kind``: master, m or v) in its parameter's shape,
        whatever the swap state: O(leaf) I/O."""
        store = {"master": self.master, "m": self.m, "v": self.v}[kind]
        if name not in store:
            return None
        if store[name] is not None:
            out = store[name].clone()
        else:
            out = self._alloc(self.numel([name]))
            self._aio.sync_pread(out, self.leaf_file(name, kind))
        return out.reshape(self._shapes[name])

    def write_leaf(self, kind: str, name: str, value) -> bool:
        """Overwrite ONE leaf, on disk when it is swapped out."""
        store = {"master": self.master, "m": self.m, "v": self.v}[kind]
        if name not in store:
            return False
        flat = host_f32(value).reshape(-1)
        if store[name] is not None:
            store[name] = flat.reshape(self._shapes[name]) \
                if kind == "master" else flat
        else:
            self._aio.sync_pwrite(flat, self.leaf_file(name, kind))
        return True

    # --- the step ----------------------------------------------------------
    def step(self, grads: Mapping[str, Any], lr: float, step_num: int,
             compute_dtype: Optional[torch.dtype], grad_scale: float = 1.0,
             release_grads: bool = False, keys=None,
             out: Optional[Mapping[str, torch.Tensor]] = None,
             done: Optional[Callable[[str, torch.Tensor], None]] = None
             ) -> Dict[str, torch.Tensor]:
        """One host Adam step over the leaves in ``keys`` (default: all),
        ``step_num`` 1-indexed. Returns {name: new value in
        ``compute_dtype``} (fp32 for None).

        ``grads[name]`` is read when the leaf's turn comes: an fp32 CPU
        tensor of the parameter's size (a mapping whose lookup waits for
        the leaf's device-to-host copy lets the copies overlap the
        updates), multiplied by ``grad_scale`` in fp32 first when that is
        not 1 (a deferred clip or average at no extra pass). With
        ``release_grads`` a mutable ``grads`` has each entry set to None
        as soon as its update is done, so the caller's host memory falls as
        the step goes: pass an owned dict. ``out[name]``, when given, is
        the (contiguous CPU) tensor the new value is written into, e.g. a
        pinned upload buffer; ``done(name, new)`` is called after each
        leaf. ``last_timings``: {swap_in_s (the reads' submission),
        compute_s (the updates, overlapped read waits included), drain_s}.
        """
        t0 = time.perf_counter()
        tickets = self._submit_swap_in(keys) if self.nvme else {}
        t_in = time.perf_counter()
        scale = torch.tensor(grad_scale, dtype=torch.float32)
        results: Dict[str, torch.Tensor] = {}
        try:
            for name in self._shapes:
                if keys is not None and name not in keys:
                    continue
                if name in tickets:
                    # this leaf's reads only; later leaves keep streaming
                    # (popped after ALL its reads land: a failed wait
                    # leaves it for the unwind to drop)
                    for t in tickets[name]:
                        self._aio.wait_ticket(t)
                    del tickets[name]
                g = grads[name]
                g = g.to(torch.float32).reshape(-1)
                if grad_scale != 1.0:
                    g = g * scale
                g = g.contiguous()
                if release_grads and hasattr(grads, "__setitem__"):
                    grads[name] = None
                master = self.master[name]
                self.opt.step(master.view(-1), g, self.m[name],
                              self.v[name], step_num, lr=lr)
                del g
                results[name] = self._emit(name, master, compute_dtype,
                                           None if out is None
                                           else out[name])
                if done is not None:
                    done(name, results[name])
                if self.nvme:
                    # its writes overlap the next leaves' updates
                    self._submit_leaf_swap_out(name)
            t_compute = time.perf_counter()
        except BaseException:
            if self.nvme:
                # leaves whose reads never completed hold garbage: drop
                # them so a retry reads the files again
                for name in tickets:
                    self._drop(name)
                try:
                    self._aio.wait()
                except IOError as io_err:
                    # the files may be partly written: the host copies of
                    # the finished leaves stay authoritative
                    logger.warning("swap-out drain failed during exception "
                                   "unwind: %s; the host copies stay "
                                   "authoritative", io_err)
                else:
                    self._drop_stores()
            raise
        if self.nvme:
            self._aio.wait()        # raises on any failed chunk
            self._drop_stores()
        t_drain = time.perf_counter()
        self.last_timings = {"swap_in_s": t_in - t0,
                             "compute_s": t_compute - t_in,
                             "drain_s": t_drain - t_compute}
        return results

    def _emit(self, name: str, master: torch.Tensor,
              compute_dtype: Optional[torch.dtype],
              dst: Optional[torch.Tensor]) -> torch.Tensor:
        """The new value of one leaf in ``compute_dtype`` (into ``dst``)."""
        shape = self._shapes[name]
        if compute_dtype == torch.bfloat16:
            return self.opt.to_bf16(
                master, None if dst is None else dst.view(shape))
        if dst is not None:
            return dst.view(shape).copy_(master)
        if compute_dtype is None or compute_dtype == torch.float32:
            return master.clone()
        return master.to(compute_dtype)

    # --- checkpoints -------------------------------------------------------
    def sync_master_from(self, params: Mapping[str, Any]) -> None:
        """Re-seed the fp32 master from loaded weights ({name: tensor or
        array}), e.g. when a checkpoint restores the module without
        offloaded optimizer state (the next step would otherwise clobber the
        loaded weights with values recomputed from the stale master)."""
        if self.nvme:
            self._swap_in_all()
        for name, value in params.items():
            if name in self.master:
                self.master[name] = host_f32(value, self._shapes[name])
        if self.nvme:
            self._swap_out_all()

    def state_dict(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{"master": {name: fp32, parameter-shaped}, "m": {name: flat},
        "v": {name: flat}} (copies; the JAX package's keys)."""
        if self.nvme:
            self._swap_in_all()
        sd = {kind: {name: t.clone() for name, t in store.items()}
              for kind, store in (("master", self.master), ("m", self.m),
                                  ("v", self.v))}
        if self.nvme:
            self._swap_out_all()
        return sd

    def load_state_dict(self, sd: Mapping[str, Mapping[str, Any]]) -> None:
        if self.nvme:
            self._swap_in_all()
        for name, shape in self._shapes.items():
            for kind, store, want in (("master", self.master, shape),
                                      ("m", self.m, (-1,)),
                                      ("v", self.v, (-1,))):
                value = (sd.get(kind) or {}).get(name)
                if value is not None:
                    store[name] = host_f32(value, want)
        if self.nvme:
            self._swap_out_all()

    def load_universal(self, master: Mapping[str, Any],
                       opt_trees: Mapping[str, Mapping[str, Any]]) -> None:
        """Restore from a universal checkpoint: the fp32 master from
        ``master`` ({name: array}) and the moments from
        ``opt_trees["exp_avg"/"exp_avg_sq"]`` (parameter-shaped) when
        present, so the momentum survives the resume."""
        self.sync_master_from(master)
        if self.nvme:
            self._swap_in_all()
        for field, store in (("exp_avg", self.m), ("exp_avg_sq", self.v)):
            for name, value in (opt_trees.get(field) or {}).items():
                if name in store:
                    store[name] = host_f32(value, (-1,))
        if self.nvme:
            self._swap_out_all()

    def close(self) -> None:
        if self._aio is not None:
            self._aio.close()


class HostStepStaging:
    """The device side of an offloaded step on one card: the fp32
    gradients go down and the new compute-dtype parameters come back up
    through a ring of ``slots`` PINNED buffers, each the size of the
    largest parameter, on two copy streams:

    * the gradients' copies start once the compute stream has finished
      them (the copy stream waits on it), ``slots`` parameters ahead of
      the host Adam; the host reads a leaf only after its copy's event,
      and a down slot is refilled only after the host step consumed it;
    * each leaf's new value is written into an up slot only after that
      slot's previous upload's event has completed, and its upload starts
      as soon as the leaf is done, overlapping the next leaves' updates;
    * at the end the compute stream waits on both copy streams: the next
      forward reads the new parameters and the accumulators are zeroed
      after their copies.

    So pinned memory is ``slots`` x the largest parameter x (4 + the
    compute dtype's bytes), whatever the model's size. On the CPU route
    the accumulators are host tensors already and the new values are
    written into the parameters' own storage (never the master's).
    ``totals()`` gives the seconds and bytes of the transfers (device
    events a copy), of the host updates (on the card) and of the whole
    host step, summed over steps.
    """

    def __init__(self, params, compute_dtype: torch.dtype, device,
                 slots: int = 3):
        self.params = list(params)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.compute_dtype = compute_dtype
        self.slots = slots
        self.reset_totals()
        self._pending = []
        if not self.cuda:
            return
        largest = max(p.numel() for p in self.params)
        self.down = [torch.empty(largest, dtype=torch.float32,
                                 pin_memory=True) for _ in range(slots)]
        self.up = [torch.empty(largest, dtype=compute_dtype, pin_memory=True)
                   for _ in range(slots)]
        self.d2h = torch.cuda.Stream(self.device)
        self.h2d = torch.cuda.Stream(self.device)
        self.up_done = [None] * slots

    def reset_totals(self) -> None:
        self._totals = {"steps": 0, "down_s": 0.0, "up_s": 0.0,
                        "down_bytes": 0, "up_bytes": 0, "adam_s": 0.0,
                        "host_step_s": 0.0}

    def _collect(self) -> None:
        """Fold the finished copies' event times into the totals."""
        for kind, start, end in self._pending:
            end.synchronize()
            self._totals[kind] += start.elapsed_time(end) / 1e3
        self._pending = []

    def totals(self) -> Dict[str, float]:
        self._collect()
        return dict(self._totals)

    def _copy(self, stream, kind: str, dst, src) -> torch.cuda.Event:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            start.record(stream)
            dst.copy_(src, non_blocking=True)
            end.record(stream)
        self._pending.append((kind, start, end))
        return end

    @torch.no_grad()
    def run(self, opt: OffloadedOptimizer, names, grads, lr: float,
            step_num: int) -> None:
        """One host step: ``grads`` (the fp32 accumulators, aligned with
        ``names`` and the parameters) down, ``opt.step``, the new values
        into the parameters."""
        t0 = time.perf_counter()
        tot = self._totals
        tot["steps"] += 1
        if not self.cuda:
            opt.step(dict(zip(names, grads)), lr, step_num,
                     self.compute_dtype,
                     out={n: p.detach() for n, p in zip(names, self.params)})
            tot["host_step_s"] += time.perf_counter() - t0
            return
        got = {}
        self._collect()
        index = {n: i for i, n in enumerate(names)}
        cur = torch.cuda.current_stream(self.device)
        self.d2h.wait_stream(cur)
        self.h2d.wait_stream(cur)
        R, down_done = self.slots, {}
        params = self.params

        def issue_down(i):
            if i < len(names):
                n = grads[i].numel()
                down_done[i] = self._copy(self.d2h, "down_s",
                                          self.down[i % R][:n],
                                          grads[i].view(-1))
                tot["down_bytes"] += 4 * n

        for i in range(min(R, len(names))):
            issue_down(i)
        staging = self

        class Grads:
            def __getitem__(self, name):
                i = index[name]
                down_done.pop(i).synchronize()
                got["t"] = time.perf_counter()
                return staging.down[i % R][:grads[i].numel()]

        class Out:
            def __getitem__(self, name):
                i = index[name]
                prev = staging.up_done[i % R]
                if prev is not None:
                    prev.synchronize()
                return staging.up[i % R][:params[i].numel()]

        def done(name, new):
            tot["adam_s"] += time.perf_counter() - got.pop("t")
            i = index[name]
            p = params[i]
            self.up_done[i % R] = self._copy(self.h2d, "up_s", p.view(-1),
                                             new.view(-1))
            tot["up_bytes"] += p.numel() * p.element_size()
            issue_down(i + R)       # its down slot is consumed

        opt.step(Grads(), lr, step_num, self.compute_dtype, out=Out(),
                 done=done)
        cur.wait_stream(self.h2d)
        cur.wait_stream(self.d2h)
        tot["host_step_s"] += time.perf_counter() - t0
