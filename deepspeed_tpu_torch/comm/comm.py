"""The communication facade: the port of ``deepspeed_tpu/comm/comm.py`` on
``torch.distributed``.

The JAX package's collectives are XLA ops inside compiled code over mesh
axes; here they are eager ``torch.distributed`` calls over the process
groups of ``parallel.mesh``, with the same names and the same ``group``
argument: a mesh axis name or a tuple of them (``None``: the whole
data-parallel world, the MiCS replica axis included). Results follow the
JAX functions: ``all_gather_into_tensor`` returns the shards concatenated
along ``axis``, ``reduce_scatter_tensor`` this rank's summed slice along
``scatter_dimension``, ``all_to_all_single`` the received chunks
concatenated along ``concat_axis``; ``all_reduce`` and ``broadcast``
work in place and return their tensor. Over a group of one rank every op
returns its input, so code written for a world runs unchanged without a
process group; a world of one rank WITH a process group still calls the
backend (the same code path as a larger world). A collective never
returns its input in place of a result: one over a group that the
installed mesh makes larger than one rank, without a process group,
raises, and the backend's errors propagate.

Backends. ``init_distributed`` picks ``nccl`` for a CUDA device and
``gloo`` for ``device="cpu"``; ``dist_backend="gloo"`` over CUDA tensors
is the caller's choice (it runs two ranks on one card, where NCCL refuses
two ranks a device). PyTorch's backend table lists only ``all_reduce`` and
``broadcast`` for gloo with CUDA tensors, but on the H100 machine's
PyTorch 2.11 gloo took every collective this layer calls, natively and
exactly (the table is in PERF.md), so every op is the backend's own on
every backend.

``ReduceOp.AVG`` is a sum divided by the group's size on every backend.
The comms logger (``configure``/``log_summary``) records each op under the
name the caller used.

``ppermute`` and ``axis_index`` are ops inside a compiled program in the
JAX package (pipeline stages' sends); they raise here until pipeline
parallelism is ported.
"""

from __future__ import annotations

import datetime
import functools
import os
import time
import zlib
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..parallel import mesh as mesh_mod
from ..utils.comms_logging import CommsLogger, get_caller_func
from ..utils.logging import logger

Group = Union[str, Sequence[str], None]


class ReduceOp:
    SUM = "sum"
    AVG = "avg"
    PRODUCT = "prod"
    MIN = "min"
    MAX = "max"


comms_logger = CommsLogger()

_initialized = False


def _dist():
    import torch.distributed as dist

    return dist


def _dist_on() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


@functools.lru_cache(maxsize=None)
def _collective(name: str):
    """The installed torch's call for ``all_gather_single`` /
    ``reduce_scatter_single``, or their older names where those are absent
    (torch 2.13 deprecates ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor`` for them)."""
    dist = _dist()
    old = {"all_gather_single": "all_gather_into_tensor",
           "reduce_scatter_single": "reduce_scatter_tensor"}[name]
    return getattr(dist, name, None) or getattr(dist, old)


def init_distributed(dist_backend: Optional[str] = None,
                     auto_mpi_discovery: bool = True,
                     distributed_port: int = 29500,
                     verbose: bool = True,
                     timeout=None,
                     init_method: Optional[str] = None,
                     dist_init_required: Optional[bool] = None,
                     config=None,
                     rank: int = -1,
                     world_size: int = -1,
                     device=None) -> None:
    """Join the process group (≅ reference comm/comm.py:561).

    ``rank`` and ``world_size`` come from the arguments or from ``RANK`` /
    ``WORLD_SIZE``; the rendezvous is ``init_method`` (e.g. a
    ``file://`` store) or ``env://`` from ``MASTER_ADDR`` / ``MASTER_PORT``
    (``distributed_port`` when the port is unset). A single process without
    ``init_method`` or ``dist_init_required=True`` makes no group (a no-op,
    as in the JAX package), and ``dist_init_required=False`` makes none in
    any world. ``dist_backend`` defaults to ``nccl`` when
    ``device`` (default ``cuda``) is a CUDA device and ``gloo`` for
    ``"cpu"``. ``timeout`` is in seconds (or a ``timedelta``)."""
    global _initialized
    dist = _dist()
    if _dist_on():
        if config is not None:
            configure(config)
        _initialized = True
        return
    env_world = int(os.environ.get("WORLD_SIZE", "1")) if world_size == -1 \
        else int(world_size)
    env_rank = int(os.environ.get("RANK", "0")) if rank == -1 else int(rank)
    need = env_world > 1 or init_method is not None
    if dist_init_required is not None:
        need = bool(dist_init_required)
    if need:
        if dist_backend is None:
            from ..accelerator.real_accelerator import resolve_device

            dist_backend = "nccl" if resolve_device(device).type == "cuda" \
                else "gloo"
        if init_method is None:
            if "MASTER_ADDR" not in os.environ:
                raise RuntimeError(
                    f"init_distributed: a world of {env_world} needs "
                    f"init_method= or MASTER_ADDR/MASTER_PORT")
            os.environ.setdefault("MASTER_PORT", str(distributed_port))
            init_method = "env://"
        kwargs = {}
        if timeout is not None:
            kwargs["timeout"] = timeout if isinstance(
                timeout, datetime.timedelta) else \
                datetime.timedelta(seconds=float(timeout))
        if verbose:
            logger.info(f"init_distributed: backend={dist_backend} "
                        f"rank={env_rank} world_size={env_world} "
                        f"init_method={init_method}")
        dist.init_process_group(dist_backend, init_method=init_method,
                                rank=env_rank, world_size=env_world,
                                **kwargs)
    if config is not None:
        configure(config)
    _initialized = True


def is_initialized() -> bool:
    return _initialized or _dist_on()


def get_backend() -> Optional[str]:
    return _dist().get_backend() if _dist_on() else None


def configure(config=None, enabled=None, prof_all=None, prof_ops=None,
              verbose=None, debug=None) -> None:
    """``config``: a ``DeepSpeedConfig`` (its ``comms_logger`` block) or
    the block itself."""
    if config is not None:
        comms_logger.configure(getattr(config, "comms_logger", config))
    if enabled is not None:
        comms_logger.enabled = enabled
    if prof_all is not None:
        comms_logger.prof_all = prof_all
    if prof_ops is not None:
        comms_logger.prof_ops = prof_ops
    if verbose is not None:
        comms_logger.verbose = verbose
    if debug is not None:
        comms_logger.debug = debug


def get_rank() -> int:
    return _dist().get_rank() if _dist_on() else 0


def get_world_size(group: Group = None) -> int:
    """The world's size (``group=None``), or the size of the group along
    the named mesh axes."""
    if group is None:
        return _dist().get_world_size() if _dist_on() else 1
    return _axes_size(group)


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def _axes(group: Group) -> tuple:
    if group is None:
        # the default group is the whole data-parallel world; under a
        # MiCS-factored mesh that includes the replica axis (data_outer)
        axes = tuple(mesh_mod.ZERO_AXES)
        if mesh_mod.has_mesh() and \
                mesh_mod.DATA_OUTER_AXIS in mesh_mod.get_mesh().axis_names:
            axes = (mesh_mod.DATA_OUTER_AXIS,) + axes
        return axes
    if isinstance(group, str):
        return (group,)
    return tuple(group)


def _no_group(group: Group) -> None:
    """Without a process group every group is one rank, unless an
    installed mesh says otherwise: then a collective cannot run, and it
    raises rather than return its input."""
    if mesh_mod.has_mesh():
        n = mesh_mod.get_mesh().axis_size(_axes(group))
        if n > 1:
            raise RuntimeError(
                f"a collective over {_axes(group)} ({n} ranks by the "
                f"installed mesh) without a process group: call "
                f"init_distributed first")


def _axes_size(group: Group) -> int:
    if not _dist_on():
        _no_group(group)
        return 1
    return mesh_mod.get_mesh().axis_size(_axes(group))


def _resolve(group: Group):
    """(process group or None, size, this rank's index in it). ``None``
    with size 1 means: no call. A world of one rank with a process group
    calls the backend on the default group; a group the installed mesh
    makes larger than one rank, without a process group, raises."""
    if not _dist_on():
        _no_group(group)
        return None, 1, 0
    mesh = mesh_mod.get_mesh()
    axes = _axes(group)
    n = mesh.axis_size(axes)
    if n == 1:
        if _dist().get_world_size() == 1:
            return _dist().group.WORLD, 1, 0
        return None, 1, 0
    return mesh.group(axes), n, mesh.axis_rank(axes)


_TORCH_OPS = {ReduceOp.SUM: "SUM", ReduceOp.PRODUCT: "PRODUCT",
              ReduceOp.MIN: "MIN", ReduceOp.MAX: "MAX"}


def _torch_op(op: str):
    if op not in _TORCH_OPS:
        raise ValueError(f"unknown reduce op {op}")
    return getattr(_dist().ReduceOp, _TORCH_OPS[op])


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------
def timed_op(func):
    """Latency/bandwidth-record decorator, ≅ reference comm/comm.py:100.
    A CUDA tensor's op is timed to the device's completion."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if not comms_logger.enabled:
            return func(*args, **kwargs)
        name = func.__name__
        prof = comms_logger.prof_all or name in comms_logger.prof_ops
        if not prof:
            return func(*args, **kwargs)
        tensor = args[0] if args else kwargs.get("tensor")
        if isinstance(tensor, torch.Tensor):
            msg_size = tensor.numel() * tensor.element_size()
        else:
            msg_size = int(np.asarray(tensor).nbytes) \
                if tensor is not None else 0
        start = time.perf_counter()
        result = func(*args, **kwargs)
        if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
            torch.cuda.synchronize(tensor.device)
        latency = time.perf_counter() - start
        record = name
        if comms_logger.debug:
            record += f" | [Caller Func: {get_caller_func()}]"
        comms_logger.append(name, record, latency, msg_size,
                            get_world_size(kwargs.get("group")))
        return result

    return wrapper


# ---------------------------------------------------------------------------
# collectives over mesh axes
# ---------------------------------------------------------------------------
@timed_op
def all_reduce(tensor: torch.Tensor, op: str = ReduceOp.SUM,
               group: Group = None) -> torch.Tensor:
    """≅ dist.all_reduce over the group's ranks, in place; returns
    ``tensor``."""
    pg, n, _ = _resolve(group)
    if pg is None:
        return tensor
    if op == ReduceOp.AVG:
        _dist().all_reduce(tensor, group=pg)
        return tensor.div_(n)
    _dist().all_reduce(tensor, op=_torch_op(op), group=pg)
    return tensor


def _gather_stacked(tensor: torch.Tensor, pg, n: int) -> torch.Tensor:
    """(n, *tensor.shape): every rank's tensor, in group order."""
    t = tensor.contiguous()
    buf = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    _collective("all_gather_single")(buf.view(-1), t.view(-1), group=pg)
    return buf


@timed_op
def all_gather_into_tensor(tensor: torch.Tensor, group: Group = None,
                           axis: int = 0, tiled: bool = True
                           ) -> torch.Tensor:
    """The group's tensors concatenated along ``axis`` (``tiled``), or
    stacked along a new ``axis`` (the JAX ``lax.all_gather``); a negative
    ``axis`` counts from the end of the result."""
    pg, n, _ = _resolve(group)
    if pg is None:
        return tensor if tiled else tensor.unsqueeze(axis)
    axis %= tensor.dim() + (0 if tiled else 1)
    buf = _gather_stacked(tensor, pg, n)
    if not tiled:
        return buf.movedim(0, axis)
    shape = list(tensor.shape)
    shape[axis] *= n
    return buf.movedim(0, axis).reshape(shape)


@timed_op
def reduce_scatter_tensor(tensor: torch.Tensor, group: Group = None,
                          scatter_dimension: int = 0, tiled: bool = True,
                          op: str = ReduceOp.SUM) -> torch.Tensor:
    """This rank's slice along ``scatter_dimension`` of the group's sum
    (the JAX ``lax.psum_scatter``; ``tiled=False`` drops the dimension,
    whose size must then be the group's). ``tensor`` is not modified."""
    pg, n, _ = _resolve(group)
    d = scatter_dimension
    if pg is None:
        return tensor if tiled else tensor.squeeze(d)
    size = tensor.shape[d]
    if size % n:
        raise ValueError(f"reduce_scatter: dim {d} of {tuple(tensor.shape)} "
                         f"does not split into {n}")
    k = size // n
    shape = list(tensor.shape)
    split = shape[:d] + [n, k] + shape[d + 1:]
    parts = tensor.reshape(split).movedim(d, 0).contiguous()
    out = torch.empty(parts.shape[1:], dtype=tensor.dtype,
                      device=tensor.device)
    _collective("reduce_scatter_single")(
        out.view(-1), parts.view(-1),
        op=_torch_op(ReduceOp.SUM if op == ReduceOp.AVG else op), group=pg)
    out = out.reshape(shape[:d] + [k] + shape[d + 1:])
    if op == ReduceOp.AVG:
        out = out.div_(n)
    return out if tiled else out.squeeze(d)


@timed_op
def all_to_all_single(tensor: torch.Tensor, group: Group = None,
                      split_axis: int = 0, concat_axis: int = 0,
                      tiled: bool = True) -> torch.Tensor:
    """Split ``tensor`` along ``split_axis`` into the group's size of
    chunks, chunk j to the group's j-th rank; return the received chunks
    concatenated along ``concat_axis`` (the JAX ``lax.all_to_all``,
    ``tiled``)."""
    if not tiled:
        raise NotImplementedError("all_to_all_single: only tiled=True")
    pg, n, _ = _resolve(group)
    if pg is None:
        return tensor
    if tensor.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of "
                         f"{tuple(tensor.shape)} does not split into {n}")
    send = torch.stack(tensor.chunk(n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    _dist().all_to_all_single(recv, send, group=pg)
    return torch.cat(list(recv.unbind(0)), dim=concat_axis)


@timed_op
def broadcast(tensor: torch.Tensor, src: int = 0,
              group: Group = None) -> torch.Tensor:
    """≅ dist.broadcast from global rank ``src``, in place."""
    pg, _, _ = _resolve(group)
    if pg is None:
        return tensor
    _dist().broadcast(tensor, src=src, group=pg)
    return tensor


def barrier(group: Group = None, name: str = "") -> None:
    pg, _, _ = _resolve(group)
    if pg is not None:
        _dist().barrier(group=pg)


def ppermute(tensor, perm, group: Group = None):
    """Point-to-point ring transfer: a pipeline stage's send and receive
    inside a compiled program in the JAX package."""
    raise NotImplementedError(
        "ppermute (point-to-point stage transfers) belongs to pipeline "
        "parallelism, which is not ported to the PyTorch/CUDA package yet")


def axis_index(group: Group = None):
    raise NotImplementedError(
        "axis_index is an in-program op of pipeline parallelism, which is "
        "not ported to the PyTorch/CUDA package yet; use "
        "parallel.mesh.get_mesh().axis_rank(axes)")


# ---------------------------------------------------------------------------
# host (control-plane) collectives over the whole world
# ---------------------------------------------------------------------------
def _host_device() -> torch.device:
    if get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _world_group():
    if not _dist_on():
        return None, 1, 0
    dist = _dist()
    return dist.group.WORLD, dist.get_world_size(), dist.get_rank()


@timed_op
def all_reduce_host(tensor, op: str = ReduceOp.SUM):
    """All-reduce of a host value over the world; returns numpy."""
    pg, n, _ = _world_group()
    arr = np.asarray(tensor)
    if pg is None:
        return arr
    t = torch.as_tensor(arr).to(_host_device())
    if op == ReduceOp.AVG:
        _dist().all_reduce(t, group=pg)
        t = t / n
    else:
        _dist().all_reduce(t, op=_torch_op(op), group=pg)
    return t.cpu().numpy()


@timed_op
def broadcast_host(tensor, src: int = 0):
    pg, _, _ = _world_group()
    arr = np.asarray(tensor)
    if pg is None:
        return arr
    t = torch.as_tensor(arr).to(_host_device())
    _dist().broadcast(t, src=src, group=pg)
    return t.cpu().numpy()


def broadcast_object(obj, src: int = 0):
    """A picklable host value from global rank ``src`` to every rank of the
    world (``obj`` is ignored on the others)."""
    pg, _, _ = _world_group()
    if pg is None:
        return obj
    box = [obj]
    _dist().broadcast_object_list(box, src=src, group=pg,
                                  device=_host_device())
    return box[0]


@timed_op
def all_gather_host(tensor, group: Group = None):
    """(n, *shape): every rank's host value, over the world (``group``
    None, as every host collective) or the group along the named mesh
    axes."""
    pg, n, _ = _world_group() if group is None else _resolve(group)
    arr = np.asarray(tensor)
    if pg is None or n == 1:
        return arr[None]
    t = torch.as_tensor(arr).to(_host_device())
    return _gather_stacked(t, pg, n).cpu().numpy()


def log_summary(show_straggler: bool = False):
    """≅ reference comm/comm.py:408."""
    return comms_logger.log_all(print_log=True, show_straggler=show_straggler)


# ---------------------------------------------------------------------------
# cross-rank consistency checks (the reference's
# assert_ints_same_as_other_ranks, stage3.py:1080): hash the inputs every
# rank must agree on and compare on the host
# ---------------------------------------------------------------------------
def stable_hash(value) -> int:
    """Deterministic 63-bit hash of a (nested) value via canonical repr."""

    def canon(v):
        if isinstance(v, dict):
            items = sorted(v.items(), key=lambda kv: str(kv[0]))
            return "{" + ",".join(
                f"{k}:{canon(val)}" for k, val in items) + "}"
        if isinstance(v, (list, tuple)):
            return "[" + ",".join(canon(x) for x in v) + "]"
        if hasattr(v, "shape") and hasattr(v, "dtype"):
            return f"arr({tuple(v.shape)},{v.dtype})"
        return repr(v)

    data = canon(value).encode()
    return (zlib.crc32(data) << 31) | zlib.crc32(data[::-1])


def assert_same_across_ranks(value, name: str = "value") -> None:
    """Raise (on every rank, with the per-rank table) if ``value``'s stable
    hash differs across processes. Single process: no-op."""
    if get_world_size() == 1:
        return
    h = np.int64(stable_hash(value) % (2 ** 62))
    gathered = all_gather_host(h)
    if not (gathered == gathered[0]).all():
        table = ", ".join(f"rank{i}={int(v)}" for i, v in enumerate(gathered))
        raise RuntimeError(
            f"cross-rank consistency check failed for {name!r}: processes "
            f"disagree ({table}). Every rank must feed the same config and "
            f"batch structure (the reference's "
            f"assert_ints_same_as_other_ranks, stage3.py:1080).")
