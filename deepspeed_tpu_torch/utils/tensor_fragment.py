"""Whole-tensor access to ZeRO-partitioned training state: the port of
``deepspeed_tpu/utils/tensor_fragment.py`` (the reference's
``safe_get_full_*`` / ``safe_set_full_*``, tensor_fragment.py:48-124).

A parameter is addressed by its name in the port's state dict
(``engine.module``'s dotted names, e.g. ``blocks.0.attn.qkv.weight``).
Over a data-parallel world each rank holds slices
(``runtime/zero/partition.py``), and over a model group tensor-parallel
parts: the getters all-gather them (the data group, then the model group),
so every rank calls them together; the setter writes each rank's slice of
the value it is given (the same value on every rank). Under optimizer
offload the host optimizer's whole tensors are read and written.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_MOMENTS = {"exp_avg": "m", "exp_avg_sq": "v"}


def _index(engine, param_path: str) -> Optional[int]:
    name = param_path.replace("/", ".")
    try:
        return engine._param_names.index(name)
    except ValueError:
        return None


def _whole(engine, i: int, t: torch.Tensor) -> np.ndarray:
    lay = engine._part.layouts[i]
    if tuple(t.shape) != lay.shape:
        t = engine._part.gather(lay, t)
    t = engine._tp_whole(engine._param_names[i], t)
    return t.detach().float().cpu().numpy().copy()


def safe_get_full_fp32_param(engine, param_path: str) -> Optional[np.ndarray]:
    """The full fp32 master weights of one parameter (the parameter in fp32
    where the engine keeps no master)."""
    i = _index(engine, param_path)
    if i is None:
        return None
    if engine._offload_opt is not None:
        name = engine._param_names[i]
        if name in engine._offload_opt.master:
            return np.asarray(engine._offload_opt.read_leaf("master", name),
                              np.float32)
    return _whole(engine, i, engine._targets[i])


def safe_get_full_grad(engine, param_path: str) -> Optional[np.ndarray]:
    """The full gradient sum this rank has accumulated since the last step
    (the eager ``backward`` path; ``train_batch`` consumes it). A stage-2
    or -3 accumulator is already the ZeRO group's sum of its slice; a whole
    one is this rank's own sum."""
    i = _index(engine, param_path)
    if i is None or not engine._grad_acc:
        return None
    return _whole(engine, i, engine._grad_acc[i])


def safe_get_full_optimizer_state(engine, param_path: str,
                                  optim_state_key: str
                                  ) -> Optional[np.ndarray]:
    """One optimizer field of one parameter (``exp_avg`` | ``exp_avg_sq``,
    or any field of the optimizer's state), whole."""
    i = _index(engine, param_path)
    if i is None:
        return None
    if engine._offload_opt is not None:
        kind = _MOMENTS.get(optim_state_key)
        if kind is None:
            return None
        return np.asarray(engine._offload_opt.read_leaf(
            kind, engine._param_names[i]))
    opt = engine.opt_state
    if opt is None or optim_state_key not in opt._fields:
        return None
    return _whole(engine, i, getattr(opt, optim_state_key)[i])


@torch.no_grad()
def safe_set_full_fp32_param(engine, param_path: str, value) -> bool:
    """Overwrite one parameter's master weights and its compute copy with
    the whole ``value`` (each rank keeps its slices)."""
    i = _index(engine, param_path)
    if i is None:
        return False
    lay = engine._part.layouts[i]
    whole = torch.as_tensor(np.asarray(value, np.float32))
    full = engine._tp_part(engine._param_names[i], whole)
    for t in {id(x): x for x in (engine._targets[i],
                                 engine._params[i])}.values():
        t.copy_(engine._part.take(lay, full, t))
    if engine._offload_opt is not None:
        engine._offload_opt.write_leaf("master", engine._param_names[i],
                                       whole.numpy())
    return True
