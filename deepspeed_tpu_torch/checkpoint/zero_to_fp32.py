"""ZeRO-checkpoint → consolidated fp32 state dict: the port of
``deepspeed_tpu/checkpoint/zero_to_fp32.py``.

The port's checkpoints store whole tensors, so consolidation is a read and
an upcast: the fp32 master weights where the engine kept them, else the
module's parameters in fp32, keyed by the module's dotted parameter names.
The result loads into the model with ``load_state_dict`` after a cast to
the model's dtype. The function and the CLI are the JAX package's::

    python -m deepspeed_tpu_torch.checkpoint.zero_to_fp32 CKPT_DIR OUT.npz
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

import numpy as np

from ..runtime.checkpoint_engine.checkpoint_engine import (
    ArrayCheckpointEngine,
    as_numpy,
    checkpoint_meta_path,
    read_latest,
)
from ..utils.logging import logger
from .universal_checkpoint import _flatten, _unflatten


def get_fp32_state_dict_from_zero_checkpoint(
        checkpoint_dir: str, tag: Optional[str] = None,
        flat_keys: bool = True) -> Dict[str, np.ndarray]:
    """Returns ``{param_name: fp32 ndarray}`` from a checkpoint dir —
    reference zero_to_fp32.py:459. Prefers the fp32 master weights; falls
    back to upcasting the compute-dtype module params."""
    if tag is None:
        tag = read_latest(checkpoint_dir)
    engine = ArrayCheckpointEngine()
    sd = engine.load(checkpoint_meta_path(checkpoint_dir, tag, "model",
                                          mp_rank=0, dp_rank=0))
    master = sd.get("master")
    source = master if master else sd["module"]
    # the JAX package's "/"-joined tree paths become "." (the port's names
    # have no "/")
    tree = {k.replace("/", "."): as_numpy(v, np.float32)
            for k, v in _flatten(source).items() if v is not None}
    if flat_keys:
        return tree
    return _unflatten({k.replace(".", "/"): v for k, v in tree.items()})


def convert_zero_checkpoint_to_fp32_state_dict(
        checkpoint_dir: str, output_file: str,
        tag: Optional[str] = None) -> None:
    """Write the consolidated fp32 state dict to ``output_file`` (.npz) —
    reference zero_to_fp32.py:508 writes a torch file; here it is an npz
    keyed by dotted param names, loadable with numpy alone."""
    state_dict = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    np.savez(output_file, **state_dict)
    total = sum(v.size for v in state_dict.values())
    logger.info(f"saved {len(state_dict)} params ({total / 1e6:.1f}M elems) "
                f"to {output_file}")


def main():
    parser = argparse.ArgumentParser(
        description="Extract fp32 weights from a deepspeed_tpu_torch "
        "checkpoint")
    parser.add_argument("checkpoint_dir", type=str,
                        help="checkpoint dir containing the 'latest' file")
    parser.add_argument("output_file", type=str,
                        help="output .npz path for the fp32 state dict")
    parser.add_argument("-t", "--tag", type=str, default=None)
    args = parser.parse_args()
    convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir,
                                               args.output_file, tag=args.tag)


if __name__ == "__main__":
    main()
