"""Checkpoint tools of the port: the weight bridge from the JAX package's
trees (``flax_import``), universal checkpoints, the fp32 export and the
Megatron-DeepSpeed reader and GPT-2 importer, under the JAX package's
names (``megatron_gpt2_state_dict`` stands for ``megatron_gpt2_to_flax``).
"""

from .deepspeed_checkpoint import DeepSpeedCheckpoint
from .gpt2_import import megatron_gpt2_state_dict
from .reshape_3d_utils import get_model_3d_descriptor, model_3d_desc
from .reshape_meg_2d import meg_2d_parallel_map, reshape_meg_2d_parallel
from .universal_checkpoint import ds_to_universal, load_universal, universal_dir
from .zero_to_fp32 import (
    convert_zero_checkpoint_to_fp32_state_dict,
    get_fp32_state_dict_from_zero_checkpoint,
)

__all__ = [
    "ds_to_universal", "load_universal", "universal_dir",
    "get_fp32_state_dict_from_zero_checkpoint",
    "convert_zero_checkpoint_to_fp32_state_dict",
    "DeepSpeedCheckpoint", "meg_2d_parallel_map", "reshape_meg_2d_parallel",
    "model_3d_desc", "get_model_3d_descriptor", "megatron_gpt2_state_dict",
]
