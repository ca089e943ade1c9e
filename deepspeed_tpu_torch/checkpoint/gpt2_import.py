"""Import a reference-format (Megatron-DeepSpeed) GPT-2 checkpoint into the
port's GPT-2: the port of ``deepspeed_tpu/checkpoint/gpt2_import.py``
(``megatron_gpt2_to_flax``, :59).

:class:`DeepSpeedCheckpoint` merges the TP/PP layer-file shards (the
qkv/row/col concat rules, ``get_layer_cat_dim``, and the version-0 qkv
regroup), and this module renames the merged tensors into
``models/gpt2.GPT2LMHeadModel``'s ``state_dict``:

* Megatron stores torch ``Linear`` weights (out, in), the port's layout, so
  nothing is transposed (the JAX importer transposes into flax kernels);
* ``query_key_value`` keeps the contiguous [q|k|v] rows of checkpoint
  version 0, which the port's ``attn.qkv`` splits the same way;
* layer files 1..L become ``blocks.{0..L-1}``;
* Megatron pads the vocabulary for TP divisibility: rows beyond
  ``config.vocab_size`` (and positions beyond ``n_positions``) are cut.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .deepspeed_checkpoint import DeepSpeedCheckpoint

# Megatron layer-file param name -> the port's name inside a block
_BLOCK_MAP = {
    "input_layernorm.weight": "ln_1.weight",
    "input_layernorm.bias": "ln_1.bias",
    "self_attention.query_key_value.weight": "attn.qkv.weight",
    "self_attention.query_key_value.bias": "attn.qkv.bias",
    "self_attention.dense.weight": "attn.proj.weight",
    "self_attention.dense.bias": "attn.proj.bias",
    # pre-SelfAttention-rename Megatron checkpoints
    "attention.query_key_value.weight": "attn.qkv.weight",
    "attention.query_key_value.bias": "attn.qkv.bias",
    "attention.dense.weight": "attn.proj.weight",
    "attention.dense.bias": "attn.proj.bias",
    "post_attention_layernorm.weight": "ln_2.weight",
    "post_attention_layernorm.bias": "ln_2.bias",
    "mlp.dense_h_to_4h.weight": "mlp.fc.weight",
    "mlp.dense_h_to_4h.bias": "mlp.fc.bias",
    "mlp.dense_4h_to_h.weight": "mlp.proj.weight",
    "mlp.dense_4h_to_h.bias": "mlp.proj.bias",
}


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def megatron_gpt2_state_dict(ckpt_dir: str, config) -> Dict[str, torch.Tensor]:
    """Read a Megatron-DeepSpeed GPT-2 layer-file checkpoint (any original
    TP/PP degree) and return the whole (unsharded) fp32 ``state_dict`` of
    the port's ``GPT2LMHeadModel(config)``; load it with
    ``load_state_dict`` or pass it as ``initialize(model_parameters=...)``.
    """
    ckpt = DeepSpeedCheckpoint(ckpt_dir, tp_degree=1, pp_degree=1)
    version = ckpt.checkpoint_version()
    if version >= 1.0:
        raise NotImplementedError(
            f"checkpoint_version {version}: versions >= 1.0 store qkv "
            f"per-head-interleaved, which does not match this model's "
            f"contiguous [q|k|v] split — re-layout support is not "
            f"implemented; convert with Megatron's own tools first")
    sd: Dict[str, torch.Tensor] = {}
    emb = ckpt.get_embedding_state(0)
    sd["wte.weight"] = _tensor(
        np.asarray(emb["word_embeddings.weight"])[:config.vocab_size])
    if "position_embeddings.weight" in emb:
        sd["wpe.weight"] = _tensor(
            np.asarray(emb["position_embeddings.weight"])
            [:config.n_positions])
    norm = ckpt.get_final_norm_state(0)
    sd["ln_f.weight"] = _tensor(norm["weight"])
    if "bias" in norm:
        sd["ln_f.bias"] = _tensor(norm["bias"])

    # one merged state dict per transformer layer: the per-layer files are
    # one-per-original-tp-rank; merge with the qkv/row/col concat rules
    layer_keys = ckpt.layer_keys[1:-1]
    assert len(layer_keys) == config.n_layer, \
        f"checkpoint has {len(layer_keys)} transformer layers, config " \
        f"wants {config.n_layer}"
    for li, layer_key in enumerate(layer_keys):
        for name, value in ckpt.merged_layer_state(layer_key).items():
            if name in _BLOCK_MAP:
                sd[f"blocks.{li}.{_BLOCK_MAP[name]}"] = _tensor(value)
    return sd
