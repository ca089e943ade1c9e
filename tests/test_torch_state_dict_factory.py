"""Model-parallel resharding of Megatron state dicts: the port's
``runtime/state_dict_factory.py`` against the JAX package's. Shards of a
one-layer Megatron GPT (fused ``query_key_value`` weight and bias,
row-parallel ``dense`` and ``dense_4h_to_h``, column-parallel
``dense_h_to_4h``, vocab-parallel embeddings, whole layernorms, a scalar)
saved at model-parallel degrees 1 and 2 (``.npz`` and ``.pt``, bf16 among
them) are loaded at 1, 2 and 4 ranks, checkpoint versions 0 and 2: every
rank's arrays equal the JAX loader's, exactly, and the merged and split
version-0 qkv regroups Q, K and V."""

import json

import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime import state_dict_factory as J
from deepspeed_tpu_torch.runtime import state_dict_factory as P

from _torch_threads import one_thread  # noqa: F401

H = 8          # hidden


def _full(rng):
    return {
        "language_model.embedding.word_embeddings.weight":
            rng.standard_normal((16, H)),
        "language_model.transformer.layers.0.input_layernorm.weight":
            rng.standard_normal(H),
        "language_model.transformer.layers.0.attention.query_key_value."
        "weight": rng.standard_normal((3 * H, H)),
        "language_model.transformer.layers.0.attention.query_key_value."
        "bias": rng.standard_normal(3 * H),
        "language_model.transformer.layers.0.attention.dense.weight":
            rng.standard_normal((H, H)),
        "language_model.transformer.layers.0.mlp.dense_h_to_4h.weight":
            rng.standard_normal((4 * H, H)),
        "language_model.transformer.layers.0.mlp.dense_4h_to_h.weight":
            rng.standard_normal((H, 4 * H)),
        "checkpoint_version": np.float64(2.0),
    }


def _save(tmp_path, shards, fmt):
    paths = []
    for i, sd in enumerate(shards):
        path = str(tmp_path / f"mp_rank_{i:02d}.{fmt}")
        if fmt == "npz":
            np.savez(path, **{k: np.asarray(v, np.float32)
                              for k, v in sd.items()})
        else:
            torch.save({"module": {k: torch.as_tensor(
                np.asarray(v, np.float32)).to(
                torch.bfloat16 if "dense" in k else torch.float32)
                for k, v in sd.items()}}, path)
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{(version, saved degree, fmt): shard paths}: one full state dict
    split into 2 by the JAX loader's own rules for each version."""
    out = {}
    full = _full(np.random.default_rng(0))
    for version in (0, 2):
        split = J.MegatronSDLoader([], version)
        two = [split.split_state_dict(full, 2, i) for i in range(2)]
        for fmt in ("npz", "pt"):
            for mp, shards in ((1, [full]), (2, two)):
                tmp = tmp_path_factory.mktemp(f"v{version}{fmt}{mp}")
                out[(version, mp, fmt)] = _save(tmp, shards, fmt)
    return out


@pytest.mark.parametrize("fmt", ["npz", "pt"])
@pytest.mark.parametrize("version", [0, 2])
@pytest.mark.parametrize("saved_mp,target_mp", [(1, 2), (2, 1), (2, 4),
                                                (2, 2)])
def test_load_matches_jax(saved, fmt, version, saved_mp, target_mp):
    paths = saved[(version, saved_mp, fmt)]
    port = P.SDLoaderFactory.get_sd_loader(paths, "Megatron", version)
    jax_ = J.SDLoaderFactory.get_sd_loader(paths, "Megatron", version)
    assert port.ckpt_mp_size == jax_.ckpt_mp_size == saved_mp
    for rank in range(target_mp):
        got, want = port.load(target_mp, rank), jax_.load(target_mp, rank)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(want[key]), key)


@pytest.mark.parametrize("version", [0, 2])
def test_qkv_regroup_round_trip(version):
    """Split then merge gives the original back; at version 0 each shard
    holds a block of Q, one of K and one of V."""
    full = _full(np.random.default_rng(1))
    loader = P.MegatronSDLoader([], version)
    parts = [loader.split_state_dict(full, 2, i) for i in range(2)]
    merged = loader.merge_state_dicts(parts)
    for key in full:
        np.testing.assert_array_equal(merged[key], full[key])
    qkv = "language_model.transformer.layers.0.attention.query_key_value." \
        "weight"
    q = full[qkv][:H]
    if version == 0:
        np.testing.assert_array_equal(parts[1][qkv][:H // 2], q[H // 2:])
    else:
        np.testing.assert_array_equal(parts[0][qkv], full[qkv][:3 * H // 2])


def test_factory_json_and_unknown_type(tmp_path):
    desc = {"type": "Megatron", "checkpoints": ["a.npz", "b.npz"],
            "version": 2.0}
    path = tmp_path / "ckpt.json"
    path.write_text(json.dumps(desc))
    for src in (desc, str(path)):
        loader = P.SDLoaderFactory.get_sd_loader_json(src)
        assert loader.ckpt_mp_size == 2 and loader.version == 2.0
    with pytest.raises(ValueError, match="unknown sd_type"):
        P.SDLoaderFactory.get_sd_loader([], "hf")


class _Custom:
    """A class ``weights_only`` unpickling does not allow."""


def test_pt_with_code_needs_trust(tmp_path, monkeypatch):
    """A ``.pt`` shard that only full unpickling can read is refused
    unless ``DS_TRUST_CHECKPOINT=1``, as the checkpoint module's loads
    are."""
    path = str(tmp_path / "mp_rank_00.pt")
    torch.save({"module": {"w": torch.ones(2)}, "extra": _Custom()}, path)
    loader = P.SDLoaderFactory.get_sd_loader([path], "Megatron", 2.0)
    monkeypatch.delenv("DS_TRUST_CHECKPOINT", raising=False)
    with pytest.raises(RuntimeError, match="DS_TRUST_CHECKPOINT"):
        loader.load(1, 0)
    monkeypatch.setenv("DS_TRUST_CHECKPOINT", "1")
    np.testing.assert_array_equal(loader.load(1, 0)["w"], np.ones(2))
