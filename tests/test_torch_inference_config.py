"""The port's inference config parses the JAX package's CUDA switches.

``enable_cuda_graph``, ``use_triton`` and ``triton_autotune`` are accepted
by the JAX ``DeepSpeedInferenceConfig`` as no-ops; the port accepts and
records them the same way, and ``checkpoint`` too (a path, a dict or None,
which no code of either package reads). The keys it has no feature for
yet still raise.
"""

import pytest

from deepspeed_tpu.inference.config import \
    DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu_torch.inference.config import (_NOT_PORTED,
                                                  DeepSpeedInferenceConfig)

SWITCHES = ("enable_cuda_graph", "use_triton", "triton_autotune")


@pytest.mark.parametrize("key", SWITCHES)
@pytest.mark.parametrize("value", [True, False])
def test_cuda_switches_parse_as_in_jax(key, value):
    cfg = {"dtype": "bfloat16", key: value}
    assert getattr(JaxInferenceConfig(**cfg), key) is value
    assert getattr(DeepSpeedInferenceConfig.from_dict(cfg), key) is value
    assert getattr(DeepSpeedInferenceConfig.from_dict({}), key) is False


def test_all_switches_together_and_unported_keys_still_raise():
    cfg = DeepSpeedInferenceConfig.from_dict(dict.fromkeys(SWITCHES, True))
    assert all(getattr(cfg, k) for k in SWITCHES)
    assert not set(SWITCHES) & set(_NOT_PORTED)
    on = {"zero": {"stage": 3}, "injection_policy": {"Block": ("attn",)}}
    assert set(on) == set(_NOT_PORTED)
    for key, value in on.items():
        DeepSpeedInferenceConfig.from_dict({key: _NOT_PORTED[key]})
        with pytest.raises(NotImplementedError, match=key):
            DeepSpeedInferenceConfig.from_dict({key: value})
    # the checkpoint key parses and is recorded, as in the JAX package
    for value in ("ckpt.json", {"type": "Megatron", "checkpoints": []}, None):
        want = JaxInferenceConfig(checkpoint=value).checkpoint
        assert DeepSpeedInferenceConfig.from_dict(
            {"checkpoint": value}).checkpoint == want == value
