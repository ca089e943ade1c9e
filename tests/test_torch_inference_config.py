"""The port's inference config parses the JAX package's CUDA switches.

``enable_cuda_graph``, ``use_triton`` and ``triton_autotune`` are accepted
by the JAX ``DeepSpeedInferenceConfig`` as no-ops; the port accepts and
records them the same way, and ``checkpoint`` too (a path, a dict or None,
which no code of either package reads). Every key parses: tensor
parallelism and a truthy injection policy too (tensor-parallel serving).
"""

import pytest

from deepspeed_tpu.inference.config import \
    DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu_torch.inference.config import (_NOT_PORTED,
                                                  DeepSpeedInferenceConfig)

from _torch_threads import one_thread  # noqa: F401


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
    # every key parses now: a truthy injection policy is recorded as in the
    # JAX config (the engines read it only when truthy), and so is a
    # tensor-parallel degree above one, under either spelling
    assert _NOT_PORTED == ()
    for policy in (None, {}, {"Block": ("attn",)}):
        assert DeepSpeedInferenceConfig.from_dict(
            {"injection_policy": policy}).injection_policy == \
            JaxInferenceConfig(injection_policy=policy).injection_policy \
            == policy
    for tp in ({"mp_size": 2}, {"tensor_parallel": {"tp_size": 4}}):
        cfg = DeepSpeedInferenceConfig.from_dict(tp)
        assert cfg.mp_size == JaxInferenceConfig(
            tensor_parallel=cfg.tensor_parallel).mp_size in (2, 4)
    with pytest.raises(ValueError, match="tp_size"):
        DeepSpeedInferenceConfig.from_dict({"mp_size": 0})
    # the checkpoint and zero keys parse and are recorded, as in the JAX
    # package
    for value in ("ckpt.json", {"type": "Megatron", "checkpoints": []}, None):
        want = JaxInferenceConfig(checkpoint=value).checkpoint
        assert DeepSpeedInferenceConfig.from_dict(
            {"checkpoint": value}).checkpoint == want == value
    for value in ({}, {"stage": 0}, {"stage": 3, "offload_param": "cpu"}):
        want = JaxInferenceConfig(zero=value).zero
        assert DeepSpeedInferenceConfig.from_dict(
            {"zero": value}).zero == want == value
    assert DeepSpeedInferenceConfig.from_dict({}).zero == \
        JaxInferenceConfig().zero == {}
    # quant defaults are the JAX config's
    jq = JaxInferenceConfig(quant={"enabled": True}).quant
    assert DeepSpeedInferenceConfig.from_dict(
        {"quant": {"enabled": True}}).quant == {
        "enabled": jq.enabled, "bits": jq.bits, "group_size": jq.group_size}
