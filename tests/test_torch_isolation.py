"""Boundaries of the PyTorch/CUDA port that hold without a card: it never
imports JAX or the JAX package, it refuses to fall back to the CPU
silently, CPU tensors never reach the kernel builder (the offload paths'
host ops build with the C++ compiler instead), and the builder targets
Hopper and writes into the ignored build directory."""

import ast
import subprocess
from pathlib import Path

import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models.transformer_lm import (TransformerLM,
                                                       transformer_config)
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.attention.decode_attention import \
    decode_attention
from deepspeed_tpu_torch.ops.attention.flash_attention import \
    flash_attention
from deepspeed_tpu_torch.ops.attention.paged_attention import \
    paged_decode_attention
from deepspeed_tpu_torch.ops.quantization import QuantDense, int8_matmul

from _torch_threads import one_thread  # noqa: F401


REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ml_dtypes", "deepspeed_tpu"}


def _port_files():
    return sorted((REPO / "deepspeed_tpu_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    # the serving fleet's modules are scanned like every other
    names = {str(f.relative_to(REPO)) for f in files}
    assert {f"deepspeed_tpu_torch/{m}.py" for m in (
        "serving/router", "telemetry/fleet", "serving/frontend/bridge",
        "serving/frontend/server")} <= names
    # and the tensor-parallel serving modules
    assert {f"deepspeed_tpu_torch/{m}.py" for m in (
        "parallel/axis_rules", "module_inject/__init__",
        "module_inject/layers", "runtime/state_dict_factory")} <= names
    bad = {str(f.relative_to(REPO)): sorted(set(_imported_roots(f))
                                            & FORBIDDEN)
           for f in files}
    assert not {f: r for f, r in bad.items() if r}


def test_entry_points_refuse_to_default_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = TransformerLM(transformer_config(
        "gpt2", vocab_size=32, max_seq_len=16, n_embd=16, n_layer=1,
        n_head=2, dtype=torch.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dst.init_inference(model, config={"dtype": "float32"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dst.init_serving(model, config={"dtype": "float32"})
    eng = dst.init_inference(model, config={"dtype": "float32"},
                             device="cpu")
    assert eng.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dst.get_accelerator()
    cpu = dst.get_accelerator("cpu")
    assert cpu.devices() == [torch.device("cpu")]
    assert cpu.memory_stats() == {} and not cpu.is_sm90()
    with pytest.raises(ValueError, match="unsupported device"):
        dst.get_accelerator("meta")


def test_cuda_accelerator_probes_hopper(monkeypatch):
    from deepspeed_tpu_torch.accelerator import CudaAccelerator

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for cap, want in (((9, 0), True), ((8, 0), False)):
        monkeypatch.setattr(torch.cuda, "get_device_capability",
                            lambda *a, cap=cap: cap)
        assert CudaAccelerator().is_sm90() is want
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert not CudaAccelerator().is_sm90()


def test_cpu_tensors_never_reach_the_kernel_builder(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("op builder called for CPU tensors")

    for name in ("build", "load", "launch", "find_nvcc"):
        monkeypatch.setattr(op_builder, name, refuse)
    q = torch.randn(1, 8, 2, 32)
    flash_attention(q, q, q)
    cache = torch.randn(1, 2, 8, 32)
    decode_attention(q[:, 0], cache, cache, 4)
    pages = torch.randn(3, 2, 4, 32)
    paged_decode_attention(q[:, :2], pages, pages,
                           torch.tensor([[2, 0, 3]], dtype=torch.int32), 5)
    # the int8 variants and the int8 matmul, directly and through the layer
    c8, sc = cache.to(torch.int8), torch.ones(1, 2, 8)
    decode_attention(q[:, 0], c8, c8, 4, k_scale=sc, v_scale=sc)
    p8, psc = pages.to(torch.int8), torch.ones(3, 2, 4)
    paged_decode_attention(q[:, :2], p8, p8,
                           torch.tensor([[2, 0, 3]], dtype=torch.int32), 5,
                           k_scale_pages=psc, v_scale_pages=psc)
    int8_matmul(q[0], torch.ones(5, 32, dtype=torch.int8), torch.ones(5))
    QuantDense(32, 5)(q)
    assert flash_attention.launches == 0 and decode_attention.launches == 0
    assert paged_decode_attention.launches == 0 and int8_matmul.launches == 0
    assert decode_attention.int8_launches == 0
    assert paged_decode_attention.int8_launches == 0


def test_builder_targets_sm90a_in_the_ignored_build_dir(monkeypatch,
                                                        tmp_path):
    assert op_builder.BUILD_DIR == REPO / "build" / "kernels"
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored
    calls = []

    class FakeNvcc:
        def __init__(self, cmd, **kwargs):
            calls.append(cmd)
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
            self.returncode = 0

        def communicate(self):
            return b"", None

    monkeypatch.setattr(op_builder, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(op_builder, "find_nvcc", lambda: "/opt/cuda/nvcc")
    monkeypatch.setattr(subprocess, "Popen", FakeNvcc)
    paths = op_builder.build()
    assert len(calls) == len(op_builder.SIGNATURES) == len(paths)
    for cmd, path in zip(calls, paths):
        assert cmd[0] == "/opt/cuda/nvcc"
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
        assert {"-shared", "-O3", "-std=c++17"} <= set(cmd)
        assert path.exists() and path.parent == tmp_path / "kernels"
        assert op_builder.sources_hash() in path.name
    # a second build finds every library and starts no compiler
    assert op_builder.build() == paths and len(calls) == len(paths)


def test_offload_paths_use_host_ops_only(monkeypatch, tmp_path):
    """The offload engines on the CPU: the host ops (``cpu_adam``, ``aio``)
    from ``build/host/``, never ``nvcc`` or a CUDA library."""
    from deepspeed_tpu_torch.runtime.zero import offload, param_offload

    assert offload.OffloadedOptimizer and param_offload.ParamOffloadRunner
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored
    assert op_builder.HOST_BUILD_DIR == REPO / "build" / "host"

    def refuse(*args, **kwargs):
        raise AssertionError("CUDA op builder called on the CPU route")

    for name in ("build", "load", "launch", "find_nvcc"):
        monkeypatch.setattr(op_builder, name, refuse)
    cfg = transformer_config("llama", vocab_size=32, max_seq_len=8,
                             n_embd=16, n_layer=2, n_head=2,
                             dtype=torch.float32)
    config = {"train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    batch = {"input_ids": torch.randint(0, 32, (2, 8))}
    for zero in ({"offload_optimizer": {"device": "nvme",
                                        "nvme_path": str(tmp_path / "o")}},
                 {"offload_param": {"device": "nvme",
                                    "nvme_path": str(tmp_path / "p")}}):
        engine, *_ = dst.initialize(model=TransformerLM(cfg), device="cpu",
                                    config=dict(config,
                                                zero_optimization=zero))
        assert torch.isfinite(engine.train_batch(batch=batch))
    assert {p.name.split("-")[0] for p in
            op_builder.HOST_BUILD_DIR.glob("lib*.so")} >= \
        {"libaio", "libcpu_adam"}
