"""The data-parallel layer on a card. Marked ``cuda``: each test skips
without a CUDA device (decided inside the test). Run on a GPU machine with

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_dp.py

* A NCCL process group of one rank changes nothing: a tiny GPT-2 in bf16
  (flash kernels on) trains three steps at ZeRO stages 0 and 3 with the
  same losses and final masters, bit for bit, as without a group.
* Two gloo ranks on one card: all_gather, reduce_scatter and all_to_all
  with CUDA tensors (PyTorch's backend table lists only all_reduce and
  broadcast for gloo with CUDA tensors; the installed PyTorch's gloo runs
  them all) equal the exact results in fp32 and bf16 (small integers:
  every sum is exact).
"""

import pytest
import torch

from _torch_dist import spawn
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.cuda

TINY = dict(vocab_size=256, n_positions=128, n_embd=128, n_layer=2,
            n_head=2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and CUDA tensors")


def _run(stage):
    from deepspeed_tpu_torch.models import gpt2 as PG

    import numpy as np

    cfg = PG.GPT2Config(**TINY, dtype=torch.float32,
                        use_flash_attention=True)
    model = PG.GPT2LMHeadModel(cfg, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, 256, (8, 128)).astype(np.int32)}
               for _ in range(3)]
    config = {"train_micro_batch_size_per_gpu": 4,
              "gradient_accumulation_steps": 2, "bf16": {"enabled": True},
              "zero_optimization": {"stage": stage},
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
              "gradient_clipping": 1.0, "steps_per_print": 100}
    return dict(model=(cfg, state, torch.bfloat16), config=config,
                batches=batches)


def _on_cuda(run):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.parallel import mesh as mesh_mod
    from _torch_dist import build_model, rank_rows

    mesh_mod.reset_mesh()
    engine, *_ = dst.initialize(model=build_model(run["model"]),
                                config=run["config"])
    losses = [float(engine.train_batch(batch=rank_rows(b, 0, 1, 2)))
              for b in run["batches"]]
    return losses, [m.clone() for m in engine.master]


@pytest.mark.parametrize("stage", [0, 3])
def test_nccl_world_one_equals_no_group(stage, tmp_path):
    _card()
    import torch.distributed as dist

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm import comm as comm_mod
    from deepspeed_tpu_torch.parallel import mesh as mesh_mod

    run = _run(stage)
    alone = _on_cuda(run)
    comm.init_distributed(init_method=f"file://{tmp_path}/store", rank=0,
                          world_size=1, verbose=False)
    try:
        assert dist.get_backend() == "nccl"
        grouped = _on_cuda(run)
    finally:
        dist.destroy_process_group()
        comm_mod._initialized = False
        mesh_mod.reset_mesh()
    assert alone[0] == grouped[0]
    for a, g in zip(alone[1], grouped[1]):
        assert torch.equal(a, g)


def test_gloo_collectives_on_cuda_are_exact(tmp_path):
    _card()
    results = spawn("gloo_cuda", 2, tmp_path, timeout=180)
    for res in results:
        assert res.pop("backend") == "gloo"
        assert all(res.values()), res
