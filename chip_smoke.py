"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:

1. build    compile every CUDA kernel from ``deepspeed_tpu_torch/ops/csrc``
            with nvcc (sm_90a) and print the card's name and power limit.
2. kernels  hold each kernel against its plain PyTorch version on the card at
            the serving path's shapes, and time the kernel, the plain version,
            one PyTorch library call computing the same function, and the
            card's bound for the same work.
3. serve    GPT-2 small at its published widths (random weights from the
            seed), bf16, through ``init_serving(..., num_slots=8,
            prefill_chunk=0)``: 16 requests, run until drained; every request
            must finish, the invariants must hold, and both kernels' launch
            counters must rise during the run.
4. reference  for 2 served requests, the served path's prefill and decode
            logits against an fp32 copy of the model with plain attention.

The last two lines are a ``{"kernels": [...]}`` object and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 flop/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# Kernel vs plain version on the same bf16 inputs. The plain version works
# in fp32 throughout; the kernel rounds p to bf16 before the PV product (as
# the TPU kernel does) and both round the output to bf16. Outputs are
# weighted means of N(0, 1) values (|out| < 4, bf16 spacing <= 2^-6 there),
# so two roundings stay under 3e-2; a masking or indexing bug gives O(1).
OUT_ATOL = 3e-2
# lse is fp32 in both, from the same bf16 scores: only summation order
# differs (|lse| <= ~12 at T=1024).
LSE_ATOL = 1e-3
# Served bf16 logits vs the fp32 model with plain attention, per position,
# as ||served - ref|| / ||ref||: bf16 keeps 8 significant bits (2^-9
# relative rounding) and the residual stream is rounded about twice per
# layer over 12 layers, which compounds to a few percent at most; a wrong
# kernel (mask, GQA map, cache offset) gives errors of order 1.
LOGITS_REL_TOL = 5e-2

KERNELS = {
    "decode_attention": dict(
        source="deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
        replaces="deepspeed_tpu/ops/attention/decode_attention.py:203"),
    "flash_attention_fwd": dict(
        source="deepspeed_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        replaces="deepspeed_tpu/ops/attention/flash_attention.py:140"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, replays: int = 10) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph and replayed, timed by CUDA events, so the host's time to
    issue each launch stays out of the number."""
    fn()  # first call: kernel build, shared-memory attribute
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


# ---------------------------------------------------------------------------
def phase_build() -> str:
    from deepspeed_tpu_torch.ops import op_builder

    t0 = time.perf_counter()
    paths = op_builder.build()
    log(f"[build] {len(paths)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(p.name for p in paths))
    card = card_line()
    log(card)
    return card


def phase_kernels(gen: torch.Generator) -> dict:
    from deepspeed_tpu_torch.ops.attention.decode_attention import (
        alibi_slopes, decode_attention, decode_attention_reference)
    from deepspeed_tpu_torch.ops.attention.flash_attention import (
        flash_attention, mha_reference)

    dev, bf16 = "cuda", torch.bfloat16
    results = {}

    # -- decode: the serving decode step's shapes (8 slots, GPT-2 heads) ----
    L, B, H, D, S = 12, 8, 12, 64, 1024
    kc = torch.randn(L, B, H, S, D, generator=gen, device=dev).to(bf16)
    vc = torch.randn(L, B, H, S, D, generator=gen, device=dev).to(bf16)
    q = torch.randn(B, H, D, generator=gen, device=dev).to(bf16)
    lengths = torch.tensor([1, 517, 1024, 1, 300, 1024, 64, 999],
                           dtype=torch.int32, device=dev)
    slopes = alibi_slopes(H).to(dev)
    scale = 1.0 / math.sqrt(D)
    err = 0.0
    for sl in (None, slopes):
        for layer in (0, L - 1):
            got = decode_attention(q, kc[layer], vc[layer], lengths,
                                   alibi_slopes=sl)
            want = decode_attention_reference(q, kc[layer], vc[layer],
                                              lengths, scale, sl)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            assert math.isfinite(e) and e <= OUT_ATOL, \
                f"decode kernel vs plain: max |err| {e} > {OUT_ATOL} " \
                f"(alibi={sl is not None})"
            err = max(err, e)
    # time over the 12 layers in turn, as a decode step reads them: the
    # 300 MB of cache never sits in the 50 MB L2 between calls
    ms = cuda_ms(lambda: [decode_attention(q, kc[i], vc[i], lengths)
                          for i in range(L)], reps=4) / L
    plain_ms = cuda_ms(lambda: [decode_attention_reference(
        q, kc[i], vc[i], lengths, scale) for i in range(L)], reps=1) / L
    pos = torch.arange(S, device=dev)
    mask = (pos[None, :] < lengths[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]
    lib_ms = cuda_ms(lambda: [F.scaled_dot_product_attention(
        q4, kc[i], vc[i], attn_mask=mask) for i in range(L)], reps=4) / L
    live = int(lengths.sum())
    esize = 2
    nbytes = 2 * H * live * D * esize + 2 * B * H * D * esize + 4 * B
    flops = 4 * H * live * D
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
    results["decode_attention"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=bound,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S
        >= flops / BF16_FLOPS_PER_S else "operations")
    log(f"[kernels] decode_attention B={B} H=KV={H} D={D} S={S} lengths="
        f"{lengths.tolist()}: max|err| {err:.3g} (tol {OUT_ATOL}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
        f"bound {bound:.4f} ms")

    # -- flash forward: admission prefill at every bucket width -------------
    B = 1
    err = 0.0
    lse_err = 0.0
    per_t = {}
    for T in (16, 32, 64, 128, 256, 512, 1024):
        qf, kf, vf = (torch.randn(B, T, H, D, generator=gen, device=dev)
                      .to(bf16) for _ in range(3))
        out, lse = flash_attention(qf, kf, vf, causal=True)
        ref, ref_lse = mha_reference(qf, kf, vf, causal=True)
        torch.cuda.synchronize()
        e = (out.float() - ref.float()).abs().max().item()
        le = (lse - ref_lse).abs().max().item()
        assert math.isfinite(e) and e <= OUT_ATOL, \
            f"flash kernel vs plain at T={T}: max |err| {e} > {OUT_ATOL}"
        assert math.isfinite(le) and le <= LSE_ATOL, \
            f"flash lse vs plain at T={T}: max |err| {le} > {LSE_ATOL}"
        err, lse_err = max(err, e), max(lse_err, le)
        per_t[T] = cuda_ms(lambda: flash_attention(qf, kf, vf), reps=20)
    T = 1024
    ms = per_t[T]
    plain_ms = cuda_ms(lambda: mha_reference(qf, kf, vf), reps=2)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (qf, kf, vf))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), reps=20)
    flops = 4 * B * H * D * (T * (T + 1) // 2)
    nbytes = 4 * B * T * H * D * esize + 4 * B * H * T
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
    results["flash_attention_fwd"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=bound,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S
        >= flops / BF16_FLOPS_PER_S else "operations")
    log(f"[kernels] flash_attention_fwd B=1 H={H} D={D} causal, T 16..1024: "
        f"max|err| out {err:.3g} (tol {OUT_ATOL}), lse {lse_err:.3g} "
        f"(tol {LSE_ATOL}); per-T kernel ms "
        + ", ".join(f"{t}:{v:.4f}" for t, v in per_t.items()))
    log(f"[kernels] flash_attention_fwd T={T}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound:.4f} ms")
    return results


def gpt2_small(seed: int):
    """GPT-2 small at its published widths (openai-community/gpt2
    config.json), random weights from ``seed``."""
    from deepspeed_tpu_torch.models.transformer_lm import (
        TransformerLM, transformer_config)

    cfg = transformer_config("gpt2", vocab_size=50257, n_embd=768,
                             n_head=12, n_layer=12, max_seq_len=1024,
                             layer_norm_epsilon=1e-5, dtype=torch.bfloat16)
    model = TransformerLM(cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def phase_serve(model, seed: int, device: str = "cuda"):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.ops.attention.decode_attention import \
        decode_attention
    from deepspeed_tpu_torch.ops.attention.flash_attention import \
        flash_attention
    from deepspeed_tpu_torch.serving.request import RequestState

    srv = dst.init_serving(model, config={"dtype": "bfloat16"}, num_slots=8,
                           prefill_chunk=0, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    vocab = model.config.vocab_size
    # warm-up through the engine, not the server: first cuBLAS handles,
    # kernel loads and allocator growth stay out of the measured run and
    # out of the server's metrics
    srv.engine.generate(rng.integers(0, vocab, 40), max_new_tokens=4)
    prompt_lens = rng.integers(32, 769, 16)
    budgets = rng.integers(64, 129, 16)
    assert all(p + n <= 1024 for p, n in zip(prompt_lens, budgets))
    prompts = [rng.integers(0, vocab, int(n)).astype(np.int32)
               for n in prompt_lens]

    decode_attention.launches = 0
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [srv.submit(p, max_new_tokens=int(n))
            for p, n in zip(prompts, budgets)]
    srv.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode_attention": decode_attention.launches,
                "flash_attention_fwd": flash_attention.launches}

    bad = [(r.request_id, r.state.value) for r in reqs
           if r.state is not RequestState.FINISHED]
    assert not bad, f"requests not FINISHED: {bad}"
    srv.check_invariants()
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched while serving"
    for r, n in zip(reqs, budgets):
        assert len(r.output_tokens) == n, (r.request_id, len(r.output_tokens))
    st = srv.stats()
    log(f"[serve] gpt2-small bf16, 8 slots, 16 requests (prompts "
        f"{int(prompt_lens.min())}-{int(prompt_lens.max())}, new "
        f"{int(budgets.min())}-{int(budgets.max())}): {st['new_tokens']} "
        f"tokens in {wall:.2f} s wall; tokens/s {st['tokens_per_s']:.1f}; "
        f"TTFT p50 {st['ttft_p50_ms']:.2f} ms p99 {st['ttft_p99_ms']:.2f} ms; "
        f"step gap p50 {st['step_gap_p50_ms']:.2f} ms p99 "
        f"{st['step_gap_p99_ms']:.2f} ms; launches {launches}")
    return srv, reqs, launches


def served_path_logits(eng, prompt, continuation) -> torch.Tensor:
    """(1 + len(continuation), V) logits of the served path, teacher-forced
    at batch 1: the bucketed prefill the server runs at admission, then one
    decode step per continuation token."""
    from deepspeed_tpu_torch.serving.engine import ServingEngine

    P = len(prompt)
    width = ServingEngine._bucket(P, eng.kv_cache_spec().max_seq_len)
    ids = np.zeros((1, width), np.int64)
    ids[0, :P] = prompt
    logits, cache = eng.prefill_at(ids, P - 1)
    rows = [logits[0, 0]]
    for i, tok in enumerate(continuation):
        rows.append(eng.decode(cache, [[int(tok)]], P + i)[0, 0])
    return torch.stack(rows)


def phase_reference(model, srv, reqs, device: str = "cuda") -> float:
    """Teacher-force two served requests through the served path (bf16,
    kernels) and through an fp32 copy with plain attention."""
    from deepspeed_tpu_torch.models.transformer_lm import TransformerLM

    eng = srv.engine
    ref_cfg = dataclasses.replace(model.config, dtype=torch.float32,
                                  use_flash_attention=False,
                                  decode_kernel="off")
    ref = TransformerLM(ref_cfg)
    ref.load_state_dict({k: v.float() for k, v in
                         eng.module.state_dict().items()})
    ref = ref.to(device).eval()
    worst = 0.0
    for req in (reqs[0], reqs[-1]):
        prompt = np.asarray(req.prompt)
        out = np.asarray(req.output_tokens)
        served = served_path_logits(eng, prompt, out[:-1])   # (n, V)
        full = np.concatenate([prompt, out[:-1]])[None]
        with torch.no_grad():
            want = ref.logits(torch.as_tensor(full, device=device))[0]
        want = want[len(prompt) - 1:]
        rel = ((served.float() - want).norm(dim=-1)
               / want.norm(dim=-1)).max().item()
        assert math.isfinite(rel) and rel <= LOGITS_REL_TOL, \
            f"request {req.request_id}: served logits vs fp32 reference " \
            f"rel err {rel} > {LOGITS_REL_TOL}"
        assert served.shape == want.shape == (len(out), model.config.vocab_size)
        worst = max(worst, rel)
    log(f"[reference] 2 requests teacher-forced: max per-position "
        f"||served - fp32|| / ||fp32|| = {worst:.4g} (tol {LOGITS_REL_TOL})")
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    card = phase_build()
    results = phase_kernels(gen)
    model = gpt2_small(args.seed)
    srv, reqs, launches = phase_serve(model, args.seed)
    phase_reference(model, srv, reqs)
    kernels = [dict(name=name, route="cuda", **KERNELS[name],
                    launches=launches[name], **results[name])
               for name in KERNELS]
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
