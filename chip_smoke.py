"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:

1. build    compile every CUDA kernel from ``deepspeed_tpu_torch/ops/csrc``
            with nvcc (sm_90a) and print the card's name and power limit.
2. kernels  hold each kernel against its plain PyTorch version on the card at
            the serving path's shapes, and time the kernel, the plain version,
            one PyTorch library call computing the same function (none
            reads a page table, so none for the paged kernel), and the
            card's bound for the same work.
3. serve    GPT-2 small at its published widths (random weights from the
            seed), bf16, through ``init_serving(..., num_slots=8,
            prefill_chunk=0)``: 16 requests, run until drained; every request
            must finish, the invariants must hold, and both kernels' launch
            counters must rise during the run.
4. reference  for 2 served requests, the served path's prefill and decode
            logits against an fp32 copy of the model with plain attention.
3b. serve_paged  the same model through the default serving path,
            ``init_serving(..., num_slots=8, prefill_chunk=64, paged_kv=
            {"page_size": 64, "num_pages": 128, "prefix_cache": True,
            "kernel": "auto"})``: 16 requests, 8 of them sharing a 512-token
            prefix (the first is running before the rest arrive); every
            request must finish with its full budget, the page audit must be
            clean, the prefix cache must have served tokens, and the paged
            kernel must run 12 times per decode step.
4b. reference_paged  for 2 served requests (one a prefix hit), the paged
            path's chunked prefill and decode logits against the fp32 model.

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
# The same comparison per output row (one query row of one head), as
# ||kernel - plain|| / ||plain|| over D: a long slot's outputs are small
# (a mean over ~1000 positions), so the absolute limit alone would let a
# kernel that mis-weights a few of its pages pass. The two bf16 roundings
# above are each within 2^-9 of a row's values, so a right kernel stays
# well under 1e-2; dropping or doubling one page of 64 among 1000
# positions moves a row by ~0.25.
ROW_REL_TOL = 1e-2
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
    "paged_decode_attention": dict(
        source="deepspeed_tpu_torch/ops/csrc/paged_decode_attention.cu",
        replaces="deepspeed_tpu/ops/attention/paged_attention.py:125"),
}
PAGED_KV = {"page_size": 64, "num_pages": 128, "prefix_cache": True,
            "kernel": "auto"}


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


def eager_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn`` issued eagerly ``reps`` times
    between CUDA events, for functions that sync with the host and so
    cannot be captured in a graph."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(got: torch.Tensor, want: torch.Tensor, what: str) -> tuple:
    """Hold a kernel's output against its plain version: max |err| within
    OUT_ATOL and every row (last axis) within ROW_REL_TOL of the plain
    row's norm. Returns (max |err|, max row relative error)."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    rel = ((got - want).norm(dim=-1)
           / want.norm(dim=-1).clamp_min(1e-6)).max().item()
    assert math.isfinite(err) and err <= OUT_ATOL, \
        f"{what}: max |err| {err} > {OUT_ATOL}"
    assert math.isfinite(rel) and rel <= ROW_REL_TOL, \
        f"{what}: max row rel err {rel} > {ROW_REL_TOL}"
    return err, rel


def bound(nbytes: float, flops: float) -> dict:
    """The card's least time for the work, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def reset_launches() -> None:
    from deepspeed_tpu_torch.ops.attention.decode_attention import \
        decode_attention
    from deepspeed_tpu_torch.ops.attention.flash_attention import \
        flash_attention
    from deepspeed_tpu_torch.ops.attention.paged_attention import \
        paged_decode_attention

    for fn in (decode_attention, flash_attention, paged_decode_attention):
        fn.launches = 0


def read_launches() -> dict:
    from deepspeed_tpu_torch.ops.attention.decode_attention import \
        decode_attention
    from deepspeed_tpu_torch.ops.attention.flash_attention import \
        flash_attention
    from deepspeed_tpu_torch.ops.attention.paged_attention import \
        paged_decode_attention

    return {"decode_attention": decode_attention.launches,
            "flash_attention_fwd": flash_attention.launches,
            "paged_decode_attention": paged_decode_attention.launches}


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


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
    err = rel = 0.0
    for sl in (None, slopes):
        for layer in (0, L - 1):
            got = decode_attention(q, kc[layer], vc[layer], lengths,
                                   alibi_slopes=sl)
            want = decode_attention_reference(q, kc[layer], vc[layer],
                                              lengths, scale, sl)
            e, r = compare(got, want, f"decode kernel vs plain "
                           f"(alibi={sl is not None})")
            err, rel = max(err, e), max(rel, r)
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
    results["decode_attention"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        **bound(2 * H * live * D * esize + 2 * B * H * D * esize + 4 * B,
                4 * H * live * D))
    log(f"[kernels] decode_attention B={B} H=KV={H} D={D} S={S} lengths="
        f"{lengths.tolist()}: max|err| {err:.3g} (tol {OUT_ATOL}), row rel "
        f"{rel:.3g} (tol {ROW_REL_TOL}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{results['decode_attention']['bound_ms']:.4f} ms")

    # -- flash forward: admission prefill at every bucket width -------------
    B = 1
    err = rel = lse_err = 0.0
    per_t = {}
    for T in (16, 32, 64, 128, 256, 512, 1024):
        qf, kf, vf = (torch.randn(B, T, H, D, generator=gen, device=dev)
                      .to(bf16) for _ in range(3))
        out, lse = flash_attention(qf, kf, vf, causal=True)
        ref, ref_lse = mha_reference(qf, kf, vf, causal=True)
        e, r = compare(out, ref, f"flash kernel vs plain at T={T}")
        le = (lse - ref_lse).abs().max().item()
        assert math.isfinite(le) and le <= LSE_ATOL, \
            f"flash lse vs plain at T={T}: max |err| {le} > {LSE_ATOL}"
        err, rel, lse_err = max(err, e), max(rel, r), max(lse_err, le)
        per_t[T] = cuda_ms(lambda: flash_attention(qf, kf, vf), reps=20)
    T = 1024
    ms = per_t[T]
    plain_ms = cuda_ms(lambda: mha_reference(qf, kf, vf), reps=2)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (qf, kf, vf))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), reps=20)
    results["flash_attention_fwd"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        **bound(4 * B * T * H * D * esize + 4 * B * H * T,
                4 * B * H * D * (T * (T + 1) // 2)))
    log(f"[kernels] flash_attention_fwd B=1 H={H} D={D} causal, T 16..1024: "
        f"max|err| out {err:.3g} (tol {OUT_ATOL}), row rel "
        f"{rel:.3g} (tol {ROW_REL_TOL}), "
        f"lse {lse_err:.3g} (tol {LSE_ATOL}); per-T kernel ms "
        + ", ".join(f"{t}:{v:.4f}" for t, v in per_t.items()))
    log(f"[kernels] flash_attention_fwd T={T}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{results['flash_attention_fwd']['bound_ms']:.4f} ms")
    results["paged_decode_attention"] = paged_kernel(gen)
    return results


def paged_kernel(gen: torch.Generator) -> dict:
    """The paged kernel at the serving path's shapes: 8 slots, GPT-2 heads,
    64-position pages, 16 pages per slot, shuffled page ids, sentinels past
    each slot's live pages, ragged starts on and beside page boundaries."""
    from deepspeed_tpu_torch.ops.attention.decode_attention import (
        alibi_slopes, decode_attention)
    from deepspeed_tpu_torch.ops.attention.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference)

    dev, bf16 = "cuda", torch.bfloat16
    L, B, D, ps, per_slot = 12, 8, 64, 64, 16
    S = ps * per_slot
    P = B * per_slot + 4
    scale = 1.0 / math.sqrt(D)

    def inputs(T, H, KV):
        k = torch.randn(L, P, KV, ps, D, generator=gen, device=dev).to(bf16)
        v = torch.randn(L, P, KV, ps, D, generator=gen, device=dev).to(bf16)
        q = torch.randn(B, T, H, D, generator=gen, device=dev).to(bf16)
        starts = torch.tensor([0, 63, 64, S - 1 - T, 517, 300, 128, 999 - T],
                              dtype=torch.int32, device=dev)
        perm = torch.randperm(P, generator=gen, device=dev)[:B * per_slot]
        table = perm.reshape(B, per_slot).to(torch.int32)
        live = (starts.long() + T + ps - 1) // ps
        dead = torch.arange(per_slot, device=dev)[None] >= live[:, None]
        return q, k, v, table.masked_fill(dead, P).contiguous(), starts

    err = rel = 0.0
    cases = [(T, 12, 12, False) for T in (1, 4, 8)] + [(1, 12, 4, False),
                                                       (4, 12, 4, False),
                                                       (1, 12, 12, True),
                                                       (8, 12, 12, True)]
    for T, H, KV, alibi in cases:
        q, k, v, table, starts = inputs(T, H, KV)
        sl = alibi_slopes(H).to(dev) if alibi else None
        for layer in (0, L - 1):
            got = paged_decode_attention(q, k[layer], v[layer], table, starts,
                                         alibi_slopes=sl)
            want = paged_decode_attention_reference(
                q, k[layer], v[layer], table, starts, scale, sl)
            e, r = compare(got, want, f"paged kernel vs plain (T={T}, "
                           f"H={H}, KV={KV}, alibi={alibi})")
            err, rel = max(err, e), max(rel, r)

    # time the decode step's shape (T=1, H=KV=12) over the 12 layers in
    # turn, as a decode step reads them: 300 MB of pages, past the L2
    H = KV = 12
    q, k, v, table, starts = inputs(1, H, KV)
    ms = cuda_ms(lambda: [paged_decode_attention(q, k[i], v[i], table, starts)
                          for i in range(L)], reps=4) / L
    # the plain version reads the live length on the host: eager timing
    plain_ms = eager_ms(lambda: [paged_decode_attention_reference(
        q, k[i], v[i], table, starts, scale) for i in range(L)], reps=2) / L
    # slice 1's decode kernel on the gathered dense view at the same lengths
    ids = table.long().clamp(max=P - 1).reshape(-1)
    dk, dv = (x[:, ids].reshape(L, B, per_slot, KV, ps, D)
              .permute(0, 1, 3, 2, 4, 5).reshape(L, B, KV, S, D).contiguous()
              for x in (k, v))
    q1, lengths = q[:, 0].contiguous(), (starts + 1).contiguous()
    dense_ms = cuda_ms(lambda: [decode_attention(q1, dk[i], dv[i], lengths)
                                for i in range(L)], reps=4) / L
    live = int((starts.long() + 1).sum())
    pages_read = int(((starts.long() + ps) // ps).sum())
    esize = 2
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
               **bound(2 * KV * live * D * esize + 2 * B * H * D * esize
                       + 4 * (pages_read + B), 4 * H * live * D))
    log(f"[kernels] paged_decode_attention B={B} H=KV={H} D={D} page {ps} x "
        f"{per_slot} pages/slot, P={P} shuffled, starts {starts.tolist()}; "
        f"checked T 1/4/8, GQA 12/4, ALiBi: max|err| {err:.3g} (tol "
        f"{OUT_ATOL}), row rel {rel:.3g} (tol {ROW_REL_TOL}); T=1 kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library none, bound "
        f"{out['bound_ms']:.4f} ms")
    log(f"[kernels] decode_attention on the gathered dense view, same "
        f"lengths: {dense_ms:.4f} ms (paged/dense {ms / dense_ms:.3f})")
    return out


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

    sync(device)
    reset_launches()
    t0 = time.perf_counter()
    reqs = [srv.submit(p, max_new_tokens=int(n))
            for p, n in zip(prompts, budgets)]
    srv.run_until_drained()
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_launches()

    bad = [(r.request_id, r.state.value) for r in reqs
           if r.state is not RequestState.FINISHED]
    assert not bad, f"requests not FINISHED: {bad}"
    srv.check_invariants()
    for name in ("decode_attention", "flash_attention_fwd"):
        assert launches[name] > 0, f"{name} was never launched while serving"
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


def served_paged_logits(srv, prompt, continuation) -> torch.Tensor:
    """(1 + len(continuation), V) logits of the paged served path,
    teacher-forced in one slot of the server's own pool: a prefix-cache
    hit seats the cached pages, the rest of the prompt streams in by
    chunks, then one decode step (all slots, through the paged kernel)
    per continuation token."""
    pool, eng, C = srv.pool, srv.engine, srv.prefill_chunk
    P = len(prompt)
    slot = pool.alloc()
    pool.reset_row(slot)
    pages = pool.prefix.match(prompt)
    pos = srv._prefix_plan(len(pages) * pool.page_size, P)
    if pos:
        pool.seat_prefix(slot, pages, pos)
    while pos < P:
        L = min(C, P - pos)
        ids = np.zeros((1, C), np.int64)
        ids[0, :L] = prompt[pos:pos + L]
        pool.ensure_writable(slot, pos, pos + L)
        logits = pool.run_prefill_chunk(eng, ids, slot, pos, L - 1)
        pos += L
        pool.starts[slot] = pos
    rows = [logits[0, 0]]
    tokens = torch.zeros((pool.num_slots, 1), dtype=torch.long,
                         device=eng.device)
    for tok in continuation:
        pool.ensure_writable(slot, pos, pos + 1)
        tokens[slot, 0] = int(tok)
        rows.append(pool.run_decode(eng, tokens, pool.positions())[slot, 0])
        pos += 1
        pool.starts[slot] = pos
    pool.release(slot)
    return torch.stack(rows)


def fp32_reference(model, eng, device: str = "cuda"):
    """An fp32 copy of the served weights with plain attention."""
    from deepspeed_tpu_torch.models.transformer_lm import TransformerLM

    ref_cfg = dataclasses.replace(model.config, dtype=torch.float32,
                                  use_flash_attention=False,
                                  decode_kernel="off")
    ref = TransformerLM(ref_cfg)
    ref.load_state_dict({k: v.float() for k, v in
                         eng.module.state_dict().items()})
    return ref.to(device).eval()


def phase_reference(ref, reqs, served_fn, label: str,
                    device: str = "cuda") -> float:
    """Teacher-force served requests through ``served_fn(prompt,
    continuation)`` (bf16, kernels) and through the fp32 plain-attention
    ``ref``; every position's logits must agree within LOGITS_REL_TOL."""
    worst = 0.0
    for req in reqs:
        prompt = np.asarray(req.prompt)
        out = np.asarray(req.output_tokens)
        served = served_fn(prompt, out[:-1])                 # (n, V)
        full = np.concatenate([prompt, out[:-1]])[None]
        with torch.no_grad():
            want = ref.logits(torch.as_tensor(full, device=device))[0]
        want = want[len(prompt) - 1:]
        rel = ((served.float() - want).norm(dim=-1)
               / want.norm(dim=-1)).max().item()
        assert math.isfinite(rel) and rel <= LOGITS_REL_TOL, \
            f"{label}: request {req.request_id}: served logits vs fp32 " \
            f"reference rel err {rel} > {LOGITS_REL_TOL}"
        assert served.shape == want.shape == (len(out), ref.config.vocab_size)
        worst = max(worst, rel)
    log(f"[{label}] {len(reqs)} requests teacher-forced (prompts "
        f"{[r.prompt_len for r in reqs]}, prefix-hit tokens when served "
        f"{[r.prefix_hit_tokens for r in reqs]}): max per-position "
        f"||served - fp32|| / ||fp32|| = {worst:.4g} (tol {LOGITS_REL_TOL})")
    return worst


def phase_serve_paged(model, seed: int, device: str = "cuda"):
    """The default serving path: stall-free chunked admission over the
    page pool with its prefix cache, decode through the paged kernel."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.serving.request import RequestState

    def server():
        return dst.init_serving(model, config={"dtype": "bfloat16"},
                                num_slots=8, prefill_chunk=64,
                                paged_kv=dict(PAGED_KV), seed=seed,
                                device=device)

    rng = np.random.default_rng(seed + 1)
    vocab = model.config.vocab_size
    # warm-up through a throwaway server of the same configuration: a
    # 1000-token prompt walks every chunk width, a short one the bucketed
    # admission, so first-call costs of those shapes stay out of the run
    warm = server()
    for n in (1000, 40):
        warm.submit(rng.integers(0, vocab, n), max_new_tokens=4)
    warm.run_until_drained()
    del warm
    srv = server()
    prefix = rng.integers(0, vocab, 512)
    shared = [np.concatenate([prefix, rng.integers(0, vocab, int(n))])
              for n in rng.integers(16, 257, 8)]
    cold_lens = rng.integers(32, 769, 8)
    # one short prompt, so the run has a whole-prompt (bucketed) admission
    cold_lens[0] = rng.integers(32, 65)
    cold = [rng.integers(0, vocab, int(n)) for n in cold_lens]
    rest = shared[1:] + cold
    prompts = [shared[0]] + [rest[i] for i in rng.permutation(len(rest))]
    prompts = [p.astype(np.int32) for p in prompts]
    budgets = rng.integers(64, 129, 16)
    assert all(len(p) + n <= 1024 for p, n in zip(prompts, budgets))

    sync(device)
    reset_launches()
    t0 = time.perf_counter()
    reqs = [srv.submit(prompts[0], max_new_tokens=int(budgets[0]))]
    while reqs[0].state is not RequestState.RUNNING:
        srv.step()
    reqs += [srv.submit(p, max_new_tokens=int(n))
             for p, n in zip(prompts[1:], budgets[1:])]
    srv.run_until_drained()
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_launches()

    bad = [(r.request_id, r.state.value, len(r.output_tokens), int(n))
           for r, n in zip(reqs, budgets)
           if r.state is not RequestState.FINISHED
           or len(r.output_tokens) != n]
    assert not bad, f"requests not FINISHED with their budget: {bad}"
    srv.check_invariants()
    pool = srv.pool
    held = len(pool.prefix.page_counts())
    assert (pool.table == pool.num_pages).all() and \
        pool.free_page_count + held == pool.num_pages, \
        f"pages leaked: {pool.free_page_count} free + {held} cached != " \
        f"{pool.num_pages}"
    st = srv.stats()
    assert st["prefix_hit_tokens"] > 0, "no request was seated on the cache"
    steps = st["decode_steps"]
    assert launches["paged_decode_attention"] >= 12 * steps, \
        f"paged kernel ran {launches['paged_decode_attention']} times in " \
        f"{steps} decode steps (want >= {12 * steps})"
    assert launches["flash_attention_fwd"] > 0, \
        "no whole-prompt admission ran the flash kernel"
    log(f"[serve_paged] gpt2-small bf16, 8 slots, prefill_chunk=64, paged_kv="
        f"{PAGED_KV}; 16 requests (8 share a 512-token prefix; prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))}, new "
        f"{int(budgets.min())}-{int(budgets.max())}): {st['new_tokens']} "
        f"tokens in {wall:.2f} s wall, {steps} decode steps")
    log(f"[serve_paged] tokens/s {st['tokens_per_s']:.1f}")
    log(f"[serve_paged] TTFT p50 {st['ttft_p50_ms']:.2f} ms p99 "
        f"{st['ttft_p99_ms']:.2f} ms")
    log(f"[serve_paged] step gap p50 {st['step_gap_p50_ms']:.2f} ms p99 "
        f"{st['step_gap_p99_ms']:.2f} ms")
    log(f"[serve_paged] prefix-hit tokens {st['prefix_hit_tokens']} "
        f"({st['prefix_hits']} hits of {st['prefix_lookups']} lookups); "
        f"preempted {st['preempted']}")
    log(f"[serve_paged] page stats {st['paging']}")
    log(f"[serve_paged] launches {launches}")
    return srv, reqs, launches


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
    ref = fp32_reference(model, srv.engine)
    phase_reference(ref, (reqs[0], reqs[-1]),
                    lambda p, c: served_path_logits(srv.engine, p, c),
                    "reference")
    psrv, preqs, paged_launches = phase_serve_paged(model, args.seed)
    hit = next(r for r in preqs if r.prefix_hit_tokens > 0)
    cold = max((r for r in preqs if r.prefix_hit_tokens == 0),
               key=lambda r: r.prompt_len)
    phase_reference(ref, (hit, cold),
                    lambda p, c: served_paged_logits(psrv, p, c),
                    "reference_paged")
    # each kernel's launches over the two serving runs (each counted from 0
    # just before its run and read just after)
    kernels = [dict(name=name, route="cuda", **KERNELS[name],
                    launches=launches[name] + paged_launches[name],
                    **results[name])
               for name in KERNELS]
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
