"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N] [--decode-only | --resilience-only |
                           --offload-only | --fleet-only | --zero-dp-only |
                           --tp-only]

``--decode-only`` runs the build and the decode and paged kernels' rows
alone (phase 2's decode and paged rows, phase 5's two int8 decode rows and
its int8 paged row) and prints them as one JSON line; it drives only the
two wrappers' public calls, so it also times an older tree's package put
first on the path, for comparisons of two commits in one call. Without it, phases in order; any failure exits
non-zero:

1. build    compile every CUDA kernel from ``deepspeed_tpu_torch/ops/csrc``
            with nvcc (sm_90a) and print the card's name and power limit.
2. kernels  hold each kernel against its plain PyTorch version on the card at
            the serving path's shapes, and time the kernel, the plain version,
            one PyTorch library call computing the same function (none
            reads a page table, so none for the paged kernel), and the
            card's bound for the same work. The paged kernel is checked at
            every T from 1 to 8 (a verify step's K+1 rows) and timed at
            T=5 too, bf16 and int8; int8_matmul at a verify layer's M=40.
            The decode and paged kernels
            (one template; design mma: mma.sync) are also held and timed in
            their FMA design, the same split-S grouped kernel on the FMA
            units, and timed at 1, 2, 4 and 8 chunks beside decode_plan's
            and paged_plan's choice; the paged kernel beside the decode
            kernel on the gathered dense view of its pages as well. The flash forward and dk/dv
            kernels (their design, wgmma or fma, in the kernels line) are
            also timed at every admission width (B=1, H=12, T 16..1024)
            beside their bounds and SDPA's forward and backward.
3. serve    GPT-2 small at its published widths (random weights from the
            seed), bf16, through ``init_serving(..., num_slots=8,
            prefill_chunk=0)``: 16 requests, run until drained; every request
            must finish, the invariants must hold, and both kernels' launch
            counters must rise during the run.
3c. serve captured  the same traffic on a server whose engine has
            ``enable_cuda_graph=True`` (``strict_recompile=True``): warm-up
            requests on that server (its one decode graph is captured
            there), then the measured pass: every request's greedy tokens
            equal the eager arm's, no decode step runs eagerly, and the
            launch counts are exact with replays counted; then
            ``end_warmup()`` and the traffic again, during which one
            captured step's logits on the live pool are held against the
            eager step's on a copy of it (bit-equal expected, 1e-3
            relative allowed): no recompile after warmup, one capture per
            server. Printed beside the eager arm: step gap p50/p99, TTFT and
            tokens/s, and one replay's device time by events beside the sum
            of its hand-written kernels' rows. The same follows each serve
            phase below (3b, 6, 6b).
3d. generate_captured  ``generate()`` at GPT-2 small, B=8, 128 new tokens,
            on the eager engine and on the captured one: identical tokens,
            tokens/s of each.
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
4c. overlap  ``serve_paged``'s traffic on an ``overlap=True`` server over a
            captured engine: every request's tokens equal the serial
            step's.
4d. serve_spec  speculative decoding, the JAX package's spec row
            (bench.py:704-731): 32 requests tiling a random motif of 4-8
            tokens to 32-128 tokens, budgets 64-224, on 8 slots of the
            contiguous pool, the n-gram drafter at k=8 (T = 9 rows a
            verify step, over the paged kernel's 8), each arm on a captured
            engine with ``strict_recompile``: spec off, spec on and spec on
            with a drafter that never drafts. Each arm serves the traffic
            once to warm up, then again measured: budgets met, audits
            clean, one captured step, no recompile. The spec-on tokens
            equal the no-drafts arm's exactly; against the spec-off arm
            (the one-row decode kernel) every request is identical or
            parts at a near-tie of its top two logits (``TIE_FACTOR``).
            Printed: tokens/s, tokens a slot-step, acceptance, draft
            overhead, step gap p50/p99 and one verify replay's device ms.
4e. serve_spec_paged  the same traffic over ``serve_paged``'s page pool at
            k=4 (T = 5 through the paged kernel): serial, ``overlap=True``
            and no-drafts arms, captured and strict; tokens as in 4d, the
            paged kernel exactly 12 times a verify step, one captured
            verify step's (8, 5, V) logits against the eager forward on a
            copy of the pool (1e-3 relative), no slot or page leak.
4f. serve_spec_model  the small-model drafter: GPT-2 small drafting for
            itself through a second captured engine, k=4, paged, 8 of the
            requests: tokens equal 4e's no-drafts arm's; each step's draft
            prefill (flash), 3 draft decodes (decode kernel) and verify
            (paged kernel) counted exactly; acceptance printed.
4g. serve_resilience  the default path (8 slots, serve_paged's pool, chunk
            64, captured, strict) with every resilience and telemetry key
            on (tracer, registry, timelines, SLO with two priority classes,
            flight recorder, guard_numerics, the degradation ladder,
            pressure preemption, deadlines, a step wall budget) on a fake
            clock, one 64-token admission a step: after a quiet warm-up,
            48 requests arrive (a burst of 24 tips the ladder into
            OVERLOADED) while a FaultInjector raises admit_oom at the 3rd
            admission and step_host_error at the 28th step, poisons the
            12th decode's logits with a NaN row and slows the 20th step
            past the wall budget. Held: untouched requests have the
            fault-free arm's tokens exactly (touched ones part only at
            near-ties), the poisoned request alone ends numerical_error,
            0 recompiles and one capture a server, a clean audit with no
            slot or page leak, every step span in the exported trace and
            the step_host_error's post-mortem keys. A contiguous arm (the
            decode kernel) under a NaN and an abort; a k=4 spec arm driven
            into OVERLOADED drafts nothing there and gives 4e's no-drafts
            tokens. Printed: the fault-free traffic's step gap with all
            telemetry on against all of it off (arms in turns off, on,
            on, off), telemetry_overhead_s a step. ``--resilience-only``
            runs the build, 4d, 4e and this.
4h. cost_model  (after 4c) 3b's captured server with ``cost_model=True``:
            warm-up waves, ``reset_efficiency_window()``, then 3b's traffic;
            arms with the model on and off in turns (on, off, off, on). Held:
            ``efficiency_snapshot()`` has 0 < mfu <= 1.05 and 0 <
            bandwidth_util <= 1.05, nothing unavailable, hbm_drift within
            the model's tolerance, and the tokens of every arm equal the
            off arm's and 3b's eager ones. Printed: mfu, bandwidth_util,
            tokens_per_gflop, overhead_pct, and the step gap p50 of each
            arm.
4i. serve_storage  (after 4h) GPT-2 small in fp16 through the int8
            STORAGE tier, ``config={"dtype": "float16", "quant":
            {"enabled": True, "bits": 8, "group_size": 64}}``: every weight
            of rank >= 2 stored int8 with a scale per 64 values and
            dequantized at each use. 3b's traffic on 3b's default path,
            eager, then captured under ``strict_recompile`` as in 3c: every
            request finishes with its budget, captured tokens equal eager
            ones, no recompile after warmup, the flash and paged kernels'
            counters rise; for 2 requests the served logits are within 5%
            of an fp32 copy of the dequantized weights. Printed: weight
            bytes at rest against fp16, tokens/s, step gap p50/p99, one
            replay's device time.
5.  int8 kernels  the int8_matmul kernel at TinyLlama-1.1B's decode shapes
            (8 rows), a 64-row prefill chunk and a 512-row prompt through
            gate, and the int8-cache variants of the decode and paged
            kernels, each held against its plain version and timed beside
            its bound and a library yardstick; int8_matmul is also held
            exactly on small integers (the fragment probe).
6.  serve_int8  TinyLlama-1.1B at its published widths (random weights from
            the seed, 22 layers, GQA 32/4) with int8 weights and the int8 KV
            cache on the default path: ``init_serving(..., config={"dtype":
            "int8"}, num_slots=8, prefill_chunk=64, paged_kv={"page_size": 64,
            "num_pages": <traffic peak>, "prefix_cache": True, "kernel":
            "auto"})`` with ``kv_cache_quant=True``; 16 requests, 8 sharing a
            512-token prefix. Every request finishes with its budget, the
            audits are clean, int8_matmul runs 7 x 22 times per model forward
            and the int8 paged kernel 22 times per decode step.
6b. serve_int8_contiguous  the same int8 engine, ``paged_kv=False,
            prefill_chunk=0``: a few requests through the int8 decode kernel.
6c. serve_spec_int8  TinyLlama int8 at k=4 over ``serve_int8``'s page
            pool: 16 motif requests (budgets 64-128), spec off, on and
            no-drafts arms, captured and strict, tokens as in 4d; the int8
            paged kernel 22 times a verify step, ``int8_matmul`` 22 x 7
            times a verify step in its prefill tiles (M = 40) beside the
            prefill forwards' own.
7b. zero_inference  (after 7) TinyLlama-1.1B at its published widths in
            bf16 (random weights from the seed, a bf16 KV cache), its 1.94 GB
            of blocks in pinned host memory, streamed a layer at a time by
            ``inference.ZeroInferenceEngine`` (prefetch 1: three 88 MB
            device buffers): ``score`` on 8 x 512 tokens and ``generate``
            of 32 tokens at B=8, then the int8 tier (``int8=True``). Held:
            the flash, bf16-cache decode and int8_matmul kernels against
            their plain versions at the path's shapes (B=8 x 512, GQA 32/4,
            a 2048-position cache, M=4096 through a layer's 7 projections);
            streamed logits against the resident model's on the card
            (bit-equal expected, 5% allowed) and, score logits and every
            generated step's, within 5% of the fp32 model with every kernel
            off (the int8 tier's weights dequantized); greedy tokens
            identical to the resident engine's, the peak memory of a
            streamed pass within
            the resident pieces + 3 layer buffers + the resident forward's
            activations, and the flash, decode and (int8 tier)
            int8_matmul counters rising. Printed: the stream's GB/s, the
            median ms a layer (copy-bound: a layer's copy outlasts its
            compute at this batch), tokens/s.
7.  reference_int8  served logits (kernels) against the same int8 model with
            every kernel off, through the paged path and the contiguous one,
            and on the paged path over a bf16 cache; printed, not held: the
            paged error with one kernel group on at a time, and the error
            against the unquantized bf16 model.

8.  train_kernels  the flash-attention backward kernels (dq, dkv; their
            design, wgmma or fma, in the kernels line) at GPT-2 medium's
            training shape (B=10, H=16, D=64, T=1024, bf16, causal), a
            non-causal case and a ragged T (with the flash forward's out and
            lse at the same shapes), the accumulator-packing probe that the
            wgmma kernels' P and dS go through, and the ln_linear forward and
            backward-dx kernels (bf16: wgmma) at its qkv and fc shapes
            (M=10240, C=1024, N=3072 / 4096), a ragged M and, at M=2048,
            the wide C the JAX gate takes (1600: N=4800 / 6400; 2048: N=6144
            / 8192; 4096: N=4096); each held against its plain version and
            timed beside its bound and a library yardstick. The flash forward
            and dk/dv kernels' other design (fma: fp32, and D=32) is held
            against the plain versions at small shapes, and the fp32
            ln_linear kernels at C=2048 are held and timed once. The flash
            forward, dq and dkv are timed at the training shape, at D=128,
            at TinyLlama's training shape (B=4, T=2048, 32 query heads over
            4 KV heads: phase 15's, held against the plain versions too) and
            (phase 12) at T=8192, each beside its bound and SDPA.
9.  train   GPT-2 medium at its published widths (random weights from the
            seed) at the JAX bench's flagship configuration through
            ``initialize`` and ``train_batch``: bf16 with fp32 master
            weights, ZeRO stage 2, Adam (lr 3e-4, weight decay 0.1),
            clipping 1.0, micro-batch 10 x gas 16 x seq 1024,
            ``remat_policy="dots"``; two warm-up steps, then timed steps on
            fixed batches cycled. The loss is finite and ends below its
            value at initialisation, and the flash forward, dq and dkv
            kernels each run 24 times per micro-batch (no forward recompute).
10. train_fused  the same with ``fused_ln_linear=True``: the ln_linear
            forward and backward-dx kernels also run 48 times a micro-batch.
11. reference_train  one flagship micro-batch's loss and every parameter's
            gradient with the kernels on (flash; flash + ln_linear) against
            the plain arm (einsum attention, unfused), same weights.

12. sparse_kernels  the block-sparse forward, dq and dkv kernels at the
            training shape (B=1, H=12, D=64, T=8192, bf16, the BigBird
            layout below, causal), at blocks 128 and 256, on a bidirectional
            Fixed layout with horizontal globals, per-head layouts, a layout
            with empty query rows and in fp32; each held against its plain
            version and timed beside its bound and a library yardstick (SDPA
            with the layout expanded to a token mask). The forward, dq and
            dkv kernels (bf16: wgmma, fp32: FMA) are also held and timed in
            every design at the training shape and at D=128, and dkv with
            its blocks started longest walk first against the grid order,
            on the BigBird layout and on a Fixed one whose long columns lie
            at blocks 3, 7, 11 and 15. The flash forward, dq
            and dkv kernels are held and timed once at B=1, H=12, T=8192 as
            well, the forward and dkv beside their bounds and SDPA's.
13. train_sparse  GPT-2 small widths (768/12/12, vocab 50257) at 8192
            positions with ``sparse_attention=BigBirdSparsityConfig(
            num_heads=12, block=512, num_random_blocks=1,
            num_sliding_window_blocks=3, num_global_blocks=1,
            attention="unidirectional")``, ``remat=True`` (policy "full"),
            bf16, micro-batch 1, gas 1, ZeRO stage 0, AdamW lr 1e-4 (the JAX
            package's benchmarks/sparse_lowdensity_bench.py model rows):
            two warm-up steps, then timed steps; the loss falls, and the
            sparse forward runs 24 times, dq and dkv 12 times a micro-batch.
            Then its flash-dense arm (``use_flash_attention=True``, no
            layout) the same way, and the two arms' tokens/s side by side.
14. reference_sparse  one micro-batch's loss and every parameter's gradient
            with the sparse kernels against the same weights with attention
            through the gather formulation (the JAX package's non-kernel
            route), remat "full".
15. train_llama  TinyLlama-1.1B at its published widths (vocab 32000,
            2048/5632, 22 layers, 32 heads over 4 KV heads, RMSNorm, rotary
            theta 1e4, untied head; random weights from the seed) at 2048
            positions through ``initialize`` and ``train_batch``: bf16 with
            fp32 master weights, ZeRO stage 2, AdamW (lr 3e-4, weight decay
            0.1), clipping 1.0, micro-batch 4 x gas 4, ``remat=True``,
            ``loss_chunk=512``; two warm-up steps, then six timed steps (the
            loss rises for Adam's first five updates, then falls). The loss
            ends below its value at initialisation, and the flash forward
            runs 44 times (each block recomputed), dq and dkv 22 times a
            micro-batch. Printed: tokens/s, ms a micro-batch, peak memory.
16. reference_llama  one such micro-batch at TinyLlama's widths and 2
            layers: the loss and every parameter's gradient of the kernel
            arm (bf16, flash, loss_chunk 512) against the plain arm (the
            same weights in fp32, einsum attention, dense loss), and of the
            streamed loss against the dense one, held as in 11; the peak
            memory of the dense and streamed loss arms printed.
17. checkpoint  GPT-2 medium under phase 9's configuration at gas
            ``CHECKPOINT_GAS`` (4: the state saved is the same): 2 steps,
            ``save_checkpoint`` into a temporary directory, a fresh engine
            from other weights ``load_checkpoint``s it (parameters, master
            weights and Adam moments bit-equal to the saver's), then 2 more
            steps of each: the resumed losses equal the saver's unbroken
            ones exactly, printed beside the gap between two unbroken runs
            (0: these steps are bit-reproducible on the card in PyTorch's
            default mode, so no deterministic mode is set).
            ``ds_to_universal`` and a stage-0 engine through
            ``checkpoint.load_universal`` give the same next loss;
            ``zero_to_fp32`` returns the master weights exactly. Printed:
            bytes written, seconds to save, load, export and convert; the
            directory is deleted. The flash launches of its 11 steps over
            five engines are held against phase 9's count a micro-batch.

18. train_offload  train_llama's model, configuration and batches with
            ``"offload_optimizer": {"device": "cpu"}``: the fp32 master
            weights and Adam moments on the host, the host Adam
            (``ops/csrc/cpu_adam.cpp``) stepping them between the gradients'
            copy down and the bf16 parameters' copy up (pinned staging, two
            copy streams); two warm-up steps, then three timed. Every loss
            within 2e-3 relative of train_llama's at the same step, the
            flash kernels' launches a micro-batch as train_llama's, and the
            peak at most train_llama's less 0.9 x 12 bytes a parameter.
            Printed: tokens/s, ms a step split into device fwd/bwd and the
            host step (host Adam; gradients down and parameters up, GB/s).
19. train_offload_nvme  the same widths at 2 layers, three steps each with
            the optimizer state on the host, in files under a temporary
            directory (``device: nvme``, moved by ``ops/csrc/aio.cpp``) and
            in files with the master kept in host memory (``swap_master:
            false``): losses, final parameters, master and moments
            bit-equal across the three. Printed: file bytes, the last
            step's ``swap_in_s``/``compute_s``/``drain_s``, GB/s and whether
            O_DIRECT ran; the directory is deleted.
20. train_param_offload  TinyLlama at its widths and 22 layers with
            ``"offload_param": {"device": "cpu"}``: the blocks' bf16 weights
            in pinned host memory streamed through the card a layer at a
            time, forward and (recomputing each block) backward, the host
            Adam over every parameter; phase 18's batches, two warm-up and
            two timed steps. Every loss within 5e-3 relative of phase 18's
            (the streamed head computes the dense loss), the flash forward
            twice a layer and dq, dk/dv once a layer a micro-batch, and the
            peak under the bound the phase reckons from its pieces and
            prints. Printed: tokens/s, the stream's and host step's seconds
            a step, the stream's GB/s and the peak beside train_llama's.
            ``--offload-only`` runs the build, train_llama and 18-20.

21. serve_disagg  (after 4h) the serving fleet: GPT-2 small on 3b's
            traffic, every replica with 3b's settings (8 slots, chunk 64,
            ``PAGED_KV``, ``strict_recompile``) on ONE captured engine, the
            first built by ``init_serving(..., role="prefill")``, behind a
            ``ReplicaRouter``. Arms: a prefill and a decode replica (every
            request's pages copied across pools by
            ``PagedKVPool.import_pages``); two colocated replicas (prefix
            affinity); a prefill and two decode replicas, one killed at its
            60th step by a ``FaultInjector`` (``step_host_error``) and a
            warmed decode replica joined by ``add_replica`` at router step
            90. Held: every request's greedy tokens equal 3b's captured
            run's (a request a failover re-homed re-prefills its tokens and
            may part only at a near-tie, as in 4g); the destination pages
            equal the source's, every leaf, for the first transfer and the
            first prefix-affine one; the paged kernel at least 12 times a
            decode step, the flash kernel in admissions, none on a prefill
            replica; 0 recompiles after warmup on every replica, the added
            one included; no transfer in flight at a step boundary;
            trie-hit pages skipped; no slot or page leak after the drain.
            Printed beside 3b's captured row: tokens/s, TTFT and step gap
            p50/p99 at the router; transfers, pages moved and skipped,
            bytes, a transfer's host and device ms, GB/s; a 12-page
            transfer alone beside its bound.
22. serve_http  ``ServingFrontend`` on 127.0.0.1:0 over an
            ``AsyncEngineBridge`` over arm 1's router: 16 SSE clients
            (stdlib asyncio, on a thread that makes no CUDA call) send the
            traffic, one cancelled by ``DELETE /v1/requests/{id}``
            mid-stream; then ``GET /healthz`` and ``GET /metrics``. Held:
            the streamed tokens equal arm 1's, one terminal ``cancelled``
            event and the slot and pages freed, the ``fleet`` object, the
            ``replica=/role=`` labelled series, 0 recompiles, no leak after
            ``stop(drain=True)``. Printed: the client-side TTFT, gap and
            tokens/s beside arm 1's. ``--fleet-only`` runs the build, 3b's
            captured arm alone and 21-22.

23. train_zero_dp  ZeRO over a data-parallel world, GPT-2 medium at
            the flagship config (bf16, fp32 masters, Adam 3e-4 wd 0.1,
            clip 1.0, micro 10, remat "dots"), 3 steps of 20 rows: the
            first untimed, one timed with the comms logger off, the last
            timed with it on (it syncs the device after every collective)
            for the op table. Arm (a): one rank at gas 2 without a process
            group, then over a NCCL group of one rank at ZeRO stage 0
            (``ZERO_DP_NCCL_STAGES``): step 1's loss equal, later losses
            within 1e-5 relative and the final masters within 1e-5 of the
            run without a group; the flash forward, dq and dk/dv kernels a
            layer a micro-batch. A world of one shards nothing, so stages
            1-3 there would run stage 0's code again, a one-rank all_reduce
            a tensor; the partitions run in arm (b): two ranks over gloo
            on the same card (NCCL refuses two ranks a device), processes
            this script starts with a ``file://`` store and a timeout, gas 1
            (the same micro-batches), stages 1-3 (``ZERO_DP_STAGES``):
            every loss and every step's pre-clip gradient norm within 1e-4
            relative of arm (a)'s, the gathered final masters' distance from arm (a)'s
            within 1% of arm (a)'s update (final - initial), each rank's
            bytes at rest (parameters, masters, moments, accumulators)
            within 1% of the stage's partition
            (``ZeroShardingPolicy.bytes_at_rest``), the flash kernels on
            every rank, at most two blocks gathered at stage 3. Printed:
            gloo's table for CUDA tensors (each collective called natively
            on a group of its own), the comm layer's all_gather and
            reduce_scatter against exact results, per stage the losses,
            norms, master gaps, bytes, the last step's collectives (comms
            logger: ops and bytes) and step ms with the logger off and on
            beside the card's name and power limit. A rank that exits
            non-zero or outlives the timeout fails the run. Arm (c), in the
            same two processes after arm (b): tensor-parallel training at
            ``(data, model)`` = (1, 2), GPT-2 medium at the flagship
            settings (ZeRO 2, which shards nothing at ``data`` 1) on arm
            (a)'s batches (micro ``MICRO_BS`` x gas 2): both ranks' losses
            and pre-clip gradient norms equal, within ``TP_LOSS_RTOL`` and
            ``TP_NORM_RTOL`` of arm (a)'s; a rank's parameters exactly the
            count computed from the widths (``tp_rank_params``: half of
            every block projection, the embeddings, norms and the row
            projections' biases whole) and its bytes at rest exactly the
            policy's prediction over its shapes; one eager micro-batch's
            collectives, counted by the comms logger, exactly
            ``tp_micro_collectives`` (remat's recomputation included); the
            flash kernels at the rank's 8 heads. The flash forward, dq and
            dk/dv run first at that shape (B=``MICRO_BS``, H=8, D=64,
            T=1024), held against their plain versions (``tp_rank`` in
            their JSON rows). ``--zero-dp-only`` runs the build, those rows
            and this.
24. serve_tp  (last) tensor-parallel serving: TinyLlama-1.1B widths (22
            layers, GQA 32/4, vocab 32000), bf16 weights, int8 KV, random
            from the seed, served by ``init_serving`` with the default call
            (8 slots, chunk 64, ``PAGED_KV``): 8 requests, 4 on a 512-token
            prefix, budgets 16-32. Arm (a): one rank, ``tp_size`` 1, a
            ``model=1`` mesh over a NCCL world of one (at one rank no layer
            is swapped and no collective runs: the plain one-rank path).
            Arm (b): ``tp_size`` 2, two gloo ranks on
            ``cuda:0`` (NCCL refuses two ranks a device) that this script
            starts as ``--tp-worker RANK WORLD DIR --tp-spec JSON``, each
            memory-mapping the weights phase 24 wrote and keeping its slice
            (a meta model: no rank holds the whole model). Held: budgets,
            invariants, no leak on every rank; both ranks' tokens
            identical; (b)'s tokens equal (a)'s or part only at a near-tie
            (``divergences``: both tokens within ``TIE_FACTOR`` rounding
            errors of the fp32 copy's top logit at the first parted
            position); an fp32 arm at 2 layers identical at ``tp_size`` 2
            and 1; (b)'s own logits, teacher-forced in its pool, within
            ``LOGITS_REL_TOL`` of the fp32 one-rank copy: the prefill and
            first decode of two requests (a prefix hit, the longest cold
            prompt) and every request that parts from (a) through its first
            parted position, where (b)'s token also lies within
            ``TIE_FACTOR`` of (b)'s own error below the top logit; each rank's
            parameter bytes as predicted (every projection, the embedding
            and the head halved, the norms whole) and half the KV pool; the
            flash, paged and decode kernels on every rank; a decode step's
            collectives 2 all-reduces a layer + 1 (the embedding) and 1
            all-gather (the head). Printed: tokens/s, step gap and TTFT of
            each arm, a decode step's collectives and their mean time, all
            marked gloo through the host on one card. The kernel rows run
            again at a rank's shapes (16 query heads over 2 KV heads, D 64,
            bf16 and int8 caches; under ``tp_rank`` in their JSON rows).
            Then GPT-2 small (``GPT2LMHeadModel`` at its published
            widths, bf16, its fused qkv split per head, vocab 50257 whole
            on every rank) serves ``forward`` of 4 prompts of 64 tokens
            (it has no KV cache, so no ``generate()``) at ``tp_size`` 1
            (arm (a)) and 2 (the same workers): both ranks' argmax
            identical, each arm's logits within ``LOGITS_REL_TOL`` of the
            fp32 copy, and where (b)'s argmax parts from (a)'s, (b)'s token
            within ``TIE_FACTOR`` of its own error below the copy's top
            logit.
            The key arms, at TinyLlama's widths and ``TP_KEYS_LAYERS``
            layers over ``serve_paged``'s prompts (budgets capped at
            ``TP_KEYS_BUDGET``), every rank alike: (d) ``spec_decode``
            n-gram k=4 on motif prompts at ``tp_size`` 2, its tokens
            against one rank's spec server up to near-ties, acceptance the
            same on both ranks; (e) ``dtype: "int8"`` (the storage tier
            above one rank: under ``TP_STORAGE_REST`` of one rank's bytes,
            logits within ``LOGITS_REL_TOL`` of the fp32 copy) and an
            ``int8_weights`` model (``int8_matmul`` launched at both
            regimes, logits against the dequantized fp32 copy); (f) a
            prefill/decode pair behind ``ReplicaRouter`` (the colocated
            tokens, half a page's bytes a rank); (g) ``serve_resilience``'s
            keys with no ``clock=`` (every rank's decisions identical, and
            one rank replaying rank 0's clock readings decides alike); (h)
            ``overlap`` (the serial tokens) and ``cost_model`` (2 x a
            rank's flops within 1% of one rank's); (i) ``(data, model)`` =
            ``TP_DM`` over four more gloo ranks (``--tp-spec`` mode "dm"),
            half the contiguous slots a data rank, the ``(1, 2)`` tokens up
            to near-ties. ``int8_matmul`` at a rank's column and row shapes
            and the paged kernel at T=5 join the kernel rows.
            ``--tp-only`` runs the build, those rows and this.

The last two lines are a ``{"kernels": [...]}`` object and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
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
# A query row that sees one position of an int8 cache is no mean: it
# outputs that position's dequantized V row, above 4 in a few percent of
# draws, where one bf16 step (2^-5 in [4, 8)) exceeds 3e-2 and the kernel's
# rounding of p * v_scale to bf16 (2^-9 relative) can carry the output
# rounding to the neighbouring step (on the H100: -4.125 against -4.09375,
# row rel 0.0048). There the limit is that one bf16 step of the plain value.
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
# The same limit holds the int8 model's served logits (kernels) against the
# same int8 model with every kernel off. The two differ only at bf16
# rounding level (summation order in int8_matmul, p rounded to bf16 in the
# attention kernels), but TinyLlama's 22 random layers grow any such
# difference to about 3%: on the H100, seeds 0 and 1, each source alone
# gave 0.029-0.032, all together 0.032-0.034, and a bf16 cache in place of
# the int8 one 0.031-0.034, so the int8 cache does not amplify it. The
# limit leaves 1.5x over that floor; the int8 weights themselves move the
# logits by 10% from the bf16 model's, and a wrong kernel by order 1.
LOGITS_REL_TOL = 5e-2
# A captured decode step replays the eager step's kernels on the same
# inputs: its logits are expected bit-equal; held to 1e-3 relative per row
CAPTURED_REL_TOL = 1e-3
# Speculative decoding's greedy tokens equal plain decoding's through the
# same verify forward exactly (the no-drafts arms). Against the one-row
# decode step, which computes the same logits with other kernels and other
# product shapes, two bf16 arms can part where the top two logits are
# closer than their rounding differences. Where they part, each arm's token
# is the argmax of logits within about e of a reference (e: the largest
# |decode path - reference| measured there), so it lies at most 2e below
# the reference's top logit; a wrong acceptance gives tokens far below it.
TIE_FACTOR = 2.0
# reference_train: one GPT-2 medium micro-batch in bf16, the kernel arms'
# loss and each parameter's gradient (relative L2 norm) against the plain
# arm's on the same weights. Both round to bf16 (2^-9 relative), at other
# places (the plain arm rounds the score and probability products, the
# flash kernels p and their outputs), over 24 layers: on the H100 the
# loss agreed within 3.2e-5 and the worst gradient (wte) within 4.2e-3.
# The limits leave 30x and 5x; a wrong mask, scale, delta or head mapping
# moves gradients by order 1.
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_TOL = 2e-2

# bf16 decode and paged kernel times recorded in PERF.md (H100, 700 W), for
# the side-by-side check that the int8 variants left the bf16 ones alone
RECORDED_BF16_MS = {"decode_attention": 0.0108, "paged_decode_attention": 0.0127}

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
    "int8_matmul": dict(
        source="deepspeed_tpu_torch/ops/csrc/int8_matmul.cu",
        replaces="deepspeed_tpu/ops/quantization/int8_matmul.py:143"),
    "decode_attention_int8": dict(
        source="deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
        replaces="deepspeed_tpu/ops/attention/decode_attention.py:203"),
    "paged_decode_attention_int8": dict(
        source="deepspeed_tpu_torch/ops/csrc/paged_decode_attention.cu",
        replaces="deepspeed_tpu/ops/attention/paged_attention.py:125"),
    "flash_attention_dq": dict(
        source="deepspeed_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        replaces="deepspeed_tpu/ops/attention/flash_attention.py:210"),
    "flash_attention_dkv": dict(
        source="deepspeed_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        replaces="deepspeed_tpu/ops/attention/flash_attention.py:253"),
    "ln_linear_fwd": dict(
        source="deepspeed_tpu_torch/ops/csrc/ln_linear.cu",
        replaces="deepspeed_tpu/ops/transformer/ln_linear.py:52"),
    "ln_linear_bwd_dx": dict(
        source="deepspeed_tpu_torch/ops/csrc/ln_linear.cu",
        replaces="deepspeed_tpu/ops/transformer/ln_linear.py:75"),
    "block_sparse_fwd": dict(
        source="deepspeed_tpu_torch/ops/csrc/block_sparse_attention.cu",
        replaces="deepspeed_tpu/ops/sparse_attention/pallas_kernel.py:68"),
    "block_sparse_dq": dict(
        source="deepspeed_tpu_torch/ops/csrc/block_sparse_attention.cu",
        replaces="deepspeed_tpu/ops/sparse_attention/pallas_kernel.py:164"),
    "block_sparse_dkv": dict(
        source="deepspeed_tpu_torch/ops/csrc/block_sparse_attention.cu",
        replaces="deepspeed_tpu/ops/sparse_attention/pallas_kernel.py:206"),
}
PAGED_KV = {"page_size": 64, "num_pages": 128, "prefix_cache": True,
            "kernel": "auto"}
# TinyLlama-1.1B (TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T
# config.json): vocab 32000, hidden 2048, intermediate 5632, 22 layers, 32
# heads over 4 KV heads, 2048 positions, rms_norm_eps 1e-5, rope_theta 1e4,
# untied head
TINYLLAMA = dict(vocab_size=32000, n_embd=2048, n_layer=22, n_head=32,
                 n_kv_head=4, mlp_ratio=2.75, max_seq_len=2048,
                 layer_norm_epsilon=1e-5, rope_theta=10000.0)
# projections per layer that run int8_matmul: q, k, v, o, gate, up, down
PROJECTIONS = 7


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


class patched:
    """``with patched(module, name, value):`` sets ``module.name`` and
    restores it after (a wrapper's design rule, forced for a timing)."""

    def __init__(self, module, name: str, value):
        self.module, self.name, self.value = module, name, value

    def __enter__(self):
        self.saved = getattr(self.module, self.name)
        setattr(self.module, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def decode_designs(call, check, S: int, layers: int,
                   module: str = "decode_attention",
                   plan: str = "decode_plan") -> dict:
    """A decode kernel (the contiguous one, or with ``module`` and ``plan``
    the paged one) in its FMA design beside the rule's, and the rule's
    design at 1, 2, 4 and 8 chunks of S (the plan's choice is timed as the
    row itself): ``check()`` holds the FMA design against the plain
    version, ``call()`` (``layers`` calls) is timed, a call's ms returned.
    Empty for a package without the plan (an older tree's)."""
    import importlib

    mod = importlib.import_module(f"deepspeed_tpu_torch.ops.attention.{module}")
    if not hasattr(mod, plan):
        return {}
    with patched(mod, "decode_design", lambda *_: "fma"):
        err = check()
        fma_ms = cuda_ms(call, reps=4) / layers
    rnd = importlib.import_module(
        "deepspeed_tpu_torch.ops.attention.decode_attention").PLAN_ROUND
    splits_ms = {}
    for splits in (1, 2, 4, 8):
        chunk = -(-S // (splits * rnd)) * rnd
        with patched(mod, plan, lambda *_, p=(-(-S // chunk), chunk): p):
            splits_ms[-(-S // chunk)] = cuda_ms(call, reps=4) / layers
    return dict(fma_ms=fma_ms, fma_err=err, splits_ms=splits_ms)


def decode_variants_log(fma: dict) -> str:
    """:func:`decode_designs`' times, for a log line."""
    if not fma:
        return ""
    return (f" (FMA design {fma['fma_ms']:.4f} ms, max|err| "
            f"{fma['fma_err']:.3g}; mma by chunks "
            + ", ".join(f"{k}: {v:.4f}" for k, v in fma["splits_ms"].items())
            + " ms)")


def paged_rule(B: int, T: int, H: int, KV: int, S: int, D: int) -> dict:
    """The paged kernel's design and ``paged_plan``'s split at these shapes
    (bf16 queries), for its row; empty for an older tree's package."""
    import importlib

    pa = importlib.import_module(
        "deepspeed_tpu_torch.ops.attention.paged_attention")
    if not hasattr(pa, "paged_plan"):
        return {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits, chunk = pa.paged_plan(B, T, H, KV, S, D, sms)
    return dict(design=pa.decode_design(torch.bfloat16, D), splits=splits,
                chunk=chunk)


def compare(got: torch.Tensor, want: torch.Tensor, what: str) -> tuple:
    """Hold a kernel's output against its plain version: every |err|
    within OUT_ATOL (one bf16 step of the plain value where |plain| >= 4)
    and every row (last axis) within ROW_REL_TOL of the plain row's norm.
    Returns (max |err|, max row relative error)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = diff.max().item()
    rel = ((got - want).norm(dim=-1)
           / want.norm(dim=-1).clamp_min(1e-6)).max().item()
    mag = want.abs()
    step = torch.exp2(torch.floor(torch.log2(mag.clamp_min(4.0))) - 7)
    over = diff / torch.where(mag >= 4.0, step, torch.full_like(step, OUT_ATOL))
    at = np.unravel_index(int(over.argmax()), tuple(diff.shape))
    assert math.isfinite(err) and over.max().item() <= 1.0, \
        f"{what}: |err| {diff[at].item()} over its limit at " \
        f"{tuple(map(int, at))} (kernel {got[at].item()}, plain " \
        f"{want[at].item()}; max |err| {err}, max row rel err {rel})"
    assert math.isfinite(rel) and rel <= ROW_REL_TOL, \
        f"{what}: max row rel err {rel} > {ROW_REL_TOL}"
    return err, rel


def rel_err(got, want) -> float:
    """Max over positions of ||got - want|| / ||want|| (rows of logits)."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


def bound(nbytes: float, flops: float) -> dict:
    """The card's least time for the work, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _counters() -> dict:
    """Each kernel variant's (wrapper, launch-count attribute)."""
    from deepspeed_tpu_torch.ops.attention.decode_attention import \
        decode_attention
    from deepspeed_tpu_torch.ops.attention.flash_attention import \
        flash_attention
    from deepspeed_tpu_torch.ops.attention.paged_attention import \
        paged_decode_attention
    from deepspeed_tpu_torch.ops.attention.flash_attention import (
        flash_attention_dkv, flash_attention_dq)
    from deepspeed_tpu_torch.ops.quantization.int8_matmul import int8_matmul
    from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel import (
        block_sparse_dkv, block_sparse_dq, block_sparse_fwd)
    from deepspeed_tpu_torch.ops.transformer.ln_linear import (
        ln_linear_bwd_dx, ln_linear_fwd)

    return {"decode_attention": (decode_attention, "launches"),
            "flash_attention_fwd": (flash_attention, "launches"),
            "paged_decode_attention": (paged_decode_attention, "launches"),
            "int8_matmul": (int8_matmul, "launches"),
            # the M > 16 (prefill tile) share of int8_matmul's launches
            "int8_matmul_prefill": (int8_matmul, "prefill_launches"),
            "decode_attention_int8": (decode_attention, "int8_launches"),
            "paged_decode_attention_int8": (paged_decode_attention,
                                            "int8_launches"),
            "flash_attention_dq": (flash_attention_dq, "launches"),
            "flash_attention_dkv": (flash_attention_dkv, "launches"),
            "ln_linear_fwd": (ln_linear_fwd, "launches"),
            "ln_linear_bwd_dx": (ln_linear_bwd_dx, "launches"),
            "block_sparse_fwd": (block_sparse_fwd, "launches"),
            "block_sparse_dq": (block_sparse_dq, "launches"),
            "block_sparse_dkv": (block_sparse_dkv, "launches")}


def reset_launches() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def read_launches() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in
            _counters().items()}


class ForwardCounter:
    """Counts the model forwards (one ``_transform`` each: every layer's
    projections run once per forward) inside a ``with`` block, and among
    them the decode steps run eagerly (``rows`` query rows a slot: 1, or
    K+1 for a speculative verify step; a replayed CUDA graph runs no
    ``_transform``)."""

    def __init__(self, model, rows: int = 1):
        self.model, self.rows, self.n, self.eager_decodes = model, rows, 0, 0

    def __enter__(self):
        inner = self.model._transform

        def counted(*args, **kwargs):
            self.n += 1
            mode = args[2] if len(args) > 2 else kwargs.get("mode")
            if mode in ("decode", "paged") and \
                    args[0].shape[1] == self.rows:
                self.eager_decodes += 1
            return inner(*args, **kwargs)

        self.model._transform = counted
        return self

    def __exit__(self, *exc):
        del self.model._transform     # the class's method again


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


def flash_times(q, k, v, do, label: str, reps: int,
                other: bool = True) -> dict:
    """The flash forward, dq and dk/dv kernels at one causal bf16 shape,
    each timed beside its bound and SDPA's time for the same function: its
    forward, and its backward (dq, dk and dv in one call, captured with its
    forward and the forward's time taken off); and with ``other``, for the
    record of the grid rule (``block_rows``), all three again with the
    other block size. Logs one line."""
    import importlib

    fa = importlib.import_module(
        "deepspeed_tpu_torch.ops.attention.flash_attention")
    B, T, H, D = q.shape
    out, lse = fa.flash_attention(q, k, v)
    args = (q, k, v, do, lse, fa.attention_delta(out, do), True,
            1.0 / math.sqrt(D))
    fwd = cuda_ms(lambda: fa.flash_attention(q, k, v), reps=reps)
    dq = cuda_ms(lambda: fa.flash_attention_dq(*args), reps=reps)
    dkv = cuda_ms(lambda: fa.flash_attention_dkv(*args), reps=reps)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    rows = fa.block_rows(D, B * H * -(-T // 128), sms)
    alt = ""
    if other:
        rule = fa.block_rows
        fa.block_rows = lambda *_: 192 - rows          # 64 <-> 128
        try:
            fwd_alt = cuda_ms(lambda: fa.flash_attention(q, k, v), reps=reps)
            dq_alt = cuda_ms(lambda: fa.flash_attention_dq(*args), reps=reps)
            dkv_alt = cuda_ms(lambda: fa.flash_attention_dkv(*args),
                              reps=reps)
        finally:
            fa.block_rows = rule
        alt = (f"; {192 - rows}-row blocks: forward {fwd_alt:.4f}, dq "
               f"{dq_alt:.4f}, dkv {dkv_alt:.4f}")
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    KV = k.shape[2]
    gqa = {"enable_gqa": True} if KV != H else {}

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              **gqa)

    sdpa_fwd = cuda_ms(sdpa, reps=reps)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(
        sdpa(), (qt, kt, vt), dot), reps=reps) - sdpa_fwd
    tok = q.numel() * q.element_size()      # one (B, T, H, D) tensor
    kv = k.numel() * k.element_size()       # one (B, T, KV, D) tensor
    stat = B * H * T * 4                    # lse or delta
    pairs = B * H * T * (T + 1) // 2        # causal (query, key) pairs
    # forward: q, k, v in, out and lse out; dq: q, k, v, dO, lse, delta in,
    # dq out; dk/dv: the same in, dk and dv (KV heads) out
    r = dict(fwd=fwd, fwd_bound=bound(2 * tok + 2 * kv + stat,
                                      2 * 2 * D * pairs),
             sdpa_fwd=sdpa_fwd, dq=dq,
             dq_bound=bound(3 * tok + 2 * kv + 2 * stat, 3 * 2 * D * pairs),
             dkv=dkv,
             dkv_bound=bound(2 * tok + 4 * kv + 2 * stat, 4 * 2 * D * pairs),
             sdpa_bwd=sdpa_bwd, design=fa.flash_design(q.dtype, D))
    heads = f"H={H}" if KV == H else f"H={H} KV={KV}"
    log(f"[flash_times] {label} B={B} {heads} D={D} T={T} causal "
        f"({r['design']}, {rows}-row blocks): forward {fwd:.4f} ms (bound "
        f"{r['fwd_bound']['bound_ms']:.4f}, {r['fwd_bound']['bound_by']}; "
        f"SDPA {sdpa_fwd:.4f}); dq {dq:.4f} ms (bound "
        f"{r['dq_bound']['bound_ms']:.4f}, {r['dq_bound']['bound_by']}); dkv "
        f"{dkv:.4f} ms (bound {r['dkv_bound']['bound_ms']:.4f}, "
        f"{r['dkv_bound']['bound_by']}; SDPA backward, dq + dk + dv, "
        f"{sdpa_bwd:.4f}){alt}")
    return r


def decode_kernel_row(gen: torch.Generator) -> dict:
    """The decode kernel at the serving decode step's shapes (8 slots, GPT-2
    heads, 12 layers' bf16 caches): held against its plain version with and
    without ALiBi on the first and last layer, timed over the layers in
    turn beside its FMA design, its plain version, SDPA and its bound."""
    from deepspeed_tpu_torch.ops.attention.decode_attention import (
        alibi_slopes, decode_attention, decode_attention_reference)

    dev, bf16 = "cuda", torch.bfloat16
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
    def layers():
        return [decode_attention(q, kc[i], vc[i], lengths) for i in range(L)]

    ms = cuda_ms(layers, reps=4) / L
    fma = decode_designs(layers, lambda: max(compare(
        decode_attention(q, kc[i], vc[i], lengths, alibi_slopes=sl),
        decode_attention_reference(q, kc[i], vc[i], lengths, scale, sl),
        "decode kernel, FMA design, vs plain")[0]
        for sl in (None, slopes) for i in (0, L - 1)), S, L)
    variants = decode_variants_log(fma)
    plain_ms = cuda_ms(lambda: [decode_attention_reference(
        q, kc[i], vc[i], lengths, scale) for i in range(L)], reps=1) / L
    pos = torch.arange(S, device=dev)
    mask = (pos[None, :] < lengths[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]
    lib_ms = cuda_ms(lambda: [F.scaled_dot_product_attention(
        q4, kc[i], vc[i], attn_mask=mask) for i in range(L)], reps=4) / L
    live = int(lengths.sum())
    esize = 2
    row = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **fma,
        **bound(2 * H * live * D * esize + 2 * B * H * D * esize + 4 * B,
                4 * H * live * D))
    log(f"[kernels] decode_attention B={B} H=KV={H} D={D} S={S} lengths="
        f"{lengths.tolist()}: max|err| {err:.3g} (tol {OUT_ATOL}), row rel "
        f"{rel:.3g} (tol {ROW_REL_TOL}); kernel {ms:.4f} ms{variants}, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms")
    return row


def phase_kernels(gen: torch.Generator) -> dict:
    from deepspeed_tpu_torch.ops.attention.flash_attention import (
        attention_delta, flash_attention, flash_attention_dkv,
        flash_attention_dq, flash_dkv_reference, flash_dq_reference,
        mha_reference)

    dev, bf16 = "cuda", torch.bfloat16
    H, D = 12, 64
    scale = 1.0 / math.sqrt(D)
    results = {"decode_attention": decode_kernel_row(gen)}

    # -- flash forward: admission prefill at every bucket width -------------
    # (the dq and dk/dv kernels at the same widths: a prompt's backward,
    # held and timed here beside the forward)
    B = 1
    err = rel = lse_err = dkv_err = 0.0
    per_t = {}
    for T in (16, 32, 64, 128, 256, 512, 1024):
        qf, kf, vf, dof = (torch.randn(B, T, H, D, generator=gen, device=dev)
                           .to(bf16) for _ in range(4))
        out, lse = flash_attention(qf, kf, vf, causal=True)
        ref, ref_lse = mha_reference(qf, kf, vf, causal=True)
        e, r = compare(out, ref, f"flash kernel vs plain at T={T}")
        le = (lse - ref_lse).abs().max().item()
        assert math.isfinite(le) and le <= LSE_ATOL, \
            f"flash lse vs plain at T={T}: max |err| {le} > {LSE_ATOL}"
        err, rel, lse_err = max(err, e), max(rel, r), max(lse_err, le)
        dargs = (qf, kf, vf, dof, lse, attention_delta(out, dof), True, scale)
        for g, w in zip((*flash_attention_dkv(*dargs),
                         flash_attention_dq(*dargs)),
                        (*flash_dkv_reference(*dargs),
                         flash_dq_reference(*dargs))):
            dkv_err = max(dkv_err, compare_rows(
                g, w, f"flash dq/dkv kernels vs plain at T={T}")[0])
        per_t[T] = flash_times(qf, kf, vf, dof, "serving", reps=20,
                               other=T == 1024)
    T = 1024
    ms = per_t[T]["fwd"]
    plain_ms = cuda_ms(lambda: mha_reference(qf, kf, vf), reps=2)
    results["flash_attention_fwd"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        library_ms=per_t[T]["sdpa_fwd"], design=per_t[T]["design"],
        **per_t[T]["fwd_bound"])
    log(f"[kernels] flash_attention_fwd B=1 H={H} D={D} causal, T 16..1024 "
        f"({per_t[T]['design']}): max|err| out {err:.3g} (tol {OUT_ATOL}), "
        f"row rel {rel:.3g} (tol {ROW_REL_TOL}), lse {lse_err:.3g} (tol "
        f"{LSE_ATOL}); dq and dkv max|err| {dkv_err:.3g} (row rule); per-T "
        "kernel ms forward " + ", ".join(f"{t}:{v['fwd']:.4f}"
                                         for t, v in per_t.items())
        + "; dq " + ", ".join(f"{t}:{v['dq']:.4f}" for t, v in per_t.items())
        + "; dkv " + ", ".join(f"{t}:{v['dkv']:.4f}"
                               for t, v in per_t.items()))
    log(f"[kernels] flash_attention_fwd T={T}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {per_t[T]['sdpa_fwd']:.4f} ms, bound "
        f"{results['flash_attention_fwd']['bound_ms']:.4f} ms")
    results["paged_decode_attention"] = paged_kernel(gen)
    return results


def slot_tables(gen: torch.Generator, T: int, P: int, ps: int,
                per_slot: int):
    """The paged kernel phases' 8 slots: ragged starts on and beside page
    boundaries (room for T rows each), and a (8, per_slot) int32 table of
    shuffled page ids out of P with the sentinel P past each slot's live
    pages. Returns (table, starts)."""
    dev, B, S = "cuda", 8, ps * per_slot
    starts = torch.tensor([0, 63, 64, S - 1 - T, 517, 300, 128, 999 - T],
                          dtype=torch.int32, device=dev)
    perm = torch.randperm(P, generator=gen, device=dev)[:B * per_slot]
    table = perm.reshape(B, per_slot).to(torch.int32)
    live = (starts.long() + T + ps - 1) // ps
    dead = torch.arange(per_slot, device=dev)[None] >= live[:, None]
    return table.masked_fill(dead, P).contiguous(), starts


def verify_row(label: str, gen: torch.Generator, call, B: int, H: int,
               KV: int, D: int, P: int, ps: int, per_slot: int, layers: int,
               esize: float, t1_ms: float, T: int = 5) -> dict:
    """A paged kernel row's time at ``T`` query rows a slot (a k = 4
    verify step): ``call(q, table, starts)`` runs the ``layers`` layers'
    kernels over the row's pages, ragged starts with room for T rows. The
    bound reads every live position's K/V rows (``esize`` bytes an element,
    an int8 cache's scales included) once and does T query rows' work."""
    q = torch.randn(B, T, H, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    table, starts = slot_tables(gen, T, P, ps, per_slot)
    ms = cuda_ms(lambda: call(q, table, starts), reps=4) / layers
    live = int((starts.long() + T).sum())
    # query row t of slot b attends starts[b] + t + 1 positions
    attended = int((starts.long() * T).sum()) + B * T * (T + 1) // 2
    pages_read = int(((starts.long() + T - 1) // ps + 1).sum())
    rule = paged_rule(B, T, H, KV, ps * per_slot, D)
    out = dict(T=T, ms=ms, **rule,
               **bound(2 * KV * live * D * esize + 2 * B * T * H * D * 2
                       + 4 * (pages_read + B), 4 * H * attended * D))
    log(f"{label} T={T} (verify, k=4): kernel {ms:.4f} ms (T=1 {t1_ms:.4f}; "
        f"{ms / t1_ms:.2f}x for {T}x the query rows; plan "
        f"{rule.get('splits')} x {rule.get('chunk')}), bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']})")
    return out


def paged_kernel(gen: torch.Generator) -> dict:
    """The paged kernel at the serving path's shapes: 8 slots, GPT-2 heads,
    64-position pages, 16 pages per slot, shuffled page ids, sentinels past
    each slot's live pages, ragged starts on and beside page boundaries;
    checked at every T from 1 to 8 (speculative verify's K+1 rows: partial
    row tiles at T = 5 under GQA 32/4, 40 of 48 rows, and at GQA 12/12) at
    GPT-2's and TinyLlama's heads, with ALiBi, and over 24-position pages
    (16-position groups cross pages). T=1 is timed beside the FMA design
    and 1, 2, 4, 8 chunks, and T=5 (a k=4 verify step) beside its own
    bound."""
    from deepspeed_tpu_torch.ops.attention.decode_attention import (
        alibi_slopes, decode_attention)
    from deepspeed_tpu_torch.ops.attention.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference)

    dev, bf16 = "cuda", torch.bfloat16
    L, B, D, ps, per_slot = 12, 8, 64, 64, 16
    S = ps * per_slot
    P = B * per_slot + 4
    scale = 1.0 / math.sqrt(D)

    def inputs(T, H, KV, layers=L, page=ps, pages=per_slot):
        n = B * pages + 4
        k = torch.randn(layers, n, KV, page, D, generator=gen,
                        device=dev).to(bf16)
        v = torch.randn(layers, n, KV, page, D, generator=gen,
                        device=dev).to(bf16)
        q = torch.randn(B, T, H, D, generator=gen, device=dev).to(bf16)
        return (q, k, v) + slot_tables(gen, T, n, page, pages)

    def check(q, k, v, table, starts, sl, what):
        return compare(
            paged_decode_attention(q, k, v, table, starts, alibi_slopes=sl),
            paged_decode_attention_reference(q, k, v, table, starts, scale,
                                             sl), what)

    err = rel = 0.0
    cases = [(T, H, KV, False, ps) for T in range(1, 9)
             for H, KV in ((12, 12), (32, 4))] + [
        (1, 12, 4, False, ps), (4, 12, 4, False, ps), (1, 12, 12, True, ps),
        (8, 12, 12, True, ps), (5, 12, 12, True, ps), (1, 12, 12, True, 24),
        (8, 32, 4, False, 24), (5, 32, 4, False, 24)]
    for T, H, KV, alibi, page in cases:
        # 24-position pages: 43 a slot hold the 1024 positions; two layers
        layers, pages = (L, per_slot) if page == ps else (2, -(-S // page))
        q, k, v, table, starts = inputs(T, H, KV, layers, page, pages)
        sl = alibi_slopes(H).to(dev) if alibi else None
        for layer in (0, layers - 1):
            e, r = check(q, k[layer], v[layer], table, starts, sl,
                         f"paged kernel vs plain (T={T}, H={H}, KV={KV}, "
                         f"alibi={alibi}, page {page})")
            err, rel = max(err, e), max(rel, r)
        del k, v

    # time the decode step's shape (T=1, H=KV=12) over the 12 layers in
    # turn, as a decode step reads them: 300 MB of pages, past the L2
    H = KV = 12
    q, k, v, table, starts = inputs(1, H, KV)

    def layers_call():
        return [paged_decode_attention(q, k[i], v[i], table, starts)
                for i in range(L)]

    ms = cuda_ms(layers_call, reps=4) / L
    slopes = alibi_slopes(H).to(dev)
    fma = decode_designs(layers_call, lambda: max(
        check(q, k[i], v[i], table, starts, sl,
              "paged kernel, FMA design, vs plain")[0]
        for sl in (None, slopes) for i in (0, L - 1)), S, L,
        "paged_attention", "paged_plan")
    # the plain version reads the live length on the host: eager timing
    plain_ms = eager_ms(lambda: [paged_decode_attention_reference(
        q, k[i], v[i], table, starts, scale) for i in range(L)], reps=2) / L
    # the decode kernel on the gathered dense view at the same lengths
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
    rule = paged_rule(B, 1, H, KV, S, D)
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
               dense_ms=dense_ms, **rule, **fma,
               **bound(2 * KV * live * D * esize + 2 * B * H * D * esize
                       + 4 * (pages_read + B), 4 * H * live * D))
    out["verify"] = verify_row(
        "[kernels] paged_decode_attention", gen, lambda qv, tv, sv: [
            paged_decode_attention(qv, k[i], v[i], tv, sv)
            for i in range(L)], B, H, KV, D, P, ps, per_slot, L, esize, ms)
    log(f"[kernels] paged_decode_attention B={B} H=KV={H} D={D} page {ps} x "
        f"{per_slot} pages/slot, P={P} shuffled, starts {starts.tolist()}; "
        f"checked every T 1-8 at GQA 12/12 and 32/4 (T=5: partial row "
        f"tiles), 12/4, ALiBi, 24-position pages: max|err| {err:.3g} (tol "
        f"{OUT_ATOL}), row rel {rel:.3g} (tol {ROW_REL_TOL}); T=1 kernel "
        f"{ms:.4f} ms "
        f"({rule.get('design', 'older tree')}, plan {rule.get('splits')} x "
        f"{rule.get('chunk')}){decode_variants_log(fma)}, plain "
        f"{plain_ms:.4f} ms, library none, bound {out['bound_ms']:.4f} ms")
    log(f"[kernels] decode_attention on the gathered dense view, same "
        f"lengths: {dense_ms:.4f} ms (paged/dense {ms / dense_ms:.3f})")
    return out


def gpt2_small(seed: int, dtype=torch.bfloat16, **overrides):
    """GPT-2 small at its published widths (openai-community/gpt2
    config.json; ``overrides`` narrow it for a CPU rehearsal), random
    weights from ``seed``."""
    from deepspeed_tpu_torch.models.transformer_lm import (
        TransformerLM, transformer_config)

    cfg = transformer_config("gpt2", **{
        **dict(vocab_size=50257, n_embd=768, n_head=12, n_layer=12,
               max_seq_len=1024, layer_norm_epsilon=1e-5), **overrides},
        dtype=dtype)
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
    return srv, reqs, launches, (prompts, budgets)


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


def served_weight(module, key: str) -> torch.Tensor:
    """A weight as the served module computes with it: read through its
    owner, so the storage tier's int8 weights come back dequantized."""
    owner, _, name = key.rpartition(".")
    return getattr(module.get_submodule(owner) if owner else module, name)


def fp32_reference(model, eng, device: str = "cuda"):
    """An fp32 copy of the served weights (dequantized, for the storage
    tier) with plain attention."""
    from deepspeed_tpu_torch.models.transformer_lm import TransformerLM

    ref_cfg = dataclasses.replace(model.config, dtype=torch.float32,
                                  use_flash_attention=False,
                                  decode_kernel="off")
    # built on the device: its random initial weights are overwritten at
    # once, and drawing them on the host takes seconds at 1.1B parameters
    ref = TransformerLM(ref_cfg, device=device)
    with torch.no_grad():
        ref.load_state_dict({k: served_weight(eng.module, k).float()
                             for k in ref.state_dict()})
    return ref.eval()


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
        rel = rel_err(served, want)
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


def shared_prefix_traffic(rng, vocab: int, n_shared: int = 8,
                          n_cold: int = 8):
    """The paged phases' traffic: 8 prompts on one 512-token prefix, 8 cold
    ones (32-768 tokens, the first short), budgets 64-128. The first prompt
    is a shared one (it runs before the rest arrive)."""
    prefix = rng.integers(0, vocab, 512)
    shared = [np.concatenate([prefix, rng.integers(0, vocab, int(n))])
              for n in rng.integers(16, 257, n_shared)]
    cold_lens = rng.integers(32, 769, n_cold)
    # one short prompt, so the run has a whole-prompt (bucketed) admission
    cold_lens[0] = rng.integers(32, 65)
    cold = [rng.integers(0, vocab, int(n)) for n in cold_lens]
    rest = shared[1:] + cold
    prompts = [shared[0]] + [rest[i] for i in rng.permutation(len(rest))]
    budgets = rng.integers(64, 129, len(prompts))
    return [p.astype(np.int32) for p in prompts], budgets


def phase_serve_paged(model, seed: int, device: str = "cuda",
                      config=None, label: str = "serve_paged"):
    """The default serving path: stall-free chunked admission over the
    page pool with its prefix cache, decode through the paged kernel
    (``config``: the inference config, bf16 by default)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.serving.request import RequestState

    config = config or {"dtype": "bfloat16"}
    srv = dst.init_serving(model, config=config, num_slots=8,
                           prefill_chunk=64, paged_kv=dict(PAGED_KV),
                           seed=seed, device=device)
    rng = np.random.default_rng(seed + 1)
    vocab = model.config.vocab_size
    # warm-up through a throwaway server on the same engine: a 1000-token
    # prompt walks every chunk width, a short one the bucketed admission,
    # so first-call costs of those shapes stay out of the run
    warm = dst.ServingEngine(srv.engine, num_slots=8, prefill_chunk=64,
                             paged_kv=dict(PAGED_KV), seed=seed)
    for n in (1000, 40):
        warm.submit(rng.integers(0, vocab, n), max_new_tokens=4)
    warm.run_until_drained()
    del warm
    prompts, budgets = shared_prefix_traffic(rng, vocab)
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
    L = model.config.n_layer
    assert launches["paged_decode_attention"] >= L * steps, \
        f"paged kernel ran {launches['paged_decode_attention']} times in " \
        f"{steps} decode steps (want >= {L * steps})"
    assert launches["flash_attention_fwd"] > 0, \
        "no whole-prompt admission ran the flash kernel"
    log(f"[{label}] gpt2-small {config}, 8 slots, prefill_chunk=64, paged_kv="
        f"{PAGED_KV}; 16 requests (8 share a 512-token prefix; prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))}, new "
        f"{int(budgets.min())}-{int(budgets.max())}): {st['new_tokens']} "
        f"tokens in {wall:.2f} s wall, {steps} decode steps")
    log(f"[{label}] tokens/s {st['tokens_per_s']:.1f}")
    log(f"[{label}] TTFT p50 {st['ttft_p50_ms']:.2f} ms p99 "
        f"{st['ttft_p99_ms']:.2f} ms")
    log(f"[{label}] step gap p50 {st['step_gap_p50_ms']:.2f} ms p99 "
        f"{st['step_gap_p99_ms']:.2f} ms")
    log(f"[{label}] prefix-hit tokens {st['prefix_hit_tokens']} "
        f"({st['prefix_hits']} hits of {st['prefix_lookups']} lookups); "
        f"preempted {st['preempted']}")
    log(f"[{label}] page stats {st['paging']}")
    log(f"[{label}] launches {launches}")
    return srv, reqs, launches, (prompts, budgets)


def int8_fragment_probe(gen: torch.Generator) -> None:
    """int8_matmul on small integers (x in -2..2, int8 weights, scale 1,
    fp32 out), where every sum is exact in fp32, at each tile shape the
    serving path runs (decode, split K at N=256, the 64- and 128-token
    prefill tiles): the kernel must equal the plain version exactly, so a
    misplaced fragment register or a wrong int8 conversion fails here."""
    from deepspeed_tpu_torch.ops.quantization.int8_matmul import (
        int8_matmul, int8_matmul_reference, int8_plan)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = []
    for M, K, N in ((8, 2048, 256), (8, 5632, 2048), (64, 2048, 5632),
                    (512, 2048, 5632)):
        x = torch.randint(-2, 3, (M, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = torch.randint(-128, 128, (N, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = torch.ones(N, device="cuda")
        got = int8_matmul(x, w, s, out_dtype=torch.float32)
        want = int8_matmul_reference(x, w, s, torch.float32)
        assert torch.equal(got, want), \
            f"int8 fragment probe M={M} K={K} N={N}: not exact"
        plans.append(f"M={M} K={K} N={N} (tile, splits) "
                     f"{int8_plan(M, K, N, sms)}")
    log("[int8_kernels] int8_matmul fragment probe exact at " +
        "; ".join(plans))


def int8_matmul_kernel(gen: torch.Generator) -> dict:
    """int8_matmul at TinyLlama's projection shapes: the decode step's 8
    rows through the 7 projections of one layer (q, k, v, o: K 2048 to N
    2048, 256, 256, 2048; gate, up: 2048 to 5632; down: 5632 to 2048), a
    k=4 verify step's 40 rows (8 slots x 5) through the same 7, a 64-row
    prefill chunk through gate (serve_int8's chunked admission) and a
    512-row one (serve_int8_contiguous's longest whole prompt). The JSON
    row is one decode layer, the sum of its 7 calls, with the verify layer
    under ``verify_layer`` and the prefill rows under ``prefill``. Weights
    are N(0, 0.02) quantized per channel; each shape is timed over enough
    weight copies to pass the 50 MB L2, as 22 layers' weights do."""
    import importlib

    from deepspeed_tpu_torch.ops.quantization.int8_matmul import (
        int8_matmul, int8_matmul_reference, quantize_columns)

    mod = importlib.import_module(
        "deepspeed_tpu_torch.ops.quantization.int8_matmul")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev, bf16 = "cuda", torch.bfloat16
    layer = [(2048, 2048), (2048, 256), (2048, 256), (2048, 2048),
             (2048, 5632), (2048, 5632), (5632, 2048)]
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                 nbytes=0, flops=0)
    err = rel = 0.0
    rows, prefill = [], []
    verify = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0, flops=0)
    for M, (K, N) in [(8, kn) for kn in layer] + [(40, kn) for kn in layer] \
            + [(64, (2048, 5632)), (512, (2048, 5632))]:
        wf = torch.randn(N, K, generator=gen, device=dev) * 0.02
        q, s = quantize_columns(wf.t())
        w, s = q.t().contiguous(), s.reshape(-1).contiguous()
        x = torch.randn(M, K, generator=gen, device=dev).to(bf16)
        got = int8_matmul(x, w, s)
        want = int8_matmul_reference(x, w, s, torch.float32)
        e, r = compare(got, want, f"int8_matmul M={M} K={K} N={N}")
        err, rel = max(err, e), max(rel, r)
        copies = max(1, -(-200 * 2 ** 20 // (N * K)))
        wc = w.expand(copies, N, K).contiguous()

        def kernel_ms():
            return cuda_ms(lambda: [int8_matmul(x, wc[i], s)
                                    for i in range(copies)], reps=2) / copies

        ms = kernel_ms()
        # for the record of the split rule: the same call unsplit
        tile, splits = mod.int8_plan(M, K, N, sms)
        other = ""
        if splits > 1:
            rule = mod.int8_plan
            mod.int8_plan = lambda *_, **__: (tile, 1)
            try:
                other = f" (unsplit {kernel_ms():.4f})"
            finally:
                mod.int8_plan = rule
        plain_ms = cuda_ms(lambda: int8_matmul_reference(x, w, s), reps=2)
        # the yardstick: cuBLAS on weights dequantized to bf16 ahead of
        # time, reading twice the bytes
        wd = (wc.float() * s[:, None]).to(bf16)
        lib_ms = cuda_ms(lambda: [F.linear(x, wd[i])
                                  for i in range(copies)], reps=2) / copies
        del wc, wd
        nbytes = M * K * 2 + N * K + N * 4 + M * N * 2
        flops = 2 * M * N * K
        b = bound(nbytes, flops)
        rows.append(f"M={M} K={K} N={N}: tile {tile}, {splits} splits: "
                    f"kernel {ms:.4f} ms{other}, plain {plain_ms:.4f}, bf16 "
                    f"F.linear {lib_ms:.4f}, bound {b['bound_ms']:.4f} "
                    f"({b['bound_by']}), row rel {r:.3g}")
        if M in (8, 40):
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", lib_ms), ("nbytes", nbytes),
                             ("flops", flops)):
                (total if M == 8 else verify)[key] += val
        else:
            prefill.append(dict(M=M, K=K, N=N, ms=ms, plain_ms=plain_ms,
                                library_ms=lib_ms, **b))
    for row in rows:
        log(f"[int8_kernels] int8_matmul {row}")
    verify_layer = dict(M=40, ms=verify["ms"], plain_ms=verify["plain_ms"],
                        library_ms=verify["library_ms"],
                        **bound(verify["nbytes"], verify["flops"]))
    out = dict(max_abs_err=err, ms=total["ms"], plain_ms=total["plain_ms"],
               library_ms=total["library_ms"],
               **bound(total["nbytes"], total["flops"]), prefill=prefill,
               verify_layer=verify_layer)
    log(f"[int8_kernels] int8_matmul one decode layer (7 calls, M=8): "
        f"max|err| {err:.3g} (tol {OUT_ATOL}), row rel {rel:.3g} (tol "
        f"{ROW_REL_TOL}); kernel {out['ms']:.4f} ms, plain "
        f"{out['plain_ms']:.4f} ms, bf16 F.linear {out['library_ms']:.4f} ms, "
        f"bound {out['bound_ms']:.4f} ms ({out['bound_by']})")
    log(f"[int8_kernels] int8_matmul one k=4 verify layer (7 calls, M=40 = "
        f"8 slots x 5 rows, the prefill tiles): kernel "
        f"{verify_layer['ms']:.4f} ms, plain {verify_layer['plain_ms']:.4f} "
        f"ms, bf16 F.linear {verify_layer['library_ms']:.4f} ms, bound "
        f"{verify_layer['bound_ms']:.4f} ms ({verify_layer['bound_by']})")
    return out


def int8_decode_kernel(gen: torch.Generator, L: int, H: int, KV: int,
                       S: int, lengths: list, label: str) -> dict:
    """The int8-cache decode kernel over ``L`` layers' (B, KV, S, 64)
    caches quantized per row, B = len(lengths) slots at those ragged
    lengths, ``H`` query heads: held against its plain version with and
    without ALiBi on the first and last layer, timed over the layers in
    turn (past the L2, as a decode step reads them)."""
    from deepspeed_tpu_torch.ops.attention.decode_attention import (
        alibi_slopes, decode_attention, decode_attention_reference,
        quantize_kv_rows)

    dev, bf16, D, B = "cuda", torch.bfloat16, 64, len(lengths)
    k8, ks = quantize_kv_rows(torch.randn(L, B, KV, S, D, generator=gen,
                                          device=dev))
    v8, vs = quantize_kv_rows(torch.randn(L, B, KV, S, D, generator=gen,
                                          device=dev))
    q = torch.randn(B, H, D, generator=gen, device=dev).to(bf16)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(D)
    err = rel = 0.0
    for sl in (None, alibi_slopes(H).to(dev)):
        for layer in (0, L - 1):
            got = decode_attention(q, k8[layer], v8[layer], lengths,
                                   alibi_slopes=sl, k_scale=ks[layer],
                                   v_scale=vs[layer])
            want = decode_attention_reference(q, k8[layer], v8[layer],
                                              lengths, scale, sl, ks[layer],
                                              vs[layer])
            e, r = compare(got, want, f"int8 decode kernel vs plain at "
                           f"{label} (alibi={sl is not None})")
            err, rel = max(err, e), max(rel, r)
    def layers():
        return [decode_attention(q, k8[i], v8[i], lengths, k_scale=ks[i],
                                 v_scale=vs[i]) for i in range(L)]

    ms = cuda_ms(layers, reps=4) / L
    fma = decode_designs(layers, lambda: max(compare(
        decode_attention(q, k8[i], v8[i], lengths, alibi_slopes=sl,
                         k_scale=ks[i], v_scale=vs[i]),
        decode_attention_reference(q, k8[i], v8[i], lengths, scale, sl,
                                   ks[i], vs[i]),
        f"int8 decode kernel, FMA design, vs plain at {label}")[0]
        for sl in (None, alibi_slopes(H).to(dev)) for i in (0, L - 1)), S, L)
    variants = decode_variants_log(fma)
    plain_ms = cuda_ms(lambda: [decode_attention_reference(
        q, k8[i], v8[i], lengths, scale, None, ks[i], vs[i])
        for i in range(L)], reps=1) / L
    # the yardstick: SDPA over the cache dequantized to bf16 ahead of time
    kd = (k8.float() * ks[..., None]).to(bf16)
    vd = (v8.float() * vs[..., None]).to(bf16)
    pos = torch.arange(S, device=dev)
    mask = (pos[None, :] < lengths[:, None].long())[:, None, None, :]
    lib_ms = cuda_ms(lambda: [F.scaled_dot_product_attention(
        q[:, :, None, :], kd[i], vd[i], attn_mask=mask,
        enable_gqa=KV != H) for i in range(L)], reps=4) / L
    live = int(lengths.sum())
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               **fma,
               **bound(2 * KV * live * (D + 4) + 2 * B * H * D * 2 + 4 * B,
                       4 * H * live * D))
    log(f"[int8_kernels] decode_attention_int8 at {label}: B={B} H={H} "
        f"KV={KV} D={D} S={S} lengths {lengths.tolist()}, {L} layers: "
        f"max|err| {err:.3g}, row rel {rel:.3g} (tol {ROW_REL_TOL}); kernel "
        f"{ms:.4f} ms{variants}, plain {plain_ms:.4f} ms, sdpa on a bf16 copy "
        f"{lib_ms:.4f} ms, bound {out['bound_ms']:.4f} ms")
    return out


def int8_paged_kernel(gen: torch.Generator) -> dict:
    """The int8 paged kernel with TinyLlama's heads (32 over 4 KV heads,
    D=64): 8 slots, 64-position pages, 16 pages per slot, shuffled ids,
    sentinels past each slot's live pages; every T from 1 to 8 (T=5: 40 of
    48 rows in 3 row tiles a KV head; T=8: 4 full tiles), ALiBi and
    24-position pages checked, T=1 timed over 22 layers' pools (95 MB, past
    the L2) beside the FMA design and 1, 2, 4, 8 chunks, and T=5 (a k=4
    verify step) beside its bound."""
    from deepspeed_tpu_torch.ops.attention.decode_attention import (
        alibi_slopes, decode_attention, quantize_kv_rows)
    from deepspeed_tpu_torch.ops.attention.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference)

    dev, bf16 = "cuda", torch.bfloat16
    L, B, H, KV, D, ps, per_slot = 22, 8, 32, 4, 64, 64, 16
    S = ps * per_slot
    P = B * per_slot + 4
    scale = 1.0 / math.sqrt(D)

    def pools(layers, page, pages):
        shape = (layers, B * pages + 4, KV, page, D)
        return (quantize_kv_rows(torch.randn(shape, generator=gen,
                                             device=dev))
                + quantize_kv_rows(torch.randn(shape, generator=gen,
                                               device=dev)))

    k8, ks, v8, vs = pools(L, ps, per_slot)

    def check(args, layer, sl, what):
        q, k8, ks, v8, vs, table, starts = args
        a = (q, k8[layer], v8[layer], table, starts)
        return compare(paged_decode_attention(
            *a, alibi_slopes=sl, k_scale_pages=ks[layer],
            v_scale_pages=vs[layer]), paged_decode_attention_reference(
            *a, scale, sl, ks[layer], vs[layer]), what)

    err = rel = 0.0
    # 24-position pages: 43 a slot hold the 1024 positions; two layers
    pages24 = -(-S // 24)
    small = pools(2, 24, pages24)
    for T, alibi, page in [(T, False, ps) for T in range(1, 9)] + [
            (1, True, ps), (8, True, ps), (5, True, ps), (1, True, 24),
            (8, False, 24), (5, False, 24)]:
        q = torch.randn(B, T, H, D, generator=gen, device=dev).to(bf16)
        pool, layers = ((k8, ks, v8, vs), L) if page == ps else (small, 2)
        args = (q, *pool) + slot_tables(
            gen, T, B * (per_slot if page == ps else pages24) + 4, page,
            per_slot if page == ps else pages24)
        sl = alibi_slopes(H).to(dev) if alibi else None
        for layer in (0, layers - 1):
            e, r = check(args, layer, sl, f"int8 paged kernel vs plain "
                         f"(T={T}, alibi={alibi}, page {page})")
            err, rel = max(err, e), max(rel, r)
    del small
    q = torch.randn(B, 1, H, D, generator=gen, device=dev).to(bf16)
    table, starts = slot_tables(gen, 1, P, ps, per_slot)

    def layers_call():
        return [paged_decode_attention(
            q, k8[i], v8[i], table, starts, k_scale_pages=ks[i],
            v_scale_pages=vs[i]) for i in range(L)]

    ms = cuda_ms(layers_call, reps=4) / L
    slopes = alibi_slopes(H).to(dev)
    fma = decode_designs(layers_call, lambda: max(
        check((q, k8, ks, v8, vs, table, starts), i, sl,
              "int8 paged kernel, FMA design, vs plain")[0]
        for sl in (None, slopes) for i in (0, L - 1)), S, L,
        "paged_attention", "paged_plan")
    plain_ms = eager_ms(lambda: [paged_decode_attention_reference(
        q, k8[i], v8[i], table, starts, scale, None, ks[i], vs[i])
        for i in range(L)], reps=2) / L
    ids = table.long().clamp(max=P - 1).reshape(-1)

    def dense(x):
        g = x[:, ids].reshape(L, B, per_slot, KV, ps, *x.shape[4:])
        return g.transpose(2, 3).reshape(L, B, KV, S, *x.shape[4:]) \
            .contiguous()

    dk, dv, dks, dvs = (dense(x) for x in (k8, v8, ks, vs))
    q1, lengths = q[:, 0].contiguous(), (starts + 1).contiguous()
    dense_ms = cuda_ms(lambda: [decode_attention(
        q1, dk[i], dv[i], lengths, k_scale=dks[i], v_scale=dvs[i])
        for i in range(L)], reps=4) / L
    live = int((starts.long() + 1).sum())
    pages_read = int(((starts.long() + ps) // ps).sum())
    rule = paged_rule(B, 1, H, KV, S, D)
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
               dense_ms=dense_ms, **rule, **fma,
               **bound(2 * KV * live * (D + 4) + 2 * B * H * D * 2
                       + 4 * (pages_read + B), 4 * H * live * D))
    out["verify"] = verify_row(
        "[int8_kernels] paged_decode_attention_int8", gen,
        lambda qv, tv, sv: [paged_decode_attention(
            qv, k8[i], v8[i], tv, sv, k_scale_pages=ks[i],
            v_scale_pages=vs[i]) for i in range(L)],
        B, H, KV, D, P, ps, per_slot, L, (D + 4) / D, ms)
    log(f"[int8_kernels] paged_decode_attention_int8 B={B} H={H} KV={KV} "
        f"D={D} page {ps} x {per_slot} pages/slot, P={P} shuffled; checked "
        f"every T 1-8 (T=5: partial row tiles), ALiBi, 24-position pages: "
        f"max|err| "
        f"{err:.3g}, row rel {rel:.3g} (tol {ROW_REL_TOL}); T=1 kernel "
        f"{ms:.4f} ms ({rule.get('design', 'older tree')}, plan "
        f"{rule.get('splits')} x {rule.get('chunk')})"
        f"{decode_variants_log(fma)}, plain {plain_ms:.4f} ms, library none, "
        f"bound {out['bound_ms']:.4f} ms")
    log(f"[int8_kernels] decode_attention_int8 on the gathered dense view, "
        f"same lengths: {dense_ms:.4f} ms (paged/dense {ms / dense_ms:.3f})")
    return out


def phase_int8_kernels(gen: torch.Generator, decode_only: bool = False,
                       rows: dict = None) -> dict:
    """The int8 rows. The int8 decode kernel is checked at the bf16 row's
    shapes (GPT-2 heads, printed beside it) and at the shapes
    ``serve_int8_contiguous`` gives it (TinyLlama's 22 layers, GQA 32/4, 4
    slots of 2048 positions), which make its JSON row. ``decode_only``:
    those two and the int8 paged row into ``rows`` (the first under
    ``..._gpt2``), nothing else."""
    gpt2 = int8_decode_kernel(gen, 12, 12, 12, 1024,
                              [1, 517, 1024, 1, 300, 1024, 64, 999],
                              "gpt2 shapes")
    contiguous = int8_decode_kernel(
        gen, TINYLLAMA["n_layer"], TINYLLAMA["n_head"], TINYLLAMA["n_kv_head"],
        TINYLLAMA["max_seq_len"], [1, 2048, 1100, 517],
        "serve_int8_contiguous shapes")
    if decode_only:
        rows.update(decode_attention_int8=contiguous,
                    decode_attention_int8_gpt2=gpt2,
                    paged_decode_attention_int8=int8_paged_kernel(gen))
        return rows
    int8_fragment_probe(gen)
    return {"int8_matmul": int8_matmul_kernel(gen),
            "decode_attention_int8": contiguous,
            "paged_decode_attention_int8": int8_paged_kernel(gen)}


def tinyllama(seed: int, device: str = "cuda", **overrides):
    """TinyLlama-1.1B at its published widths with the int8 KV cache,
    random N(0, 0.02) weights drawn on ``device`` from ``seed``."""
    from deepspeed_tpu_torch.models.transformer_lm import (
        TransformerLM, transformer_config)

    cfg = transformer_config("llama", **{**TINYLLAMA, **overrides},
                             kv_cache_quant=True, dtype=torch.bfloat16)
    model = TransformerLM(cfg, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model


def module_bytes(module) -> int:
    return sum(t.numel() * t.element_size()
               for t in module.state_dict().values())


def phase_serve_int8(model, seed: int, device: str = "cuda"):
    """The default serving path with int8 weights and the int8 KV cache:
    ``init_serving`` quantizes the model (dtype=int8), a throwaway server on
    the same engine warms the shapes, then 16 requests run."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.serving.request import RequestState

    L = model.config.n_layer
    bf16_bytes = module_bytes(model)
    rng = np.random.default_rng(seed + 2)
    vocab = model.config.vocab_size
    prompts, budgets = shared_prefix_traffic(rng, vocab)
    ps = PAGED_KV["page_size"]
    # page budget from the traffic's peak: the 8 largest requests resident at
    # once, plus the shared prefix's cached pages
    need = sorted(-(-(len(p) + int(n)) // ps) for p, n in zip(prompts,
                                                                 budgets))
    paged_kv = dict(PAGED_KV, num_pages=sum(need[-8:]) + 512 // ps)
    srv = dst.init_serving(model, config={"dtype": "int8"}, num_slots=8,
                           prefill_chunk=64, paged_kv=paged_kv, seed=seed,
                           device=device)
    int8_bytes = module_bytes(srv.engine.module)
    pool = srv.pool
    assert pool.cache["k"].dtype == torch.int8 and \
        pool.cache["v"].dtype == torch.int8, "the KV pages are not int8"
    assert pool.cache["k_scale"].dtype == torch.float32
    warm = dst.ServingEngine(srv.engine, num_slots=8, prefill_chunk=64,
                             paged_kv=paged_kv, seed=seed)
    for n in (1000, 40):
        warm.submit(rng.integers(0, vocab, n), max_new_tokens=4)
    warm.run_until_drained()
    del warm

    sync(device)
    with ForwardCounter(srv.engine.module) as forwards:
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
    n_fwd = forwards.n

    bad = [(r.request_id, r.state.value, len(r.output_tokens), int(n))
           for r, n in zip(reqs, budgets)
           if r.state is not RequestState.FINISHED
           or len(r.output_tokens) != n]
    assert not bad, f"requests not FINISHED with their budget: {bad}"
    srv.check_invariants()
    held = len(pool.prefix.page_counts())
    assert (pool.table == pool.num_pages).all() and \
        pool.free_page_count + held == pool.num_pages, \
        f"pages leaked: {pool.free_page_count} free + {held} cached != " \
        f"{pool.num_pages}"
    st = srv.stats()
    steps = st["decode_steps"]
    assert st["prefix_hit_tokens"] > 0, "no request was seated on the cache"
    assert launches["int8_matmul"] == PROJECTIONS * L * n_fwd, \
        f"int8_matmul ran {launches['int8_matmul']} times in {n_fwd} " \
        f"forwards (want {PROJECTIONS} x {L} per forward)"
    assert launches["paged_decode_attention_int8"] == L * steps, \
        f"int8 paged kernel ran {launches['paged_decode_attention_int8']} " \
        f"times in {steps} decode steps (want {L} per step)"
    assert launches["paged_decode_attention"] == 0 and \
        launches["decode_attention"] == 0, "a bf16 cache kernel ran"
    log(f"[serve_int8] tinyllama-1.1B widths ({L} layers, GQA "
        f"{model.config.n_head}/{model.config.kv_heads}), dtype=int8, "
        f"kv_cache_quant, 8 slots, prefill_chunk=64, paged_kv={paged_kv}; 16 "
        f"requests (8 share a 512-token prefix; prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))}, new "
        f"{int(budgets.min())}-{int(budgets.max())}): {st['new_tokens']} "
        f"tokens in {wall:.2f} s wall, {steps} decode steps, {n_fwd} model "
        f"forwards")
    log(f"[serve_int8] tokens/s {st['tokens_per_s']:.1f}")
    log(f"[serve_int8] TTFT p50 {st['ttft_p50_ms']:.2f} ms p99 "
        f"{st['ttft_p99_ms']:.2f} ms")
    log(f"[serve_int8] step gap p50 {st['step_gap_p50_ms']:.2f} ms p99 "
        f"{st['step_gap_p99_ms']:.2f} ms")
    log(f"[serve_int8] weight bytes resident: int8 tier {int8_bytes} vs bf16 "
        f"{bf16_bytes} ({int8_bytes / bf16_bytes:.3f}x)")
    log(f"[serve_int8] prefix-hit tokens {st['prefix_hit_tokens']} "
        f"({st['prefix_hits']} hits of {st['prefix_lookups']} lookups); "
        f"preempted {st['preempted']}")
    log(f"[serve_int8] page stats {st['paging']}")
    log(f"[serve_int8] launches {launches}")
    return srv, reqs, launches, (prompts, budgets, paged_kv)


def phase_serve_int8_contiguous(srv_int8, seed: int,
                                device: str = "cuda") -> dict:
    """The int8 engine over contiguous slots, whole-prompt admission: a few
    requests, decode through the int8 decode kernel."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.serving.request import RequestState

    eng = srv_int8.engine
    L = eng.module.config.n_layer
    srv = dst.ServingEngine(eng, num_slots=4, prefill_chunk=0,
                            paged_kv=False, seed=seed)
    assert srv.pool.cache["k"].dtype == torch.int8
    rng = np.random.default_rng(seed + 3)
    vocab = eng.module.config.vocab_size
    prompts = [rng.integers(0, vocab, int(n)).astype(np.int32)
               for n in rng.integers(32, 513, 6)]
    budgets = rng.integers(32, 65, 6)
    sync(device)
    with ForwardCounter(eng.module) as forwards:
        reset_launches()
        t0 = time.perf_counter()
        reqs = [srv.submit(p, max_new_tokens=int(n))
                for p, n in zip(prompts, budgets)]
        srv.run_until_drained()
        sync(device)
        wall = time.perf_counter() - t0
        launches = read_launches()
    bad = [(r.request_id, r.state.value) for r, n in zip(reqs, budgets)
           if r.state is not RequestState.FINISHED
           or len(r.output_tokens) != n]
    assert not bad, f"requests not FINISHED with their budget: {bad}"
    srv.check_invariants()
    st = srv.stats()
    steps = st["decode_steps"]
    assert launches["decode_attention_int8"] == L * steps, \
        f"int8 decode kernel ran {launches['decode_attention_int8']} times " \
        f"in {steps} decode steps (want {L} per step)"
    assert launches["int8_matmul"] == PROJECTIONS * L * forwards.n
    log(f"[serve_int8_contiguous] 4 slots, prefill_chunk=0, paged_kv=False; "
        f"6 requests (prompts {min(map(len, prompts))}-"
        f"{max(map(len, prompts))}, new {int(budgets.min())}-"
        f"{int(budgets.max())}): {st['new_tokens']} tokens in {wall:.2f} s "
        f"wall, {steps} decode steps; tokens/s {st['tokens_per_s']:.1f}; "
        f"TTFT p50 {st['ttft_p50_ms']:.2f} ms p99 {st['ttft_p99_ms']:.2f} ms; "
        f"step gap p50 {st['step_gap_p50_ms']:.2f} ms p99 "
        f"{st['step_gap_p99_ms']:.2f} ms; launches {launches}")
    return reqs, launches, srv, (prompts, budgets)


# ---------------------------------------------------------------------------
# the captured decode step (enable_cuda_graph): each serve phase again on a
# server whose engine replays its decode step from a CUDA graph
def graph_engine(model, device: str = "cuda"):
    """An engine with ``enable_cuda_graph`` over a built (and, for the int8
    tier, already quantized) model."""
    import deepspeed_tpu_torch as dst

    return dst.init_inference(model, config={"dtype": "bfloat16",
                                             "enable_cuda_graph": True},
                              device=device)


def paged_warmup(rng, vocab: int) -> list:
    """Warm-up waves for a paged server: a 1000-token prompt (every chunk
    width), a 40-token one (the bucketed admission) and a 128-token one,
    then the 128-token one again, a full prefix hit whose last page forks
    copy-on-write: every program the paged traffic can reach runs once."""
    again = rng.integers(0, vocab, 128)
    return [[rng.integers(0, vocab, 1000), rng.integers(0, vocab, 40),
             again], [again]]


def warm_up(srv, warm) -> None:
    """Serve the warm-up waves, then drop their pages from the prefix
    cache, so the measured pass starts from the pool an eager arm's fresh
    server has."""
    for wave in warm:
        for p in wave:
            srv.submit(p, max_new_tokens=4)
        srv.run_until_drained()
    pool = srv.pool
    if getattr(pool, "prefix", None) is not None:
        pool.prefix.evict(pool, pool.evictable_page_count())
        assert pool.free_page_count == pool.num_pages


def drive(srv, prompts, budgets, first_alone: bool):
    """Submit the traffic (the first request alone until it runs, as the
    paged phases do, or all at once) and serve it until drained."""
    from deepspeed_tpu_torch.serving.request import RequestState

    reqs = []
    if first_alone:
        reqs.append(srv.submit(prompts[0], max_new_tokens=int(budgets[0])))
        while reqs[0].state is RequestState.QUEUED or \
                reqs[0].state is RequestState.PREFILLING:
            srv.step()
    reqs += [srv.submit(p, max_new_tokens=int(n))
             for p, n in zip(prompts[len(reqs):], budgets[len(reqs):])]
    srv.run_until_drained()
    return reqs


def captures_of(srv) -> int:
    """Decode graphs this server's watchdog saw captured."""
    return sum(e["program"] == "DecodeGraphs.capture"
               for e in srv.watchdog.events)


def hold_captured_logits(srv, eager_engine) -> tuple:
    """The server's captured decode step on its live pool against the
    eager step (``eager_engine``, the same model) on a copy of that pool:
    the same tokens, positions and table, held on the running slots' rows
    (a prefilling or free row is padding whose writes go to the scratch
    page, where two rows may race). The step's pages are mapped first, as
    the next step would, and the replay writes the rows the next step
    writes again with the same values. Returns (max |diff|, max row
    relative diff); expected 0."""
    from deepspeed_tpu_torch.serving.request import RequestState

    pool = srv.pool
    if srv._paged:
        srv._ensure_decode_pages(1)
    rows = [slot for slot, req in srv._slot_req.items()
            if req.state is RequestState.RUNNING]
    tokens = srv._cur[:, None].clone()
    pos = pool.positions_dev()
    copy_ = {k: v.clone() for k, v in pool.cache.items()}
    # the server's own calls, so the watchdog sees no new signature
    if srv._paged:
        want = eager_engine.decode_paged(copy_, tokens, pos.long(),
                                         pool.table_dev.clone(),
                                         scratch_page=True)
        got = pool.run_decode(srv.engine, tokens, pos)
    else:
        want = eager_engine.decode(copy_, tokens, pos)
        got = srv.engine.decode(pool.cache, tokens, pos)
    got, want = got[rows], want[rows]
    diff = (got - want).abs().max().item()
    rel = ((got - want).norm(dim=-1)
           / want.norm(dim=-1).clamp_min(1e-6)).max().item()
    return diff, rel


def replay_ms(srv, reps: int = 50) -> float:
    """Device time of one replay of the server's decode graph, by CUDA
    events (the graph rewrites the rows of its last step, in pages or rows
    the drained server no longer uses)."""
    graphs = srv.engine.decode_graphs
    (graph,) = [g for g in graphs._graphs.values()
                if g.bound_to(srv.pool.cache)]
    graph.graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def serve_line(st: dict) -> str:
    return (f"tokens/s {st['tokens_per_s']:.1f}; TTFT p50 "
            f"{st['ttft_p50_ms']:.2f} ms; step gap p50 "
            f"{st['step_gap_p50_ms']:.2f} ms p99 {st['step_gap_p99_ms']:.2f} "
            f"ms")


def phase_captured(label: str, eager_srv, eager_reqs, make_server, warm,
                   prompts, budgets, first_alone: bool, check_launches,
                   kernel_ms: float, device: str = "cuda") -> dict:
    """``label``'s traffic again on ``make_server()`` (an engine with
    ``enable_cuda_graph``, ``strict_recompile=True``). The warm-up requests
    run on that server, in waves each drained before the next (its one
    decode graph is captured there, bound to its pool), then the measured
    pass: every request's greedy tokens must
    be the eager arm's, no decode step may run eagerly, and
    ``check_launches(launches, decode_steps, forwards)`` holds the launch
    counts, replays included. Then ``end_warmup()`` and the same traffic
    again as churn: one captured step's logits on the live pool against
    the eager step's on a copy of it (1e-3 relative; bit-equal expected),
    no recompile, one capture in all. Returns the arm's numbers."""
    from deepspeed_tpu_torch.serving.metrics import ServingMetrics
    from deepspeed_tpu_torch.serving.request import RequestState

    t_arm = time.perf_counter()
    srv = make_server()
    warm_up(srv, warm)
    srv.metrics = ServingMetrics(step_fn=lambda: srv.step_id)
    sync(device)
    with ForwardCounter(srv.engine.module) as forwards:
        reset_launches()
        t0 = time.perf_counter()
        reqs = drive(srv, prompts, budgets, first_alone)
        sync(device)
        wall = time.perf_counter() - t0
        launches = read_launches()
    bad = [(r.request_id, r.state.value, len(r.output_tokens), int(n))
           for r, n in zip(reqs, budgets)
           if r.state is not RequestState.FINISHED
           or len(r.output_tokens) != n]
    assert not bad, f"{label}: captured requests not FINISHED: {bad}"
    srv.check_invariants()
    differ = [r.request_id for r, e in zip(reqs, eager_reqs)
              if not np.array_equal(r.tokens(), e.tokens())]
    assert not differ, f"{label}: captured tokens differ from the eager " \
        f"arm's for requests {differ}"
    st = srv.stats()
    steps = st["decode_steps"]
    # on a CPU engine (a rehearsal) the static-buffer step runs eagerly
    assert forwards.eager_decodes == (0 if device == "cuda" else steps), \
        f"{label}: {forwards.eager_decodes} decode steps ran eagerly"
    check_launches(launches, steps, forwards.n - forwards.eager_decodes)

    srv.end_warmup()
    churn = [srv.submit(p, max_new_tokens=int(n))
             for p, n in zip(prompts, budgets)]
    held = None
    while srv.pending or srv.live_count:
        srv.step()
        if held is None and srv._running_count() >= 2:
            held = hold_captured_logits(srv, eager_srv.engine)
    assert held is not None, f"{label}: no step with two running requests"
    assert math.isfinite(held[1]) and held[1] <= CAPTURED_REL_TOL, \
        f"{label}: captured decode logits vs eager rel err {held[1]} > " \
        f"{CAPTURED_REL_TOL} (max |diff| {held[0]})"
    assert all(r.state is RequestState.FINISHED for r in churn)
    srv.check_invariants()
    assert srv.watchdog.recompiles == 0, \
        f"{label}: recompiles after warmup: {srv.watchdog.events[-3:]}"
    assert captures_of(srv) == 1, \
        f"{label}: {captures_of(srv)} decode graphs captured, want 1"
    rep = replay_ms(srv) if device == "cuda" else float("nan")
    eager_st = eager_srv.stats()
    log(f"[{label}] captured: {st['new_tokens']} tokens in {wall:.2f} s "
        f"wall, {steps} decode steps, every one a replay; tokens identical "
        f"to the eager arm's; {serve_line(st)} (eager: "
        f"{serve_line(eager_st)}); TTFT p99 {st['ttft_p99_ms']:.2f} ms "
        f"(eager {eager_st['ttft_p99_ms']:.2f})")
    log(f"[{label}] captured: one replay {rep:.4f} ms on the device (its "
        f"hand-written kernels' rows sum to {kernel_ms:.4f} ms); decode "
        f"logits vs eager on a copy of the pool: max |diff| {held[0]:.3g}, "
        f"row rel {held[1]:.3g} (tol {CAPTURED_REL_TOL}); 1 capture, 0 "
        f"recompiles after warmup under strict_recompile; the arm (warm-up, "
        f"measured pass, churn) took {time.perf_counter() - t_arm:.1f} s; "
        f"launches {launches}")
    return dict(srv=srv, reqs=reqs, launches=launches, stats=st,
                replay_ms=rep, logits_max_abs=held[0], logits_rel=held[1])


def exact_launches(label: str, kernel: str, layers: int,
                   projections: int = 0):
    """A ``check_launches`` for :func:`phase_captured`: ``kernel`` ran
    ``layers`` times a decode step, and with int8 weights ``int8_matmul``
    ``projections`` x ``layers`` times a forward, replays counted as
    forwards."""
    def check(launches, steps, forwards):
        assert launches[kernel] == layers * steps, \
            f"{label}: {kernel} ran {launches[kernel]} times in {steps} " \
            f"decode steps (want {layers} per step)"
        want = projections * layers * (forwards + steps)
        assert launches["int8_matmul"] == want, \
            f"{label}: int8_matmul ran {launches['int8_matmul']} times " \
            f"(want {want}: {forwards} prefill forwards + {steps} replays)"
    return check


def phase_generate_captured(eager, captured, seed: int, B: int = 8,
                            T: int = 128, new: int = 128,
                            device: str = "cuda") -> dict:
    """``generate()`` at batch ``B`` on the eager engine and on the one
    with ``enable_cuda_graph``: identical tokens; tokens/s of each."""
    rng = np.random.default_rng(seed + 4)
    vocab = eager.module.config.vocab_size
    prompts = rng.integers(0, vocab, (B, T))
    out, rate = {}, {}
    for name, eng in (("eager", eager), ("captured", captured)):
        eng.generate(prompts[:, :16], max_new_tokens=4)   # first calls
        eng.generate(prompts, max_new_tokens=2)
        sync(device)
        t0 = time.perf_counter()
        out[name] = eng.generate(prompts, max_new_tokens=new)
        sync(device)
        rate[name] = B * new / (time.perf_counter() - t0)
    assert np.array_equal(out["eager"], out["captured"]), \
        "captured generate() tokens differ from the eager engine's"
    log(f"[generate_captured] gpt2-small bf16, B={B}, prompt {T}, "
        f"{new} new tokens: tokens identical; tokens/s eager "
        f"{rate['eager']:.1f}, captured {rate['captured']:.1f} "
        f"({rate['captured'] / rate['eager']:.2f}x)")
    return rate


def phase_overlap_captured(label: str, engine, eager_reqs, warm, prompts,
                           budgets, seed: int, device: str = "cuda") -> dict:
    """``serve_paged``'s traffic on an ``overlap=True`` server over the
    captured engine: every request's tokens are the serial step's."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.serving.metrics import ServingMetrics
    from deepspeed_tpu_torch.serving.request import RequestState

    srv = dst.ServingEngine(engine, num_slots=8, prefill_chunk=64,
                            paged_kv=dict(PAGED_KV), seed=seed, overlap=True)
    warm_up(srv, warm)
    srv.metrics = ServingMetrics(step_fn=lambda: srv.step_id)
    sync(device)
    t0 = time.perf_counter()
    reqs = drive(srv, prompts, budgets, first_alone=True)
    sync(device)
    wall = time.perf_counter() - t0
    srv.check_invariants()
    assert all(r.state is RequestState.FINISHED for r in reqs)
    differ = [r.request_id for r, e in zip(reqs, eager_reqs)
              if not np.array_equal(r.tokens(), e.tokens())]
    assert not differ, f"{label}: overlap tokens differ from the serial " \
        f"step's for requests {differ}"
    st = srv.stats()
    log(f"[{label}] overlap=True, captured: {st['new_tokens']} tokens in "
        f"{wall:.2f} s wall, tokens identical to the serial step's; "
        f"{serve_line(st)}; TTFT p99 {st['ttft_p99_ms']:.2f} ms")
    return st


# ---------------------------------------------------------------------------
# the int8 storage tier and the cost model on the default path
# the storage tier: fp16 compute, int8 at rest with a scale per 64 values
STORAGE = {"dtype": "float16",
           "quant": {"enabled": True, "bits": 8, "group_size": 64}}


def phase_serve_storage(seed: int, results: dict, warm,
                        device: str = "cuda", **overrides) -> list:
    """GPT-2 small in fp16 through the int8 storage tier on 3b's default
    path and traffic, eager and captured; 2 requests' served logits
    against an fp32 copy of the dequantized weights. Returns the two arms'
    launch counts."""
    import deepspeed_tpu_torch as dst

    model = gpt2_small(seed, dtype=torch.float16, **overrides)
    L = model.config.n_layer
    fp16_bytes = module_bytes(model)
    srv, reqs, launches, traffic = phase_serve_paged(
        model, seed, device, config=STORAGE, label="serve_storage")
    module = srv.engine.module
    stored = [m for m in module.modules() if hasattr(m, "parametrizations")]
    assert stored and module.embed_tokens.parametrizations.weight.original \
        .dtype == torch.int8, "the storage tier left the weights unquantized"
    rest = module_bytes(module)
    log(f"[serve_storage] weights at rest {rest} bytes, {rest / fp16_bytes:.3f}"
        f" x the fp16 model's {fp16_bytes} ({len(stored)} modules hold int8 "
        f"weights dequantized at each use)")
    hit = next(r for r in reqs if r.prefix_hit_tokens > 0)
    cold = max((r for r in reqs if r.prefix_hit_tokens == 0),
               key=lambda r: r.prompt_len)
    ref = fp32_reference(model, srv.engine, device)
    phase_reference(ref, (hit, cold),
                    lambda p, c: served_paged_logits(srv, p, c),
                    "reference_storage", device)
    del ref
    cap = phase_captured(
        "serve_storage", srv, reqs, lambda: dst.ServingEngine(
            dst.init_inference(module, config={"dtype": "float16",
                                               "enable_cuda_graph": True},
                               device=device),
            num_slots=8, prefill_chunk=64, paged_kv=dict(PAGED_KV),
            seed=seed, strict_recompile=True),
        warm, *traffic, first_alone=True,
        check_launches=exact_launches("serve_storage",
                                      "paged_decode_attention", L),
        kernel_ms=L * results["paged_decode_attention"]["ms"],
        device=device)
    return [launches, cap["launches"]]


def phase_cost_model(model, seed: int, warm, prompts, budgets, eager_reqs,
                     device: str = "cuda") -> list:
    """3b's captured server with ``cost_model=True`` against the same
    server without it, in turns (on, off, off, on): after the warm-up
    waves, ``reset_efficiency_window()``, then the traffic. Returns the
    arms' launch counts."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.serving.metrics import ServingMetrics
    from deepspeed_tpu_torch.serving.request import RequestState

    arms, runs = [], []
    for cost in (True, False, False, True):
        # an engine of its own a server: the watchdog's proxies on an
        # engine are shared, and would charge an off arm's calls to an
        # earlier server's model
        srv = dst.ServingEngine(graph_engine(model, device), num_slots=8,
                                prefill_chunk=64,
                                paged_kv=dict(PAGED_KV), seed=seed,
                                cost_model=cost)
        warm_up(srv, warm)
        srv.reset_efficiency_window()
        srv.metrics = ServingMetrics(step_fn=lambda: srv.step_id)
        sync(device)
        reset_launches()
        reqs = drive(srv, prompts, budgets, first_alone=True)
        sync(device)
        runs.append(read_launches())
        assert all(r.state is RequestState.FINISHED for r in reqs)
        srv.check_invariants()
        differ = [r.request_id for r, e in zip(reqs, eager_reqs)
                  if not np.array_equal(r.tokens(), e.tokens())]
        assert not differ, f"cost_model (on={cost}): tokens differ from " \
            f"serve_paged's for requests {differ}"
        arm = dict(cost=cost, stats=srv.stats())
        if cost:
            snap = srv.efficiency_snapshot()
            cs = snap["costs"]
            assert cs["unavailable"] == 0 and cs["uncosted_calls"] == 0, \
                f"cost_model: uncosted programs: {cs}"
            assert 0 < snap["mfu"] <= 1.05 and \
                0 < snap["bandwidth_util"] <= 1.05, \
                f"cost_model: mfu {snap['mfu']}, bandwidth_util " \
                f"{snap['bandwidth_util']} outside (0, 1.05]"
            assert snap["hbm_drift"] <= srv.costs.hbm_tolerance, \
                f"cost_model: hbm_drift {snap['hbm_drift']}"
            arm["snap"] = snap
        arms.append(arm)
    on = [a for a in arms if a["cost"]]
    for a in on:
        snap, cs = a["snap"], a["snap"]["costs"]
        log(f"[cost_model] on: mfu {snap['mfu']:.6f}, bandwidth_util "
            f"{snap['bandwidth_util']:.6f}, tokens_per_gflop "
            f"{cs['tokens_per_gflop']:.4f}, overhead_pct "
            f"{snap['overhead_pct']:.4f}; {cs['flops_total']:.6g} flops and "
            f"{cs['bytes_accessed_total']:.6g} bytes in {cs['wall_s']:.4f} s "
            f"of step wall over {cs['calls_total']} program calls "
            f"({cs['programs']} signatures counted, {cs['unavailable']} "
            f"unavailable); hbm_drift {snap['hbm_drift']}, KV "
            f"{cs['hbm']['kv_bytes_actual']:.6g} bytes; peaks "
            f"{cs['peak_flops']:.4g} flop/s, {cs['peak_bytes_per_s']:.4g} B/s")
    log("[cost_model] step gap p50 in turns (on, off, off, on): " + ", ".join(
        f"{a['stats']['step_gap_p50_ms']:.3f} ms" for a in arms)
        + "; tokens/s " + ", ".join(f"{a['stats']['tokens_per_s']:.1f}"
                                    for a in arms)
        + "; every arm's tokens equal serve_paged's")
    return runs


# ---------------------------------------------------------------------------
# speculative decoding (serving/spec_decode/): draft + one (8, K+1) verify
# forward a step, captured, under strict_recompile
SPEC_NGRAM = {"drafter": "ngram", "k": 8, "max_ngram": 3}


def motif_traffic(rng, vocab: int, n: int, budget_hi: int = 224):
    """The JAX package's spec row traffic (bench.py:704-731): each prompt
    tiles a random motif of 4-8 tokens to 32-128 tokens, budgets 64 to
    ``budget_hi``. Weights are random, so what the drafter finds in it
    says nothing about real text."""
    prompts, budgets = [], []
    for _ in range(n):
        T = int(rng.integers(32, 129))
        motif = rng.integers(0, vocab, size=int(rng.integers(4, 9)))
        prompts.append(np.tile(motif, T // len(motif) + 1)[:T]
                       .astype(np.int32))
        budgets.append(int(rng.integers(64, budget_hi + 1)))
    return prompts, budgets


def hold_captured_verify(srv, eager_engine) -> tuple:
    """A paged server's captured verify forward on its live pool against
    the eager forward (``eager_engine``, the same model) on a copy of the
    pool: the current tokens and the last drafts, the same positions and
    table, held on the running slots' (num_slots, K+1, V) rows. The K+1
    positions are mapped first, as the next step would; the next step
    rewrites every row the replay wrote before reading it. Returns (max
    |diff|, max row relative diff); expected 0."""
    from deepspeed_tpu_torch.serving.request import RequestState

    pool, K = srv.pool, srv._spec.k
    srv._ensure_decode_pages(K + 1)
    rows = [slot for slot, req in srv._slot_req.items()
            if req.state is RequestState.RUNNING]
    tokens = torch.cat([srv._cur[:, None], srv._draft], dim=1)
    pos = pool.positions_dev().long()
    copy_ = {k: v.clone() for k, v in pool.cache.items()}
    want = eager_engine.decode_paged(copy_, tokens, pos,
                                     pool.table_dev.clone(), scratch_page=True)
    # the pool's own call form, so the watchdog sees no new signature
    got = srv.engine.decode_paged(pool.cache, tokens, pos, pool.table_dev,
                                  scratch_page=True)
    got, want = got[rows], want[rows]
    assert got.shape[1:] == (K + 1, srv.engine.module.config.vocab_size)
    diff = (got - want).abs().max().item()
    rel = ((got - want).norm(dim=-1)
           / want.norm(dim=-1).clamp_min(1e-6)).max().item()
    return diff, rel


def spec_arm(label: str, srv, prompts, budgets, device: str = "cuda",
             eager_engine=None, rows: int = 1) -> dict:
    """One server's arm: the traffic once as warm-up (it reaches every
    program the traffic can; with ``eager_engine`` one captured verify
    step is held against the eager one there), its prefix pages dropped,
    ``end_warmup()``, then the traffic again, measured: every request
    finishes with its budget, the audits hold, no recompile after warm-up
    (``strict_recompile`` raises at the step that makes one) and one
    captured step in all. ``rows``: the query rows of the server's decode
    step (K+1 with speculation)."""
    from deepspeed_tpu_torch.serving.metrics import ServingMetrics
    from deepspeed_tpu_torch.serving.request import RequestState

    held = None
    reqs = [srv.submit(p, max_new_tokens=int(n))
            for p, n in zip(prompts, budgets)]
    while srv.pending or srv.live_count:
        srv.step()
        if eager_engine is not None and held is None and \
                captures_of(srv) == 1 and srv._running_count() >= 2:
            held = hold_captured_verify(srv, eager_engine)
    assert all(r.state is RequestState.FINISHED for r in reqs)
    warm_up(srv, [])
    srv.end_warmup()
    srv.metrics = ServingMetrics(step_fn=lambda: srv.step_id)
    sync(device)
    with ForwardCounter(srv.engine.module, rows) as forwards:
        reset_launches()
        t0 = time.perf_counter()
        reqs = drive(srv, prompts, budgets, first_alone=False)
        sync(device)
        wall = time.perf_counter() - t0
        launches = read_launches()
    bad = [(r.request_id, r.state.value, len(r.output_tokens), int(n))
           for r, n in zip(reqs, budgets)
           if r.state is not RequestState.FINISHED
           or len(r.output_tokens) != n]
    assert not bad, f"{label}: requests not FINISHED with their budget: {bad}"
    srv.check_invariants()
    if srv._paged:
        pool = srv.pool
        held_pages = len(pool.prefix.page_counts())
        assert (pool.table == pool.num_pages).all() and \
            pool.free_page_count + held_pages == pool.num_pages, \
            f"{label}: pages leaked"
    assert srv.watchdog.recompiles == 0, \
        f"{label}: recompiles after warmup: {srv.watchdog.events[-3:]}"
    assert captures_of(srv) == 1, \
        f"{label}: {captures_of(srv)} steps captured, want 1"
    st = srv.stats()
    assert forwards.eager_decodes == (0 if device == "cuda"
                                      else st["decode_steps"]), \
        f"{label}: {forwards.eager_decodes} decode steps ran eagerly"
    if eager_engine is not None:
        assert held is not None, f"{label}: no step with two running rows"
        assert math.isfinite(held[1]) and held[1] <= CAPTURED_REL_TOL, \
            f"{label}: captured verify logits vs eager rel err {held[1]} > " \
            f"{CAPTURED_REL_TOL} (max |diff| {held[0]})"
    rep = replay_ms(srv) if device == "cuda" else float("nan")
    return dict(srv=srv, reqs=reqs, launches=launches, stats=st, wall=wall,
                forwards=forwards.n - forwards.eager_decodes, replay_ms=rep,
                held=held)


def spec_line(arm: dict) -> str:
    st = arm["stats"]
    acc = st["spec_acceptance_rate"]
    over = st["draft_overhead_pct"]
    return (f"{st['new_tokens']} tokens in {arm['wall']:.2f} s wall, "
            f"{st['decode_steps']} decode steps; tokens/s "
            f"{st['tokens_per_s']:.1f}; tokens per slot-step "
            f"{st['tokens_per_decode_step']:.3f}; acceptance "
            f"{'n/a' if acc is None else f'{acc:.3f}'}; draft overhead "
            f"{'n/a' if over is None else f'{over:.2f}'}%; step gap p50 "
            f"{st['step_gap_p50_ms']:.2f} ms p99 {st['step_gap_p99_ms']:.2f} "
            f"ms; TTFT p50 {st['ttft_p50_ms']:.2f} ms; one replay "
            f"{arm['replay_ms']:.4f} ms")


def same_tokens(label: str, arm: dict, ref_reqs, what: str) -> None:
    differ = [r.request_id for r, e in zip(arm["reqs"], ref_reqs)
              if not np.array_equal(r.tokens(), e.tokens())]
    assert not differ, f"{label}: tokens differ from {what} for requests " \
        f"{differ}"


def no_drafts():
    """A drafter that never drafts: every verify step is then plain greedy
    decoding through the verify forward itself (draft_len 0 in every
    row), the exact oracle for what drafting may not change."""
    from deepspeed_tpu_torch.serving.spec_decode import Drafter

    class NoDrafts(Drafter):
        name = "none"

        def propose(self, histories, k):
            return (np.zeros((len(histories), k), np.int32),
                    np.zeros((len(histories),), np.int32))

    return NoDrafts()


def divergences(label: str, spec_reqs, off_reqs, engine, ref,
                against: str = "the one-row decode step") -> dict:
    """The spec arm's greedy tokens against the one-row decode step's
    (``off_reqs``), which computes the same logits with other kernels and
    other product shapes, so in bf16 an argmax whose top two logits are
    closer than their rounding differences can fall either way, after
    which the two continuations part. For each request that differs, at
    its first differing token: the teacher-forced logits of the decode
    path (``engine``) and of ``ref`` (fp32 or plain kernels) on the common
    prefix, and both arms' tokens' distance below ``ref``'s maximum as a
    multiple of the largest |decode path - ref| at that position
    (``against`` names ``off_reqs``' arm in the log). Returns the counts
    and the worst multiple."""
    same, worst, rows = 0, 0.0, []
    for r, o in zip(spec_reqs, off_reqs):
        a, b = np.asarray(r.output_tokens), np.asarray(o.output_tokens)
        d = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if d is None:
            same += 1
            continue
        prompt = np.asarray(r.prompt)
        got = served_path_logits(engine, prompt, a[:d])[-1].float()
        with torch.no_grad():
            want = ref.logits(torch.as_tensor(
                np.concatenate([prompt, a[:d]])[None],
                device=got.device))[0, -1].float()
        err = (got - want).abs().max().item()
        top = want.max().item()
        gap = max(top - want[int(a[d])].item(), top - want[int(b[d])].item())
        worst = max(worst, gap / err)
        rows.append((r.request_id, d, round(gap, 5), round(err, 5)))
    log(f"[{label}] vs {against}: {same} of {len(spec_reqs)} "
        f"requests identical; first differences (request, token, gap below "
        f"the reference's top logit, max |decode path - reference|): "
        f"{rows}; worst gap / error {worst:.3g} (limit {TIE_FACTOR})")
    assert worst <= TIE_FACTOR, \
        f"{label}: a token where the arms part lies {worst:.3g} rounding " \
        f"errors below the reference's top logit (limit {TIE_FACTOR}): not " \
        f"a tie, a wrong token: {rows}"
    return dict(same=same, n=len(spec_reqs), worst=worst, rows=rows)


def phase_serve_spec(model, seed: int, device: str = "cuda") -> dict:
    """bench.py's spec row on the port: GPT-2 small bf16, 32 motif
    requests on 8 slots, the n-gram drafter at k=8, the contiguous pool
    (ServingEngine's default: T = 9 exceeds the paged kernel's 8 rows);
    spec off and spec on, each on a captured engine with
    ``strict_recompile``: identical tokens, one captured step each (the
    verify forward for spec on), 0 recompiles after warm-up."""
    import deepspeed_tpu_torch as dst

    rng = np.random.default_rng(seed + 5)
    prompts, budgets = motif_traffic(rng, model.config.vocab_size, 32)
    arms = {}
    for name, spec in (("off", None), ("on", SPEC_NGRAM),
                       ("no drafts", dict(SPEC_NGRAM, drafter=no_drafts()))):
        srv = dst.ServingEngine(graph_engine(model, device), num_slots=8,
                                max_queue_depth=64, seed=seed,
                                strict_recompile=True, spec_decode=spec)
        arms[name] = spec_arm(f"serve_spec {name}", srv, prompts, budgets,
                              device, rows=1 if spec is None
                              else spec["k"] + 1)
    same_tokens("serve_spec", arms["on"], arms["no drafts"]["reqs"],
                "the no-drafts arm's")
    eager = dst.init_inference(model, config={"dtype": "bfloat16"},
                               device=device)
    arms["divergences"] = divergences(
        "serve_spec", arms["on"]["reqs"], arms["off"]["reqs"], eager,
        fp32_reference(model, eager, device))
    on = arms["on"]
    k = SPEC_NGRAM["k"]
    assert on["launches"]["decode_attention"] == 0, \
        "serve_spec: a verify step ran the one-row decode kernel"
    assert arms["off"]["launches"]["decode_attention"] == \
        12 * arms["off"]["stats"]["decode_steps"]
    assert on["stats"]["spec_drafted"] > 0
    for name in ("off", "on", "no drafts"):
        arm = arms[name]
        log(f"[serve_spec] spec {name} (gpt2-small bf16, 8 slots, contiguous, "
            f"captured, strict_recompile; 32 motif requests, prompts "
            f"{min(map(len, prompts))}-{max(map(len, prompts))}, new "
            f"{min(budgets)}-{max(budgets)}): {spec_line(arm)}")
    ratio = on["stats"]["tokens_per_s"] / arms["off"]["stats"]["tokens_per_s"]
    log(f"[serve_spec] ngram k={k}: tokens identical to the no-drafts "
        f"arm's; 1 capture each (the verify forward (8, {k + 1}) with "
        f"speculation), 0 recompiles after warm-up; spec-on/off tokens/s "
        f"{ratio:.2f} on random weights (motif traffic: not a speed-up "
        f"users see); launches spec on {on['launches']}")
    return arms


def phase_serve_spec_paged(model, seed: int, spec_arms: dict, prompts,
                           budgets, device: str = "cuda") -> dict:
    """``serve_spec``'s traffic over ``serve_paged``'s PAGED_KV at k=4: a
    verify step sends T = 5 query rows a slot through the paged kernel.
    A serial arm, an ``overlap=True`` arm and a no-drafts arm, captured,
    strict: the serial arm's tokens equal the no-drafts arm's and the
    overlap arm's; against ``serve_spec``'s spec-off arm as
    :func:`divergences` holds them; the paged kernel runs exactly 12 times
    a verify step (replays counted); one captured verify step's (8, 5, V)
    logits equal the eager forward's on a copy of the pool; no slot or
    page leaks."""
    import deepspeed_tpu_torch as dst

    spec = dict(SPEC_NGRAM, k=4)
    eager = dst.init_inference(model, config={"dtype": "bfloat16"},
                               device=device)
    arms = {}
    for name, overlap, drafter in (("serial", False, "ngram"),
                                   ("overlap", True, "ngram"),
                                   ("no drafts", False, no_drafts())):
        srv = dst.ServingEngine(graph_engine(model, device), num_slots=8,
                                max_queue_depth=64, prefill_chunk=64,
                                paged_kv=dict(PAGED_KV), seed=seed,
                                strict_recompile=True, overlap=overlap,
                                spec_decode=dict(spec, drafter=drafter))
        arm = spec_arm(f"serve_spec_paged {name}", srv, prompts, budgets,
                       device, eager_engine=eager if name == "serial"
                       else None, rows=spec["k"] + 1)
        steps = arm["stats"]["decode_steps"]
        assert arm["launches"]["paged_decode_attention"] == 12 * steps, \
            f"serve_spec_paged {name}: paged kernel ran " \
            f"{arm['launches']['paged_decode_attention']} times in {steps} " \
            f"verify steps (want 12 each)"
        arms[name] = arm
        log(f"[serve_spec_paged] {name} (k=4, T=5 through the paged kernel, "
            f"paged_kv={PAGED_KV}, captured, strict_recompile): "
            f"{spec_line(arm)}; paged kernel launches "
            f"{arm['launches']['paged_decode_attention']} = 12 x {steps} "
            f"verify steps")
    same_tokens("serve_spec_paged", arms["serial"], arms["no drafts"]["reqs"],
                "the no-drafts arm's")
    same_tokens("serve_spec_paged overlap", arms["overlap"],
                arms["serial"]["reqs"], "the serial arm's")
    arms["divergences"] = divergences(
        "serve_spec_paged", arms["serial"]["reqs"], spec_arms["off"]["reqs"],
        eager, fp32_reference(model, eager, device))
    held = arms["serial"]["held"]
    log(f"[serve_spec_paged] tokens equal the no-drafts and overlap arms'; "
        f"captured verify logits (8, 5, V) vs eager on a copy of the pool: "
        f"max |diff| {held[0]:.3g}, row rel {held[1]:.3g} (tol "
        f"{CAPTURED_REL_TOL}); launches serial {arms['serial']['launches']}")
    return arms


def phase_serve_spec_model(model, seed: int, paged_arms: dict, prompts,
                           budgets, device: str = "cuda") -> dict:
    """The small-model drafter: GPT-2 small drafting for itself (a second,
    captured engine over the same weights), k=4, over the paged pool, the
    first 8 of ``serve_spec``'s requests at once: tokens equal
    ``serve_spec_paged``'s no-drafts arm's (the same verify forward); each
    step runs the draft prefill (flash kernel), k-1 draft decode replays
    (the decode kernel) and one verify replay (the paged kernel).
    Acceptance is reported, not held: the drafter's decode kernel and the
    verify's paged kernel round differently."""
    import deepspeed_tpu_torch as dst

    k = 4
    drafter_engine = graph_engine(model, device)
    srv = dst.ServingEngine(
        graph_engine(model, device), num_slots=8, max_queue_depth=64,
        prefill_chunk=64, paged_kv=dict(PAGED_KV), seed=seed,
        spec_decode={"drafter": "model", "k": k,
                     "draft_engine": drafter_engine})
    sync(device)
    reset_launches()
    t0 = time.perf_counter()
    reqs = drive(srv, prompts, budgets, first_alone=False)
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    arm = dict(reqs=reqs, launches=launches, stats=srv.stats(), wall=wall,
               replay_ms=replay_ms(srv) if device == "cuda"
               else float("nan"))
    srv.check_invariants()
    assert all(len(r.output_tokens) == n for r, n in zip(reqs, budgets))
    same_tokens("serve_spec_model", arm,
                paged_arms["no drafts"]["reqs"][:len(reqs)],
                "serve_spec_paged's no-drafts arm")
    steps = arm["stats"]["decode_steps"]
    assert launches["paged_decode_attention"] == 12 * steps
    assert launches["decode_attention"] == 12 * (k - 1) * steps, \
        f"serve_spec_model: decode kernel ran {launches['decode_attention']}" \
        f" times in {steps} steps (want 12 x {k - 1} draft decodes each)"
    assert launches["flash_attention_fwd"] >= 12 * steps
    log(f"[serve_spec_model] SmallModelDrafter (gpt2-small drafting for "
        f"itself, captured draft engine), k={k}, paged, {len(reqs)} "
        f"requests: {spec_line(arm)}; tokens equal the no-drafts arm's; "
        f"launches {launches}")
    return arm


# ---------------------------------------------------------------------------
# serving resilience and telemetry (serving/resilience/, telemetry/): the
# default serving path with every fault-tolerance and telemetry key on,
# under a seeded fault schedule, on a fake clock
RESILIENCE_TICK = 0.02       # fake-clock seconds a step
# one 64-wide admission (or one prefill chunk) a step, in every load state:
# every prefill runs alone, so a request's tokens never depend on who else
# was admitted with it, and a fault that reorders admissions changes no
# token of a request it did not touch
RESILIENCE_BUDGET = 64
RESILIENCE_FAULTS = {"admit_oom": [3], "nan_logits": [12],
                     "step_host_error": [28], "slow_dispatch": [20]}
RESILIENCE_SLOW_MS = 100.0
RESILIENCE_WALL_BUDGET_MS = 50.0
PRIORITY = {"classes": ("interactive", "batch")}
# the interactive class's TTFT target; a class alerts only when under a
# fifth of its requests in the window finish within target (goodput
# target 0.5, warn at burn 1.6), so the burn-rate shedding of the batch
# class guards against a real miss, not the backlog of a burst
RESILIENCE_SLO = {"classes": {"interactive": {"ttft_ms": 2000.0,
                                              "gap_ms": None}},
                  "window_steps": 64, "goodput_target": 0.5,
                  "warn_burn": 1.6, "page_burn": 1.9}
RESILIENCE_LADDER = {"queue_pressured": 8, "queue_overloaded": 16,
                     "cooldown_steps": 4, "retry_after_s": 0.5}
RESILIENCE_PREEMPT_QUEUE = 16
# arrivals a step: one every other step, a burst of 24 at step 32 (which
# tips the ladder into OVERLOADED and sheds some of what follows), then
# one every other step again: 48 in all
RESILIENCE_ARRIVALS = [1, 0] * 16 + [24, 0] + [1, 0] * 8


class FakeClock:
    """The serving engine's clock (``clock=``), advanced by the caller."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def clocked_faults(clock, **kw):
    """A FaultInjector whose ``slow_dispatch`` moves the fake clock by
    ``slow_ms`` (the step then takes that long on the engine's clock)
    instead of sleeping."""
    from deepspeed_tpu_torch.serving.resilience import FaultInjector

    class ClockedFaults(FaultInjector):
        def maybe_sleep(self, point="slow_dispatch"):
            if self._roll(point):
                clock.t += self.slow_ms / 1e3
                return True
            return False

    return ClockedFaults(**kw)


def resilience_traffic(rng, vocab: int) -> list:
    """48 requests arriving RESILIENCE_ARRIVALS a step: prompts of 33-64
    tokens (one 64-wide bucketed admission each) or 65-200 (chunked),
    budgets 16-48, every third of class interactive and the rest batch, a
    400 ms deadline on every eighth. Returns [(arrival step, prompt,
    submit kwargs)]."""
    steps = [s for s, n in enumerate(RESILIENCE_ARRIVALS) for _ in range(n)]
    out = []
    for i, step in enumerate(steps):
        T = int(rng.integers(33, 65) if i % 2 == 0 else rng.integers(65, 201))
        kw = dict(max_new_tokens=int(rng.integers(16, 49)),
                  priority="interactive" if i % 3 == 0 else "batch")
        if i % 8 == 5:
            kw["deadline_ms"] = 400.0
        out.append((step, rng.integers(0, vocab, T).astype(np.int32), kw))
    return out


def resilience_warmup(rng, vocab: int) -> list:
    """:func:`paged_warmup`'s waves (every chunk width, the bucketed
    admission, a prefix hit with its copy-on-write fork) and a wave of two
    10-token prompts admitted together (the batched admission)."""
    return paged_warmup(rng, vocab) + [[rng.integers(0, vocab, 10),
                                        rng.integers(0, vocab, 10)]]


def fault_free_arm(engine, traffic, warm, seed: int, telemetry: bool,
                   device: str = "cuda") -> dict:
    """The traffic with no faults, deadlines, classes or degradation, all
    submitted at once, on the real clock: telemetry all on (tracer, SLO
    tracker, flight recorder, timelines) or all off (tracer off, no SLO
    tracker, no flight recorder, one timeline kept)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.serving.metrics import ServingMetrics
    from deepspeed_tpu_torch.serving.request import RequestState
    from deepspeed_tpu_torch.telemetry import Tracer

    knobs = (dict(tracer=Tracer(), slo=True, flight_recorder=True)
             if telemetry else
             dict(tracer=None, slo=None, flight_recorder=False,
                  timeline_capacity=1))
    srv = dst.ServingEngine(engine, num_slots=8, prefill_chunk=64,
                            prefill_token_budget=RESILIENCE_BUDGET,
                            paged_kv=dict(PAGED_KV), seed=seed,
                            strict_recompile=True, **knobs)
    warm_up(srv, warm)
    srv.end_warmup()
    srv.metrics = ServingMetrics(registry=srv.registry,
                                 step_fn=lambda: srv.step_id)
    over0, steps0 = srv.telemetry_overhead_s, srv.step_id
    sync(device)
    t0 = time.perf_counter()
    reqs = [srv.submit(p, max_new_tokens=kw["max_new_tokens"])
            for _, p, kw in traffic]
    srv.run_until_drained()
    sync(device)
    wall = time.perf_counter() - t0
    assert all(r.state is RequestState.FINISHED for r in reqs)
    assert srv.watchdog.recompiles == 0
    srv.check_invariants()
    st = srv.stats()
    steps = srv.step_id - steps0
    return dict(reqs=reqs, stats=st, wall=wall, steps=steps,
                overhead_per_step_ms=(srv.telemetry_overhead_s - over0)
                / steps * 1e3)


def fault_arm(engine, traffic, warm, seed: int,
              device: str = "cuda") -> dict:
    """serve_resilience's fault arm: the server with every resilience and
    telemetry key on, warmed quietly (the warm-up waves, then a wave of
    interactive requests that seeds that class's SLO windows), then the
    traffic arriving step by step on the fake clock under
    RESILIENCE_FAULTS. An injected fault is caught at the step boundary
    (where the engine has already rolled the step back); for the
    step_host_error the harness writes the flight recorder's
    post-mortem."""
    import tempfile

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.serving.resilience import InjectedFault
    from deepspeed_tpu_torch.telemetry import Tracer

    clock = FakeClock()
    faults = clocked_faults(clock, seed=seed, slow_ms=RESILIENCE_SLOW_MS)
    srv = dst.ServingEngine(
        engine, num_slots=8, prefill_chunk=64,
        prefill_token_budget=RESILIENCE_BUDGET, paged_kv=dict(PAGED_KV),
        seed=seed, strict_recompile=True, tracer=Tracer(),
        slo=RESILIENCE_SLO, flight_recorder=True,
        dump_dir=tempfile.mkdtemp(prefix="serve_resilience-"),
        guard_numerics=True, degradation=RESILIENCE_LADDER,
        preempt_queue_threshold=RESILIENCE_PREEMPT_QUEUE, priority=PRIORITY,
        step_wall_budget_ms=RESILIENCE_WALL_BUDGET_MS, clock=clock,
        fault_injector=faults)
    warm_up(srv, warm)
    for _, p, kw in traffic[:8]:
        srv.submit(p[:40], max_new_tokens=4, priority="interactive")
    srv.run_until_drained()
    srv.end_warmup()
    faults.load_schedule(RESILIENCE_FAULTS)
    captures = captures_of(srv)
    reqs, errors, levels, post_mortem = [], [], [], None
    sync(device)
    reset_launches()
    t0 = time.perf_counter()
    step = 0
    while step <= traffic[-1][0] or srv.pending or srv.live_count:
        for _, p, kw in (x for x in traffic if x[0] == step):
            reqs.append(srv.submit(p, **kw))
        try:
            srv.step()
        except InjectedFault as e:
            errors.append(e.point)
            if e.point == "step_host_error":
                post_mortem = srv.recorder.dump(
                    "step_host_error", error=e, timelines=srv.timelines,
                    registry=srv.registry, tracer=srv.tracer)
        levels.append(srv._load.state)
        clock.t += RESILIENCE_TICK
        step += 1
        assert step < 2000, "serve_resilience: the traffic never drained"
    sync(device)
    return dict(srv=srv, reqs=reqs, errors=errors, levels=levels,
                faults=faults, post_mortem=post_mortem,
                launches=read_launches(), wall=time.perf_counter() - t0,
                steps=step, captures=captures)


def touched(req, timeline) -> bool:
    """Whether a fault, deadline, preemption or shedding touched ``req``."""
    names = [e["event"] for e in timeline]
    return (req.state.value != "finished"
            or str(req.finish_reason) not in ("length", "eos")
            or req.preemptions > 0 or "requeued" in names)


def phase_serve_resilience(model, seed: int, spec_prompts, spec_budgets,
                           no_drafts_reqs, device: str = "cuda") -> dict:
    """The default serving path (8 slots, PAGED_KV, chunk 64, captured,
    strict_recompile) with every resilience and telemetry key on: tracer,
    registry, timelines, SLO tracker with two priority classes, flight
    recorder (post-mortems into a temporary directory), guard_numerics,
    the degradation ladder, pressure preemption, deadlines on every eighth
    request, a step wall budget, and the engine's clock a fake clock moved
    RESILIENCE_TICK a step. After a quiet warm-up and ``end_warmup()``, a
    FaultInjector fires RESILIENCE_FAULTS (the 3rd admission raises
    admit_oom, the 12th decode's logits get a NaN row, the 28th step
    raises step_host_error, the 20th step's dispatch is slow against the
    wall budget) while 48 requests arrive (RESILIENCE_ARRIVALS). Held:

    1. every request no fault, deadline, preemption or shedding touched
       has exactly the tokens of the fault-free arm; the others' tokens
       part from it only at near-ties (``divergences``);
    2. exactly one request, the poisoned one, ends FAILED numerical_error;
    3. no recompile and no new capture after warm-up;
    4. after the drain the audit is clean, no slot or page leaks;
    5. the exported trace holds every step span, and the step_host_error's
       post-mortem (written by this harness from the flight recorder)
       carries POST_MORTEM_KEYS;
    6. a spec arm (n-gram, k=4) driven into OVERLOADED drafts nothing
       while overloaded, captures nothing new, and gives the no-drafts
       arm's tokens exactly (``no_drafts_reqs``: serve_spec_paged's, over
       ``spec_prompts``).

    Also a contiguous arm (the decode kernel) under the NaN and the
    step_host_error faults. Prints the fault-free traffic's step gap with
    all telemetry on against all of it off (four arms, in turns off, on,
    on, off), and ``telemetry_overhead_s`` per step."""
    import os

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.serving.request import RequestState
    from deepspeed_tpu_torch.serving.resilience import (InjectedFault,
                                                        LoadState)
    from deepspeed_tpu_torch.telemetry import POST_MORTEM_KEYS, Tracer

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 14)
    vocab = model.config.vocab_size
    traffic = resilience_traffic(rng, vocab)
    warm = resilience_warmup(rng, vocab)
    eager = dst.init_inference(model, config={"dtype": "bfloat16"},
                               device=device)

    # the fault-free arms, telemetry off and on in turns (off, on, on,
    # off): the same tokens in all four
    ref_engine = graph_engine(model, device)
    turns = [(on, fault_free_arm(ref_engine, traffic, warm, seed, on,
                                 device)) for on in (False, True, True,
                                                     False)]
    for on, arm in turns[1:]:
        same_tokens(f"serve_resilience telemetry {'on' if on else 'off'}",
                    arm, turns[0][1]["reqs"], "the first arm's")
    arms = {"on": turns[1][1], "off": turns[0][1]}
    ref_tokens = [r.output_tokens for r in arms["on"]["reqs"]]

    # the fault arm
    fa = fault_arm(graph_engine(model, device), traffic, warm, seed, device)
    srv, reqs, errors, levels, faults = (fa[k] for k in (
        "srv", "reqs", "errors", "levels", "faults"))
    post_mortem, launches, wall, step = (fa[k] for k in (
        "post_mortem", "launches", "wall", "steps"))
    dump_dir = srv.dump_dir

    # 2-4: the poisoned request alone, no recompile or capture, no leaks
    assert sorted(errors) == ["admit_oom", "step_host_error"], errors
    assert faults.fired == {p: len(RESILIENCE_FAULTS.get(p, ()))
                            for p in faults.fired}, faults.fired
    poisoned = [r for r in reqs if r.finish_reason == "numerical_error"]
    assert len(poisoned) == 1 and poisoned[0].state is RequestState.FAILED
    assert srv.watchdog.recompiles == 0, srv.watchdog.events[-3:]
    assert captures_of(srv) == fa["captures"] == 1
    srv.check_invariants()
    pool = srv.pool
    held_pages = len(pool.prefix.page_counts())
    assert srv.live_count == 0 and pool.free_count == pool.num_slots
    assert (pool.table == pool.num_pages).all() and \
        pool.free_page_count + held_pages == pool.num_pages, "pages leaked"
    assert srv.timelines.open_ids() == []
    st = srv.stats()
    assert st["step_overruns"] == 1
    # 1: untouched requests exactly, touched ones up to near-ties
    untouched = [i for i, r in enumerate(reqs)
                 if not touched(r, srv.timeline(r.request_id))]
    differ = [reqs[i].request_id for i in untouched
              if reqs[i].output_tokens != ref_tokens[i]]
    assert not differ, f"serve_resilience: untouched requests {differ} " \
        f"differ from the fault-free arm"
    hit = [i for i in range(len(reqs)) if i not in untouched
           and reqs[i].output_tokens]
    ties = divergences("serve_resilience", [reqs[i] for i in hit],
                       [arms["on"]["reqs"][i] for i in hit], eager,
                       fp32_reference(model, eager, device),
                       against="the fault-free arm (touched requests)")
    # 5: every step span in the exported trace; the post-mortem's keys
    path = os.path.join(dump_dir, "trace.json")
    srv.tracer.export(path)
    with open(path) as f:
        spans = {e["name"] for e in json.load(f)["traceEvents"]
                 if e["ph"] == "X"}
    want = {"serving/step", "serving/grant", "serving/admit",
            "serving/prefill_batch", "serving/prefill_chunk",
            "serving/decode", "serving/sample"}
    assert want <= spans, f"serve_resilience: spans missing: {want - spans}"
    assert post_mortem is not None
    with open(post_mortem) as f:
        assert sorted(json.load(f)) == sorted(POST_MORTEM_KEYS)
    reasons = {}
    for r in reqs:
        key = str(r.finish_reason or r.reject_reason)
        reasons[key] = reasons.get(key, 0) + 1
    if device == "cuda":
        for name in ("paged_decode_attention", "flash_attention_fwd"):
            assert launches[name] > 0, f"serve_resilience: {name} never ran"

    # the contiguous pool (the decode kernel) under the NaN and the abort
    cclock = FakeClock()
    cfaults = clocked_faults(cclock, seed=seed)
    csrv = dst.ServingEngine(
        graph_engine(model, device), num_slots=8, prefill_chunk=64,
        prefill_token_budget=RESILIENCE_BUDGET, paged_kv=False, seed=seed,
        strict_recompile=True, guard_numerics=True, clock=cclock,
        fault_injector=cfaults, tracer=Tracer())
    ctraffic = [(p, kw["max_new_tokens"]) for _, p, kw in traffic[:12]]
    for p, n in ctraffic:                 # the same traffic as warm-up
        csrv.submit(p, max_new_tokens=n)
    csrv.run_until_drained()
    csrv.end_warmup()
    cfaults.load_schedule({"nan_logits": [5], "step_host_error": [9]})
    reset_launches()
    creqs = [csrv.submit(p, max_new_tokens=n) for p, n in ctraffic]
    while csrv.pending or csrv.live_count:
        try:
            csrv.step()
        except InjectedFault as e:
            assert e.point == "step_host_error"
        cclock.t += RESILIENCE_TICK
    claunches = read_launches()
    assert sum(r.finish_reason == "numerical_error" for r in creqs) == 1
    assert csrv.watchdog.recompiles == 0 and captures_of(csrv) == 1
    csrv.check_invariants()
    assert csrv.live_count == 0 and csrv.timelines.open_ids() == []
    if device == "cuda":
        assert claunches["decode_attention"] > 0

    # 6: speculation suspended under OVERLOADED (the whole traffic queued
    # at once: overloaded until a quarter of it is left waiting)
    n_spec = len(spec_prompts)
    ladder = {"queue_pressured": max(1, n_spec // 8),
              "queue_overloaded": max(2, n_spec // 4), "cooldown_steps": 4}
    spec = dst.ServingEngine(
        graph_engine(model, device), num_slots=8, max_queue_depth=64,
        prefill_chunk=64, paged_kv=dict(PAGED_KV), seed=seed,
        strict_recompile=True, spec_decode=dict(SPEC_NGRAM, k=4),
        degradation=ladder)
    for p, n in zip(spec_prompts, spec_budgets):
        spec.submit(p, max_new_tokens=int(n))
    spec.run_until_drained()
    warm_up(spec, [])
    spec.end_warmup()
    sreqs = [spec.submit(p, max_new_tokens=int(n))
             for p, n in zip(spec_prompts, spec_budgets)]
    overloaded = drafted_overloaded = drafted = 0
    while spec.pending or spec.live_count:
        before = spec.metrics.drafted
        spec.step()
        if spec._load.state is LoadState.OVERLOADED:
            overloaded += 1
            drafted_overloaded += spec.metrics.drafted - before
        else:
            drafted += spec.metrics.drafted - before
    assert overloaded > 0 and drafted_overloaded == 0 and drafted > 0
    assert spec.watchdog.recompiles == 0 and captures_of(spec) == 1
    spec.check_invariants()
    same_tokens("serve_resilience spec", dict(reqs=sreqs), no_drafts_reqs,
                "serve_spec_paged's no-drafts arm")

    def column(on: bool, key: str) -> str:
        return " / ".join(f"{arm['stats'][key]:.3f}" for o, arm in turns
                          if o is on)

    log(f"[serve_resilience] fault-free traffic (48 requests, gpt2-small "
        f"bf16, paged, captured), arms in turns off, on, on, off: step gap "
        f"p50 {column(True, 'step_gap_p50_ms')} ms, p99 "
        f"{column(True, 'step_gap_p99_ms')} ms with all telemetry on "
        f"(tracer, SLO, flight recorder, timelines) against p50 "
        f"{column(False, 'step_gap_p50_ms')} ms, p99 "
        f"{column(False, 'step_gap_p99_ms')} ms with it off; "
        f"telemetry_overhead_s "
        + " / ".join(f"{arm['overhead_per_step_ms']:.4f}"
                     for o, arm in turns if o)
        + f" ms a step over {arms['on']['steps']} steps; tokens/s on "
        f"{column(True, 'tokens_per_s')}, off "
        f"{column(False, 'tokens_per_s')}; tokens identical")
    log(f"[serve_resilience] fault arm: {len(reqs)} requests in {step} "
        f"steps ({wall:.2f} s wall): outcomes {reasons}; faults raised "
        f"{errors}, fired {faults.fired}; {st['preempted']} preemptions, "
        f"{st['step_overruns']} step overrun, load states walked "
        f"{sorted({lv.name for lv in levels})}; {len(untouched)} untouched "
        f"requests identical to the fault-free arm, {len(hit)} touched ones "
        f"held at near-ties ({ties['same']} identical); 0 recompiles, 1 "
        f"capture; audit clean, no slot or page leak; trace spans "
        f"{sorted(spans)}; post-mortem {os.path.basename(post_mortem)}; "
        f"launches {launches}")
    log(f"[serve_resilience] contiguous arm: 12 requests, 1 "
        f"numerical_error, 0 recompiles, launches {claunches}; spec arm "
        f"(k=4, {n_spec} requests, ladder {ladder}): {overloaded} "
        f"overloaded steps drafted 0 tokens, "
        f"{drafted} drafted otherwise, tokens equal the no-drafts arm's; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, contiguous_launches=claunches,
                arms=arms, reasons=reasons)


def phase_serve_spec_int8(engine, seed: int, paged_kv: dict, eager, ref,
                          device: str = "cuda") -> dict:
    """TinyLlama-1.1B int8 (int8 weights, int8 KV pages) at k=4: 16 motif
    requests (budgets 64-128) on a spec-off, a spec-on and a no-drafts
    server over the captured int8 engine, strict: the spec-on tokens equal
    the no-drafts arm's, and against the spec-off arm as
    :func:`divergences` holds them (``eager``: the int8 engine, ``ref``:
    the int8 model with every kernel off); the int8 paged kernel runs 22
    times a verify step, and int8_matmul 22 x 7 times a verify step in its
    prefill tiles (M = 8 x 5 = 40), beside the prefill chunks' own 22 x 7
    a forward."""
    import deepspeed_tpu_torch as dst

    L = engine.module.config.n_layer
    rng = np.random.default_rng(seed + 6)
    prompts, budgets = motif_traffic(rng, engine.module.config.vocab_size,
                                     16, budget_hi=128)
    arms = {}
    for name, spec in (("off", None), ("on", dict(SPEC_NGRAM, k=4)),
                       ("no drafts", dict(SPEC_NGRAM, k=4,
                                          drafter=no_drafts()))):
        srv = dst.ServingEngine(engine, num_slots=8, max_queue_depth=64,
                                prefill_chunk=64, paged_kv=dict(paged_kv),
                                seed=seed, strict_recompile=True,
                                spec_decode=spec)
        arms[name] = spec_arm(f"serve_spec_int8 {name}", srv, prompts,
                              budgets, device, rows=1 if spec is None else 5)
    same_tokens("serve_spec_int8", arms["on"], arms["no drafts"]["reqs"],
                "the no-drafts arm's")
    arms["divergences"] = divergences(
        "serve_spec_int8", arms["on"]["reqs"], arms["off"]["reqs"], eager,
        ref)
    on = arms["on"]
    steps, fwd = on["stats"]["decode_steps"], on["forwards"]
    lau = on["launches"]
    assert lau["paged_decode_attention_int8"] == L * steps, \
        f"serve_spec_int8: int8 paged kernel ran " \
        f"{lau['paged_decode_attention_int8']} times in {steps} verify steps"
    assert lau["int8_matmul_prefill"] == PROJECTIONS * L * (steps + fwd), \
        f"serve_spec_int8: int8_matmul prefill tiles ran " \
        f"{lau['int8_matmul_prefill']} times (want {PROJECTIONS} x {L} x " \
        f"({steps} verify steps + {fwd} prefill forwards))"
    assert lau["int8_matmul"] == lau["int8_matmul_prefill"], \
        "serve_spec_int8: a verify projection took the decode tiles"
    for name in ("off", "on", "no drafts"):
        log(f"[serve_spec_int8] spec {name} (tinyllama-1.1B widths int8, "
            f"kv_cache_quant, paged_kv={paged_kv}, captured, "
            f"strict_recompile; 16 motif requests, new {min(budgets)}-"
            f"{max(budgets)}): {spec_line(arms[name])}")
    log(f"[serve_spec_int8] k=4: spec-on tokens equal the no-drafts arm's; "
        f"int8 paged kernel {lau['paged_decode_attention_int8']} = {L} x "
        f"{steps} verify steps; int8_matmul {lau['int8_matmul']}, all in "
        f"the prefill tiles: {PROJECTIONS} x {L} x ({steps} verify steps at "
        f"M=40 + {fwd} prefill forwards)")
    return arms


def int8_variant(srv_int8, seed: int, matmul: str = "off",
                 attention: str = "off", kv_cache_quant: bool = True):
    """A server of a copy of the int8 model with its kernel switches set
    (``"auto"`` or ``"off"``): ``matmul`` for the QuantDense projections,
    ``attention`` for the decode, flash and paged kernels (``"off"``: the
    plain versions and the page pool's dense composition). With
    ``kv_cache_quant=False`` the cache is bf16."""
    import deepspeed_tpu_torch as dst

    module = copy.deepcopy(srv_int8.engine.module)
    module.replace_config(int8_kernel=matmul, decode_kernel=attention,
                          use_flash_attention=attention,
                          kv_cache_quant=kv_cache_quant)
    eng = dst.init_inference(module, config={"dtype": "bfloat16"},
                             device=srv_int8.device)
    return dst.ServingEngine(eng, num_slots=srv_int8.pool.num_slots,
                             prefill_chunk=srv_int8.prefill_chunk,
                             paged_kv=dict(PAGED_KV, kernel=attention),
                             seed=seed)


def phase_reference_int8(srv_int8, bf16_ref, reqs, contiguous_reqs,
                         seed: int, device: str = "cuda") -> float:
    """Teacher-force served requests through the int8 model with every
    kernel on and with every kernel off, on the paged path (``reqs``) and
    on the contiguous one (``contiguous_reqs``, bucketed prefill then the
    int8 decode kernel), and the same paged comparison over a bf16 cache:
    every position within LOGITS_REL_TOL. Printed, not held: the paged
    error with one kernel group on at a time and the error against the
    unquantized bf16 model (plain attention, full-context logits)."""
    def paged(srv):
        return [served_paged_logits(srv, np.asarray(r.prompt),
                                    np.asarray(r.output_tokens)[:-1])
                for r in reqs]

    kernels = paged(srv_int8)
    off = int8_variant(srv_int8, seed)
    plain = paged(off)
    worst = 0.0
    for req, got, want in zip(reqs, kernels, plain):
        rel = rel_err(got, want)
        assert math.isfinite(rel) and rel <= LOGITS_REL_TOL, \
            f"reference_int8: request {req.request_id}: served int8 logits " \
            f"vs kernels off rel err {rel} > {LOGITS_REL_TOL}"
        worst = max(worst, rel)
    worst_contig = 0.0
    for req in contiguous_reqs:
        prompt, out = np.asarray(req.prompt), np.asarray(req.output_tokens)
        got = served_path_logits(srv_int8.engine, prompt, out[:-1])
        want = served_path_logits(off.engine, prompt, out[:-1])
        rel = rel_err(got, want)
        assert math.isfinite(rel) and rel <= LOGITS_REL_TOL, \
            f"reference_int8: contiguous request {req.request_id}: served " \
            f"int8 logits vs kernels off rel err {rel} > {LOGITS_REL_TOL}"
        worst_contig = max(worst_contig, rel)
    del off

    def vs(a, b):
        return max(rel_err(x, y) for x, y in zip(a, b))

    only_matmul = vs(paged(int8_variant(srv_int8, seed, matmul="auto")),
                     plain)
    only_attention = vs(paged(int8_variant(srv_int8, seed,
                                           attention="auto")), plain)
    bf16_cache = vs(paged(int8_variant(srv_int8, seed, "auto", "auto",
                                       kv_cache_quant=False)),
                    paged(int8_variant(srv_int8, seed,
                                       kv_cache_quant=False)))
    assert math.isfinite(bf16_cache) and bf16_cache <= LOGITS_REL_TOL, \
        f"reference_int8: paged int8 logits over a bf16 cache vs kernels " \
        f"off rel err {bf16_cache} > {LOGITS_REL_TOL}"
    worst_bf16 = 0.0
    for req, got in zip(reqs, kernels):
        full = np.concatenate([req.prompt, req.output_tokens[:-1]])[None]
        with torch.no_grad():
            want = bf16_ref.logits(torch.as_tensor(full, device=device))[0]
        want = want[req.prompt_len - 1:]
        assert got.shape == want.shape
        worst_bf16 = max(worst_bf16, rel_err(got, want))
    log(f"[reference_int8] paged: {len(reqs)} requests teacher-forced "
        f"(prompts {[r.prompt_len for r in reqs]}, prefix-hit tokens when "
        f"served {[r.prefix_hit_tokens for r in reqs]}): max per-position "
        f"||int8 kernels - int8 plain|| / ||int8 plain|| = {worst:.4g} (tol "
        f"{LOGITS_REL_TOL})")
    log(f"[reference_int8] contiguous: {len(contiguous_reqs)} requests "
        f"(prompts {[r.prompt_len for r in contiguous_reqs]}): "
        f"{worst_contig:.4g} (tol {LOGITS_REL_TOL})")
    log(f"[reference_int8] paged over a bf16 cache, every kernel on vs "
        f"off: {bf16_cache:.4g} (tol {LOGITS_REL_TOL})")
    log(f"[reference_int8] paged, not held: int8_matmul alone on "
        f"{only_matmul:.4g}; attention kernels alone on "
        f"{only_attention:.4g}; int8 kernels against the unquantized bf16 "
        f"model {worst_bf16:.4g}")
    return worst


# ---------------------------------------------------------------------------
# ZeRO-Inference: TinyLlama's blocks in pinned host memory, streamed a layer
# at a time; score 8 x 512 tokens, generate 32 at B=8
ZI_BATCH, ZI_SCORE_LEN, ZI_PROMPT, ZI_NEW = 8, 512, 64, 32


def zi_pass(zi, ids, device: str) -> tuple:
    """One streamed pass and its scoring tail: (logits, scores, seconds,
    bytes streamed, peak bytes allocated during the pass)."""
    sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    streamed = zi.streamed_bytes
    t0 = time.perf_counter()
    logits = zi.forward(ids)
    sync(device)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    scores = zi.score_logits(logits, ids)
    sync(device)
    wall = time.perf_counter() - t0
    return logits, scores, wall, zi.streamed_bytes - streamed, peak


def zi_kernel_checks(gen: torch.Generator, cfg) -> None:
    """The kernels of the streamed path held against their plain versions
    at the shapes it gives them: flash forward over a score pass's
    (8, 512) GQA 32/4 layer, the bf16-cache decode kernel over 8 rows of a
    2048-position GQA 32/4 cache (the generate run's lengths 64-95 beside
    ragged ones), and int8_matmul over the score pass's 8 x 512 rows
    through a layer's 7 projections (the int8 tier)."""
    from deepspeed_tpu_torch.ops.attention.decode_attention import (
        decode_attention, decode_attention_reference)
    from deepspeed_tpu_torch.ops.attention.flash_attention import (
        flash_attention, mha_reference)
    from deepspeed_tpu_torch.ops.quantization.int8_matmul import (
        int8_matmul, int8_matmul_reference, quantize_columns)

    dev, bf16 = "cuda", torch.bfloat16
    B, H, KV, D, S = ZI_BATCH, cfg.n_head, cfg.kv_heads, cfg.head_dim, \
        cfg.max_seq_len
    q, k, v = (torch.randn(B, ZI_SCORE_LEN, n, D, generator=gen,
                           device=dev).to(bf16) for n in (H, KV, KV))
    flash = compare(flash_attention(q, k, v, causal=True)[0],
                    mha_reference(q, k, v, causal=True)[0],
                    f"zero_inference: flash forward at B={B} T={ZI_SCORE_LEN} "
                    f"H={H} KV={KV}")
    kc, vc = (torch.randn(B, KV, S, D, generator=gen, device=dev).to(bf16)
              for _ in range(2))
    qd = torch.randn(B, H, D, generator=gen, device=dev).to(bf16)
    decode = (0.0, 0.0)
    for lengths in ([64, 64, 80, 80, 95, 95, 65, 94],
                    [1, 517, 2048, 64, 300, 2048, 95, 999]):
        lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
        e, r = compare(decode_attention(qd, kc, vc, lengths),
                       decode_attention_reference(qd, kc, vc, lengths,
                                                  1.0 / math.sqrt(D)),
                       f"zero_inference: bf16-cache decode kernel at B={B} "
                       f"H={H} KV={KV} S={S} lengths {lengths.tolist()}")
        decode = (max(decode[0], e), max(decode[1], r))
    C, F_ = cfg.n_embd, int(cfg.mlp_ratio * cfg.n_embd)
    M = ZI_BATCH * ZI_SCORE_LEN
    matmul = (0.0, 0.0)
    for K, N in ((C, H * D), (C, KV * D), (C, KV * D), (H * D, C), (C, F_),
                 (C, F_), (F_, C)):
        wq, sc = quantize_columns(torch.randn(K, N, generator=gen,
                                              device=dev) * 0.02)
        w, sc = wq.t().contiguous(), sc.reshape(-1).contiguous()
        x = torch.randn(M, K, generator=gen, device=dev).to(bf16)
        e, r = compare(int8_matmul(x, w, sc),
                       int8_matmul_reference(x, w, sc, torch.float32),
                       f"zero_inference: int8_matmul at M={M} K={K} N={N}")
        matmul = (max(matmul[0], e), max(matmul[1], r))
    log(f"[zero_inference] kernels vs plain at the streamed path's shapes: "
        f"flash forward B={B} T={ZI_SCORE_LEN} H={H} KV={KV} max|err| "
        f"{flash[0]:.3g} row rel {flash[1]:.3g}; bf16-cache decode B={B} "
        f"H={H} KV={KV} S={S} max|err| {decode[0]:.3g} row rel "
        f"{decode[1]:.3g}; int8_matmul M={M} over a layer's 7 projections "
        f"max|err| {matmul[0]:.3g} row rel {matmul[1]:.3g} (tol {OUT_ATOL}, "
        f"row {ROW_REL_TOL})")


def zi_plain_reference(module, device: str):
    """An fp32 copy of ``module`` with every kernel off: plain attention,
    the plain decode, and an int8 model's projections as dense fp32
    weights (int8 x scale)."""
    from deepspeed_tpu_torch.models.transformer_lm import TransformerLM
    from deepspeed_tpu_torch.ops.quantization.linear import QuantDense

    cfg = dataclasses.replace(module.config, dtype=torch.float32,
                              use_flash_attention=False, decode_kernel="off",
                              int8_weights=False)
    ref = TransformerLM(cfg, device="meta").to_empty(device=device)

    def weight(key):
        owner, _, name = key.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        if isinstance(mod, QuantDense) and name == "weight":
            return mod.weight.float() * mod.scale[:, None]
        return getattr(mod, name).float()

    with torch.no_grad():
        ref.load_state_dict({k: weight(k) for k in ref.state_dict()})
    return ref.eval()


def zi_hold_plain(tier: str, ref, ids, logits, prompts, toks, heads,
                  device: str) -> tuple:
    """The streamed score logits and each generated step's logits (the
    prefill's last position, then every decode step's, teacher-forced
    through ``ref`` over the streamed tokens) within LOGITS_REL_TOL of the
    fp32 plain model. Returns (score rel err, decode rel err)."""
    with torch.no_grad():
        want = ref.logits(ids)
        score = rel_err(logits, want)
        del want
        full = torch.as_tensor(toks[:, :-1], device=device)
        want = ref.logits(full)[:, prompts.shape[1] - 1:]
    got = torch.cat(heads, dim=1)
    assert got.shape == want.shape, (got.shape, want.shape)
    steps = rel_err(got, want)
    for what, rel in (("score logits", score), ("generated steps' logits",
                                                 steps)):
        assert math.isfinite(rel) and rel <= LOGITS_REL_TOL, \
            f"zero_inference ({tier}): streamed {what} vs the fp32 plain " \
            f"model rel err {rel} > {LOGITS_REL_TOL}"
    return score, steps


def phase_zero_inference(seed: int, device: str = "cuda",
                         **overrides) -> list:
    """TinyLlama-1.1B (bf16 cache) streamed from pinned host memory by
    ``ZeroInferenceEngine`` (prefetch 1), against the resident model on
    the card and against the fp32 plain model (every kernel off); then the
    int8 tier against the resident int8 compute tier and the plain model
    of its dequantized weights. The path's kernels are first held against
    their plain versions at its shapes. Returns the streamed passes'
    launch counts."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference import ZeroInferenceEngine
    from deepspeed_tpu_torch.ops.quantization import (DENSE_KEYS,
                                                      quantize_lm_params)

    model = tinyllama(seed, device=device, **overrides)
    cfg = model.replace_config(kv_cache_quant=False)
    L = cfg.n_layer
    rng = np.random.default_rng(seed + 16)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                       (ZI_BATCH, ZI_SCORE_LEN)),
                          device=device)
    prompts = rng.integers(0, cfg.vocab_size, (ZI_BATCH, ZI_PROMPT))
    host = {k: v.detach().cpu().pin_memory() if device == "cuda"
            else v.detach().clone() for k, v in model.state_dict().items()}
    block_bytes = sum(module_bytes(b) for b in model.blocks)
    if device == "cuda":
        zi_kernel_checks(
            torch.Generator(device=device).manual_seed(seed + 17), cfg)

    def resident_pass(module):
        sync(device)
        base = torch.cuda.memory_allocated() if device == "cuda" else 0
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = module.logits(ids)
        sync(device)
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) \
            if device == "cuda" else 0
        return out, wall, peak

    resident_pass(model)                    # first calls, kernel loads
    want, res_wall, activations = resident_pass(model)
    runs = []
    for tier in ("bf16", "int8"):
        if tier == "int8":
            qmodel = copy.deepcopy(model)
            quantize_lm_params(qmodel, DENSE_KEYS - {"lm_head"})
            qmodel.replace_config(int8_weights=True)
            want, res_wall, _ = resident_pass(qmodel)
        m0 = torch.cuda.memory_allocated() if device == "cuda" else 0
        t0 = time.perf_counter()
        zi = ZeroInferenceEngine(cfg, host, prefetch=1, int8=tier == "int8",
                                 device=device)
        setup = time.perf_counter() - t0
        small = (torch.cuda.memory_allocated() - m0 if device == "cuda"
                 else 0) - 3 * zi.layer_nbytes
        zi_pass(zi, ids[:1, :16], device)   # first calls
        reset_launches()
        logits, scores, wall, nbytes, peak = zi_pass(zi, ids, device)
        peak -= m0
        launches = read_launches()
        runs.append(launches)
        rel = rel_err(logits, want)
        exact = torch.equal(logits, want)
        assert math.isfinite(rel) and rel <= LOGITS_REL_TOL, \
            f"zero_inference ({tier}): streamed logits vs resident rel " \
            f"err {rel} > {LOGITS_REL_TOL}"
        assert launches["flash_attention_fwd"] == L, \
            f"zero_inference ({tier}): {launches['flash_attention_fwd']} " \
            f"flash launches in a {L}-layer pass"
        if tier == "int8":
            assert launches["int8_matmul"] == PROJECTIONS * L, \
                f"zero_inference: {launches['int8_matmul']} int8_matmul " \
                f"launches, want {PROJECTIONS * L}"
        # plus 1 MiB for the pass's small tensors (positions, indices): on
        # the H100 the streamed pass exceeded the rest by 4 KiB
        bound = small + 3 * zi.layer_nbytes + activations + 2 ** 20
        if device == "cuda":
            assert peak <= bound, \
                f"zero_inference ({tier}): a streamed pass peaked {peak} " \
                f"bytes above its start, over resident pieces {small} + 3 " \
                f"layer buffers {3 * zi.layer_nbytes} + activations " \
                f"{activations} + 1 MiB"
        times = []
        zi.forward(ids, layer_times=times)
        med = float(np.median(times)) * 1e3
        new = ZI_NEW if tier == "bf16" else 8
        # each step's head logits, kept for the plain model's check
        heads, head = [], zi._head

        def record(x):
            heads.append(head(x))
            return heads[-1]

        zi._head = record
        sync(device)
        reset_launches()
        t0 = time.perf_counter()
        toks = zi.generate(prompts, max_new_tokens=new)
        sync(device)
        gen_wall = time.perf_counter() - t0
        glaunches = read_launches()
        del zi._head
        runs.append(glaunches)
        assert glaunches["flash_attention_fwd"] == L and \
            glaunches["decode_attention"] == L * (new - 1), \
            f"zero_inference ({tier}): generate launches {glaunches}"
        resident_eng = dst.init_inference(
            model if tier == "bf16" else qmodel,
            config={"dtype": "bfloat16"}, device=device)
        expect = resident_eng.generate(prompts, max_new_tokens=new)
        ref = zi_plain_reference(model if tier == "bf16" else qmodel, device)
        plain = zi_hold_plain(tier, ref, ids, logits, prompts, toks, heads,
                              device)
        del ref, heads
        gbps = nbytes / wall / 1e9
        log(f"[zero_inference] {tier}: TinyLlama-1.1B, {L} layers of "
            f"{zi.layer_nbytes / 1e6:.1f} MB streamed from pinned host memory "
            f"({block_bytes / 1e9:.3f} GB of bf16 blocks; engine set-up "
            f"{setup:.2f} s), prefetch 1; score {ZI_BATCH} x {ZI_SCORE_LEN}: "
            f"{wall * 1e3:.1f} ms, {nbytes / 1e9:.3f} GB at {gbps:.2f} GB/s "
            f"(a layer's copy {zi.layer_nbytes / gbps / 1e6:.3f} ms), "
            f"{ZI_BATCH * ZI_SCORE_LEN / wall:.1f} tokens/s scored, scores "
            f"{np.round(scores, 4).tolist()}; logits vs the resident model "
            f"rel {rel:.3g} (bit-equal: {exact}); median layer "
            f"{med:.3f} ms (stage + copy + compute, synced) against "
            f"{res_wall / L * 1e3:.3f} ms a layer resident; peak above the "
            f"engine's start {peak / 1e6:.1f} MB (bound {bound / 1e6:.1f}: "
            f"resident "
            f"pieces {small / 1e6:.1f} + 3 x {zi.layer_nbytes / 1e6:.1f} + "
            f"activations {activations / 1e6:.1f} + 1 MiB) against the "
            f"model's "
            f"{module_bytes(model) / 1e9:.3f} GB; generate B={ZI_BATCH}, "
            f"prompt {ZI_PROMPT}, {new} new: {gen_wall:.2f} s, "
            f"{ZI_BATCH * new / gen_wall:.1f} tokens/s, tokens identical "
            f"to the resident engine's: {np.array_equal(toks, expect)}; "
            f"against the fp32 plain model (every kernel off"
            f"{', int8 weights dequantized' if tier == 'int8' else ''}): "
            f"score logits rel {plain[0]:.4g}, the {new} generated steps' "
            f"logits rel {plain[1]:.4g} (tol {LOGITS_REL_TOL}); "
            f"launches {launches}")
        assert np.array_equal(toks, expect), \
            f"zero_inference ({tier}): streamed greedy tokens differ from " \
            f"the resident engine's in rows " \
            f"{np.nonzero((toks != expect).any(1))[0].tolist()}"
        del zi, resident_eng
    del model, qmodel, host
    if device == "cuda":
        torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------
# training
# GPT-2 medium (openai-community/gpt2-medium config.json; the JAX bench's
# flagship, bench.py:188-208): vocab 50257, 1024 positions, 1024/24/16
GPT2_MEDIUM = dict(vocab_size=50257, n_positions=1024, n_embd=1024,
                   n_layer=24, n_head=16)
MICRO_BS, GAS, SEQ = 10, 16, 1024
# the checkpoint phase's accumulation: its checks (bit-equal state and
# resumed losses) and its files do not depend on it, its steps' time does
# (16 until arm (c) of train_zero_dp came; cut to keep the smoke in time)
CHECKPOINT_GAS = 4
# train_llama: TinyLlama-1.1B at its published widths (TINYLLAMA) and its
# 2048 positions, micro-batch 4 x gas 4, the streaming loss 512 positions a
# chunk
LLAMA_MICRO_BS, LLAMA_GAS, LLAMA_SEQ, LLAMA_CHUNK = 4, 4, 2048, 512
# a fresh TinyLlama under AdamW lr 3e-4 without warmup rises for Adam's
# first five updates (to 14.3 from 10.64 on the H100) and falls below its
# initial loss at the seventh step, so the two warm-up steps are followed
# by six timed ones and the last is held below the first
LLAMA_TIMED_STEPS = 6


def flagship_config(gas: int) -> dict:
    """bench.py's DeepSpeed config, with ``gas`` micro-batches a step."""
    return {"train_micro_batch_size_per_gpu": MICRO_BS,
            "gradient_accumulation_steps": gas, "bf16": {"enabled": True},
            "zero_optimization": {"stage": 2},
            "optimizer": {"type": "Adam",
                          "params": {"lr": 3e-4, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "steps_per_print": 1000000}


def compare_rows(got, want, what: str) -> tuple:
    """The row rule for gradients: every row (last axis) within ROW_REL_TOL
    of the plain row's norm, the norm floored at 1% of the median row's
    (a row whose exact value vanishes, as the first query's dq under causal
    attention with one key, holds only rounding noise on both sides).
    Returns (max |err|, max row relative error)."""
    got, want = got.float(), want.float()
    norms = want.norm(dim=-1)
    floor = 1e-2 * norms.flatten().median().clamp_min(1e-30)
    err = (got - want).abs().max().item()
    rel = ((got - want).norm(dim=-1) / norms.clamp_min(floor)).max().item()
    assert math.isfinite(rel) and rel <= ROW_REL_TOL, \
        f"{what}: max row rel err {rel} > {ROW_REL_TOL}"
    return err, rel


def flash_backward_kernels(gen: torch.Generator) -> tuple:
    from deepspeed_tpu_torch.ops.attention.flash_attention import (
        attention_delta, flash_attention, flash_attention_dkv,
        flash_attention_dq, flash_dkv_reference, flash_dq_reference,
        mha_reference)

    dev, bf16 = "cuda", torch.bfloat16
    H, D = 16, 64
    scale = 1.0 / math.sqrt(D)
    stats = {"fwd": [0.0, 0.0], "dq": [0.0, 0.0], "dkv": [0.0, 0.0]}
    lse_err = 0.0

    def inputs(B, T, S, heads=H, kv_heads=H):
        q, do = (torch.randn(B, T, heads, D, generator=gen, device=dev)
                 .to(bf16) for _ in range(2))
        k, v = (torch.randn(B, S, kv_heads, D, generator=gen, device=dev)
                .to(bf16) for _ in range(2))
        return q, k, v, do

    def check(q, k, v, do, causal, label):
        nonlocal lse_err
        out, lse = flash_attention(q, k, v, causal=causal)
        # the forward at the training shapes, whose (out, lse) the
        # backward kernels and their plain versions both take
        ref_out, ref_lse = mha_reference(q, k, v, causal=causal)
        e, r = compare_rows(out, ref_out, f"flash forward kernel vs plain "
                            f"({label})")
        stats["fwd"] = [max(stats["fwd"][0], e), max(stats["fwd"][1], r)]
        le = (lse - ref_lse).abs().max().item()
        assert math.isfinite(le) and le <= LSE_ATOL, \
            f"flash lse vs plain ({label}): max |err| {le} > {LSE_ATOL}"
        lse_err = max(lse_err, le)
        del ref_out, ref_lse
        delta = attention_delta(out, do)
        args = (q, k, v, do, lse, delta, causal, scale)
        for name, got, want in (
                ("dq", (flash_attention_dq(*args),),
                 (flash_dq_reference(*args),)),
                ("dkv", flash_attention_dkv(*args),
                 flash_dkv_reference(*args))):
            for g, w in zip(got, want):
                e, r = compare_rows(g, w, f"flash {name} kernel vs plain "
                                    f"({label})")
                stats[name] = [max(stats[name][0], e), max(stats[name][1], r)]
        return args

    check(*inputs(4, 512, 512), False, "non-causal T=S=512")
    check(*inputs(2, 1000, 1000), True, "causal ragged T=1000")
    # TinyLlama's training shape (train_llama): 32 query heads over 4 KV
    # heads, the dk/dv kernel summing each group of 8
    llama = inputs(LLAMA_MICRO_BS, LLAMA_SEQ, LLAMA_SEQ,
                   TINYLLAMA["n_head"], TINYLLAMA["n_kv_head"])
    check(*llama, True, f"causal GQA 32/4 B={LLAMA_MICRO_BS} "
          f"T={LLAMA_SEQ}")
    flash_times(*llama, "TinyLlama training", reps=3, other=False)
    del llama
    fma_design_check(gen)
    pack_probe(gen)
    B, T = MICRO_BS, SEQ
    q, k, v, do = inputs(B, T, T)
    args = check(q, k, v, do, True, f"causal B={B} T={T}")
    plain_dq = cuda_ms(lambda: flash_dq_reference(*args), reps=1)
    plain_dkv = cuda_ms(lambda: flash_dkv_reference(*args), reps=1)
    # the forward, dq and dkv beside their bounds and the library
    # yardstick: SDPA forward, and its backward (dq, dk and dv together)
    times = flash_times(q, k, v, do, "training", reps=3)
    ms_dq, lib_bwd = times["dq"], times["sdpa_bwd"]
    # D=128 at the same tokens (8 heads): the one-warpgroup blocks that
    # block_rows picks there, beside the two-warpgroup ones
    q8, k8, v8, do8 = (torch.randn(B, T, 8, 128, generator=gen, device=dev)
                       .to(bf16) for _ in range(4))
    compare_rows(flash_attention(q8, k8, v8)[0], mha_reference(q8, k8, v8)[0],
                 "flash forward kernel vs plain (D=128)")
    flash_times(q8, k8, v8, do8, "training D=128", reps=3)
    del q8, k8, v8, do8
    out = {
        "flash_attention_dq": dict(
            max_abs_err=stats["dq"][0], ms=ms_dq, plain_ms=plain_dq,
            library_ms=lib_bwd, design=times["design"], **times["dq_bound"]),
        "flash_attention_dkv": dict(
            max_abs_err=stats["dkv"][0], ms=times["dkv"], plain_ms=plain_dkv,
            library_ms=lib_bwd, design=times["design"],
            **times["dkv_bound"]),
    }
    log(f"[train_kernels] flash_attention_fwd at the same four shapes: "
        f"max|err| {stats['fwd'][0]:.3g}, row rel {stats['fwd'][1]:.3g} "
        f"(tol {ROW_REL_TOL}), lse max|err| {lse_err:.3g} (tol {LSE_ATOL})")
    for name in ("dq", "dkv"):
        r = out[f"flash_attention_{name}"]
        log(f"[train_kernels] flash_attention_{name} B={B} H={H} D={D} "
            f"T={T} causal (checked also non-causal 512, causal 1000, GQA "
            f"32/4 at T={LLAMA_SEQ}): "
            f"max|err| {stats[name][0]:.3g}, row rel {stats[name][1]:.3g} "
            f"(tol {ROW_REL_TOL}); kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    log(f"[train_kernels] SDPA backward (dq, dk, dv in one call) "
        f"{lib_bwd:.4f} ms; SDPA forward + backward "
        f"{times['sdpa_fwd'] + lib_bwd:.4f} ms; port forward "
        f"{times['fwd']:.4f} + dq + dkv = "
        f"{times['fwd'] + ms_dq + times['dkv']:.4f} ms")
    return out, stats["fwd"][0]


def pack_probe(gen: torch.Generator) -> None:
    """The packing of an fp32 wgmma accumulator into 16-bit A fragments
    alone (the flash forward's P, dk/dv's P and dS, dq's dS), as the card
    test pins it: S = a bᵀ (SS), packed, o = S c (RS, c read through the
    transpose-B bit) on small integers, so o equals the plain product
    exactly."""
    from deepspeed_tpu_torch.ops.op_builder import DTYPE_CODES, launch

    for dtype in (torch.bfloat16, torch.float16):
        a, b = (torch.randint(-1, 2, (64, 64), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        c = torch.randint(-2, 3, (64, 64), generator=gen,
                          device="cuda").to(dtype)
        o = torch.empty(64, 64, device="cuda")
        launch("flash_attention_fwd", a.device, DTYPE_CODES[dtype],
               a.data_ptr(), b.data_ptr(), c.data_ptr(), o.data_ptr(),
               symbol="dstorch_wgmma_pack_probe")
        want = (a.float() @ b.float().t()) @ c.float()
        assert torch.equal(o, want), f"wgmma packing probe ({dtype}): not exact"
    log("[train_kernels] wgmma accumulator packing probe exact (bf16, fp16)")


def fma_design_check(gen: torch.Generator) -> None:
    """The flash forward, dq and dk/dv kernels' FMA design, which the main
    paths (bf16, D=64) no longer run: fp32 at D=64 and bf16 at D=32, GQA
    and a ragged T, each against its plain version (fp32 within 1e-4 of
    each output's largest element, summation order only; bf16 by the row
    rule)."""
    from deepspeed_tpu_torch.ops.attention.flash_attention import (
        attention_delta, flash_attention, flash_attention_dkv,
        flash_attention_dq, flash_design, flash_dkv_reference,
        flash_dq_reference, mha_reference)

    errs = []
    for dtype, D in ((torch.float32, 64), (torch.bfloat16, 32)):
        assert flash_design(dtype, D) == "fma"
        q, do = (torch.randn(2, 129, 8, D, generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn(2, 129, 2, D, generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        out, lse = flash_attention(q, k, v)
        ref, _ = mha_reference(q, k, v)
        args = (q, k, v, do, lse, attention_delta(out, do), True,
                1 / math.sqrt(D))
        pairs = [(out, ref), *zip(flash_attention_dkv(*args),
                                  flash_dkv_reference(*args)),
                 (flash_attention_dq(*args), flash_dq_reference(*args))]
        for got, want in pairs:
            if dtype == torch.float32:
                e = ((got - want).abs().max()
                     / want.abs().max().clamp_min(1e-2)).item()
                assert e <= 1e-4, f"fma design fp32: {e} > 1e-4"
            else:
                e = compare_rows(got, want, "fma design bf16 D=32")[1]
            errs.append(e)
    log(f"[train_kernels] flash forward, dq and dkv, fma design (fp32 D=64, "
        f"bf16 D=32, GQA 8/2, T=129): within their limits, worst "
        f"{max(errs):.3g}")


def ln_linear_kernels(gen: torch.Generator) -> dict:
    """The ln_linear forward and backward-dx kernels (bf16: wgmma) against
    their plain versions, at the flagship's qkv and fc shapes, a ragged M,
    and the wide C that the JAX gate takes (GPT-2 XL's 1600, gpt2-1.3b's
    2048, the gate's top 4096) at M=2048; each timed beside its bound, its
    plain version and the library calls. Returns the qkv shape's rows."""
    from deepspeed_tpu_torch.ops.transformer.ln_linear import (
        BLOCK_M, ln_linear_bwd_dx, ln_linear_bwd_dx_reference, ln_linear_fwd,
        ln_linear_fwd_reference)

    dev, bf16 = "cuda", torch.bfloat16
    C = GPT2_MEDIUM["n_embd"]
    M = MICRO_BS * SEQ
    stats = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}
    times = {}

    def inputs(m, c, n):
        x = torch.randn(m, c, generator=gen, device=dev).to(bf16)
        g = (1 + 0.1 * torch.randn(c, generator=gen, device=dev)).to(bf16)
        b = (0.1 * torch.randn(c, generator=gen, device=dev)).to(bf16)
        w = (torch.randn(n, c, generator=gen, device=dev) * 0.02).to(bf16)
        bias = (0.02 * torch.randn(n, generator=gen, device=dev)).to(bf16)
        dy = torch.randn(m, n, generator=gen, device=dev).to(bf16)
        return x, g, b, w, bias, dy

    def track(key, pair):
        stats[key] = [max(a, b) for a, b in zip(stats[key], pair)]

    shapes = [("qkv", M, C, 3 * C), ("fc", M, C, 4 * C),
              ("ragged", 1000, C, 3 * C)]
    for c, ns in ((1600, (4800, 6400)), (2048, (6144, 8192)),
                  (4096, (4096,))):
        shapes += [(f"C={c} N={n}", 2048, c, n) for n in ns]
    for label, m, c, n in shapes:
        x, g, b, w, bias, dy = inputs(m, c, n)
        y, mean, rstd = ln_linear_fwd(x, g, b, w, bias)
        ry, rmean, rrstd = ln_linear_fwd_reference(x, g, b, w, bias, 1e-5)
        track("fwd", compare_rows(y, ry, f"ln_linear_fwd ({label})"))
        stat_err = max((mean - rmean).abs().max().item(),
                       ((rstd - rrstd) / rrstd).abs().max().item())
        assert stat_err <= 1e-4, f"ln_linear stats ({label}): {stat_err}"
        dx, dg, db = ln_linear_bwd_dx(dy, w, x, g, mean, rstd)
        rdx, rdg, rdb = ln_linear_bwd_dx_reference(dy, w, x, g, mean, rstd)
        track("bwd", compare_rows(dx, rdx, f"ln_linear_bwd_dx ({label})"))
        for got, want in ((dg.sum(0), rdg.sum(0)), (db.sum(0), rdb.sum(0))):
            track("bwd", compare_rows(got[None], want[None],
                                      f"ln_linear dgamma/dbeta ({label})"))
        if label == "ragged":
            continue
        xg = x.detach().requires_grad_()
        gg, bg = (t.detach().requires_grad_() for t in (g, b))

        def lib_fwd(x, g, b):
            return F.linear(F.layer_norm(x, (c,), g, b, 1e-5), w, bias)

        tiles = -(-m // BLOCK_M)
        times[label] = t = dict(
            fwd=cuda_ms(lambda: ln_linear_fwd(x, g, b, w, bias), reps=3),
            fwd_plain=cuda_ms(lambda: ln_linear_fwd_reference(
                x, g, b, w, bias, 1e-5), reps=1),
            fwd_lib=cuda_ms(lambda: lib_fwd(x, g, b), reps=3),
            bwd=cuda_ms(lambda: ln_linear_bwd_dx(dy, w, x, g, mean, rstd),
                        reps=3),
            bwd_plain=cuda_ms(lambda: ln_linear_bwd_dx_reference(
                dy, w, x, g, mean, rstd), reps=1),
            fwd_bound=bound(2 * (m * c + n * c + n + 2 * c + m * n) + 8 * m,
                            2 * m * c * n),
            bwd_bound=bound(2 * (m * n + n * c + 2 * m * c + c) + 8 * m
                            + 8 * tiles * c, 2 * m * c * n))
        # the autograd of the two for dx, dgamma and dbeta (the kernel's
        # outputs), captured with its forward; the forward's time taken off
        t["bwd_lib"] = cuda_ms(lambda: torch.autograd.grad(
            lib_fwd(xg, gg, bg), (xg, gg, bg), dy), reps=3) - t["fwd_lib"]
        log(f"[train_kernels] ln_linear {label} M={m} C={c} N={n}: forward "
            f"kernel {t['fwd']:.4f} ms, plain {t['fwd_plain']:.4f} ms, "
            f"F.layer_norm + F.linear {t['fwd_lib']:.4f} ms, bound "
            f"{t['fwd_bound']['bound_ms']:.4f} ms "
            f"({t['fwd_bound']['bound_by']}); backward-dx kernel "
            f"{t['bwd']:.4f} ms, plain {t['bwd_plain']:.4f} ms, autograd of "
            f"the two {t['bwd_lib']:.4f} ms, bound "
            f"{t['bwd_bound']['bound_ms']:.4f} ms")
    ln_linear_fp32_wide(gen)
    log(f"[train_kernels] ln_linear max|err| forward {stats['fwd'][0]:.3g} "
        f"row rel {stats['fwd'][1]:.3g}; backward-dx {stats['bwd'][0]:.3g} "
        f"row rel {stats['bwd'][1]:.3g} (tol {ROW_REL_TOL}); statistics "
        f"within 1e-4; {len(shapes)} shapes")
    qkv = times["qkv"]
    return {"ln_linear_fwd": dict(
                max_abs_err=stats["fwd"][0], ms=qkv["fwd"],
                plain_ms=qkv["fwd_plain"], library_ms=qkv["fwd_lib"],
                **qkv["fwd_bound"]),
            "ln_linear_bwd_dx": dict(
                max_abs_err=stats["bwd"][0], ms=qkv["bwd"],
                plain_ms=qkv["bwd_plain"], library_ms=qkv["bwd_lib"],
                **qkv["bwd_bound"])}


def ln_linear_fp32_wide(gen: torch.Generator) -> None:
    """The fp32 ln_linear kernels (FMA units) at C=2048, a width the fp32
    gate took only once its shared memory stopped growing with C: forward
    and backward-dx held against their plain versions (1e-4 of each output's
    largest element: fp32 throughout, summation order only) and timed once
    beside them."""
    from deepspeed_tpu_torch.ops.transformer.ln_linear import (
        ln_linear_bwd_dx, ln_linear_bwd_dx_reference, ln_linear_fwd,
        ln_linear_fwd_reference)

    m = c = n = 2048
    x = torch.randn(m, c, generator=gen, device="cuda")
    g = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    b = 0.1 * torch.randn(c, generator=gen, device="cuda")
    w = torch.randn(n, c, generator=gen, device="cuda") / math.sqrt(c)
    bias = 0.1 * torch.randn(n, generator=gen, device="cuda")
    dy = torch.randn(m, n, generator=gen, device="cuda")
    y, mean, rstd = ln_linear_fwd(x, g, b, w, bias)
    got = [y, *ln_linear_bwd_dx(dy, w, x, g, mean, rstd)]
    want = [ln_linear_fwd_reference(x, g, b, w, bias, 1e-5)[0],
            *ln_linear_bwd_dx_reference(dy, w, x, g, mean, rstd)]
    for name, a, r in zip(("y", "dx", "dgamma", "dbeta"), got,
                          [want[0], want[1], want[2].sum(0), want[3].sum(0)]):
        a = a.sum(0) if name in ("dgamma", "dbeta") else a
        e = ((a - r).abs().max() / r.abs().max().clamp_min(1e-2)).item()
        assert e <= 1e-4, f"ln_linear fp32 C={c} {name}: {e} > 1e-4"
    t = dict(fwd=cuda_ms(lambda: ln_linear_fwd(x, g, b, w, bias), reps=3),
             fwd_plain=cuda_ms(lambda: ln_linear_fwd_reference(
                 x, g, b, w, bias, 1e-5), reps=1),
             bwd=cuda_ms(lambda: ln_linear_bwd_dx(dy, w, x, g, mean, rstd),
                         reps=3),
             bwd_plain=cuda_ms(lambda: ln_linear_bwd_dx_reference(
                 dy, w, x, g, mean, rstd), reps=1))
    log(f"[train_kernels] ln_linear fp32 M={m} C={c} N={n} (fma): within "
        f"1e-4 of the plain versions; forward kernel {t['fwd']:.4f} ms, plain "
        f"{t['fwd_plain']:.4f} ms; backward-dx kernel {t['bwd']:.4f} ms, "
        f"plain {t['bwd_plain']:.4f} ms")


def phase_train_kernels(gen: torch.Generator, results: dict) -> None:
    """Adds the training kernels' rows to ``results``; the flash
    forward's max |err| becomes the largest over its serving and training
    shapes."""
    flash, fwd_err = flash_backward_kernels(gen)
    results.update(flash)
    fwd = results["flash_attention_fwd"]
    fwd["max_abs_err"] = max(fwd["max_abs_err"], fwd_err)
    results.update(ln_linear_kernels(gen))
    torch.cuda.empty_cache()
    return results


def gpt2_medium(seed: int, device: str = "cuda", **overrides):
    """GPT-2 medium at its published widths with the flagship's switches
    (bf16, ``remat_policy="dots"``), fp32 random weights from ``seed`` as
    a fresh model's; ``overrides`` replace config fields (a rehearsal
    narrows the widths)."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel

    cfg = GPT2Config(**{**GPT2_MEDIUM, "dtype": torch.bfloat16,
                        "remat": True, "remat_policy": "dots",
                        "use_flash_attention": True, **overrides})
    model = GPT2LMHeadModel(cfg, device=device, param_dtype=torch.float32)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model


def token_batches(seed: int, rows: int, vocab: int, seq: int = SEQ):
    """Two fixed batches of Zipf-distributed tokens (text's skew: a model
    learns their frequencies within steps), cycled by the train phases."""
    rng = np.random.default_rng(seed)
    return [{"input_ids": ((rng.zipf(1.2, (rows, seq)) - 1) % vocab
                           ).astype(np.int32)} for _ in range(2)]


TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv", "ln_linear_fwd", "ln_linear_bwd_dx",
                 "block_sparse_fwd", "block_sparse_dq", "block_sparse_dkv")


def micro_batch_launches(cfg) -> dict:
    """Each training kernel's launches in one micro-batch of a GPT-2 or
    ``TransformerLM`` with ``cfg``: the attention forward (block-sparse
    with a layout, else flash) once a layer, twice when the block is
    recomputed (remat "full" or "dots_plain"; a ``TransformerLM``
    checkpoints each block whole); its dq and dkv once a layer; with
    ``fused_ln_linear`` the ln_linear forward twice as often as the
    attention forward and the backward-dx twice a layer."""
    L = cfg.n_layer
    policy = getattr(cfg, "remat_policy", "full")
    runs = 2 if cfg.remat and policy != "dots" else 1
    attn = "block_sparse" if getattr(cfg, "sparse_attention", None) \
        is not None else "flash_attention"
    want = dict.fromkeys(TRAIN_KERNELS, 0)
    want.update({f"{attn}_fwd": runs * L, f"{attn}_dq": L,
                 f"{attn}_dkv": L})
    if getattr(cfg, "fused", False):
        want.update(ln_linear_fwd=2 * runs * L, ln_linear_bwd_dx=2 * L)
    return want


def describe(cfg) -> str:
    """A training model's config, for a phase's log line."""
    if hasattr(cfg, "n_positions"):            # GPT-2
        layout = "none" if cfg.sparse_attention is None else \
            type(cfg.sparse_attention).__name__
        return (f"GPT-2 {cfg.n_embd}/{cfg.n_layer}/{cfg.n_head} vocab "
                f"{cfg.vocab_size} seq {cfg.n_positions}, sparse layout "
                f"{layout}, fused_ln_linear={cfg.fused}, remat "
                f"{cfg.remat_policy}")
    return (f"TransformerLM {cfg.n_embd}/{int(cfg.mlp_ratio * cfg.n_embd)}/"
            f"{cfg.n_layer}, GQA {cfg.n_head}/{cfg.kv_heads}, vocab "
            f"{cfg.vocab_size} seq {cfg.max_seq_len}, {cfg.norm}, "
            f"{cfg.pos_emb}, tied head {cfg.tie_word_embeddings}, remat "
            f"{cfg.remat}, loss_chunk {cfg.loss_chunk}")


def train_seq(cfg) -> int:
    return getattr(cfg, "n_positions", None) or cfg.max_seq_len


def phase_train(model, seed: int, config: dict, steps: int, label: str,
                device: str = "cuda", record: dict = None) -> tuple:
    """Two warm-up steps, then ``steps`` timed steps through
    ``initialize(config=config)``; returns (engine, losses, launches,
    tokens/s). The second warm-up step keeps Adam's first steps out of the
    timed ones: they move every weight by about lr at once, and at width
    1024 the loss rises after the second update before it falls, so the
    last loss is held below the loss at initialisation. ``record``, when
    given, receives every loss (warm-up first) and the timed steps' peak
    memory."""
    import deepspeed_tpu_torch as dst

    cfg = model.config
    engine, *_ = dst.initialize(model=model, config=config, device=device)
    micro, gas = (config["train_micro_batch_size_per_gpu"],
                  config["gradient_accumulation_steps"])
    batches = token_batches(seed, micro * gas, cfg.vocab_size,
                            train_seq(cfg))
    warm = [float(engine.train_batch(batch=batches[i])) for i in (1, 0)]
    sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses = [engine.train_batch(batch=batches[(i + 1) % 2])
              for i in range(steps)]
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    losses = [float(x) for x in losses]
    assert all(math.isfinite(x) for x in losses), f"{label}: losses {losses}"
    # below the loss at initialisation (the first warm-up step), not the
    # first timed step, which follows Adam's second update
    assert losses[-1] < warm[0], \
        f"{label}: loss did not fall: warm-up {warm}, then {losses}"
    micros = gas * steps
    want = {k: n * micros for k, n in micro_batch_launches(cfg).items()}
    got = {k: launches[k] for k in want}
    assert got == want, f"{label}: launches {got}, want {want}"
    tokens = micros * micro * train_seq(cfg)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if record is not None:
        record.update(losses=warm + losses, peak=peak)
    log(f"[{label}] {describe(cfg)}, micro {micro} x gas {gas}: warm-up "
        f"losses {[round(x, 4) for x in warm]}, then {steps} steps "
        f"{[round(x, 4) for x in losses]}; {tokens} tokens in {wall:.2f} s: "
        f"{tokens / wall:.1f} tokens/s, {wall / steps * 1e3:.1f} ms a step, "
        f"{wall / micros * 1e3:.1f} ms a micro-batch; peak "
        f"{peak / 2 ** 30:.2f} GiB allocated; launches "
        f"{ {k: n for k, n in got.items() if n} } (expected "
        f"{ {k: n for k, n in want.items() if n} })")
    if device == "cuda":
        # one more step traced: the device's busy share is its kernels'
        # time over the untraced step's wall time
        dev_ms, top = traced_device_ms(
            lambda: engine.train_batch(batch=batches[0]))
        step_ms = wall / steps * 1e3
        busy = (f"{dev_ms:.1f} ms of kernels against {step_ms:.1f} ms a step "
                f"untraced: device busy {dev_ms / step_ms:.3f}, idle "
                f"{1 - dev_ms / step_ms:.3f}" if dev_ms > 0 else
                "device time not measured (the profiler saw no kernel)")
        log(f"[{label}] traced step: {busy}; largest kernels "
            + "; ".join(f"{name[:60]} {ms:.1f}" for name, ms in top))
    return engine, losses, launches, tokens / wall


def traced_device_ms(fn) -> tuple:
    """Runs ``fn`` once under ``torch.profiler`` and returns the device
    time of the kernels it launched (ms, summed over the CUDA events) and
    the six largest kernels by name, as (ms, [(name, ms), ...])."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    return (sum(ms for _, ms in rows),
            sorted(rows, key=lambda r: -r[1])[:6])


def grads_of(model, batch) -> tuple:
    model.zero_grad(set_to_none=True)
    loss = model(batch)
    loss.backward()
    grads = {k: p.grad.float() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def hold_gradients(phase: str, what: str, arm: tuple, ref: tuple) -> None:
    """Log and hold one arm's (loss, gradients) against the reference
    arm's: the loss within TRAIN_LOSS_TOL relative, every parameter's
    gradient within TRAIN_GRAD_TOL in relative L2 norm."""
    (loss, grads), (ref_loss, ref_grads) = arm, ref
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    rels = {k: ((g - ref_grads[k]).norm()
                / ref_grads[k].norm().clamp_min(1e-30)).item()
            for k, g in grads.items()}
    worst = max(rels, key=rels.get)
    log(f"[{phase}] {what}: loss {loss:.6f} vs {ref_loss:.6f} (rel "
        f"{loss_rel:.3g}, tol {TRAIN_LOSS_TOL}); gradient rel norm err max "
        f"{rels[worst]:.4g} ({worst}), median "
        f"{float(np.median(list(rels.values()))):.4g} (tol {TRAIN_GRAD_TOL})")
    assert loss_rel <= TRAIN_LOSS_TOL, f"{phase} {what}: loss"
    assert rels[worst] <= TRAIN_GRAD_TOL, \
        f"{phase} {what}: {worst} rel err {rels[worst]}"


def phase_reference_train(seed: int, device: str = "cuda", **overrides):
    """The kernel arms' loss and gradients against the plain arm's on one
    flagship micro-batch, the same weights (``overrides`` as in
    :func:`gpt2_medium`)."""
    model = gpt2_medium(seed, device, **overrides).to(torch.bfloat16)
    cfg = model.config
    batch = token_batches(seed + 7, MICRO_BS, cfg.vocab_size,
                          cfg.n_positions)[0]
    arms = {}
    for name, flash, fused in (("plain", False, False),
                               ("flash", True, False),
                               ("flash+ln_linear", True, True)):
        model.replace_config(use_flash_attention=flash, fused_ln_linear=fused)
        arms[name] = grads_of(model, batch)
    plain = arms.pop("plain")
    for name, arm in arms.items():
        hold_gradients("reference_train", f"{name} vs plain", arm, plain)
    del model
    if device == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# block-sparse attention training
# GPT-2 small widths (openai-community/gpt2 config.json) at 8192 positions
# with the BigBird layout of the JAX package's own model-level use of its
# sparse kernels (benchmarks/sparse_lowdensity_bench.py:118-171)
GPT2_SMALL_8K = dict(vocab_size=50257, n_positions=8192, n_embd=768,
                     n_layer=12, n_head=12)
BIGBIRD = dict(num_heads=12, block=512, num_random_blocks=1,
               num_sliding_window_blocks=3, num_global_blocks=1,
               attention="unidirectional")
SPARSE_TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": 1,
    "zero_optimization": {"stage": 0},
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
    "bf16": {"enabled": True}, "steps_per_print": 10 ** 9}


def bigbird(**overrides):
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig

    return BigBirdSparsityConfig(**{**BIGBIRD, **overrides})


def live_pairs(layout: np.ndarray, block: int, causal: bool) -> int:
    """(query, key) pairs a layout keeps, over its heads, after token-level
    causal masking: what the kernels compute for these inputs."""
    h, i, j = np.nonzero(layout)
    full = block * block
    if not causal:
        return int(len(h) * full)
    return int(full * (j < i).sum() + block * (block + 1) // 2 * (j == i).sum())


def sparse_kernel_check(gen, layout, block: int, T: int, causal: bool,
                        dtype=torch.bfloat16, D: int = 64) -> dict:
    """The three block-sparse kernels against their plain versions on one
    layout (row rule, lse within LSE_ATOL); returns the inputs, schedule
    and (max |err|) per kernel for timing."""
    from deepspeed_tpu_torch.ops.attention.flash_attention import \
        attention_delta
    from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel import (
        block_sparse_dkv, block_sparse_dkv_reference, block_sparse_dq,
        block_sparse_dq_reference, block_sparse_fwd,
        block_sparse_fwd_reference, schedule)

    B, H = 1, layout.shape[0]
    q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    idx, cnt, idx_t, cnt_t = schedule(layout, "cuda")
    scale = 1.0 / math.sqrt(D)
    label = f"block {block} T={T} D={D} causal={causal} {dtype}"
    out, lse = block_sparse_fwd(q, k, v, idx, cnt, block, causal, scale)
    ref, ref_lse = block_sparse_fwd_reference(q, k, v, idx, cnt, block,
                                              causal, scale)
    err = {"fwd": compare_rows(out, ref, f"block_sparse_fwd ({label})")[0]}
    le = (lse - ref_lse).abs().max().item()
    assert math.isfinite(le) and le <= LSE_ATOL, \
        f"block_sparse lse ({label}): max |err| {le} > {LSE_ATOL}"
    del ref, ref_lse
    delta = attention_delta(out, do)
    args = (q, k, v, do, lse, delta)
    dq = block_sparse_dq(*args, idx, cnt, block, causal, scale)
    err["dq"] = compare_rows(dq, block_sparse_dq_reference(
        *args, idx, cnt, block, causal, scale),
        f"block_sparse_dq ({label})")[0]
    dk, dv = block_sparse_dkv(*args, idx_t, cnt_t, block, causal, scale)
    want_dk, want_dv = block_sparse_dkv_reference(*args, idx_t, cnt_t, block,
                                                  causal, scale)
    err["dkv"] = max(compare_rows(dk, want_dk, f"block_sparse dk ({label})")[0],
                     compare_rows(dv, want_dv, f"block_sparse dv ({label})")[0])
    return dict(args=args, sched=(idx, cnt, idx_t, cnt_t), scale=scale,
                err=err, lse_err=le, layout=layout)


def sparse_designs(fwd_args, dq_args, dkv_args, err: dict) -> dict:
    """The block-sparse forward, dq and dk/dv kernels at one shape in every
    design (0: the FMA kernels, 1: wgmma with 128-row blocks, 2: with
    64-row blocks), whatever the rule picks: each held against the plain
    versions (row rule, lse within LSE_ATOL; its max |err| folded into
    ``err``) and timed. Returns {design: (fwd ms, dq ms, dkv ms)} and logs
    one line."""
    import importlib

    bsk = importlib.import_module(
        "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel")
    q, block = dq_args[0], dq_args[8]
    rule = tuple(bsk._design_code(q, block, kernel)
                 for kernel in ("fwd", "dq", "dkv"))
    want_out, want_lse = bsk.block_sparse_fwd_reference(*fwd_args)
    want_dq = bsk.block_sparse_dq_reference(*dq_args)
    want_dk, want_dv = bsk.block_sparse_dkv_reference(*dkv_args)
    out = {}
    for code in (0, 1, 2):
        with patched(bsk, "sparse_design_code", lambda *_, c=code: c):
            what = f"block_sparse design {code}"
            got, lse = bsk.block_sparse_fwd(*fwd_args)
            err["fwd"] = max(err["fwd"], compare_rows(
                got, want_out, f"{what} forward")[0])
            le = (lse - want_lse).abs().max().item()
            assert math.isfinite(le) and le <= LSE_ATOL, \
                f"{what} lse: max |err| {le} > {LSE_ATOL}"
            dk, dv = bsk.block_sparse_dkv(*dkv_args)
            err["dq"] = max(err["dq"], compare_rows(
                bsk.block_sparse_dq(*dq_args), want_dq, f"{what} dq")[0])
            err["dkv"] = max(err["dkv"],
                             compare_rows(dk, want_dk, f"{what} dk")[0],
                             compare_rows(dv, want_dv, f"{what} dv")[0])
            del got, lse, dk, dv
            out[code] = tuple(cuda_ms(fn, reps=5) for fn in (
                lambda: bsk.block_sparse_fwd(*fwd_args),
                lambda: bsk.block_sparse_dq(*dq_args),
                lambda: bsk.block_sparse_dkv(*dkv_args)))
    B, T, H, D = q.shape
    log(f"[sparse_kernels] forward / dq / dkv by design at B={B} H={H} D={D} "
        f"T={T} block {block} (the rule picks {' / '.join(map(str, rule))}; "
        f"each within the row rule): " + "; ".join(
            f"{code} ({name}) " + " / ".join(f"{ms:.4f}" for ms in times)
            + " ms" for (code, times), name in zip(
                out.items(), ("FMA", "wgmma 128-row", "wgmma 64-row"))))
    return out


def grid_order(cnt_t: torch.Tensor) -> torch.Tensor:
    """The transposed schedule's (head, layout column) pairs in the order a
    grid with heads fastest and columns ascending takes them: the order the
    wgmma dk/dv kernel's blocks started in before ``launch_order``, kept
    for comparison."""
    H, nq = cnt_t.shape
    p = torch.arange(H * nq, device=cnt_t.device)
    return ((p % H) * nq + p // H).to(torch.int32)


def sparse_launch_orders(cases) -> None:
    """dk/dv with its blocks started longest walk first (``launch_order``,
    the rule) against the grid order, on each (label, checked case from
    ``sparse_kernel_check``, block, causal): the same work in another
    order. Logs one line a case."""
    import importlib

    bsk = importlib.import_module(
        "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel")
    chosen = bsk.launch_order
    for label, res, block, causal in cases:
        args, (_, _, idx_t, cnt_t) = res["args"], res["sched"]
        dkv_args = (*args, idx_t, cnt_t, block, causal, res["scale"])
        grid = grid_order(cnt_t)
        ms = {}
        for name, order in (("longest first", chosen),
                            ("grid", lambda _: grid)):
            bsk.launch_order = order
            try:
                ms[name] = cuda_ms(lambda: bsk.block_sparse_dkv(*dkv_args),
                                   reps=5)
            finally:
                bsk.launch_order = chosen
        log(f"[sparse_kernels] dkv launch order, {label} (T="
            f"{args[0].shape[1]}, {live_pairs(res['layout'], block, causal)} "
            f"live pairs; a key column lists at most {cnt_t.amax().item()}, "
            f"on average {cnt_t.float().mean().item():.2f} query blocks): "
            f"longest first {ms['longest first']:.4f} ms, grid order "
            f"{ms['grid']:.4f} ms")


def phase_sparse_kernels(gen: torch.Generator) -> dict:
    """The block-sparse kernels' rows of the kernel table, at the training
    shape, after the listed checks; and the flash kernels held once at
    B=1, H=12, T=8192 (the dense arm's shape)."""
    from deepspeed_tpu_torch.ops.attention.flash_attention import (
        attention_delta, flash_attention, flash_attention_dkv,
        flash_attention_dq, flash_dkv_reference, flash_dq_reference,
        mha_reference)
    from deepspeed_tpu_torch.ops.sparse_attention import (
        FixedSparsityConfig)
    from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel import (
        _token_mask, block_sparse_dkv, block_sparse_dkv_reference,
        block_sparse_dq, block_sparse_dq_reference, block_sparse_fwd,
        block_sparse_fwd_reference)

    T, H, D = GPT2_SMALL_8K["n_positions"], 12, 64
    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    lse_err = 0.0

    def track(res):
        nonlocal lse_err
        for key in errs:
            errs[key] = max(errs[key], res["err"][key])
        lse_err = max(lse_err, res["lse_err"])

    # the other checked cases first, each freed before the next
    empty = np.tril(np.ones((H, 8, 8), np.int32))
    empty[:, 3] = 0                               # query block 3: no key
    empty[::2, 5, 6] = 1                          # a block in row 5's future
    empty[1::2, 6, :6] = 0                        # row 6: its diagonal only
    cases = [
        ("BigBird block 128", bigbird(block=128).make_layout(T), 128, T,
         True, torch.bfloat16),
        ("BigBird block 256", bigbird(block=256).make_layout(T), 256, T,
         True, torch.bfloat16),
        ("Fixed bidirectional, horizontal globals, T=2048",
         FixedSparsityConfig(num_heads=H, block=128, num_local_blocks=4,
                             num_global_blocks=1,
                             horizontal_global_attention=True
                             ).make_layout(2048), 128, 2048, False,
         torch.bfloat16),
        ("BigBird per-head layouts, T=2048", bigbird(
            block=128, different_layout_per_head=True).make_layout(2048),
         128, 2048, True, torch.bfloat16),
        ("empty query rows, T=2048", empty, 256, 2048, True, torch.bfloat16),
        ("BigBird block 512, fp32, T=4096", bigbird().make_layout(4096),
         512, 4096, True, torch.float32),
    ]
    for label, layout, block, t, causal, dtype in cases:
        track(sparse_kernel_check(gen, layout, block, t, causal, dtype))
        log(f"[sparse_kernels] checked {label}: within the row rule")
        torch.cuda.empty_cache()

    block = BIGBIRD["block"]
    layout = bigbird().make_layout(T)
    res = sparse_kernel_check(gen, layout, block, T, True)
    track(res)
    args, (idx, cnt, idx_t, cnt_t), scale = \
        res["args"], res["sched"], res["scale"]
    q, k, v, do = args[:4]
    fwd = (q, k, v, idx, cnt, block, True, scale)
    dq_args = (*args, idx, cnt, block, True, scale)
    dkv_args = (*args, idx_t, cnt_t, block, True, scale)
    times = dict(
        fwd=cuda_ms(lambda: block_sparse_fwd(*fwd), reps=5),
        dq=cuda_ms(lambda: block_sparse_dq(*dq_args), reps=5),
        dkv=cuda_ms(lambda: block_sparse_dkv(*dkv_args), reps=5))
    designs = sparse_designs(fwd, dq_args, dkv_args, errs)
    # long walks wherever the layout puts them: Fixed's horizontal globals
    # (blocks 3, 7, 11, 15) against BigBird's global block 0
    fixed = sparse_kernel_check(gen, FixedSparsityConfig(
        num_heads=H, block=block, num_local_blocks=4, num_global_blocks=1,
        horizontal_global_attention=True).make_layout(T), block, T, False)
    track(fixed)
    sparse_launch_orders([(f"BigBird block {block} causal", res, block, True),
                          (f"Fixed bidirectional block {block}, horizontal "
                           f"globals", fixed, block, False)])
    del fixed
    # D = 128, for the record of the block-size rule
    wide = sparse_kernel_check(gen, layout, block, T, True, D=128)
    track(wide)
    sparse_designs(
        (*wide["args"][:3], *wide["sched"][:2], block, True, wide["scale"]),
        (*wide["args"], *wide["sched"][:2], block, True, wide["scale"]),
        (*wide["args"], *wide["sched"][2:], block, True, wide["scale"]), errs)
    del wide
    torch.cuda.empty_cache()
    plain = dict(
        fwd=cuda_ms(lambda: block_sparse_fwd_reference(*fwd), reps=1,
                    replays=3),
        dq=cuda_ms(lambda: block_sparse_dq_reference(*dq_args), reps=1,
                   replays=3),
        dkv=cuda_ms(lambda: block_sparse_dkv_reference(*dkv_args), reps=1,
                    replays=3))
    torch.cuda.empty_cache()
    # the library yardstick: one SDPA call with the layout expanded to a
    # (1, H, T, T) boolean token mask computes the same function; its
    # backward (dq, dk, dv in one call) is captured whole with its forward
    # and the forward's time taken off, as for the flash rows
    mask = _token_mask(idx, cnt, block, T, True)[None]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def masked_sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    lib_fwd = cuda_ms(masked_sdpa, reps=2)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        masked_sdpa(), (qt, kt, vt), dot), reps=2) - lib_fwd
    del mask
    torch.cuda.empty_cache()

    def causal_sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    dense_fwd = cuda_ms(causal_sdpa, reps=3)
    dense_fwd_bwd = cuda_ms(lambda: torch.autograd.grad(
        causal_sdpa(), (qt, kt, vt), dot), reps=3)

    pairs = live_pairs(layout, block, True)
    tok = q.numel() * q.element_size()          # one (B, T, H, D) tensor
    stat = q.shape[0] * H * T * 4
    sched = sum(t.numel() * 4 for t in (idx, cnt, idx_t, cnt_t))
    rows = {
        "block_sparse_fwd": dict(
            max_abs_err=errs["fwd"], ms=times["fwd"], plain_ms=plain["fwd"],
            library_ms=lib_fwd,
            **bound(4 * tok + stat + sched // 2, 2 * 2 * D * pairs)),
        "block_sparse_dq": dict(
            max_abs_err=errs["dq"], ms=times["dq"], plain_ms=plain["dq"],
            library_ms=lib_bwd,
            **bound(5 * tok + 2 * stat + sched // 2, 3 * 2 * D * pairs)),
        "block_sparse_dkv": dict(
            max_abs_err=errs["dkv"], ms=times["dkv"], plain_ms=plain["dkv"],
            library_ms=lib_bwd,
            **bound(6 * tok + 2 * stat + sched // 2, 4 * 2 * D * pairs)),
    }
    for name, r in rows.items():
        log(f"[sparse_kernels] {name} B=1 H={H} D={D} T={T} BigBird block "
            f"{block} causal, {pairs} live pairs: max|err| "
            f"{r['max_abs_err']:.3g} (row rule {ROW_REL_TOL}); kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, masked SDPA "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    pair = times["dq"] + times["dkv"]
    log(f"[sparse_kernels] lse max|err| {lse_err:.3g} (tol {LSE_ATOL}); "
        f"port forward + dq + dkv {sum(times.values()):.4f} ms against "
        f"masked SDPA forward + backward {lib_fwd + lib_bwd:.4f} ms "
        f"(factor {sum(times.values()) / (lib_fwd + lib_bwd):.2f}); port dq "
        f"+ dkv {pair:.4f} ms against the masked SDPA backward "
        f"{lib_bwd:.4f} ms (factor {pair / lib_bwd:.2f}; the FMA design's "
        f"{sum(designs[0][1:]):.4f} ms, factor "
        f"{sum(designs[0][1:]) / lib_bwd:.2f}); forward {times['fwd']:.4f} "
        f"ms against the masked SDPA forward {lib_fwd:.4f} ms (the FMA "
        f"design's {designs[0][0]:.4f} ms); "
        f"causal dense SDPA forward {dense_fwd:.4f} ms, forward + backward "
        f"{dense_fwd_bwd:.4f} ms")
    for name, ms in zip(("block_sparse_fwd", "block_sparse_dq",
                         "block_sparse_dkv"), designs[0]):
        rows[name]["fma_ms"] = ms
    del qt, kt, vt, res, args, q, k, v, do, fwd, dq_args, dkv_args
    torch.cuda.empty_cache()

    # the flash kernels at the dense arm's shape, once
    q, k, v, do = (torch.randn(1, T, H, D, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = flash_attention(q, k, v, causal=True)
    ref, ref_lse = mha_reference(q, k, v, causal=True)
    e_fwd = compare_rows(out, ref, "flash forward at T=8192")[0]
    le = (lse - ref_lse).abs().max().item()
    assert math.isfinite(le) and le <= LSE_ATOL, f"flash lse at T=8192: {le}"
    del ref, ref_lse
    fargs = (q, k, v, do, lse, attention_delta(out, do), True, scale)
    e_dq = compare_rows(flash_attention_dq(*fargs), flash_dq_reference(*fargs),
                        "flash dq at T=8192")[0]
    dk, dv = flash_attention_dkv(*fargs)
    want_dk, want_dv = flash_dkv_reference(*fargs)
    e_dkv = max(compare_rows(dk, want_dk, "flash dk at T=8192")[0],
                compare_rows(dv, want_dv, "flash dv at T=8192")[0])
    del want_dk, want_dv
    ft = flash_times(q, k, v, do, "dense arm", reps=3)
    flash = [ft["fwd"], ft["dq"], ft["dkv"]]
    log(f"[sparse_kernels] flash forward, dq, dkv at B=1 H={H} T={T} "
        f"causal: max|err| {e_fwd:.3g} / {e_dq:.3g} / {e_dkv:.3g} (row "
        f"rule), lse {le:.3g}; {flash[0]:.4f} + {flash[1]:.4f} + "
        f"{flash[2]:.4f} = {sum(flash):.4f} ms a layer against the sparse "
        f"kernels' {sum(times.values()):.4f} ms (sparse/dense "
        f"{sum(times.values()) / sum(flash):.3f})")
    del q, k, v, do, fargs
    torch.cuda.empty_cache()
    return rows


def gpt2_small_8k(seed: int, device: str = "cuda", sparse: bool = True,
                  **overrides):
    """GPT-2 small widths at 8192 positions with the JAX bench's model-row
    switches (bf16, ``remat=True`` with the JAX default policy "full"): the
    BigBird layout, or with ``sparse=False`` the flash-dense arm; fp32
    random weights from ``seed`` (GPT-2's init). ``overrides`` replace
    config fields (a rehearsal narrows the widths)."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel

    fields = {**GPT2_SMALL_8K, "dtype": torch.bfloat16, "remat": True,
              "remat_policy": "full", **overrides}
    if sparse:
        fields.setdefault("sparse_attention", bigbird(
            num_heads=fields["n_head"],
            block=min(BIGBIRD["block"], fields["n_positions"] // 4)))
    else:
        fields["use_flash_attention"] = True
    model = GPT2LMHeadModel(GPT2Config(**fields), device=device,
                            param_dtype=torch.float32)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model


def phase_train_sparse(seed: int, steps: int, device: str = "cuda",
                       **overrides) -> list:
    """``train_sparse``: the sparse arm, then the flash-dense arm of the
    same model on the same batches; returns each arm's launches."""
    runs, rates = [], {}
    for label, sparse in (("train_sparse", True), ("train_sparse_dense",
                                                   False)):
        model = gpt2_small_8k(seed, device, sparse, **overrides)
        engine, _, launches, rate = phase_train(
            model, seed, SPARSE_TRAIN_CONFIG, steps, label, device)
        runs.append(launches)
        rates[label] = rate
        del engine, model
        if device == "cuda":
            torch.cuda.empty_cache()
    log(f"[train_sparse] tokens/s: sparse {rates['train_sparse']:.1f}, "
        f"flash-dense {rates['train_sparse_dense']:.1f} (sparse/dense "
        f"{rates['train_sparse'] / rates['train_sparse_dense']:.3f})")
    return runs


def phase_reference_sparse(seed: int, device: str = "cuda", **overrides):
    """One micro-batch's loss and every parameter's gradient with the sparse
    kernels against the same weights with the model's sparse-attention call
    pointed at the gather formulation (the JAX package's non-kernel route)
    for that arm only; remat "full" in both, so one layer's gather scores
    (about 1 GB in fp32 at T=8192) are live at a time."""
    from deepspeed_tpu_torch.models import gpt2 as gpt2_module
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_attention

    model = gpt2_small_8k(seed, device, **overrides).to(torch.bfloat16)
    cfg = model.config
    batch = token_batches(seed + 7, 1, cfg.vocab_size, cfg.n_positions)[0]
    reset_launches()
    kernel_arm = grads_of(model, batch)
    launched = read_launches()["block_sparse_fwd"]
    kernel_route = gpt2_module.block_sparse_flash_attention
    gpt2_module.block_sparse_flash_attention = (
        lambda q, k, v, layout, block, causal: block_sparse_attention(
            q, k, v, layout, block, causal=causal))
    try:
        reset_launches()
        gather_arm = grads_of(model, batch)
        assert read_launches()["block_sparse_fwd"] == 0
    finally:
        gpt2_module.block_sparse_flash_attention = kernel_route
    assert launched == 2 * cfg.n_layer, launched
    hold_gradients("reference_sparse",
                   "sparse kernels vs gather formulation", kernel_arm,
                   gather_arm)
    del model
    if device == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# TinyLlama training, its reference, and checkpoints
# train_llama: bf16 with fp32 masters, ZeRO 2, AdamW lr 3e-4 wd 0.1, clip 1.0
LLAMA_TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": LLAMA_MICRO_BS,
    "gradient_accumulation_steps": LLAMA_GAS, "bf16": {"enabled": True},
    "zero_optimization": {"stage": 2},
    "optimizer": {"type": "AdamW",
                  "params": {"lr": 3e-4, "weight_decay": 0.1}},
    "gradient_clipping": 1.0, "steps_per_print": 1000000}


def tinyllama_train(seed: int, device: str = "cuda", **overrides):
    """TinyLlama-1.1B at its published widths (``TINYLLAMA``) for
    training: bf16 activations, ``remat=True``, ``loss_chunk=LLAMA_CHUNK``,
    the flash kernels forced; fp32 random N(0, 0.02) weights drawn on
    ``device`` from ``seed`` (the engine keeps them as its master weights
    and casts the module to bf16). ``overrides`` replace config fields (a
    rehearsal narrows the widths; the reference arms cut the depth)."""
    from deepspeed_tpu_torch.models.transformer_lm import (
        TransformerLM, transformer_config)

    fields = {**TINYLLAMA, "remat": True, "loss_chunk": LLAMA_CHUNK,
              "use_flash_attention": True, **overrides}
    model = TransformerLM(transformer_config("llama", **fields,
                                             dtype=torch.float32),
                          device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    model.replace_config(dtype=torch.bfloat16)
    return model


def phase_train_llama(seed: int, steps: int, device: str = "cuda",
                      **overrides) -> dict:
    """``train_llama``: :func:`phase_train` on :func:`tinyllama_train`'s
    model under ``LLAMA_TRAIN_CONFIG``; returns {launches, losses (warm-up
    first), peak}."""
    model = tinyllama_train(seed, device, **overrides)
    record = {}
    engine, _, launches, _ = phase_train(model, seed, LLAMA_TRAIN_CONFIG,
                                         steps, "train_llama", device,
                                         record)
    del engine, model
    if device == "cuda":
        torch.cuda.empty_cache()
    return dict(record, launches=launches)


def loss_grads_peak(model, batch, device: str) -> tuple:
    """:func:`grads_of` and the peak device memory its forward and backward
    allocated above what was allocated before (0 on the CPU)."""
    model.zero_grad(set_to_none=True)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    loss = model(batch)
    loss.backward()
    peak = torch.cuda.max_memory_allocated() - base if device == "cuda" \
        else 0
    grads = {k: p.grad.float() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return (loss.item(), grads), peak


def phase_reference_llama(seed: int, device: str = "cuda", **overrides):
    """One train_llama micro-batch at TinyLlama's widths and 2 layers: the
    kernel arm (bf16, flash, ``loss_chunk``) against the plain arm (the
    same bf16 weights in fp32, einsum attention, dense loss), and the
    streamed loss against the dense one (both kernel arms); each arm's
    loss and every parameter's gradient held as reference_train holds
    them. Prints the peak memory of the two loss arms."""
    model = tinyllama_train(seed, device, **{"n_layer": 2, **overrides}
                            ).to(torch.bfloat16)
    plain = copy.deepcopy(model).float()
    plain.replace_config(dtype=torch.float32, use_flash_attention=False,
                         loss_chunk=0)
    cfg = model.config
    batch = token_batches(seed + 7, LLAMA_MICRO_BS, cfg.vocab_size,
                          cfg.max_seq_len)[0]
    arms, peaks = {}, {}
    for name, arm, chunk in (("plain", plain, 0), ("dense", model, 0),
                             ("chunked", model, cfg.loss_chunk)):
        arm.replace_config(loss_chunk=chunk)
        reset_launches()
        arms[name], peaks[name] = loss_grads_peak(arm, batch, device)
        want = 0 if arm is plain else 2 * cfg.n_layer
        got = read_launches()["flash_attention_fwd"]
        assert got == want, f"reference_llama {name}: {got} flash " \
            f"forwards, want {want}"
    del plain
    hold_gradients("reference_llama", f"kernels (bf16, flash, loss_chunk "
                   f"{cfg.loss_chunk}) vs plain (fp32, einsum, dense loss)",
                   arms["chunked"], arms["plain"])
    hold_gradients("reference_llama", f"loss_chunk {cfg.loss_chunk} vs "
                   f"dense loss (bf16, flash)", arms["chunked"],
                   arms["dense"])
    log(f"[reference_llama] peak memory of a micro-batch's forward and "
        f"backward above the weights (B={LLAMA_MICRO_BS}, T="
        f"{cfg.max_seq_len}, vocab {cfg.vocab_size}, {cfg.n_layer} layers): "
        f"dense loss {peaks['dense'] / 2 ** 30:.3f} GiB, loss_chunk "
        f"{cfg.loss_chunk} {peaks['chunked'] / 2 ** 30:.3f} GiB (drop "
        f"{(peaks['dense'] - peaks['chunked']) / 2 ** 30:.3f} GiB); fp32 "
        f"plain arm {peaks['plain'] / 2 ** 30:.3f} GiB")
    del model, arms
    if device == "cuda":
        torch.cuda.empty_cache()


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, name))
               for root, _, names in os.walk(path) for name in names)


def same_state(a, b) -> bool:
    """Two engines' parameters, master weights and optimizer moments
    bit-equal."""
    pairs = list(zip(a._params, b._params)) + \
        list(zip(a.master, b.master)) + \
        [(x, y) for fa, fb in zip(a.opt_state, b.opt_state)
         for x, y in zip(fa, fb)]
    return all(torch.equal(x, y) for x, y in pairs)


def phase_checkpoint(seed: int, gas: int = GAS, device: str = "cuda",
                     **overrides) -> dict:
    """``checkpoint``: GPT-2 medium under the train phase's config. Trains
    2 steps, saves,
    loads into an engine built from other weights (bit-equal parameters,
    master weights and moments right after), and 2 more steps of both
    equal the saver's unbroken run; a second unbroken run gives the gap
    between two unbroken runs. ``ds_to_universal`` then a stage-0 engine
    through ``checkpoint.load_universal``: the next loss equal; and
    ``zero_to_fp32`` equal to the saver's master weights. The directory
    (a temporary one) is deleted. Returns the training launches."""
    import shutil
    import tempfile

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint import (
        ds_to_universal, get_fp32_state_dict_from_zero_checkpoint)

    config = flagship_config(gas)

    def engine(model_seed, cfg=config):
        eng, *_ = dst.initialize(model=gpt2_medium(model_seed, device,
                                                   **overrides),
                                 config=cfg, device=device)
        return eng

    step_s, ran = [], []

    def steps(eng, idx):
        sync(device)
        t0 = time.perf_counter()
        out = [float(eng.train_batch(batch=batches[i % 2])) for i in idx]
        step_s.append((time.perf_counter() - t0) / len(out))
        ran.append(len(out))
        return out

    root = tempfile.mkdtemp(prefix="chip_smoke_checkpoint_")
    try:
        reset_launches()
        saver = engine(seed)
        cfg = saver.module.config
        batches = token_batches(seed, MICRO_BS * gas, cfg.vocab_size,
                                cfg.n_positions)
        losses = steps(saver, range(2))
        sync(device)
        t0 = time.perf_counter()
        saver.save_checkpoint(root)
        t_save = time.perf_counter() - t0
        nbytes = dir_bytes(root)
        resumed = engine(seed + 1)
        t0 = time.perf_counter()
        resumed.load_checkpoint(root)
        sync(device)
        t_load = time.perf_counter() - t0
        assert same_state(resumed, saver), \
            "checkpoint: the loaded state differs from the saver's"
        t0 = time.perf_counter()
        fp32 = get_fp32_state_dict_from_zero_checkpoint(root)
        t_fp32 = time.perf_counter() - t0
        assert all(np.array_equal(fp32[name], m.cpu().numpy()) for name, m
                   in zip(saver._param_names, saver.master)), \
            "checkpoint: zero_to_fp32 differs from the master weights"
        t0 = time.perf_counter()
        ds_to_universal(root)
        t_universal = time.perf_counter() - t0
        ueng = engine(seed + 2, dict(config, zero_optimization={"stage": 0},
                                     checkpoint={"load_universal": True}))
        ueng.load_checkpoint(root)
        universal_loss = steps(ueng, [2])[0]
        del ueng
        losses += steps(saver, (2, 3))
        resumed_losses = steps(resumed, (2, 3))
        del saver, resumed
        if device == "cuda":
            torch.cuda.empty_cache()
        again = steps(engine(seed), range(4))
        launches = read_launches()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gap_unbroken = max(abs(a - b) for a, b in zip(losses, again))
    gap_resumed = max(abs(a - b) for a, b in zip(losses[2:], resumed_losses))
    micros = gas * sum(ran)
    want = {k: n * micros for k, n in micro_batch_launches(cfg).items()}
    got = {k: launches[k] for k in want}
    log(f"[checkpoint] GPT-2 {cfg.n_embd}/{cfg.n_layer}/{cfg.n_head}, micro "
        f"{MICRO_BS} x gas {gas}: unbroken losses "
        f"{losses}, resumed after step 2 {resumed_losses}, a second "
        f"unbroken run {again}; max |gap| between two unbroken runs "
        f"{gap_unbroken}, to the resumed run {gap_resumed}; universal "
        f"(stage 2 -> 0) next loss {universal_loss} vs {losses[2]}; "
        f"zero_to_fp32 equals the master weights; {nbytes} bytes written "
        f"(save {t_save:.2f} s, load {t_load:.2f} s, zero_to_fp32 "
        f"{t_fp32:.2f} s, ds_to_universal {t_universal:.2f} s; directory "
        f"deleted); {np.mean(step_s):.2f} s a step; {sum(ran)} steps of "
        f"{gas} micro-batches over five engines: launches {got}, want "
        f"{want}")
    assert got == want, f"checkpoint: launches {got}, want {want}"
    assert gap_resumed == 0.0, "checkpoint: resumed losses differ"
    assert universal_loss == losses[2], "checkpoint: universal loss differs"
    return launches


# ---------------------------------------------------------------------------
# ZeRO-Offload and ZeRO-Infinity training (phases 18-20)
OFFLOAD_TIMED_STEPS = 3
PARAM_OFFLOAD_TIMED_STEPS = 2
OFFLOAD_LOSS_RTOL = 2e-3          # train_offload against train_llama
PARAM_OFFLOAD_LOSS_RTOL = 5e-3    # train_param_offload against train_offload


def offload_config(**zero) -> dict:
    """``LLAMA_TRAIN_CONFIG`` with ``zero`` added to its ZeRO block."""
    config = copy.deepcopy(LLAMA_TRAIN_CONFIG)
    config["zero_optimization"].update(zero)
    return config


def fresh_device(device: str) -> int:
    """Collect the earlier phases' engines (an engine can sit in a
    reference cycle until the collector runs) and return the device's
    allocated bytes."""
    import gc

    gc.collect()
    if device != "cuda":
        return 0
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def stage_peaks(engine, batch) -> dict:
    """One more streamed step with the device's peak read and reset at
    each stage boundary: the forward stream, the head (its loss and
    backward), the backward stream, the host step."""
    runner = engine._param_offload
    marks = {}

    def mark(name):
        torch.cuda.synchronize()
        marks[name] = max(marks.get(name, 0),
                          torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    def wrap(obj, attr, before=None, after=None):
        real = getattr(obj, attr)

        def fn(*args, **kwargs):
            if before:
                before(*args)
            out = real(*args, **kwargs)
            if after:
                after()
            return out
        setattr(obj, attr, fn)
        return real

    saved = [(runner, "_forward_stream", wrap(
        runner, "_forward_stream", after=lambda: mark("forward stream"))),
        (runner.store, "begin_pass", wrap(
            runner.store, "begin_pass", before=lambda order: mark("head")
            if len(order) > 1 and order[0] > order[-1] else None)),
        (runner.opt, "step", wrap(
            runner.opt, "step", before=lambda *a: mark("backward stream")
            if "host step" not in marks else None))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.train_batch(batch=batch)
    mark("host step")
    for obj, attr, _ in saved:
        delattr(obj, attr)
    return marks


def offload_steps(engine, batches, warm: int, steps: int, device: str):
    """``warm`` untimed then ``steps`` timed ``train_batch`` calls on the
    batches in train_llama's order (1, 0, 1, ...); returns (losses, timed
    wall seconds, launches of the timed steps, peak of the timed steps,
    fwd_bwd seconds summed over them)."""
    order = [batches[(i + 1) % 2] for i in range(warm + steps)]
    losses = [float(engine.train_batch(batch=b)) for b in order[:warm]]
    sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    engine.offload_timings(reset=True)
    reset_launches()
    fwd_bwd, t0 = 0.0, time.perf_counter()
    for b in order[warm:]:
        losses.append(engine.train_batch(batch=b))
        fwd_bwd += engine.last_timings.get("fwd_bwd_s", 0.0)
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    return [float(x) for x in losses], wall, launches, peak, fwd_bwd


def hold_losses(label: str, got, want, rtol: float, what: str) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), f"{label}: losses {got}"
    err = float(np.max(np.abs(got - want) / np.abs(want)))
    assert err <= rtol, f"{label}: losses {got.tolist()} against {what} " \
        f"{want.tolist()}: {err:.2e} relative > {rtol}"
    return err


def hold_train_launches(label: str, cfg, launches: dict, micros: int):
    want = {k: n * micros for k, n in micro_batch_launches(cfg).items()}
    got = {k: launches[k] for k in want}
    assert got == want, f"{label}: launches {got}, want {want}"
    return {k: n for k, n in got.items() if n}


def phase_train_offload(seed: int, llama: dict, device: str = "cuda",
                        **overrides) -> dict:
    """18. ``train_offload``: train_llama's model and batches with
    ``offload_optimizer: {"device": "cpu"}``; every loss within
    OFFLOAD_LOSS_RTOL of train_llama's at the same step, the flash
    kernels' launches a micro-batch as train_llama's, and the peak at most
    train_llama's less 0.9 x 12 bytes a parameter (the fp32 master and both
    moments off the card)."""
    import deepspeed_tpu_torch as dst

    label = "train_offload"
    base = fresh_device(device)
    model = tinyllama_train(seed, device, **overrides)
    cfg = model.config
    n = sum(p.numel() for p in model.parameters())
    engine, *_ = dst.initialize(model=model, device=device,
                                config=offload_config(
                                    offload_optimizer={"device": "cpu"}))
    del model
    micro, gas = LLAMA_MICRO_BS, LLAMA_GAS
    batches = token_batches(seed, micro * gas, cfg.vocab_size,
                            cfg.max_seq_len)
    steps = OFFLOAD_TIMED_STEPS
    losses, wall, launches, peak, fwd_bwd = offload_steps(
        engine, batches, 2, steps, device)
    tim = engine.offload_timings()
    err = hold_losses(label, losses, llama["losses"][:len(losses)],
                      OFFLOAD_LOSS_RTOL, "train_llama")
    got = hold_train_launches(label, cfg, launches, gas * steps)
    peak -= base
    limit = llama["peak"] - 0.9 * 12 * n
    if device == "cuda":
        assert peak <= limit, f"{label}: peak {peak / 2 ** 30:.2f} GiB > " \
            f"train_llama's {llama['peak'] / 2 ** 30:.2f} GiB - 0.9 x 12 " \
            f"bytes x {n} parameters = {limit / 2 ** 30:.2f} GiB"
    tokens = steps * gas * micro * cfg.max_seq_len
    per = {k: tim[k] / steps for k in ("host_step_s", "adam_s", "down_s",
                                       "up_s")}
    log(f"[{label}] {describe(cfg)}, {n / 1e9:.3f}B parameters, micro "
        f"{micro} x gas {gas}, optimizer on the host: losses "
        f"{[round(x, 4) for x in losses]} (train_llama "
        f"{[round(x, 4) for x in llama['losses'][:len(losses)]]}, largest "
        f"gap {err:.2e} relative); {tokens} tokens in {wall:.2f} s: "
        f"{tokens / wall:.1f} tokens/s, {wall / steps * 1e3:.1f} ms a step = "
        f"device fwd/bwd {fwd_bwd / steps * 1e3:.1f} ms + host step "
        f"{per['host_step_s'] * 1e3:.1f} ms (host Adam and bf16 rounding "
        f"{per['adam_s'] * 1e3:.1f} ms; gradients down "
        f"{tim['down_bytes'] / steps / 1e9:.2f} GB in {per['down_s'] * 1e3:.1f}"
        f" ms of copies, {tim['down_bytes'] / max(tim['down_s'], 1e-9) / 1e9:.1f}"
        f" GB/s; parameters up {tim['up_bytes'] / steps / 1e9:.2f} GB in "
        f"{per['up_s'] * 1e3:.1f} ms, "
        f"{tim['up_bytes'] / max(tim['up_s'], 1e-9) / 1e9:.1f} GB/s; copies "
        f"overlap the host Adam); peak {peak / 2 ** 30:.2f} GiB allocated "
        f"above the {base / 2 ** 30:.2f} GiB held before the phase "
        f"against train_llama's {llama['peak'] / 2 ** 30:.2f} GiB (limit "
        f"{limit / 2 ** 30:.2f} GiB); launches {got}")
    del engine
    if device == "cuda":
        torch.cuda.empty_cache()
    return dict(launches=launches, losses=losses, peak=peak, n=n)


def phase_train_offload_nvme(seed: int, device: str = "cuda",
                             **overrides) -> None:
    """19. ``train_offload_nvme``: TinyLlama's widths cut to 2 layers, 3
    steps each with ``offload_optimizer`` on the host, on NVMe (files in a
    temporary directory) and on NVMe with ``swap_master: false``: losses,
    final parameters and host state bit-equal across the tiers."""
    import shutil
    import tempfile

    import deepspeed_tpu_torch as dst

    label = "train_offload_nvme"
    fresh_device(device)
    root = tempfile.mkdtemp(prefix="dstorch_offload_")
    try:
        arms = {}
        for arm, block in (("cpu", {"device": "cpu"}),
                           ("nvme", {"device": "nvme",
                                     "nvme_path": f"{root}/nvme"}),
                           ("nvme moments", {"device": "nvme",
                                             "swap_master": False,
                                             "nvme_path": f"{root}/moments"})):
            model = tinyllama_train(seed, device, **{"n_layer": 2,
                                                     **overrides})
            cfg = model.config
            engine, *_ = dst.initialize(
                model=model, device=device,
                config=offload_config(offload_optimizer=block))
            del model
            batches = token_batches(seed, LLAMA_MICRO_BS * LLAMA_GAS,
                                    cfg.vocab_size, cfg.max_seq_len)
            losses, wall, _, _, _ = offload_steps(engine, batches, 0, 3,
                                                  device)
            opt = engine._offload_opt
            state = opt.state_dict()
            arms[arm] = dict(losses=losses, wall=wall,
                             params={k: v.detach().cpu().clone() for k, v in
                                     engine.module.state_dict().items()},
                             state=state, timings=dict(opt.last_timings),
                             bytes=dir_bytes(block["nvme_path"])
                             if "nvme_path" in block else 0,
                             o_direct=opt._aio.o_direct if opt.nvme
                             else None, n=opt.numel(),
                             swap_master=opt.swap_master)
            del engine, opt, state
            if device == "cuda":
                torch.cuda.empty_cache()
        ref = arms["cpu"]
        for arm in ("nvme", "nvme moments"):
            got = arms[arm]
            assert got["losses"] == ref["losses"], \
                f"{label}: {arm} losses {got['losses']} != cpu {ref['losses']}"
            bad = [k for k, v in ref["params"].items()
                   if not torch.equal(got["params"][k], v)]
            bad += [f"{kind}/{k}" for kind in ("master", "m", "v")
                    for k, v in ref["state"][kind].items()
                    if not torch.equal(got["state"][kind][k], v)]
            assert not bad, f"{label}: {arm} differs from cpu at {bad[:4]}"
        lines = []
        for arm, a in arms.items():
            t = a["timings"]
            line = (f"{arm}: losses {[round(x, 4) for x in a['losses']]}, "
                    f"{a['wall'] / 3 * 1e3:.1f} ms a step")
            if arm != "cpu":
                kinds = 3 if a["swap_master"] else 2
                moved = 2 * kinds * 4 * a["n"]
                host = sum(t.values())
                line += (f", {a['bytes'] / 1e9:.2f} GB of files, last step "
                         f"swap_in_s {t['swap_in_s']:.3f} compute_s "
                         f"{t['compute_s']:.3f} drain_s {t['drain_s']:.3f}: "
                         f"{moved / 1e9:.2f} GB read and written in "
                         f"{host:.3f} s of host step, "
                         f"{moved / host / 1e9:.2f} GB/s, O_DIRECT "
                         f"{'on' if a['o_direct'] else 'off (the filesystem refused it)'}")
            lines.append(line)
        log(f"[{label}] TinyLlama widths, 2 layers "
            f"({arms['cpu']['n'] / 1e6:.1f}M parameters), files under "
            f"{root}: the nvme tiers bit-equal to the cpu tier (losses, "
            f"parameters, master, moments); " + "; ".join(lines))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def param_offload_peak_bound(engine, cfg) -> dict:
    """train_param_offload's device memory, reckoned from its pieces (the
    runner's docstring): the resident parameters and their fp32 gradient
    sums, ``prefetch + 2`` layer buffers, L+1 boundary activations, one
    layer's recompute (saved activations twice over for the backward's
    transients, and three layers' gradients in flight) and the head (fp32
    logits, their log-probabilities and gradient, and the fp32 head weight
    and its gradient), plus 1 GiB."""
    runner = engine._param_offload
    B, T, C = LLAMA_MICRO_BS, cfg.max_seq_len, cfg.n_embd
    H, V, L = int(cfg.mlp_ratio * C), cfg.vocab_size, cfg.n_layer
    tokens = B * T
    resident = sum(p.numel() * (p.element_size() + 4)
                   for _, p in runner.resident)
    layers = (runner.store.prefetch + 2) * runner.store.layer_nbytes
    boundary = (L + 1) * tokens * C * 2
    recompute = 2 * tokens * (6 * C + 4 * H) * 2 + \
        3 * runner.store.layer_nbytes
    head = 3 * B * (T - 1) * V * 4 + 2 * V * C * 4
    parts = dict(resident=resident, layer_buffers=layers,
                 boundary_activations=boundary, recompute=recompute,
                 head=head, slack=2 ** 30)
    parts["total"] = sum(parts.values())
    return parts


def phase_train_param_offload(seed: int, offload: dict, llama: dict,
                              device: str = "cuda", **overrides) -> dict:
    """20. ``train_param_offload``: TinyLlama at its widths and 22 layers
    with ``offload_param: {"device": "cpu"}`` on train_offload's batches:
    every loss within PARAM_OFFLOAD_LOSS_RTOL of train_offload's (the
    streamed head computes the dense loss, train_offload the streamed
    one), the flash forward twice a layer and dq, dk/dv once a layer a
    micro-batch, and the peak under :func:`param_offload_peak_bound`."""
    import deepspeed_tpu_torch as dst

    label = "train_param_offload"
    base = fresh_device(device)
    model = tinyllama_train(seed, device, **overrides)
    cfg = model.config
    engine, *_ = dst.initialize(model=model, device=device,
                                config=offload_config(
                                    offload_param={"device": "cpu"}))
    del model
    if device == "cuda":
        torch.cuda.empty_cache()
    runner = engine._param_offload
    micro, gas = LLAMA_MICRO_BS, LLAMA_GAS
    batches = token_batches(seed, micro * gas, cfg.vocab_size,
                            cfg.max_seq_len)
    steps = PARAM_OFFLOAD_TIMED_STEPS
    streamed0 = runner.store.streamed_bytes
    keys = ("forward_stream_s", "backward_stream_s", "host_adam_s",
            "param_writeback_s", "grad_finalize_s")
    totals = dict.fromkeys(keys, 0.0)
    real = runner.train_batch

    def timed(*args, **kwargs):
        out = real(*args, **kwargs)
        for k in keys:
            totals[k] += runner.last_timings[k]
        return out

    runner.train_batch = timed
    losses, wall, launches, peak, _ = offload_steps(engine, batches, 2,
                                                    steps, device)
    runner.train_batch = real
    peak -= base
    stages = {k: v - base for k, v in stage_peaks(engine, batches[1]).items()
              } if device == "cuda" else {}
    streamed = runner.store.streamed_bytes - streamed0
    err = hold_losses(label, losses, offload["losses"][:len(losses)],
                      PARAM_OFFLOAD_LOSS_RTOL, "train_offload")
    got = hold_train_launches(label, cfg, launches, gas * steps)
    parts = param_offload_peak_bound(engine, cfg)
    if device == "cuda":
        assert peak <= parts["total"], f"{label}: peak " \
            f"{peak / 2 ** 30:.2f} GiB > the reckoned " \
            f"{parts['total'] / 2 ** 30:.2f} GiB ({parts})"
    total_steps = 2 + steps
    per = {k: totals[k] / total_steps for k in keys}
    stream_s = totals["forward_stream_s"] + totals["backward_stream_s"]
    tokens = steps * gas * micro * cfg.max_seq_len
    log(f"[{label}] {describe(cfg)}, {cfg.n_layer} layers x "
        f"{runner.store.layer_nbytes / 1e6:.1f} MB streamed from pinned host "
        f"memory (prefetch {runner.store.prefetch}): losses "
        f"{[round(x, 4) for x in losses]} (train_offload "
        f"{[round(x, 4) for x in offload['losses'][:len(losses)]]}, largest "
        f"gap {err:.2e} relative); {tokens} tokens in {wall:.2f} s: "
        f"{tokens / wall:.1f} tokens/s, {wall / steps * 1e3:.1f} ms a step; "
        f"a step's mean over all {total_steps} steps: forward_stream_s "
        f"{per['forward_stream_s']:.3f}, backward_stream_s "
        f"{per['backward_stream_s']:.3f}, grad_finalize_s "
        f"{per['grad_finalize_s']:.3f}, host_adam_s {per['host_adam_s']:.3f},"
        f" param_writeback_s {per['param_writeback_s']:.3f}; the stream "
        f"{streamed / stream_s / 1e9:.1f} GB/s over its passes; peak "
        f"{peak / 2 ** 30:.2f} GiB allocated above the "
        f"{base / 2 ** 30:.2f} GiB held before the phase (one more step's "
        f"peak by stage: " + ", ".join(f"{k} {v / 2 ** 30:.2f}"
                                      for k, v in stages.items())
        + f"; reckoned bound "
        f"{parts['total'] / 2 ** 30:.2f} GiB: "
        + ", ".join(f"{k} {v / 2 ** 30:.2f}" for k, v in parts.items()
                    if k != "total")
        + f"; train_llama's peak {llama['peak'] / 2 ** 30:.2f} GiB); "
        f"launches {got}")
    del engine, runner
    if device == "cuda":
        torch.cuda.empty_cache()
    return dict(launches=launches, losses=losses, peak=peak)


def offload_phases(seed: int, llama: dict, device: str = "cuda",
                   **overrides) -> list:
    """Phases 18-20 after train_llama (``llama``: its losses and peak);
    returns the launches of the two full-depth phases."""
    offload = phase_train_offload(seed, llama, device, **overrides)
    phase_train_offload_nvme(seed, device, **overrides)
    streamed = phase_train_param_offload(seed, offload, llama, device,
                                         **overrides)
    return [offload["launches"], streamed["launches"]]


# ---------------------------------------------------------------------------
# phase 23: ZeRO over a data-parallel world
# ---------------------------------------------------------------------------
# arm (b)'s micro-batches a rank a step; arm (a) runs one rank with twice
# as many, the same micro-batches
ZERO_DP_GAS = 1
# steps a run: the first untimed, then timed with the comms logger off,
# the last timed with it on (a device sync after every collective) for
# the op table (4 until arm (c) came; cut to keep the smoke in its time)
ZERO_DP_STEPS = 3
# arm (a)'s stages over a NCCL world of one (which shards nothing: every
# stage runs stage 0's code there, so it was cut from 0-3 to 0 when arm
# (c) came) and arm (b)'s over two ranks, each partitioning its own way
ZERO_DP_NCCL_STAGES = (0,)
ZERO_DP_STAGES = (1, 2, 3)
ZERO_DP_TIMEOUT = 600             # seconds for arm (b)'s two ranks
ZERO_DP_NCCL_RTOL = 1e-5          # arm (a) after step 1 (step 1: equal)
ZERO_DP_MASTER_ATOL = 1e-5        # arm (a)'s final masters
# Arm (b) against arm (a): the same micro-batches through the same
# kernels, so only the order of fp32 sums differs (the world's sum of two
# accumulators, the shards' sum of squares in the norm). Losses and each
# step's pre-clip global gradient norm within 1e-4 relative: Adam and the
# clip hide the gradient's scale, the norm does not (a wrong world divisor
# or an unaveraged sum doubles it). The final masters, gathered: the norm
# of their difference from arm (a)'s within 1% of the norm of arm (a)'s
# update (final - initial masters); a slice updated from another slice's
# gradient gives about 100%.
ZERO_DP_LOSS_RTOL = 1e-4
ZERO_DP_NORM_RTOL = 1e-4
ZERO_DP_UPDATE_RTOL = 1e-2
ZERO_DP_BYTES_RTOL = 0.01
# Arm (c) against arm (a), written before the first run on the card: the
# same micro-batches, but every row-parallel product is two bf16 partial
# sums, each rounded to bf16, added in bf16 by the all-reduce (arm (a)
# rounds one fp32-accumulated sum once), so a row-parallel output carries
# about one more bf16 rounding (2^-9 relative) at 48 products a forward;
# the fp32 CPU tests hold the same paths to 1e-5. Losses within 2e-3
# relative and pre-clip gradient norms within 3e-2 (the norm sums squares
# of gradients whose bf16 noise the extra roundings move; Adam then
# compounds the parting over four steps).
TP_LOSS_RTOL = 2e-3
TP_NORM_RTOL = 3e-2


def tp_rank_params(cfg, m: int) -> int:
    """A rank's parameter count of GPT-2 (``cfg``) over a model group of
    ``m`` ranks, from the widths: the embeddings (a vocabulary ``m`` does
    not divide stays whole), the norms and the row-parallel projections'
    biases whole; qkv (weight and bias), ``attn.proj``'s weight, ``mlp.fc``
    (weight and bias) and ``mlp.proj``'s weight in ``m`` parts."""
    C, V, P, L = cfg.n_embd, cfg.vocab_size, cfg.n_positions, cfg.n_layer
    embed = (V // m if V % m == 0 else V) * C + P * C
    whole = 2 * C + 2 * C + C + C                 # ln_1, ln_2, two biases
    split = 3 * C * C + 3 * C + C * C + 4 * C * C + 4 * C + 4 * C * C
    return embed + L * (whole + split // m) + 2 * C


def tp_micro_collectives(cfg, m: int = 2) -> dict:
    """The collectives one micro-batch of GPT-2 (``cfg``) issues over a
    model group, from the code: a layer's forward all-reduces the
    row-parallel ``attn.proj`` and ``mlp.proj`` outputs (2), its backward
    the column-parallel qkv's and ``mlp.fc``'s input gradients
    (``copy_to_group``, 2); under remat the checkpointed block's
    recomputation runs the forward again only as far as its last saved
    tensor (``mlp.proj``'s input: torch.utils.checkpoint stops there), so
    it issues ``attn.proj``'s all-reduce and not ``mlp.proj``'s (1). A
    vocabulary the group divides adds the embedding's all-reduce and the
    tied head's all-gather forward and its input gradient's all-reduce
    backward; GPT-2's 50257 stays whole and adds none."""
    per_layer = 4 + (1 if cfg.remat else 0)
    out = {"all_reduce": cfg.n_layer * per_layer}
    if cfg.vocab_size % m == 0:
        out["all_reduce"] += 2
        out["all_gather_into_tensor"] = 1
    return out


def zero_dp_run(seed: int, stage: int, gas: int, rank: int, world: int,
                device: str, overrides: dict, keep_init: bool = False,
                model: int = 1) -> dict:
    """GPT-2 medium from ``seed`` through ``initialize`` at ``stage``, this
    rank's rows of ``ZERO_DP_STEPS`` global batches (rank r's micro-batch
    k is the global micro-batch k·world + r, as ``train_batch`` splits a
    batch); returns the losses and pre-clip gradient norms, the step time
    with the comms logger off (the mean over steps 1 to n-2) and on (the
    last step), the engine, bytes at rest beside the policy's prediction,
    the comms logger's totals over the last step and, with ``keep_init``,
    a copy of the initial masters. ``model`` above 1 trains over a model
    group of that many ranks (``mesh`` ``{"data": 1, "model": model}``;
    ``rank`` and ``world`` are then the data-parallel ones, 0 and 1)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import mesh as mesh_mod

    mesh_mod.reset_mesh()
    model_ = gpt2_medium(seed, device, **overrides)
    cfg = model_.config
    config = flagship_config(gas)
    config["zero_optimization"] = {"stage": stage}
    if model > 1:
        config["mesh"] = {"data": 1, "model": model}
    engine, *_ = dst.initialize(model=model_, config=config, device=device)
    init = [t.detach().clone() for t in engine._targets] if keep_init \
        else None
    shapes = {lay.name: lay.shape for lay in engine._part.layouts}
    bytes_ = engine.bytes_at_rest()
    predicted = engine.policy.bytes_at_rest(
        shapes, param_itemsize=2, keep_master=True,
        moments=len(engine.opt_state))
    rows = MICRO_BS * gas * world
    batches = token_batches(seed, rows, cfg.vocab_size, train_seq(cfg))
    mine = [{"input_ids": b["input_ids"].reshape(
        gas, world, MICRO_BS, -1)[:, rank].reshape(gas * MICRO_BS, -1)}
        for b in batches]
    losses, norms, times = [], [], []
    for step in range(ZERO_DP_STEPS):
        logged = step == ZERO_DP_STEPS - 1
        if logged:
            comm.comms_logger.reset()
        comm.configure(enabled=logged, prof_all=True)
        sync(device)
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch=mine[step % 2])))
        sync(device)
        times.append(time.perf_counter() - t0)
        norms.append(float(engine.get_global_grad_norm()))
    comm.configure(enabled=False)
    comms_ = {name: {"count": v["count"], "bytes": v["bytes"]}
              for name, v in comm.comms_logger.totals().items()}
    comm.comms_logger.reset()
    return dict(losses=losses, norms=norms,
                step_ms=1e3 * sum(times[1:-1]) / (ZERO_DP_STEPS - 2),
                logged_ms=1e3 * times[-1], engine=engine, bytes=bytes_,
                predicted=predicted, comms=comms_, cfg=cfg, init=init)


def comms_table(comms_: dict) -> str:
    return ", ".join(f"{name} {v['count']} ops {v['bytes'] / 1e6:.1f} MB"
                     for name, v in sorted(comms_.items()))


def zero_dp_worker(rank: int, world: int, tmp: str, seed: int,
                   spec: dict) -> int:
    """Arm (b)'s rank: gloo over ``spec["device"]`` (cuda:0 for every rank
    on the card), the table of what gloo takes for CUDA tensors and the
    comm layer's collectives against exact results, then the ZeRO stages
    of ``ZERO_DP_STAGES``, each run's gathered final masters held against
    arm (a)'s (``ref_master.pt`` in ``tmp``), then arm (c)
    (:func:`tp_train_arm`); writes ``rank<r>.json`` to ``tmp``."""
    from deepspeed_tpu_torch import comm

    torch.backends.cuda.matmul.allow_tf32 = False   # as main() sets them
    torch.backends.cudnn.allow_tf32 = False
    device, overrides = spec["device"], spec["overrides"]
    comm.init_distributed(dist_backend="gloo", rank=rank, world_size=world,
                          init_method=f"file://{os.path.join(tmp, 'store')}",
                          timeout=ZERO_DP_TIMEOUT, verbose=False)
    out = {"table": gloo_cuda_table() if device == "cuda" else {},
           "exact": exact_collectives(device), "stages": {}}
    ref = torch.load(os.path.join(tmp, "ref_master.pt"), mmap=True)
    for stage in ZERO_DP_STAGES:
        reset_launches()
        run = zero_dp_run(seed, stage, ZERO_DP_GAS, rank, world, device,
                          overrides)
        launches = read_launches()
        micros = ZERO_DP_GAS * ZERO_DP_STEPS
        want = {k: n * micros
                for k, n in micro_batch_launches(run["cfg"]).items()}
        engine = run["engine"]
        sq, worst = 0.0, 0.0
        for lay, t, r in zip(engine._part.layouts, engine._targets, ref):
            diff = engine._part.gather(lay, t).float() - r.to(device)
            sq += float(diff.double().square().sum())
            worst = max(worst, diff.abs().max().item())
        out["stages"][stage] = dict(
            losses=run["losses"], norms=run["norms"],
            step_ms=run["step_ms"], logged_ms=run["logged_ms"],
            bytes=run["bytes"], predicted=run["predicted"],
            comms=run["comms"], launches={k: launches[k] for k in want},
            want=want, master_gap_norm=math.sqrt(sq), master_gap_max=worst,
            max_live_blocks=getattr(engine._zero3, "max_live_blocks", None))
        del run, engine
        fresh_device(device)
    out["tp"] = tp_train_arm(seed, world, device, overrides)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def tp_train_arm(seed: int, world: int, device: str,
                 overrides: dict) -> dict:
    """Arm (c) on one rank of a model group of ``world``: arm (a)'s
    training (micro ``MICRO_BS`` x gas 2, ``ZERO_DP_STEPS`` steps) at
    ``(data, model)`` = (1, ``world``), ZeRO 2; then one more micro-batch
    through the eager API with the comms logger on, whose collectives are
    one micro-batch's (nothing else runs in it: at ``data`` 1 no gradient
    is reduced), its gradients dropped after."""
    from deepspeed_tpu_torch import comm

    gas = 2 * ZERO_DP_GAS
    reset_launches()
    run = zero_dp_run(seed, 2, gas, 0, 1, device, overrides, model=world)
    engine, cfg = run["engine"], run["cfg"]
    micro = {"input_ids": token_batches(
        seed, MICRO_BS * gas, cfg.vocab_size,
        train_seq(cfg))[0]["input_ids"][:MICRO_BS]}
    sync(device)
    comm.comms_logger.reset()
    comm.configure(enabled=True, prof_all=True)
    engine.backward(engine.forward(micro))
    sync(device)
    comm.configure(enabled=False)
    micro_comms = {name: v["count"]
                   for name, v in comm.comms_logger.totals().items()}
    comm.comms_logger.reset()
    engine._clear_accumulation()
    launches = read_launches()
    micros = ZERO_DP_STEPS * gas + 1
    want = {k: n * micros for k, n in micro_batch_launches(cfg).items()}
    out = dict(losses=run["losses"], norms=run["norms"],
               step_ms=run["step_ms"], logged_ms=run["logged_ms"],
               bytes=run["bytes"], predicted=run["predicted"],
               comms=run["comms"], micro_comms=micro_comms,
               micro_want=tp_micro_collectives(cfg, world),
               params=sum(p.numel() for p in engine.module.parameters()),
               params_want=tp_rank_params(cfg, world),
               launches={k: launches[k] for k in want}, want=want,
               mp=engine.mp_world_size, heads=engine.module.blocks[0]
               .attn.heads)
    del run, engine
    fresh_device(device)
    return out


def gloo_cuda_table() -> dict:
    """Each collective called natively on gloo with a CUDA tensor, on a
    group of its own: "native" where it ran and gave the exact result,
    else the error's first line (PyTorch's backend table lists all_reduce
    and broadcast)."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.comm import comm as comm_mod

    pg = dist.new_group(backend="gloo")
    rank, n = dist.get_rank(), dist.get_world_size()
    x = torch.arange(4 * n, dtype=torch.float32, device="cuda") + rank

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y, group=pg)
        return y, sum(torch.arange(4 * n, device="cuda") + r
                      for r in range(n))

    def broadcast():
        y = x.clone()
        dist.broadcast(y, src=0, group=pg)
        return y, torch.arange(4 * n, dtype=torch.float32, device="cuda")

    def all_gather():
        ys = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(ys, x, group=pg)
        return torch.cat(ys), torch.cat([x - rank + r for r in range(n)])

    def all_gather_into_tensor():
        y = torch.empty(4 * n * n, device="cuda")
        comm_mod._collective("all_gather_single")(y, x, group=pg)
        return y, torch.cat([x - rank + r for r in range(n)])

    def reduce_scatter_tensor():
        y = torch.empty(4, device="cuda")
        comm_mod._collective("reduce_scatter_single")(y, x, group=pg)
        full = sum(x - rank + r for r in range(n))
        return y, full[4 * rank:4 * rank + 4]

    def all_to_all_single():
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=pg)
        return y, torch.cat([(x - rank + r)[4 * rank:4 * rank + 4]
                             for r in range(n)])

    table = {}
    for fn in (all_reduce, broadcast, all_gather, all_gather_into_tensor,
               reduce_scatter_tensor, all_to_all_single):
        try:
            got, want = fn()
            torch.cuda.synchronize()
            table[fn.__name__] = "native" if torch.equal(
                got.float(), want.float()) else "wrong result"
        except Exception as exc:   # the table records what gloo refuses
            table[fn.__name__] = f"{type(exc).__name__}: " \
                f"{str(exc).strip().splitlines()[0][:100]}"
    dist.destroy_process_group(pg)
    return table


def exact_collectives(device: str) -> list:
    """The comm layer's all_gather and reduce_scatter against the exact
    results, fp32 and bf16 along dims 0 and 1 (small integers: every sum
    is exact)."""
    from deepspeed_tpu_torch import comm

    rank, n = comm.get_rank(), comm.get_world_size()
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for dim in (0, 1):
            parts = [(torch.arange(24, device=device).reshape(4, 6)
                      * (r + 1)).to(dtype) for r in range(n)]
            whole = torch.cat(parts, dim)
            got = comm.all_gather_into_tensor(parts[rank], axis=dim)
            assert torch.equal(got, whole), ("all_gather", dtype, dim)
            k = whole.shape[dim] // n
            got = comm.reduce_scatter_tensor(whole.float(),
                                             scatter_dimension=dim)
            want = (whole.float() * n).narrow(dim, rank * k, k)
            assert torch.equal(got, want), ("reduce_scatter", dtype, dim)
            out.append(f"{str(dtype).split('.')[1]} dim {dim}")
    return out


def phase_train_zero_dp(seed: int, device: str = "cuda",
                        **overrides) -> dict:
    """Phase 23 (module docstring); returns the flash kernels' launches
    over arm (a)'s process-group runs and arm (b)'s two ranks."""
    import tempfile

    import torch.distributed as dist

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm import comm as comm_mod
    from deepspeed_tpu_torch.parallel import mesh as mesh_mod

    gas = 2 * ZERO_DP_GAS
    tmp = tempfile.mkdtemp(prefix="zero_dp_")
    card = card_line() if device == "cuda" else "cpu"
    # arm (a): one rank without a process group, then over NCCL
    ref = zero_dp_run(seed, 0, gas, 0, 1, device, overrides, keep_init=True)
    ref_losses, ref_norms = ref["losses"], ref["norms"]
    ref_master = [t.detach().clone() for t in ref["engine"]._targets]
    update = math.sqrt(sum(float((t - i).double().square().sum())
                           for t, i in zip(ref_master, ref["init"])))
    torch.save([t.cpu() for t in ref_master],
               os.path.join(tmp, "ref_master.pt"))
    log(f"[train_zero_dp] (a) no process group, {describe(ref['cfg'])}, "
        f"micro {MICRO_BS} x gas {gas}: losses {ref_losses}, pre-clip "
        f"grad norms {ref_norms}, the masters' update norm {update:.6g}; "
        f"{ref['step_ms']:.1f} ms a step on {card}")
    del ref
    fresh_device(device)
    comm.init_distributed(init_method=f"file://{os.path.join(tmp, 'nccl')}",
                          rank=0, world_size=1, device=device,
                          verbose=False)
    backend = dist.get_backend()
    reset_launches()
    try:
        for stage in ZERO_DP_NCCL_STAGES:
            run = zero_dp_run(seed, stage, gas, 0, 1, device, overrides)
            losses = run["losses"]
            gap = max(abs(a - b) / abs(b) for a, b in
                      zip(losses[1:], ref_losses[1:]))
            master_gap = max((m - r).abs().max().item() for m, r in
                             zip(run["engine"]._targets, ref_master))
            sharded = sum(lay.state_sharded for lay in
                          run["engine"]._part.layouts)
            log(f"[train_zero_dp] (a) {backend} world 1, stage {stage}: "
                f"losses {losses}; step 1 equal: "
                f"{losses[0] == ref_losses[0]}, later steps rel gap "
                f"{gap:.3g} (tol {ZERO_DP_NCCL_RTOL}), final masters max "
                f"abs gap {master_gap:.3g} (tol {ZERO_DP_MASTER_ATOL}); "
                f"{sharded} tensors sharded (a world of one shards none: "
                f"stages 1-3 run stage 0's reduction); the last step's "
                f"collectives: {comms_table(run['comms'])}; "
                f"{run['step_ms']:.1f} ms a step on {card}")
            assert losses[0] == ref_losses[0], (stage, losses, ref_losses)
            assert gap <= ZERO_DP_NCCL_RTOL, (stage, losses, ref_losses)
            assert master_gap <= ZERO_DP_MASTER_ATOL, (stage, master_gap)
            cfg = run["cfg"]
            del run
            fresh_device(device)
        launches = read_launches()
    finally:
        dist.destroy_process_group()
        comm_mod._initialized = False
        mesh_mod.reset_mesh()
    del ref_master
    fresh_device(device)
    micros = len(ZERO_DP_NCCL_STAGES) * gas * ZERO_DP_STEPS
    want = {k: n * micros for k, n in micro_batch_launches(cfg).items()}
    if device == "cuda":
        assert {k: launches[k] for k in want} == want, (launches, want)

    # arm (b): two ranks over gloo on the same card, in processes of their own
    world = 2
    spec = json.dumps({"device": device, "overrides": overrides})
    procs = []
    for rank in range(world):
        logf = open(os.path.join(tmp, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--zero-dp-worker",
             str(rank), str(world), tmp, "--seed", str(seed),
             "--zero-dp-spec", spec], stdout=logf, stderr=subprocess.STDOUT),
            logf))
    t0 = time.perf_counter()
    deadline = time.monotonic() + ZERO_DP_TIMEOUT
    try:
        for rank, (proc, logf) in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"train_zero_dp: rank {rank} still running "
                                   f"after {ZERO_DP_TIMEOUT} s")
            if rc != 0:
                with open(os.path.join(tmp, f"rank{rank}.log")) as fh:
                    tail = "".join(fh.readlines()[-40:])
                raise RuntimeError(f"train_zero_dp: rank {rank} exited {rc}:\n"
                                   f"{tail}")
    finally:
        for proc, logf in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logf.close()
    wall = time.perf_counter() - t0
    results = []
    for rank in range(world):
        with open(os.path.join(tmp, f"rank{rank}.json")) as fh:
            results.append(json.load(fh))
    os.remove(os.path.join(tmp, "ref_master.pt"))
    log(f"[train_zero_dp] (b) gloo world 2 on one {device}: the two ranks "
        f"took {wall:.1f} s (process start and model builds included); "
        f"gloo with CUDA tensors (torch {torch.__version__}), each op "
        f"called natively: {results[0]['table']}; the comm layer's "
        f"all_gather / reduce_scatter exact: {results[0]['exact']}")
    total = dict.fromkeys(want, 0)
    for k in want:
        total[k] += launches[k]
    for stage in ZERO_DP_STAGES:
        per = [r["stages"][str(stage)] for r in results]
        losses, norms = per[0]["losses"], per[0]["norms"]
        assert all(p["losses"] == losses and p["norms"] == norms
                   for p in per), stage
        gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        norm_gap = max(abs(a - b) / abs(b) for a, b in zip(norms, ref_norms))
        masters = [p["master_gap_norm"] / update for p in per]
        lines = []
        for rank, p in enumerate(per):
            b, w = p["bytes"], p["predicted"]
            rel = {k: abs(b[k] - w[k]) / max(w[k], 1) for k in w}
            lines.append(f"rank {rank} " + ", ".join(
                f"{k} {b[k]} (predicted {w[k]})" for k in w))
            assert max(rel.values()) <= ZERO_DP_BYTES_RTOL, (stage, rank, rel)
            if device == "cuda":
                assert p["launches"] == p["want"], (stage, rank, p)
            for k in want:
                total[k] += p["launches"][k]
        log(f"[train_zero_dp] (b) stage {stage}: losses {losses} vs (a) "
            f"{ref_losses}: rel gap {gap:.3g} (tol {ZERO_DP_LOSS_RTOL}); "
            f"pre-clip grad norms {norms}: rel gap {norm_gap:.3g} (tol "
            f"{ZERO_DP_NORM_RTOL}); gathered final masters against (a)'s: "
            f"gap norm / update norm {masters[0]:.3g} / {masters[1]:.3g} "
            f"(ranks 0 / 1, tol {ZERO_DP_UPDATE_RTOL}), max abs gap "
            f"{per[0]['master_gap_max']:.3g}; bytes at rest "
            f"{'; '.join(lines)}; the last step's collectives (rank 0): "
            f"{comms_table(per[0]['comms'])}; a step with the comms logger "
            f"off {per[0]['step_ms']:.1f} / {per[1]['step_ms']:.1f} ms, on "
            f"(a device sync after every collective) "
            f"{per[0]['logged_ms']:.1f} / {per[1]['logged_ms']:.1f} ms "
            f"(ranks 0 / 1) on {card}; gathered blocks alive at most "
            f"{per[0]['max_live_blocks']}")
        assert gap <= ZERO_DP_LOSS_RTOL, (stage, losses, ref_losses)
        assert norm_gap <= ZERO_DP_NORM_RTOL, (stage, norms, ref_norms)
        assert max(masters) <= ZERO_DP_UPDATE_RTOL, (stage, masters)
        # at GPT-2 medium's widths stage 3 shards every block's weights (a
        # narrow rehearsal's all sit under the persistence threshold)
        live = per[0]["max_live_blocks"]
        if stage == 3 and (device == "cuda" or live is not None):
            assert live is not None and 1 <= live <= 2, per[0]
    # arm (c): tensor-parallel training in the same two processes
    per = [r["tp"] for r in results]
    c = per[0]
    assert all(p["losses"] == c["losses"] and p["norms"] == c["norms"]
               for p in per), [p["losses"] for p in per]
    gap = max(abs(a - b) / abs(b) for a, b in zip(c["losses"], ref_losses))
    norm_gap = max(abs(a - b) / abs(b) for a, b in zip(c["norms"],
                                                        ref_norms))
    for rank, p in enumerate(per):
        assert p["mp"] == world and p["params"] == p["params_want"], \
            (rank, p["mp"], p["params"], p["params_want"])
        assert p["bytes"] == p["predicted"], (rank, p["bytes"],
                                              p["predicted"])
        assert p["micro_comms"] == p["micro_want"], \
            (rank, p["micro_comms"], p["micro_want"])
        if device == "cuda":
            assert p["launches"] == p["want"], (rank, p["launches"],
                                                p["want"])
        for k in want:
            total[k] += p["launches"][k]
    log(f"[train_zero_dp] (c) tensor parallel, (data, model) = (1, {world}), "
        f"two gloo ranks on one {device}, ZeRO 2 (at data 1 it shards "
        f"nothing), micro {MICRO_BS} x gas {gas}, {c['heads']} heads a "
        f"rank: losses {c['losses']} vs (a) {ref_losses}: rel gap "
        f"{gap:.3g} (tol {TP_LOSS_RTOL}); pre-clip grad norms "
        f"{c['norms']}: rel gap {norm_gap:.3g} (tol {TP_NORM_RTOL}); both "
        f"ranks alike; a rank's parameters {c['params']} (computed from the "
        f"widths {c['params_want']}; the whole model "
        f"{tp_rank_params(cfg, 1)}); bytes at rest {c['bytes']} (predicted "
        f"{c['predicted']}); one micro-batch's collectives "
        f"{c['micro_comms']} (predicted {c['micro_want']}: 4 a layer and "
        f"1 recomputed); the last step's collectives (rank 0): "
        f"{comms_table(c['comms'])}; a step with the comms logger off "
        f"{per[0]['step_ms']:.1f} / {per[1]['step_ms']:.1f} ms, on "
        f"{per[0]['logged_ms']:.1f} / {per[1]['logged_ms']:.1f} ms (ranks "
        f"0 / 1) on {card}: gloo through the host on one card, the "
        f"placement and equality, not tensor parallelism's speed; flash "
        f"launches {c['launches']}")
    assert gap <= TP_LOSS_RTOL, (c["losses"], ref_losses)
    assert norm_gap <= TP_NORM_RTOL, (c["norms"], ref_norms)
    launches.update(total)
    return launches


# ---------------------------------------------------------------------------
# phases 21-22: the serving fleet
# ---------------------------------------------------------------------------
# a disaggregated arm's decode replica dies at this step of its own
FLEET_KILL_STEP = 60
# the router step of arm 3 at which the warmed decode replica joins
FLEET_ADD_STEP = 90
# requests the HTTP phase cancels by DELETE, after this many streamed tokens
HTTP_CANCEL_AFTER = 8


def serve_paged_traffic(seed: int, vocab: int):
    """``phase_serve_paged``'s traffic, drawn from the same generator after
    the same two warm-up prompts, for a run that skips that phase."""
    rng = np.random.default_rng(seed + 1)
    for n in (1000, 40):
        rng.integers(0, vocab, n)
    return shared_prefix_traffic(rng, vocab)


def fleet_replica(engine, role: str, seed: int):
    """A fleet replica on the shared engine, with ``serve_paged``'s
    settings (8 slots, chunk 64, ``PAGED_KV``) and a strict watchdog."""
    import deepspeed_tpu_torch as dst

    return dst.ServingEngine(engine, num_slots=8, prefill_chunk=64,
                             paged_kv=dict(PAGED_KV), seed=seed,
                             strict_recompile=True, role=role)


def colocated_arm(engine, seed: int, warm, prompts, budgets,
                  device: str = "cuda") -> dict:
    """``serve_paged`` captured (phase 3b's captured arm), for a run that
    skips it: one replica of the fleet's settings, warmed, then the traffic
    with the first request alone until it runs."""
    from deepspeed_tpu_torch.serving.metrics import ServingMetrics

    srv = fleet_replica(engine, "both", seed)
    warm_up(srv, warm)
    srv.end_warmup()
    srv.metrics = ServingMetrics(step_fn=lambda: srv.step_id)
    sync(device)
    reqs = drive(srv, prompts, budgets, first_alone=True)
    sync(device)
    assert srv.watchdog.recompiles == 0
    st = srv.stats()
    log(f"[serve_disagg] colocated reference (serve_paged captured, one "
        f"replica): {serve_line(st)}; TTFT p99 {st['ttft_p99_ms']:.2f} ms")
    return dict(reqs=reqs, stats=st)


def fleet_warm(router, warm) -> None:
    """Warm every replica: a colocated one serves the waves alone, a split
    fleet serves them through the router (its decode replicas capture
    their steps on the handoffs); then every trie is emptied, so the
    measured pass starts from the pools a fresh server has, and the
    watchdogs are armed."""
    if all(role == "both" for role in router.roles):
        for rep in router.replicas:
            warm_up(rep, warm)
    else:
        for wave in warm:
            for p in wave:
                router.submit(p, max_new_tokens=4)
            router.run_until_drained()
        for rep in router.replicas:
            warm_up(rep, [])
    router.end_warmup()


class TransferWatch:
    """Wraps each decode-capable replica's ``adopt`` for the measured pass:
    records every transfer's stats and its device time (CUDA events around
    it, read after the pass), and holds the destination pages equal to the
    source pages, every leaf, for the first transfer and the first
    prefix-affine one (before ``finish_handoff`` releases the source)."""

    def __init__(self, device: str):
        self.device = device
        self.stats, self.events, self.held = [], [], []

    def attach(self, rep) -> None:
        real = rep.adopt

        def adopt(req, src):
            spool, pool = src.pool, rep.pool
            n = -(-int(spool.starts[req.slot]) // spool.page_size)
            src_pages = [int(p) for p in spool.table[req.slot, :n]]
            ev = None
            if self.device == "cuda":
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            st = real(req, src)
            if ev is not None:
                ev[1].record()
                self.events.append(ev)
            self.stats.append(st)
            kind = ("first" if not self.held else
                    "prefix-affine" if st["hit_pages"] and
                    all(k != "prefix-affine" for k, _ in self.held) else None)
            if kind is not None:
                dst_pages = [int(p) for p in pool.table[req.slot, :n]]
                for name, leaf in spool.cache.items():
                    assert torch.equal(leaf[:, src_pages],
                                       pool.cache[name][:, dst_pages]), \
                        f"{kind} transfer: destination {name} pages differ " \
                        f"from the source's"
                self.held.append((kind, n))
            return st

        rep.adopt = adopt

    def device_ms(self) -> list:
        return [a.elapsed_time(b) for a, b in self.events]


def prefill_decode_launches(rep, counter: dict):
    """Wrap a prefill replica's ``step`` to add the paged decode kernel's
    launches made inside it to ``counter["n"]``."""
    from deepspeed_tpu_torch.ops.attention.paged_attention import \
        paged_decode_attention

    real = rep.step

    def step():
        before = paged_decode_attention.launches
        try:
            return real()
        finally:
            counter["n"] += paged_decode_attention.launches - before

    rep.step = step


def pct(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q)) \
        if len(values) else float("nan")


def hold_fleet_tokens(label: str, reqs, colocated, touched, engine,
                      ref) -> dict:
    """Every request's greedy tokens against the colocated captured run's:
    identical, except that a request a failover re-homed (``touched``)
    re-prefilled its generated tokens through the chunked path, whose
    other products round otherwise in bf16, so it may part at a near-tie
    (``divergences``, as ``serve_resilience`` holds its preempted
    requests)."""
    differ = [i for i, (r, c) in enumerate(zip(reqs, colocated))
              if not np.array_equal(r.tokens(), c.tokens())]
    wrong = [reqs[i].request_id for i in differ if i not in touched]
    assert not wrong, f"{label}: tokens differ from the colocated captured " \
        f"run's for requests {wrong} (none of them re-homed by a failover)"
    if differ:
        return divergences(label, [reqs[i] for i in differ],
                           [colocated[i] for i in differ], engine, ref,
                           against="the colocated captured run")
    return dict(same=len(reqs), n=len(reqs), worst=0.0, rows=[])


def fleet_arm(label: str, router, prompts, budgets, colocated_reqs,
              engine, ref, seed: int, device: str = "cuda",
              kill: int = None, spare=None) -> dict:
    """Serve the traffic through ``router`` (warmed) with the first request
    alone until it runs; ``kill``: a decode replica whose step raises (the
    ported ``FaultInjector``, ``step_host_error``) at its
    ``FLEET_KILL_STEP``-th step; ``spare``: a warmed decode replica joined
    with ``add_replica`` at router step ``FLEET_ADD_STEP``. Holds tokens,
    launches, page bits, recompiles, in-flight transfers and leaks;
    returns the arm's numbers."""
    from deepspeed_tpu_torch.serving import FaultInjector, ServingMetrics
    from deepspeed_tpu_torch.serving.request import RequestState

    for rep in router.replicas + ([spare] if spare is not None else []):
        rep.metrics = ServingMetrics(registry=rep.registry,
                                     step_fn=lambda rep=rep: rep.step_id)
    if kill is not None:
        router.replicas[kill].faults = FaultInjector(
            seed=seed, schedule={"step_host_error": [FLEET_KILL_STEP]})
    watch = TransferWatch(device)
    for i in router.decode_capable:
        watch.attach(router.replicas[i])
    if spare is not None:
        watch.attach(spare)
    prefill_launches = {"n": 0}
    for i in router.alive_replicas:
        if router.roles[i] == "prefill":
            prefill_decode_launches(router.replicas[i], prefill_launches)
    gaps, steps = [], 0

    def step():
        nonlocal steps
        running = any(router.replicas[i]._running_count()
                      for i in router.decode_capable)
        t0 = time.perf_counter()
        router.step()
        wall = time.perf_counter() - t0
        steps += 1
        if running:
            gaps.append(wall)
        assert router.fleet_topology()["transfers_in_flight"] == 0, \
            f"{label}: a transfer in flight at a step boundary"
        if spare is not None and steps == FLEET_ADD_STEP:
            router.add_replica(spare, "decode")

    sync(device)
    reset_launches()
    t0 = time.perf_counter()
    reqs = [router.submit(prompts[0], max_new_tokens=int(budgets[0]))]
    while reqs[0].state in (RequestState.QUEUED, RequestState.PREFILLING):
        step()
    reqs += [router.submit(p, max_new_tokens=int(n))
             for p, n in zip(prompts[1:], budgets[1:])]
    while router.has_work():
        step()
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    bad = [(r.request_id, r.state.value, len(r.output_tokens), int(n))
           for r, n in zip(reqs, budgets)
           if r.state is not RequestState.FINISHED
           or len(r.output_tokens) != n]
    assert not bad, f"{label}: requests not FINISHED with their budget: {bad}"
    router.check_invariants()
    touched = {i for i, r in enumerate(reqs)
               if any(h["kind"] == "failover"
                      for h in router.journey(r.journey_id)["hops"])}
    if kill is None:
        assert router.alive_replicas == list(range(router.num_replicas)), \
            f"{label}: replicas died: {router.stats()['alive']}"
    else:
        assert router.alive_replicas == [i for i in range(router.num_replicas)
                                         if i != kill], \
            f"{label}: alive {router.alive_replicas}, want all but {kill}"
        assert router.replicas[kill].faults.fired.get("step_host_error") \
            == 1 and router.failovers > 0 and touched
    if spare is not None:
        assert spare in router.replicas, f"{label}: the spare never joined"
    # zero recompiles on every replica, the dead and the added included
    recompiles = {i: rep.watchdog.recompiles
                  for i, rep in enumerate(router.replicas)}
    assert not any(recompiles.values()), \
        f"{label}: recompiles after warmup {recompiles}: " \
        f"{[e for rep in router.replicas for e in rep.watchdog.events if not e['warmup']][:3]}"
    for i in router.alive_replicas:
        rep = router.replicas[i]
        pool = rep.pool
        held = len(pool.prefix.page_counts())
        assert (pool.table == pool.num_pages).all() and \
            pool.free_page_count + held == pool.num_pages and \
            pool.free_count == pool.num_slots, \
            f"{label}: replica {i} leaked: {pool.free_page_count} free + " \
            f"{held} cached != {pool.num_pages}, {pool.free_count} free slots"
    L = engine.module.config.n_layer
    dsteps = sum(router.replicas[i].stats()["decode_steps"]
                 for i in range(router.num_replicas)
                 if router.roles[i] != "prefill")
    assert launches["paged_decode_attention"] >= L * dsteps, \
        f"{label}: paged kernel ran {launches['paged_decode_attention']} " \
        f"times in {dsteps} decode steps with live rows"
    assert launches["flash_attention_fwd"] > 0, \
        f"{label}: no whole-prompt admission ran the flash kernel"
    assert prefill_launches["n"] == 0, \
        f"{label}: {prefill_launches['n']} paged decode launches on a " \
        f"prefill replica"
    split = any(role == "prefill" for role in router.roles)
    if split:
        assert router.transfers >= len(reqs) and \
            router.transfer_pages_saved > 0, \
            f"{label}: {router.transfers} transfers, " \
            f"{router.transfer_pages_saved} trie-hit pages skipped"
        assert [k for k, _ in watch.held] == ["first", "prefix-affine"], \
            f"{label}: page bits held for {watch.held}"
    tokens = hold_fleet_tokens(label, reqs, colocated_reqs, touched,
                               engine, ref)
    new = sum(len(r.output_tokens) for r in reqs)
    ttft = [r.ttft * 1e3 for r in reqs]
    out = dict(label=label, router=router, reqs=reqs, launches=launches,
               wall=wall, tokens_per_s=new / wall, new_tokens=new,
               ttft_p50_ms=pct(ttft, 50), ttft_p99_ms=pct(ttft, 99),
               gap_p50_ms=pct(gaps, 50) * 1e3,
               gap_p99_ms=pct(gaps, 99) * 1e3, steps=steps,
               decode_steps=dsteps, touched=len(touched), tokens=tokens)
    if split:
        host_ms = [st["seconds"] * 1e3 for st in watch.stats]
        dev_ms = watch.device_ms() if device == "cuda" else []
        moved = sum(st["pages"] for st in watch.stats)
        nbytes = sum(st["bytes"] for st in watch.stats)
        out.update(transfers=len(watch.stats), pages_moved=moved,
                   pages_skipped=router.transfer_pages_saved,
                   bytes=nbytes, page_bytes=router.replicas[0].pool.page_nbytes,
                   host_ms_p50=pct(host_ms, 50), host_ms_p99=pct(host_ms, 99),
                   device_ms_p50=pct(dev_ms, 50),
                   device_ms_p99=pct(dev_ms, 99), bits_held=watch.held)
    return out


def fleet_line(arm: dict) -> str:
    line = (f"tokens/s {arm['tokens_per_s']:.1f}; TTFT p50 "
            f"{arm['ttft_p50_ms']:.2f} ms p99 {arm['ttft_p99_ms']:.2f} ms; "
            f"step gap p50 {arm['gap_p50_ms']:.2f} ms p99 "
            f"{arm['gap_p99_ms']:.2f} ms ({arm['new_tokens']} tokens, "
            f"{arm['steps']} router steps, {arm['decode_steps']} decode "
            f"steps)")
    if "transfers" in arm:
        line += (f"; {arm['transfers']} transfers, {arm['pages_moved']} "
                 f"pages moved, {arm['pages_skipped']} trie-hit pages "
                 f"skipped, {arm['bytes']} bytes ({arm['page_bytes']} a "
                 f"page); a transfer {arm['host_ms_p50']:.3f} / "
                 f"{arm['host_ms_p99']:.3f} ms host (p50 / p99), "
                 f"{arm['device_ms_p50']:.4f} / {arm['device_ms_p99']:.4f} "
                 f"ms on the stream between events around adopt (the card "
                 f"waits there on the host's work too); page bits held on "
                 f"{arm['bits_held']}")
    return line


def transfer_probe(src, dst, pages: int, reps: int = 20) -> dict:
    """One ``pages``-page cross-pool transfer on the card, by CUDA events
    (gather, scatter and the index uploads), beside its bound: the pages
    read and written by the gather and again by the scatter."""
    ids = [src.pool.alloc_page() for _ in range(pages)]
    out = []
    for _ in range(reps + 2):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        got = dst.pool.import_pages(src.pool, ids)
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
        dst.pool.unref_pages(got)
    src.pool.unref_pages(ids)
    ms = float(np.median(out[2:]))
    nbytes = pages * src.pool.page_nbytes
    b = bound(4 * nbytes, 0.0)
    return dict(ms=ms, bytes=nbytes, gbps=nbytes / (ms / 1e3) / 1e9, **b)


def phase_serve_disagg(model, seed: int, warm, prompts, budgets,
                       colocated: dict, eager_engine, ref,
                       device: str = "cuda") -> dict:
    """Phase 21: GPT-2 small served by a fleet whose replicas share one
    captured engine (``init_serving(..., role=...)`` for the first, the
    rest ``ServingEngine``s on its engine) behind a ``ReplicaRouter``, each
    replica with ``serve_paged``'s settings: (1) a prefill and a decode
    replica, (2) two colocated replicas (prefix affinity), (3) a prefill
    and two decode replicas, one killed mid-run by a ``FaultInjector``
    and a warmed decode replica added with ``add_replica``. The traffic
    and the reference tokens are ``serve_paged``'s captured run's."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.serving import ReplicaRouter

    first = dst.init_serving(model, config={"dtype": "bfloat16",
                                            "enable_cuda_graph": True},
                             num_slots=8, prefill_chunk=64,
                             paged_kv=dict(PAGED_KV), seed=seed,
                             strict_recompile=True, role="prefill",
                             device=device)
    engine = first.engine
    col = colocated["reqs"]
    arms = {}

    def run(label, roles, **kw):
        t_arm = time.perf_counter()
        reps = [first if (i == 0 and label == "disaggregated")
                else fleet_replica(engine, role, seed)
                for i, role in enumerate(roles)]
        router = ReplicaRouter(reps)
        fleet_warm(router, warm)
        spare = None
        if kw.pop("spare", False):
            spare = fleet_replica(engine, "decode", seed)
            warm_up(spare, warm)
        arm = fleet_arm(f"serve_disagg {label}", router, prompts, budgets,
                        col, eager_engine, ref, seed, device, spare=spare,
                        **kw)
        log(f"[serve_disagg] {label} ({'/'.join(roles)}"
            f"{' + a decode replica added' if spare is not None else ''}): "
            f"{fleet_line(arm)}; tokens identical to the colocated captured "
            f"run's for {arm['tokens']['same']} of {arm['tokens']['n']} "
            f"requests ({arm['touched']} re-homed by a failover); 0 "
            f"recompiles after warmup on {router.num_replicas} replicas; "
            f"no leak; launches {arm['launches']}; the arm took "
            f"{time.perf_counter() - t_arm:.1f} s")
        arms[label] = arm
        return router

    pair = run("disaggregated", ["prefill", "decode"])
    run("two colocated", ["both", "both"])
    run("failover + elastic", ["prefill", "decode", "decode"], kill=2,
        spare=True)
    st = colocated["stats"]
    log(f"[serve_disagg] beside serve_paged captured (one replica): "
        f"{serve_line(st)}, TTFT p99 {st['ttft_p99_ms']:.2f} ms")
    probe = transfer_probe(pair.replicas[0], pair.replicas[1], 12) \
        if device == "cuda" else None
    if probe is not None:
        log(f"[serve_disagg] a 12-page transfer (a cold 768-token prompt) "
            f"alone: {probe['ms']:.4f} ms device, {probe['bytes']} bytes "
            f"at {probe['gbps']:.1f} GB/s; bound {probe['bound_ms']:.4f} ms "
            f"({probe['bound_by']}: gather and scatter each read and write "
            f"the pages)")
    return dict(arms=arms, router=pair, probe=probe)


async def sse_client(port: int, prompt, budget: int, t_zero: float,
                     cancel_after=None) -> dict:
    """One ``POST /v1/generate`` over stdlib asyncio streams: the streamed
    tokens with their arrival times; with ``cancel_after``, a ``DELETE
    /v1/requests/{id}`` on a second connection once that many tokens
    arrived."""
    import asyncio

    body = json.dumps({"prompt": [int(t) for t in prompt],
                       "max_new_tokens": int(budget)}).encode()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    sent = time.perf_counter()
    writer.write(b"POST /v1/generate HTTP/1.1\r\nHost: smoke\r\n"
                 + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200"), head[:80]
    out = dict(tokens=[], times=[], terminal=[], sent=sent - t_zero)
    while True:
        try:
            block = await reader.readuntil(b"\n\n")
        except asyncio.IncompleteReadError:
            break
        event, data = None, None
        for line in block.decode().strip().split("\n"):
            if line.startswith("event: "):
                event = line[7:]
            elif line.startswith("data: "):
                data = json.loads(line[6:])
        if event == "start":
            out["request_id"] = data["request_id"]
        elif event == "token":
            out["tokens"].append(data["token"])
            out["times"].append(time.perf_counter() - t_zero)
            if cancel_after is not None and \
                    len(out["tokens"]) == cancel_after:
                r2, w2 = await asyncio.open_connection("127.0.0.1", port)
                w2.write(f"DELETE /v1/requests/{out['request_id']} "
                         f"HTTP/1.1\r\nHost: smoke\r\nContent-Length: 0"
                         f"\r\n\r\n".encode())
                await w2.drain()
                out["delete"] = (await r2.read()).split(b" ")[1]
                w2.close()
                await w2.wait_closed()
        else:
            out["terminal"].append(data)
    writer.close()
    await writer.wait_closed()
    return out


async def http_get(port: int, path: str) -> tuple:
    import asyncio

    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: smoke\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ")[1]), body.decode()


def phase_serve_http(fleet: dict, prompts, budgets,
                     device: str = "cuda") -> dict:
    """Phase 22: ``ServingFrontend`` on 127.0.0.1:0 over an
    ``AsyncEngineBridge`` over phase 21's disaggregated router (warmed).
    16 SSE clients on stdlib asyncio streams (the event loop's thread makes
    no CUDA call: the bridge's step thread alone touches the card) send
    the traffic, the first alone until its first token; one is cancelled
    by DELETE mid-stream; then ``/healthz`` and ``/metrics``, and
    ``stop(drain=True)``."""
    import asyncio

    from deepspeed_tpu_torch.serving import ServingFrontend

    arm = fleet["arms"]["disaggregated"]
    router = arm["router"]
    want = {i: r.output_tokens for i, r in enumerate(arm["reqs"])}
    cancel = int(np.argmax(budgets[1:])) + 1     # the longest stream
    for rep in router.replicas:
        warm_up(rep, [])          # arm 1's pages out of the tries
    fe = ServingFrontend(router, host="127.0.0.1", port=0,
                         idle_poll_s=0.002)

    async def main():
        await fe.start()
        try:
            t_zero = time.perf_counter()
            first = asyncio.ensure_future(sse_client(
                fe.port, prompts[0], budgets[0], t_zero))
            await fe.bridge.call(lambda r: None)
            # the first stream runs alone until its first token
            while True:
                got = await fe.bridge.call(
                    lambda r: len(router._tracked) and
                    next(iter(router._tracked.values())).output_tokens)
                if got:
                    break
            rest = [sse_client(fe.port, p, n, t_zero,
                               HTTP_CANCEL_AFTER if i == cancel else None)
                    for i, (p, n) in enumerate(zip(prompts, budgets))
                    if i > 0]
            results = [await first] + list(await asyncio.gather(*rest))
            wall = time.perf_counter() - t_zero
            health = await http_get(fe.port, "/healthz")
            metrics = await http_get(fe.port, "/metrics")
            recompiles = await fe.bridge.call(
                lambda r: {i: rep.watchdog.recompiles
                           for i, rep in enumerate(r.replicas)})
        finally:
            await fe.stop(drain=True)
        return results, wall, health, metrics, recompiles

    results, wall, health, metrics, recompiles = asyncio.run(
        asyncio.wait_for(main(), 600))
    for i, res in enumerate(results):
        assert len(res["terminal"]) == 1, \
            f"serve_http: stream {i} ended with {res['terminal']}"
        term = res["terminal"][0]
        if i == cancel:
            assert res["delete"] == b"200" and term["event"] == "done" \
                and term["reason"] == "cancelled", \
                f"serve_http: the cancelled stream ended with {term}"
            assert res["tokens"] == want[i][:len(res["tokens"])]
        else:
            assert term["reason"] == "length" and res["tokens"] == want[i], \
                f"serve_http: stream {i} differs from serve_disagg's " \
                f"disaggregated arm ({term})"
    hstatus, hbody = health
    info = json.loads(hbody)
    assert hstatus == 200 and info["fleet"]["counts"] == {
        "prefill": 1, "decode": 1, "both": 0} and \
        info["fleet"]["transfers_in_flight"] == 0, info.get("fleet")
    mstatus, mtext = metrics
    assert mstatus == 200 and 'replica="0",role="prefill"' in mtext and \
        'replica="1",role="decode"' in mtext, "serve_http: /metrics labels"
    assert not any(recompiles.values()), f"serve_http: {recompiles}"
    rid = results[cancel]["request_id"]
    for rep in router.replicas:
        assert all(r.request_id != rid for r in rep._slot_req.values())
        pool = rep.pool
        held = len(pool.prefix.page_counts())
        assert (pool.table == pool.num_pages).all() and \
            pool.free_page_count + held == pool.num_pages and \
            pool.free_count == pool.num_slots, "serve_http: a leak"
    router.check_invariants()
    ttft = [(r["times"][0] - r["sent"]) * 1e3 for r in results]
    gaps = [(b - a) * 1e3 for r in results
            for a, b in zip(r["times"], r["times"][1:])]
    new = sum(len(r["tokens"]) for r in results)
    out = dict(tokens_per_s=new / wall, ttft_p50_ms=pct(ttft, 50),
               ttft_p99_ms=pct(ttft, 99), gap_p50_ms=pct(gaps, 50),
               gap_p99_ms=pct(gaps, 99), new_tokens=new)
    log(f"[serve_http] 16 SSE clients over the disaggregated fleet: "
        f"tokens/s {out['tokens_per_s']:.1f}; client TTFT p50 "
        f"{out['ttft_p50_ms']:.2f} ms p99 {out['ttft_p99_ms']:.2f} ms; "
        f"inter-token gap p50 {out['gap_p50_ms']:.2f} ms p99 "
        f"{out['gap_p99_ms']:.2f} ms ({new} tokens in {wall:.2f} s); in "
        f"process (serve_disagg disaggregated): {fleet_line(arm)}; streamed "
        f"tokens equal serve_disagg's; stream {cancel} cancelled after "
        f"{HTTP_CANCEL_AFTER} tokens with one terminal 'cancelled' event, "
        f"its slot and pages free; /healthz fleet {info['fleet']['counts']}, "
        f"/metrics labelled; 0 recompiles; no leak after stop(drain=True)")
    return out


def fleet_phases(model, seed: int, warm, prompts, budgets, colocated,
                 eager_engine, ref, device: str = "cuda") -> list:
    """Phases 21-22; returns the launches of the fleet's arms."""
    t0 = time.perf_counter()
    fleet = phase_serve_disagg(model, seed, warm, prompts, budgets,
                               colocated, eager_engine, ref, device)
    phase_serve_http(fleet, prompts, budgets, device)
    log(f"[serve_disagg] phases 21-22 took {time.perf_counter() - t0:.1f} s")
    return [arm["launches"] for arm in fleet["arms"].values()]


# ---------------------------------------------------------------------------
# phase 24: tensor-parallel serving
# ---------------------------------------------------------------------------
TP_WORLD = 2
TP_TIMEOUT = 600                  # seconds for arm (b)'s two ranks
TP_FP32_LAYERS = 2
TP_FP32_BUDGET = 8
# the projections every rank holds a slice of; every other leaf (the norms)
# is whole on every rank
TP_SHARDED = ("embed_tokens", "q_proj", "k_proj", "v_proj", "o_proj",
              "gate_proj", "up_proj", "down_proj", "lm_head")


def tp_traffic(seed: int, vocab: int):
    """Phase 24's 8 requests: 4 on one 512-token prefix (16-64 more
    tokens each), 4 cold (two of 32-64 tokens, admitted whole through the
    flash kernel, two of 65-256), budgets 16-32; the first is a shared
    one (it runs before the rest arrive)."""
    rng = np.random.default_rng(seed + 24)
    prefix = rng.integers(0, vocab, 512)
    shared = [np.concatenate([prefix, rng.integers(0, vocab, int(n))])
              for n in rng.integers(16, 65, 4)]
    cold = [rng.integers(0, vocab, int(n)) for n in
            list(rng.integers(32, 65, 2)) + list(rng.integers(65, 257, 2))]
    rest = shared[1:] + cold
    prompts = [shared[0]] + [rest[i] for i in rng.permutation(len(rest))]
    budgets = rng.integers(16, 33, len(prompts))
    return [p.astype(np.int32) for p in prompts], [int(b) for b in budgets]


def first_difference(a, b):
    """The first position where token lists ``a`` and ``b`` differ, else
    None."""
    return next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)


def tp_teacher(prompts, tokens, against) -> dict:
    """{request: the continuation to teacher-force}: the last shared
    prompt (served on the prefix cache) and the longest cold one through
    their first decode, and every request whose ``tokens`` part from
    ``against`` (the other arm's) through its first parted position."""
    shared = [i for i, p in enumerate(prompts) if len(p) > 512]
    cold = [i for i, p in enumerate(prompts) if len(p) <= 512]
    picks = {i: 1 for i in (shared[-1],
                            max(cold, key=lambda i: len(prompts[i])))}
    for i, (mine, other) in enumerate(zip(tokens, against or [])):
        d = first_difference(mine, other)
        if d is not None:
            picks[i] = max(picks.get(i, 0), d, 1)
    return {i: tokens[i][:n] for i, n in sorted(picks.items())}


def tinyllama_fp32(seed: int, device: str = "cuda", **overrides):
    """TinyLlama's widths at ``TP_FP32_LAYERS`` layers in fp32 with a
    full-precision cache, random from ``seed``."""
    from deepspeed_tpu_torch.models.transformer_lm import (
        TransformerLM, transformer_config)

    cfg = transformer_config("llama", **{**TINYLLAMA, **overrides,
                                         "n_layer": TP_FP32_LAYERS},
                             dtype=torch.float32)
    model = TransformerLM(cfg, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model


def tp_arm(model, state, tp: int, seed: int, prompts, budgets,
           device: str = "cuda", probes: bool = True, mesh=None,
           against=None) -> tuple:
    """One arm of phase 24: ``init_serving`` at ``tensor_parallel.tp_size``
    ``tp`` (``state``: the full weights on the host, sliced for this rank;
    None: the model's own), the default call (8 slots, chunk 64,
    ``PAGED_KV``), a throwaway server on the same engine to warm the
    shapes, then the traffic with the first request alone until it runs.
    Holds budgets, invariants and no leak; counts the group clock's reads
    a step (none at one rank). With ``probes``: the decode
    step's collectives (comms logger on, over one contiguous decode step),
    ``generate()`` through the decode kernel, and the teacher-forced
    logits of ``tp_teacher`` (``against``: the other arm's tokens).
    ``mesh`` is passed to ``init_serving``. Returns (a JSON-able dict, the
    server, the teacher-forced logits)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.serving.request import RequestState

    dtype = str(model.config.dtype).split(".")[-1]
    srv = dst.init_serving(
        model, config={"dtype": dtype, "tensor_parallel": {"tp_size": tp}},
        model_parameters=state, num_slots=8, prefill_chunk=64,
        paged_kv=dict(PAGED_KV), seed=seed, device=device, mesh=mesh)
    eng = srv.engine
    vocab = model.config.vocab_size
    rng = np.random.default_rng(seed + 25)
    warm = dst.ServingEngine(eng, num_slots=8, prefill_chunk=64,
                             paged_kv=dict(PAGED_KV), seed=seed)
    for n in (200, 40):
        warm.submit(rng.integers(0, vocab, n), max_new_tokens=2)
    warm.run_until_drained()
    del warm
    sync(device)
    reset_launches()
    t0 = time.perf_counter()
    reads = []      # the group clock's reads over the world, a step

    def step():
        r = getattr(srv._now, "reads", 0)
        srv.step()
        reads.append(getattr(srv._now, "reads", 0) - r)
        assert len(reads) < 20000, "serve_tp: the traffic did not drain"

    reqs = [srv.submit(prompts[0], max_new_tokens=budgets[0])]
    while reqs[0].state is not RequestState.RUNNING:
        step()
    reqs += [srv.submit(p, max_new_tokens=n)
             for p, n in zip(prompts[1:], budgets[1:])]
    while srv.scheduler.pending or srv._slot_req:
        step()
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    bad = [(r.request_id, r.state.value, len(r.output_tokens), n)
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
    out = dict(tokens=[list(map(int, r.output_tokens)) for r in reqs],
               wall=wall, new_tokens=st["new_tokens"],
               tokens_per_s=st["tokens_per_s"],
               gap_p50=st["step_gap_p50_ms"], gap_p99=st["step_gap_p99_ms"],
               ttft_p50=st["ttft_p50_ms"], decode_steps=st["decode_steps"],
               hit_tokens=st["prefix_hit_tokens"], launches=launches,
               param_bytes={k: t.numel() * t.element_size() for k, t in
                            eng.module.state_dict().items()},
               pool_bytes=sum(t.numel() * t.element_size()
                              for t in pool.cache.values()),
               kv_heads=int(pool.cache["k"].shape[2]), mp=eng.mp_world_size,
               clock_reads=dict(total=int(getattr(srv._now, "reads", 0)),
                                steps=len(reads), step_min=min(reads),
                                step_max=max(reads),
                                step_median=float(np.median(reads))))
    teacher = None
    if probes:
        # one contiguous decode step under the comms logger (it syncs the
        # device after every collective)
        ids = np.stack([p[:32] for p in prompts[-2:]])
        logits, cache = eng.prefill_at(ids)
        tok = logits[:, -1].argmax(-1)[:, None]
        sync(device)
        comm.configure(enabled=True, prof_all=True)
        comm.comms_logger.reset()
        t0 = time.perf_counter()
        eng.decode(cache, tok, 32)
        sync(device)
        out["decode_step_ms"] = 1e3 * (time.perf_counter() - t0)
        out["decode_comms"] = {name: {"count": v["count"],
                                      "bytes": v["bytes"],
                                      "ms": 1e3 * v["latency_s"]}
                               for name, v in
                               comm.comms_logger.totals().items()}
        comm.configure(enabled=False)
        comm.comms_logger.reset()
        del cache
        reset_launches()
        out["generate"] = eng.generate(ids, max_new_tokens=8).tolist()
        out["generate_launches"] = read_launches()
        teacher = {i: served_paged_logits(srv, prompts[i], cont).float().cpu()
                   for i, cont in tp_teacher(prompts, out["tokens"],
                                             against).items()}
    return out, srv, teacher


def tp_gpt2_model(seed: int, device: str = "cuda",
                  dtype=torch.bfloat16, **overrides):
    """GPT-2 small at its published widths (openai-community/gpt2
    config.json) as the port's ``GPT2LMHeadModel``: the fused qkv that a
    model group splits per head, the tied head over the whole 50257-token
    vocabulary (which 2 does not divide), flash attention; random weights
    from ``seed``, ``overrides`` narrowing it for a CPU rehearsal."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel

    cfg = GPT2Config(**{**dict(vocab_size=50257, n_positions=1024,
                               n_embd=768, n_layer=12, n_head=12,
                               dtype=dtype, use_flash_attention=True),
                        **overrides})
    model = GPT2LMHeadModel(cfg, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model


def tp_gpt2_prompts(seed: int, vocab: int) -> np.ndarray:
    """4 prompts of 64 tokens for GPT-2 small's ``forward``."""
    rng = np.random.default_rng(seed + 26)
    return rng.integers(0, vocab, (4, 64)).astype(np.int32)


def tp_gpt2_arm(model, state, tp: int, ids, device: str = "cuda",
                mesh=None) -> tuple:
    """GPT-2 small (``model``: :func:`tp_gpt2_model`'s; ``state`` its full
    weights on the host, None: its own) through ``init_inference`` at
    ``tensor_parallel.tp_size`` ``tp``: the (B, T, V) fp32 logits of
    ``forward(ids)`` on the host (GPT-2 has no KV cache, so no
    ``generate()``, in either package: ``forward`` is its serving call),
    the kernels' launches in it, and the engine."""
    import deepspeed_tpu_torch as dst

    eng = dst.init_inference(
        model, config={"dtype": "bfloat16",
                       "tensor_parallel": {"tp_size": tp}},
        model_parameters=state, device=device, mesh=mesh)
    reset_launches()
    logits = eng.forward(ids).float().cpu()
    return logits, read_launches(), eng


def gpt2_fp32_copy(model, device: str = "cuda"):
    """An fp32 copy of ``model``'s GPT-2 weights with plain attention."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel

    ref = GPT2LMHeadModel(dataclasses.replace(
        model.config, dtype=torch.float32, use_flash_attention=False),
        device=device)
    with torch.no_grad():
        ref.load_state_dict({k: v.float()
                             for k, v in model.state_dict().items()})
    return ref.eval()


# serve_tp's key arms (d)-(i): every serving key above one rank of a model
# group, at TinyLlama's widths and TP_KEYS_LAYERS layers (the depth keeps
# the lap inside the smoke's limit: what they hold is placement and
# equality, which the depth does not change)
TP_KEYS_LAYERS = 2
TP_KEYS_BUDGET = 24               # serve_paged's budgets, capped
TP_KEYS_SPEC = {"drafter": "ngram", "k": 4}
TP_DM = (2, 2)                    # arm (i)'s (data, model) mesh
TP_STORAGE_REST = 0.6             # a rank's storage-tier bytes / one rank's
TP_DEADLINE_MS = 400.0            # arm (g): every eighth request's deadline


def tp_keys_traffic(seed: int, vocab: int):
    """serve_paged's 16 prompts (8 on a 512-token prefix), budgets capped
    at ``TP_KEYS_BUDGET``."""
    prompts, budgets = serve_paged_traffic(seed, vocab)
    return ([np.asarray(p, np.int32) for p in prompts],
            [min(int(b), TP_KEYS_BUDGET) for b in budgets])


def tp_spec_traffic(seed: int, vocab: int):
    """Arm (d)'s 16 prompts: motif-tiled (``motif_traffic``, the spec
    phases' traffic), so the n-gram drafter finds something to propose,
    budgets capped at ``TP_KEYS_BUDGET``."""
    prompts, budgets = motif_traffic(np.random.default_rng(seed + 28),
                                     vocab, 16)
    return prompts, [min(b, TP_KEYS_BUDGET) for b in budgets]


def tp_keys_server(eng, seed: int, **kw):
    """serve_paged's settings (8 slots, chunk 64, ``PAGED_KV``) on ``eng``,
    with ``kw`` (``paged_kv=False``: the contiguous pool)."""
    import deepspeed_tpu_torch as dst

    return dst.ServingEngine(eng, **{**dict(
        num_slots=8, prefill_chunk=64, paged_kv=dict(PAGED_KV), seed=seed,
        max_queue_depth=64), **kw})


def tp_keys_serve(srv, prompts, budgets) -> list:
    """Every prompt submitted, drained and audited: each request finished
    with its budget, the invariants hold, no slot or page leaked (over a
    router, on every replica). Returns the requests."""
    from deepspeed_tpu_torch.serving.request import RequestState

    reqs = [srv.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    srv.run_until_drained()
    srv.check_invariants()
    bad = [(r.request_id, r.state.value, len(r.output_tokens), n)
           for r, n in zip(reqs, budgets)
           if r.state is not RequestState.FINISHED
           or len(r.output_tokens) != n]
    assert not bad, f"requests not FINISHED with their budget: {bad}"
    for s in getattr(srv, "replicas", [srv]):
        pool = s.pool
        held = len(pool.prefix.page_counts()) \
            if getattr(pool, "prefix", None) else 0
        pages = pool.free_page_count + held == pool.num_pages \
            if hasattr(pool, "free_page_count") else True
        assert pages and pool.free_count == pool.num_slots, "leaked"
    return reqs


def tokens_of(reqs) -> list:
    return [list(map(int, r.output_tokens)) for r in reqs]


def tp_clocked_traffic(prompts, budgets) -> list:
    """Arm (g)'s arrivals, ``(step, prompt, submit keywords)``: one every
    other step, the classes of ``PRIORITY`` in turns, every eighth on a
    ``TP_DEADLINE_MS`` deadline."""
    classes = PRIORITY["classes"]
    return [(2 * i, p, dict(max_new_tokens=n, priority=classes[i % 2],
                            **({"deadline_ms": TP_DEADLINE_MS}
                               if i % 8 == 7 else {})))
            for i, (p, n) in enumerate(zip(prompts, budgets))]


def tp_clocked_arm(eng, seed: int, traffic, clock=None,
                   record: bool = False) -> dict:
    """Arm (g): serve_resilience's keys (the degradation ladder, pressure
    preemption, priority classes, the SLO tracker, the numerics guard, a
    step wall budget, deadlines, RESILIENCE_FAULTS from a seeded
    injector, its slow dispatch a real sleep) over ``traffic``, with no
    ``clock=`` (``clock``: the one-rank replay of rank 0's readings).
    ``record``: the readings the server took, rank 0's own. Returns each
    request's state, finish reason, token count, preemptions and class,
    the faults raised, the steps and the overruns."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.serving.resilience import (FaultInjector,
                                                        InjectedFault)

    srv = dst.ServingEngine(
        eng, num_slots=8, prefill_chunk=64,
        prefill_token_budget=RESILIENCE_BUDGET, paged_kv=dict(PAGED_KV),
        seed=seed, slo=RESILIENCE_SLO, guard_numerics=True,
        degradation=RESILIENCE_LADDER,
        preempt_queue_threshold=RESILIENCE_PREEMPT_QUEUE, priority=PRIORITY,
        step_wall_budget_ms=RESILIENCE_WALL_BUDGET_MS, clock=clock,
        fault_injector=FaultInjector(seed=seed, schedule=RESILIENCE_FAULTS,
                                     slow_ms=RESILIENCE_SLOW_MS))
    readings = None
    if record:
        # the server's one clock (model_group.GroupClock): rank 0's
        # readings, recorded as it takes them
        readings, inner = [], srv._now.clock

        def recorded():
            readings.append(inner())
            return readings[-1]

        srv._now.clock = recorded
    reqs, errors, step = [], [], 0
    while step <= traffic[-1][0] or srv.pending or srv.live_count:
        reqs += [srv.submit(p, **kw) for s, p, kw in traffic if s == step]
        try:
            srv.step()
        except InjectedFault as e:
            errors.append(e.point)
        step += 1
        assert step < 2000, "serve_tp (g): the traffic never drained"
    srv.check_invariants()
    return dict(states=[(r.state.value, str(r.finish_reason),
                         len(r.output_tokens), r.preemptions,
                         r.priority_class) for r in reqs],
                errors=errors, steps=step, readings=readings,
                overruns=srv.metrics.step_overruns)


def tp_keys_one_rank(small, seed: int, prompts, budgets, spec_traffic,
                     ids, device: str, mesh) -> dict:
    """Arm (a)'s one-rank runs of the key arms, on ``small`` (TinyLlama's
    widths at ``TP_KEYS_LAYERS`` layers) over a ``model=1`` mesh: the
    colocated and spec (over ``spec_traffic``) servers' requests, the
    cost model's flops, a page's bytes, the storage tier (quantized on one
    rank): its bytes at rest, the logits of ``ids`` and its engine, and
    the bf16 and storage-tier decode step times (:func:`decode_step_ms`
    after a prefill of ``ids``)."""
    import deepspeed_tpu_torch as dst

    eng = dst.init_inference(small, config={"dtype": "bfloat16"},
                             device=device, mesh=mesh)
    out = dict(engine=eng)
    out["colocated"] = tp_keys_serve(tp_keys_server(eng, seed), prompts,
                                     budgets)
    out["spec"] = tp_keys_serve(tp_keys_server(
        eng, seed, spec_decode=dict(TP_KEYS_SPEC)), *spec_traffic)
    srv = tp_keys_server(eng, seed, cost_model=True)
    tp_keys_serve(srv, prompts, budgets)
    out["flops"], out["page_nbytes"] = srv.costs.flops_total, \
        srv.pool.page_nbytes
    storage = dst.init_inference(copy.deepcopy(small),
                                 config={"dtype": "bfloat16"},
                                 device=device, mesh=mesh)
    storage._quantize_storage()     # the storage tier's quantization
    out["storage"] = dict(engine=storage, bytes=module_bytes(storage.module),
                          logits=storage.forward(ids).float().cpu())
    out["decode_ms"] = dict(bf16=decode_step_ms(eng, ids, device),
                            storage=decode_step_ms(storage, ids, device))
    return out


def tp_keys_ids(seed: int, vocab: int) -> np.ndarray:
    """2 prompts of 64 tokens for the int8 arms' full-context logits."""
    return np.random.default_rng(seed + 27).integers(
        0, vocab, (2, 64)).astype(np.int32)


def decode_step_ms(eng, ids, device: str, steps: int = 8) -> float:
    """The mean wall time of a contiguous decode step of ``eng`` (greedy,
    after a prefill of ``ids``): ``steps`` steps timed after one untimed
    step. Over a model group every rank runs it; its collectives included."""
    logits, cache = eng.prefill_at(ids)
    tok = logits[:, -1].argmax(-1)[:, None]
    for i in range(steps + 1):
        if i == 1:
            sync(device)
            t0 = time.perf_counter()
        tok = eng.decode(cache, tok, ids.shape[1] + i)[:, -1] \
            .argmax(-1)[:, None]
    sync(device)
    return 1e3 * (time.perf_counter() - t0) / steps


def tp_keys_arms(rank: int, world: int, tmp: str, seed: int,
                 device: str) -> dict:
    """Arms (d)-(h) on this rank of the model group, and the contiguous
    server arm (i) is held against (module docstring, phase 24): the
    weights phase 24 wrote at ``TP_KEYS_LAYERS`` layers, memory-mapped into
    meta models. Rank 0 writes the int8 arms' logits and arm (g)'s clock
    readings to ``tmp``."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.transformer_lm import TransformerLM
    from deepspeed_tpu_torch.serving import ReplicaRouter

    with open(os.path.join(tmp, "keys_traffic.json")) as fh:
        traffic = json.load(fh)
    prompts = [np.asarray(p, np.int32) for p in traffic["prompts"]]
    budgets, ids = traffic["budgets"], np.asarray(traffic["ids"], np.int32)
    spec_traffic = ([np.asarray(p, np.int32) for p in traffic["spec_prompts"]],
                    traffic["spec_budgets"])
    tp = {"dtype": "bfloat16", "tensor_parallel": {"tp_size": world}}

    def load(key):
        cfg = torch.load(os.path.join(tmp, f"{key}_config.pt"),
                         weights_only=False)
        state = torch.load(os.path.join(tmp, f"{key}.pt"), mmap=True,
                           weights_only=True)
        return TransformerLM(cfg, device="meta"), state

    out, saved = {}, {}
    model, state = load("keys")
    eng = dst.init_inference(model, config=tp, model_parameters=state,
                             device=device)
    reset_launches()
    col = tp_keys_serve(tp_keys_server(eng, seed), prompts, budgets)
    out["colocated"] = dict(tokens=tokens_of(col), launches=read_launches())
    out["decode_ms"] = decode_step_ms(eng, ids, device)
    # (d) speculative decoding: the verify through the paged kernel at T=5
    reset_launches()
    spec = tp_keys_serve(tp_keys_server(
        eng, seed, spec_decode=dict(TP_KEYS_SPEC)), *spec_traffic)
    out["spec"] = dict(tokens=tokens_of(spec), launches=read_launches(),
                       accepted=[r.spec_accepted for r in spec],
                       drafted=[r.spec_drafted for r in spec])
    # (f) a prefill/decode pair behind the router
    pre = tp_keys_server(eng, seed, role="prefill")
    dec = tp_keys_server(eng, seed, role="decode")
    reset_launches()
    pair = tp_keys_serve(ReplicaRouter([pre, dec]), prompts, budgets)
    out["disagg"] = dict(
        tokens=tokens_of(pair), launches=read_launches(),
        page_nbytes=dec.pool.page_nbytes,
        pages=int(dec.registry.counter("paging/pages_imported").value))
    # (h) overlap, and the cost model's share
    reset_launches()
    over = tp_keys_serve(tp_keys_server(eng, seed, overlap=True), prompts,
                         budgets)
    srv = tp_keys_server(eng, seed, cost_model=True)
    tp_keys_serve(srv, prompts, budgets)
    out["overlap"] = dict(tokens=tokens_of(over), launches=read_launches(),
                          flops=srv.costs.flops_total)
    # (i)'s reference: the contiguous pool over the one data rank
    reset_launches()
    cont = tp_keys_serve(tp_keys_server(eng, seed, paged_kv=False), prompts,
                         budgets)
    out["contiguous"] = dict(tokens=tokens_of(cont),
                             launches=read_launches())
    # (g) the clocked keys with no clock=: rank 0's readings everywhere
    reset_launches()
    g = tp_clocked_arm(eng, seed, tp_clocked_traffic(prompts, budgets),
                       record=rank == 0)
    saved["readings"] = g.pop("readings")
    out["clocked"] = dict(g, launches=read_launches())
    del eng, srv, pre, dec
    fresh_device(device)
    # (e) the int8 tiers: the storage tier (dtype int8 above one rank) ...
    model, state = load("keys")
    seng = dst.init_inference(model, config={**tp, "dtype": "int8"},
                              model_parameters=state, device=device)
    saved["storage_logits"] = seng.forward(ids).float().cpu()
    reset_launches()
    stor = tp_keys_serve(tp_keys_server(seng, seed), prompts, budgets)
    out["storage"] = dict(bytes=module_bytes(seng.module),
                          tokens=tokens_of(stor), launches=read_launches(),
                          decode_ms=decode_step_ms(seng, ids, device),
                          dequant=sorted({
                              type(m).__name__ for m in seng.module.modules()
                              if type(m).__name__.endswith("Dequant")}))
    del seng
    fresh_device(device)
    # ... and an int8_weights model through int8_matmul
    model, state = load("keys_int8")
    qeng = dst.init_inference(model, config=tp, model_parameters=state,
                              device=device)
    reset_launches()
    saved["int8_logits"] = qeng.forward(ids).float().cpu()
    q = tp_keys_serve(tp_keys_server(qeng, seed), prompts, budgets)
    out["int8_weights"] = dict(
        tokens=tokens_of(q), launches=read_launches(),
        bytes=module_bytes(qeng.module),
        kinds=sorted({type(m).__name__ for m in qeng.module.modules()
                      if "Quant" in type(m).__name__}))
    del qeng, model, state
    fresh_device(device)
    if rank == 0:
        torch.save(saved, os.path.join(tmp, "keys_saved.pt"))
    return out


def tp_dm_worker(rank: int, world: int, tmp: str, seed: int,
                 device: str) -> int:
    """Arm (i)'s rank: the world of 4 as a ``(data, model)`` =
    ``TP_DM`` mesh (rank order data-major, as the JAX mesh), the keys
    model's contiguous server; writes ``dm<r>.json``."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.transformer_lm import TransformerLM
    from deepspeed_tpu_torch.parallel import mesh as mesh_mod

    comm.init_distributed(dist_backend="gloo", rank=rank, world_size=world,
                          init_method=f"file://{os.path.join(tmp, 'dm')}",
                          timeout=TP_TIMEOUT, verbose=False)
    with open(os.path.join(tmp, "keys_traffic.json")) as fh:
        traffic = json.load(fh)
    prompts = [np.asarray(p, np.int32) for p in traffic["prompts"]]
    cfg = torch.load(os.path.join(tmp, "keys_config.pt"), weights_only=False)
    state = torch.load(os.path.join(tmp, "keys.pt"), mmap=True,
                       weights_only=True)
    mesh = mesh_mod.build_mesh(data=TP_DM[0], model=TP_DM[1])
    eng = dst.init_inference(TransformerLM(cfg, device="meta"),
                             config={"dtype": "bfloat16"},
                             model_parameters=state, device=device,
                             mesh=mesh)
    reset_launches()
    srv = tp_keys_server(eng, seed, paged_kv=False)
    reqs = tp_keys_serve(srv, prompts, traffic["budgets"])
    out = dict(tokens=tokens_of(reqs), launches=read_launches(),
               rows=int(srv.pool.cache["k"].shape[1]),
               shard=list(srv.pool.shard), mp=eng.mp_world_size,
               dp=eng.dp_world_size, dp_rank=eng.dp_rank)
    with open(os.path.join(tmp, f"dm{rank}.json"), "w") as fh:
        json.dump(out, fh)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def spawn_workers(tmp: str, world: int, seed: int, spec: dict,
                  label: str) -> float:
    """Start ``world`` ranks of this file as ``--tp-worker`` processes with
    ``spec``, wait for them (every one killed past ``TP_TIMEOUT``) and
    return the seconds they took; a rank that fails raises with its log's
    tail."""
    procs = []
    for rank in range(world):
        logf = open(os.path.join(tmp, f"{label}{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tp-worker",
             str(rank), str(world), tmp, "--seed", str(seed),
             "--tp-spec", json.dumps(spec)], stdout=logf,
            stderr=subprocess.STDOUT), logf))
    t0 = time.perf_counter()
    deadline = time.monotonic() + TP_TIMEOUT
    try:
        for rank, (proc, logf) in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"serve_tp: {label} rank {rank} still "
                                   f"running after {TP_TIMEOUT} s")
            if rc != 0:
                with open(os.path.join(tmp, f"{label}{rank}.log")) as fh:
                    tail = "".join(fh.readlines()[-40:])
                raise RuntimeError(f"serve_tp: {label} rank {rank} exited "
                                   f"{rc}:\n{tail}")
    finally:
        for proc, logf in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logf.close()
    return time.perf_counter() - t0


def tp_worker(rank: int, world: int, tmp: str, seed: int,
              spec: dict) -> int:
    """Arm (b)'s rank: gloo over ``cuda:0`` (every rank on the one card),
    the weights memory-mapped from the files phase 24 wrote (a meta model:
    no rank ever holds the whole model, on the host or the card), the bf16
    arm with its probes (teacher-forced where it parts from arm (a)'s
    tokens), then the fp32 two-layer arm, GPT-2 small's forward and the key
    arms (d)-(h) (:func:`tp_keys_arms`); writes ``rank<r>.json`` (and rank
    0 ``teacher.pt``) to ``tmp``. ``spec["mode"]`` "dm": arm (i)'s rank
    instead (:func:`tp_dm_worker`)."""
    if spec.get("mode") == "dm":
        return tp_dm_worker(rank, world, tmp, seed, spec["device"])
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel
    from deepspeed_tpu_torch.models.transformer_lm import TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False   # as main() sets them
    torch.backends.cudnn.allow_tf32 = False
    device = spec["device"]
    comm.init_distributed(dist_backend="gloo", rank=rank, world_size=world,
                          init_method=f"file://{os.path.join(tmp, 'store')}",
                          timeout=TP_TIMEOUT, verbose=False)
    with open(os.path.join(tmp, "traffic.json")) as fh:
        traffic = json.load(fh)
    prompts = [np.asarray(p, np.int32) for p in traffic["prompts"]]
    out = {}
    for label, cfg_key, budgets, probes in (
            ("bf16", "bf16", traffic["budgets"], True),
            ("fp32", "fp32", [TP_FP32_BUDGET] * len(prompts), False)):
        cfg = torch.load(os.path.join(tmp, f"{cfg_key}_config.pt"),
                         weights_only=False)
        state = torch.load(os.path.join(tmp, f"{cfg_key}.pt"), mmap=True,
                           weights_only=True)
        model = TransformerLM(cfg, device="meta")
        arm, srv, teacher = tp_arm(model, state, world, seed, prompts,
                                   budgets, device, probes,
                                   against=traffic["a_tokens"])
        out[label] = arm
        if teacher is not None and rank == 0:
            torch.save(teacher, os.path.join(tmp, "teacher.pt"))
        del srv, model, state
        fresh_device(device)
    # GPT-2 small's forward over the same model group, its qkv per head
    cfg = torch.load(os.path.join(tmp, "gpt2_config.pt"), weights_only=False)
    state = torch.load(os.path.join(tmp, "gpt2.pt"), mmap=True,
                       weights_only=True)
    logits, launches, eng = tp_gpt2_arm(
        GPT2LMHeadModel(cfg, device="meta"), state, world,
        np.asarray(traffic["gpt2_ids"], np.int32), device)
    out["gpt2"] = dict(tokens=logits.argmax(-1).tolist(), launches=launches,
                       mp=eng.mp_world_size)
    if rank == 0:
        torch.save(logits, os.path.join(tmp, "gpt2_logits.pt"))
    del eng, state
    fresh_device(device)
    out["keys"] = tp_keys_arms(rank, world, tmp, seed, device)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def tp_kernel_rows(gen: torch.Generator) -> dict:
    """The flash, decode and paged kernels at a rank's shapes of TinyLlama
    over a model group of two (16 query heads over 2 KV heads, D 64),
    bf16 and int8 caches: held against their plain versions, timed beside
    them, a library call where one exists and the card's bound. Flash: the
    whole-prompt admissions (B=1, T=64) and a long prompt (T=512); decode:
    8 slots of 2048 positions at ragged lengths over 22 layers' caches;
    paged: 8 slots of 32 64-position pages, T=1 (and T=5 checked) over 22
    layers' pools."""
    from deepspeed_tpu_torch.ops.attention.decode_attention import (
        decode_attention, decode_attention_reference, quantize_kv_rows)
    from deepspeed_tpu_torch.ops.attention.flash_attention import (
        flash_attention, mha_reference)
    from deepspeed_tpu_torch.ops.attention.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference)

    dev, bf16 = "cuda", torch.bfloat16
    L, B, H, KV, D = TINYLLAMA["n_layer"], 8, 16, 2, 64
    scale = 1.0 / math.sqrt(D)
    rows = {}
    # -- flash forward --------------------------------------------------
    for T in (64, 512):
        q = torch.randn(1, T, H, D, generator=gen, device=dev).to(bf16)
        k, v = (torch.randn(1, T, KV, D, generator=gen, device=dev).to(bf16)
                for _ in range(2))
        got, _ = flash_attention(q, k, v, causal=True)
        want, _ = mha_reference(q, k, v, causal=True)
        err, rel = compare(got, want, f"flash kernel vs plain at the TP "
                           f"rank's shapes, T={T}")
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), reps=20)
        plain_ms = cuda_ms(lambda: mha_reference(q, k, v, causal=True),
                           reps=4)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps=20)
        pairs = T * (T + 1) // 2
        rows[f"flash_attention_fwd T={T}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            **bound(2 * (2 * T * H * D + 2 * T * KV * D) + 4 * H * T,
                    4 * H * pairs * D))
    # -- decode, contiguous -----------------------------------------------
    S = TINYLLAMA["max_seq_len"]
    lengths = torch.tensor([1, 2048, 1100, 517, 64, 1999, 700, 1500],
                           dtype=torch.int32, device=dev)
    live = int(lengths.sum())
    q = torch.randn(B, H, D, generator=gen, device=dev).to(bf16)
    pos = torch.arange(S, device=dev)
    mask = (pos[None, :] < lengths[:, None].long())[:, None, None, :]
    for int8 in (False, True):
        raw = [torch.randn(L, B, KV, S, D, generator=gen, device=dev)
               for _ in range(2)]
        if int8:
            (k, ks), (v, vs) = (quantize_kv_rows(x) for x in raw)
            sc = [dict(k_scale=ks[i], v_scale=vs[i]) for i in range(L)]
            kd, vd = ((x.float() * s[..., None]).to(bf16)
                      for x, s in ((k, ks), (v, vs)))
        else:
            k, v = (x.to(bf16) for x in raw)
            sc = [{}] * L
            kd, vd = k, v
        del raw
        err = rel = 0.0
        for i in (0, L - 1):
            e, r = compare(
                decode_attention(q, k[i], v[i], lengths, **sc[i]),
                decode_attention_reference(q, k[i], v[i], lengths, scale,
                                           None, sc[i].get("k_scale"),
                                           sc[i].get("v_scale")),
                f"decode kernel (int8={int8}) vs plain at the TP rank's "
                f"shapes")
            err, rel = max(err, e), max(rel, r)
        ms = cuda_ms(lambda: [decode_attention(q, k[i], v[i], lengths,
                                               **sc[i]) for i in range(L)],
                     reps=4) / L
        plain_ms = cuda_ms(lambda: [decode_attention_reference(
            q, k[i], v[i], lengths, scale, None, sc[i].get("k_scale"),
            sc[i].get("v_scale")) for i in range(L)], reps=1) / L
        lib_ms = cuda_ms(lambda: [F.scaled_dot_product_attention(
            q[:, :, None, :], kd[i], vd[i], attn_mask=mask, enable_gqa=True)
            for i in range(L)], reps=4) / L
        esize = D + 4 if int8 else 2 * D
        name = "decode_attention_int8" if int8 else "decode_attention"
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms,
                          **bound(2 * KV * live * esize + 2 * B * H * D * 2
                                  + 4 * B, 4 * H * live * D))
        del k, v, kd, vd, sc
    # -- decode, paged ----------------------------------------------------
    ps, per_slot = PAGED_KV["page_size"], S // PAGED_KV["page_size"]
    P = B * per_slot + 4
    for int8 in (False, True):
        raw = [torch.randn(L, P, KV, ps, D, generator=gen, device=dev)
               for _ in range(2)]
        if int8:
            (k, ks), (v, vs) = (quantize_kv_rows(x) for x in raw)
            sc = [dict(k_scale_pages=ks[i], v_scale_pages=vs[i])
                  for i in range(L)]
        else:
            k, v = (x.to(bf16) for x in raw)
            sc = [{}] * L
        del raw
        err = rel = 0.0
        for T in (1, 5):
            qp = torch.randn(B, T, H, D, generator=gen, device=dev).to(bf16)
            table, starts = slot_tables(gen, T, P, ps, per_slot)
            for i in (0, L - 1):
                e, r = compare(
                    paged_decode_attention(qp, k[i], v[i], table, starts,
                                           **sc[i]),
                    paged_decode_attention_reference(
                        qp, k[i], v[i], table, starts, scale, None,
                        sc[i].get("k_scale_pages"),
                        sc[i].get("v_scale_pages")),
                    f"paged kernel (int8={int8}, T={T}) vs plain at the TP "
                    f"rank's shapes")
                err, rel = max(err, e), max(rel, r)
        qp = torch.randn(B, 1, H, D, generator=gen, device=dev).to(bf16)
        table, starts = slot_tables(gen, 1, P, ps, per_slot)
        ms = cuda_ms(lambda: [paged_decode_attention(
            qp, k[i], v[i], table, starts, **sc[i]) for i in range(L)],
            reps=4) / L
        plain_ms = eager_ms(lambda: [paged_decode_attention_reference(
            qp, k[i], v[i], table, starts, scale, None,
            sc[i].get("k_scale_pages"), sc[i].get("v_scale_pages"))
            for i in range(L)], reps=2) / L
        live = int((starts.long() + 1).sum())
        pages_read = int(((starts.long() + ps) // ps).sum())
        esize = D + 4 if int8 else 2 * D
        name = ("paged_decode_attention_int8" if int8
                else "paged_decode_attention")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=None,
                          **bound(2 * KV * live * esize + 2 * B * H * D * 2
                                  + 4 * (pages_read + B),
                                  4 * H * live * D))
        if int8:
            # the k=4 speculative verify's forward (serve_tp arm (d)): T=5
            # query rows a slot, each masked at its own limit
            qv = torch.randn(B, 5, H, D, generator=gen, device=dev).to(bf16)
            table, starts = slot_tables(gen, 5, P, ps, per_slot)
            e, _ = compare(paged_decode_attention(qv, k[0], v[0], table,
                                                  starts, **sc[0]),
                           paged_decode_attention_reference(
                               qv, k[0], v[0], table, starts, scale, None,
                               sc[0]["k_scale_pages"],
                               sc[0]["v_scale_pages"]),
                           "paged kernel (int8, T=5) vs plain at the TP "
                           "rank's shapes")
            ms = cuda_ms(lambda: [paged_decode_attention(
                qv, k[i], v[i], table, starts, **sc[i]) for i in range(L)],
                reps=4) / L
            plain_ms = eager_ms(lambda: [paged_decode_attention_reference(
                qv, k[i], v[i], table, starts, scale, None,
                sc[i]["k_scale_pages"], sc[i]["v_scale_pages"])
                for i in range(L)], reps=2) / L
            # row t of a slot reads positions up to starts + t
            live = int((5 * starts.long() + 15).sum())
            pages_read = int(((starts.long() + 4 + ps) // ps).sum())
            rows[name + " T=5"] = dict(
                max_abs_err=e, ms=ms, plain_ms=plain_ms, library_ms=None,
                **bound(2 * KV * int((starts.long() + 5).sum()) * esize
                        + 2 * 5 * B * H * D * 2 + 4 * (pages_read + B),
                        4 * H * live * D))
        del k, v, sc
    rows.update(tp_int8_rows(gen))
    for name, row in rows.items():
        log(f"[serve_tp kernels] {name} at a rank's shapes (H=16, KV=2, "
            f"D=64; int8_matmul: one layer's calls of a kind, "
            f"{TINYLLAMA['n_embd']} wide, half of 5632): max|err| "
            f"{row['max_abs_err']:.3g}; kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
            + (f"{row['library_ms']:.4f} ms" if row["library_ms"] is not None
               else "none (none reads a page table)")
            + f", bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


def tp_int8_rows(gen: torch.Generator) -> dict:
    """int8_matmul at a rank's shapes of TinyLlama over a model group of
    two: a layer's column-parallel calls (q 2048 to 1024, k and v to 128,
    gate and up to 2816) and row-parallel ones (o 1024 to 2048, down 2816
    to 2048, their partial products summed across the ranks after), at
    decode (M=8, the mma.sync tiles) and prefill (M=64, one chunk: the
    wgmma tiles); each call held against its plain version, each group of
    calls timed over enough weight copies to pass the 50 MB L2, beside the
    plain version, bf16 ``F.linear`` on weights dequantized ahead of time,
    and the card's bound."""
    from deepspeed_tpu_torch.ops.quantization.int8_matmul import (
        int8_matmul, int8_matmul_reference, quantize_columns)

    dev, bf16 = "cuda", torch.bfloat16
    groups = {"column": [(2048, 1024), (2048, 128), (2048, 128),
                         (2048, 2816), (2048, 2816)],
              "row": [(1024, 2048), (2816, 2048)]}
    rows = {}
    for M, regime in ((8, "decode"), (64, "prefill")):
        for split, shapes in groups.items():
            tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0,
                       flops=0)
            err = 0.0
            for K, N in shapes:
                wf = torch.randn(N, K, generator=gen, device=dev) * 0.02
                q, sc = quantize_columns(wf.t())
                w, sc = q.t().contiguous(), sc.reshape(-1).contiguous()
                x = torch.randn(M, K, generator=gen, device=dev).to(bf16)
                e, _ = compare(int8_matmul(x, w, sc),
                               int8_matmul_reference(x, w, sc, torch.float32),
                               f"int8_matmul at a TP rank's {split} shape "
                               f"M={M} K={K} N={N}")
                err = max(err, e)
                copies = max(1, -(-200 * 2 ** 20 // (N * K)))
                wc = w.expand(copies, N, K).contiguous()
                tot["ms"] += cuda_ms(lambda: [int8_matmul(x, wc[i], sc)
                                              for i in range(copies)],
                                     reps=2) / copies
                tot["plain_ms"] += cuda_ms(
                    lambda: int8_matmul_reference(x, w, sc), reps=2)
                wd = (wc.float() * sc[:, None]).to(bf16)
                tot["library_ms"] += cuda_ms(
                    lambda: [F.linear(x, wd[i]) for i in range(copies)],
                    reps=2) / copies
                del wc, wd
                tot["nbytes"] += M * K * 2 + N * K + N * 4 + M * N * 2
                tot["flops"] += 2 * M * N * K
            rows[f"int8_matmul {regime} {split}"] = dict(
                max_abs_err=err, ms=tot["ms"], plain_ms=tot["plain_ms"],
                library_ms=tot["library_ms"], M=M, calls=len(shapes),
                **bound(tot["nbytes"], tot["flops"]))
    return rows


def tp_train_kernel_rows(gen: torch.Generator) -> dict:
    """The flash forward, dq and dk/dv kernels at a tensor-parallel
    training rank's shape (GPT-2 medium over two ranks: B=``MICRO_BS``,
    H=8, D=64, T=``SEQ``, causal, bf16): each held against its plain
    version, timed beside it, the library call and the card's bound."""
    from deepspeed_tpu_torch.ops.attention.flash_attention import (
        attention_delta, flash_attention, flash_attention_dkv,
        flash_attention_dq, flash_dkv_reference, flash_dq_reference,
        mha_reference)

    B, T, H, D = MICRO_BS, SEQ, GPT2_MEDIUM["n_head"] // TP_WORLD, 64
    q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    out, lse = flash_attention(q, k, v, causal=True)
    ref_out, ref_lse = mha_reference(q, k, v, causal=True)
    errs = {"fwd": compare_rows(out, ref_out, "flash forward kernel vs "
                                "plain at the TP training rank's shape")[0]}
    le = (lse - ref_lse).abs().max().item()
    assert math.isfinite(le) and le <= LSE_ATOL, \
        f"flash lse vs plain at the TP training rank's shape: {le}"
    del ref_out, ref_lse
    args = (q, k, v, do, lse, attention_delta(out, do), True, scale)
    errs["dq"] = compare_rows(flash_attention_dq(*args),
                              flash_dq_reference(*args),
                              "flash dq kernel vs plain at the TP training "
                              "rank's shape")[0]
    errs["dkv"] = max(compare_rows(g, w, "flash dk/dv kernel vs plain at the "
                                   "TP training rank's shape")[0]
                      for g, w in zip(flash_attention_dkv(*args),
                                      flash_dkv_reference(*args)))
    plain = {"fwd": cuda_ms(lambda: mha_reference(q, k, v, causal=True),
                            reps=1),
             "dq": cuda_ms(lambda: flash_dq_reference(*args), reps=1),
             "dkv": cuda_ms(lambda: flash_dkv_reference(*args), reps=1)}
    times = flash_times(q, k, v, do, "TP training rank", reps=3,
                        other=False)
    label = f"TP train B={B} H={H} D={D} T={T}"
    rows = {}
    for name, lib in (("fwd", "sdpa_fwd"), ("dq", "sdpa_bwd"),
                      ("dkv", "sdpa_bwd")):
        rows[f"flash_attention_{name} {label}"] = dict(
            max_abs_err=errs[name], ms=times[name], plain_ms=plain[name],
            library_ms=times[lib], **times[f"{name}_bound"])
    for name, row in rows.items():
        log(f"[train_zero_dp kernels] {name}: max|err| "
            f"{row['max_abs_err']:.3g}; kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms "
            f"(SDPA{' backward: dq, dk, dv' if 'fwd' not in name else ''}), "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


def predicted_rank_bytes(full: dict, world: int) -> int:
    """A rank's parameter bytes predicted from the one-rank model's
    (``full``: name -> bytes): every projection, the embedding and the head
    split evenly, the norms whole."""
    return sum(n // world if any(s in k for s in TP_SHARDED) else n
               for k, n in full.items())


def tp_keys_checks(keys, dms, a_keys, small, qstate, prompts, budgets,
                   spec_traffic, ids, saved, seed: int, device: str,
                   note: str, dm_wall: float) -> list:
    """Phase 24's key arms (d)-(i) held (module docstring): ``keys`` each
    rank's :func:`tp_keys_arms`, ``dms`` arm (i)'s ranks, ``a_keys`` arm
    (a)'s one-rank runs, ``saved`` rank 0's logits and clock readings.
    Returns the arms' kernel launches."""
    import types

    from deepspeed_tpu_torch.models.transformer_lm import TransformerLM

    k0, L = keys[0], small.config.n_layer
    PAGED8, PREFILL8 = "paged_decode_attention_int8", "int8_matmul_prefill"
    for arm in ("colocated", "spec", "disagg", "overlap", "contiguous",
                "storage", "int8_weights"):
        assert all(k[arm]["tokens"] == k0[arm]["tokens"] for k in keys), \
            f"serve_tp ({arm}): the ranks' tokens differ"
    ref = fp32_reference(small, a_keys["engine"], device)

    def reqs(tokens, prompts=prompts):
        return [types.SimpleNamespace(request_id=i, prompt=p,
                                      output_tokens=t)
                for i, (p, t) in enumerate(zip(prompts, tokens))]

    # (d) spec_decode at tp 2 against the one-rank spec server
    assert all(k["spec"]["accepted"] == k0["spec"]["accepted"]
               for k in keys), "serve_tp (d): acceptance differs by rank"
    sp = spec_traffic[0]
    ties = divergences("serve_tp (d)", reqs(k0["spec"]["tokens"], sp),
                       reqs(tokens_of(a_keys["spec"]), sp),
                       a_keys["engine"], ref,
                       against="arm (a)'s spec server, one rank")
    drafted = sum(k0["spec"]["drafted"])
    assert drafted > 0, "serve_tp (d): the drafter proposed nothing"
    acc = sum(k0["spec"]["accepted"]) / drafted
    # (f) the prefill/decode pair: the colocated tokens, half a page a rank
    d = k0["disagg"]
    assert d["tokens"] == k0["colocated"]["tokens"], \
        "serve_tp (f): the pair's tokens differ from the colocated server's"
    assert d["pages"] > 0 and 2 * d["page_nbytes"] == a_keys["page_nbytes"]
    # (h) overlap's tokens are the serial step's; a rank's flops are half
    o = k0["overlap"]
    assert o["tokens"] == k0["colocated"]["tokens"], "serve_tp (h) overlap"
    share = 2 * o["flops"] / a_keys["flops"]
    assert abs(share - 1) <= 0.01, f"serve_tp (h): 2 x a rank's flops / " \
        f"one rank's = {share}"
    # (i) (data, model) = (2, 2): half the slots a data rank, every rank
    # alike, (1, 2)'s tokens (a data rank's decode runs 4 rows where (1, 2)
    # runs 8: other product shapes, so a parting must be a near-tie)
    for rank, r in enumerate(dms):
        assert (r["mp"], r["dp"], r["dp_rank"]) == (TP_DM[1], TP_DM[0],
                                                    rank // TP_DM[1]), r
        assert r["rows"] * TP_DM[0] == 8 and r["tokens"] == \
            dms[0]["tokens"], f"serve_tp (i): rank {rank}"
    dm_ties = divergences("serve_tp (i)", reqs(dms[0]["tokens"]),
                          reqs(k0["contiguous"]["tokens"]),
                          a_keys["engine"], ref,
                          against=f"the (1, {TP_WORLD}) contiguous server")
    # (e) the storage tier: about half the bytes, the one-rank tier's logits
    st = [k["storage"]["bytes"] for k in keys]
    rest = max(st) / a_keys["storage"]["bytes"]
    assert rest < TP_STORAGE_REST, f"serve_tp (e): a rank stores {rest} of " \
        f"one rank's storage-tier bytes"
    sref = fp32_reference(small, a_keys["storage"]["engine"], device)
    with torch.no_grad():
        swant = sref.logits(torch.as_tensor(ids, device=device)).float()
    srel = rel_err(saved["storage_logits"].to(device), swant)
    srel1 = rel_err(a_keys["storage"]["logits"].to(device), swant)
    assert srel <= LOGITS_REL_TOL and srel1 <= LOGITS_REL_TOL, (srel, srel1)
    del sref
    # ... and the int8_weights model through int8_matmul
    q = k0["int8_weights"]
    assert q["kinds"] == ["QuantDense", "RowParallelQuantDense"], q["kinds"]
    qcfg = dataclasses.replace(small.config, dtype=torch.float32,
                               use_flash_attention=False,
                               decode_kernel="off")
    qref = TransformerLM(qcfg, device=device)
    deq = {k: (v.float() * qstate[k[:-len("weight")] + "scale"][:, None]
               if v.dtype == torch.int8 else v.float())
           for k, v in qstate.items() if not k.endswith(".scale")}
    with torch.no_grad():
        qref.load_state_dict(deq)
        qwant = qref.logits(torch.as_tensor(ids, device=device)).float()
    qrel = rel_err(saved["int8_logits"].to(device), qwant)
    assert qrel <= LOGITS_REL_TOL, f"serve_tp (e): int8_weights logits vs " \
        f"the fp32 copy: rel err {qrel}"
    del qref, deq
    # (g) the clocked keys: every rank alike, and one rank replaying rank
    # 0's readings takes the same decisions
    g = k0["clocked"]
    assert all(k["clocked"]["states"] == g["states"]
               and k["clocked"]["errors"] == g["errors"] for k in keys)
    readings = list(saved["readings"])
    it = iter(readings)
    replay = tp_clocked_arm(a_keys["engine"], seed,
                            tp_clocked_traffic(prompts, budgets),
                            clock=lambda: next(it))
    assert next(it, None) is None, "serve_tp (g): readings left unread"
    # the ranks' states came through JSON: lists, not tuples
    parted = [(i, x, y) for i, (x, y) in enumerate(zip(g["states"],
                                                      replay["states"]))
              if x != list(y)]
    assert len(replay["states"]) == len(g["states"])
    assert not parted and replay["errors"] == g["errors"], \
        f"serve_tp (g): one rank on rank 0's readings decided otherwise: " \
        f"(request, rank 0, one rank) {parted}; faults {g['errors']} vs " \
        f"{replay['errors']}"
    kinds = {}
    for st_, reason, *_ in g["states"]:
        kinds[f"{st_}/{reason}"] = kinds.get(f"{st_}/{reason}", 0) + 1
    launches = [a for k in keys + dms for a in
                ([r["launches"] for r in k.values()
                  if isinstance(r, dict) and "launches" in r]
                 if "rows" not in k else [k["launches"]])]
    if device == "cuda":
        for k in keys:
            assert k["spec"]["launches"]["paged_decode_attention_int8"] > 0
            assert k["int8_weights"]["launches"]["int8_matmul"] > \
                k["int8_weights"]["launches"]["int8_matmul_prefill"] > 0
        for r in dms:
            assert r["launches"]["decode_attention_int8"] > 0
    log(f"[serve_tp] key arms (d)-(i): TinyLlama widths at {L} layers, bf16, "
        f"int8 KV; serve_paged's {len(prompts)} prompts, budgets capped at "
        f"{TP_KEYS_BUDGET}; every rank's tokens identical ({note})")
    log(f"[serve_tp] (d) spec_decode {TP_KEYS_SPEC} at tp_size {TP_WORLD}: "
        f"{ties['same']} of {ties['n']} requests identical to one rank's "
        f"spec server, worst gap / error at a parting {ties['worst']:.3g} "
        f"(limit {TIE_FACTOR}); {len(sp)} motif prompts, {drafted} tokens "
        f"drafted, acceptance {acc:.3f}, the same on both ranks; paged int8 "
        f"launches (T=5 verify) "
        f"{[k['spec']['launches'][PAGED8] for k in keys]}")
    log(f"[serve_tp] (e) dtype int8 at tp_size {TP_WORLD} (the storage "
        f"tier): bytes a rank {st} vs one rank's storage tier "
        f"{a_keys['storage']['bytes']} ({rest:.4f}); logits of 2 x 64 "
        f"tokens vs the fp32 copy of the one-rank tier's weights: rel "
        f"{srel:.4g} (one rank {srel1:.4g}; tol {LOGITS_REL_TOL}); "
        f"dequantized through {k0['storage']['dequant']}; decode step of "
        f"2 rows, {L} layers: storage tier "
        f"{[round(k['storage']['decode_ms'], 4) for k in keys]} ms a rank "
        f"vs bf16 {[round(k['decode_ms'], 4) for k in keys]} ms (one rank: "
        f"storage {a_keys['decode_ms']['storage']:.4f}, bf16 "
        f"{a_keys['decode_ms']['bf16']:.4f} ms); "
        f"int8_weights ({q['kinds']}): bytes a rank "
        f"{[k['int8_weights']['bytes'] for k in keys]}, logits vs the fp32 "
        f"dequantized copy rel {qrel:.4g}, int8_matmul launches "
        f"{[k['int8_weights']['launches']['int8_matmul'] for k in keys]} "
        f"(prefill tiles "
        f"{[k['int8_weights']['launches'][PREFILL8] for k in keys]})")
    log(f"[serve_tp] (f) prefill/decode pair behind ReplicaRouter: tokens "
        f"equal the colocated server's; {d['pages']} pages moved a rank, "
        f"{d['page_nbytes']} bytes a page a rank vs "
        f"{a_keys['page_nbytes']} on one rank")
    log(f"[serve_tp] (g) serve_resilience's keys, no clock=: every rank's "
        f"states and faults identical over {g['steps']} steps (digests "
        f"compared twice a step), {len(readings)} clock readings of rank 0 "
        f"replayed on one rank give the same decisions; states {kinds}, "
        f"faults {g['errors']}, overruns {g['overruns']}")
    log(f"[serve_tp] (h) overlap: the serial step's tokens; cost model: 2 x "
        f"a rank's flops {o['flops']:.6g} / one rank's "
        f"{a_keys['flops']:.6g} = {share:.5f}")
    log(f"[serve_tp] (i) (data, model) = {TP_DM} over {len(dms)} gloo ranks "
        f"on one card: {dms[0]['rows']} of 8 contiguous slots a data rank "
        f"(shards {[r['shard'] for r in dms]}), every rank alike, "
        f"{dm_ties['same']} of {dm_ties['n']} requests the (1, {TP_WORLD}) "
        f"server's tokens (worst gap / error at a parting "
        f"{dm_ties['worst']:.3g}); the four ranks took {dm_wall:.1f} s "
        f"(process start and weight loads included; {note})")
    del ref
    return launches


def phase_serve_tp(seed: int, device: str = "cuda", **overrides) -> list:
    """Phase 24 (module docstring). Returns the kernels' launches over its
    runs (arm (a), and each of arm (b)'s ranks). Its scratch directory
    (the weights, the ranks' logs and results) goes however it ends."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="serve_tp_")
    try:
        return serve_tp(tmp, seed, device, **overrides)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def serve_tp(tmp: str, seed: int, device: str, gpt2_overrides=None,
             **overrides) -> list:
    """Phase 24's body, its files in ``tmp`` (``overrides`` narrow
    TinyLlama, ``gpt2_overrides`` GPT-2, for a CPU rehearsal)."""
    import types

    import torch.distributed as dist

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm import comm as comm_mod
    from deepspeed_tpu_torch.parallel import mesh as mesh_mod

    card = card_line() if device == "cuda" else "cpu"
    model = tinyllama(seed, device, **overrides)
    f32 = tinyllama_fp32(seed + 1, device, **overrides)
    for key, m in (("bf16", model), ("fp32", f32)):
        torch.save(m.config, os.path.join(tmp, f"{key}_config.pt"))
        torch.save({k: v.cpu() for k, v in m.state_dict().items()},
                   os.path.join(tmp, f"{key}.pt"))
    prompts, budgets = tp_traffic(seed, model.config.vocab_size)
    L = model.config.n_layer
    gpt2 = tp_gpt2_model(seed, device, **(gpt2_overrides or {}))
    torch.save(gpt2.config, os.path.join(tmp, "gpt2_config.pt"))
    torch.save({k: v.cpu() for k, v in gpt2.state_dict().items()},
               os.path.join(tmp, "gpt2.pt"))
    gids = tp_gpt2_prompts(seed, gpt2.config.vocab_size)
    # the key arms' model: TinyLlama's widths at TP_KEYS_LAYERS layers, and
    # its int8_weights twin (every projection but the head quantized per
    # channel on the card, as the int8 compute tier does)
    from deepspeed_tpu_torch.ops.quantization.convert import (
        DENSE_KEYS, quantize_lm_state_dict)

    small = tinyllama(seed + 3, device, **{**overrides,
                                           "n_layer": TP_KEYS_LAYERS})
    qstate, _ = quantize_lm_state_dict(small.state_dict(),
                                       DENSE_KEYS - {"lm_head"})
    for key, cfg, sd in (
            ("keys", small.config, small.state_dict()),
            ("keys_int8", dataclasses.replace(small.config,
                                              int8_weights=True), qstate)):
        torch.save(cfg, os.path.join(tmp, f"{key}_config.pt"))
        torch.save({k: v.cpu() for k, v in sd.items()},
                   os.path.join(tmp, f"{key}.pt"))
    kprompts, kbudgets = tp_keys_traffic(seed, small.config.vocab_size)
    kspec = tp_spec_traffic(seed, small.config.vocab_size)
    kids = tp_keys_ids(seed, small.config.vocab_size)
    with open(os.path.join(tmp, "keys_traffic.json"), "w") as fh:
        json.dump({"prompts": [p.tolist() for p in kprompts],
                   "budgets": kbudgets, "ids": kids.tolist(),
                   "spec_prompts": [p.tolist() for p in kspec[0]],
                   "spec_budgets": kspec[1]}, fh)

    # arm (a): one rank, a mesh of model=1 over a NCCL world of one; at one
    # rank no layer is swapped, so it issues no collective and computes
    # what the plain one-rank path does
    comm.init_distributed(init_method=f"file://{os.path.join(tmp, 'nccl')}",
                          rank=0, world_size=1, device=device,
                          verbose=False)
    backend = dist.get_backend()
    try:
        mesh = mesh_mod.build_mesh(model=1)
        a, a_srv, _ = tp_arm(model, None, 1, seed, prompts, budgets, device,
                             mesh=mesh)
        a32, a32_srv, _ = tp_arm(f32, None, 1, seed, prompts,
                                 [TP_FP32_BUDGET] * len(prompts), device,
                                 probes=False, mesh=mesh)
        ga_logits, ga_launches, ga_eng = tp_gpt2_arm(gpt2, None, 1, gids,
                                                     device, mesh=mesh)
        a_keys = tp_keys_one_rank(small, seed, kprompts, kbudgets, kspec,
                                  kids, device, mesh)
    finally:
        dist.destroy_process_group()
        comm_mod._initialized = False
        mesh_mod.reset_mesh()
    del a32_srv, f32
    with open(os.path.join(tmp, "traffic.json"), "w") as fh:
        json.dump({"prompts": [p.tolist() for p in prompts],
                   "budgets": budgets, "a_tokens": a["tokens"],
                   "gpt2_ids": gids.tolist()}, fh)
    ref = fp32_reference(model, a_srv.engine, device)
    gref = gpt2_fp32_copy(gpt2, device)
    del ga_eng, gpt2
    fresh_device(device)

    # arm (b): two gloo ranks on the same card, in processes of their own;
    # then arm (i): four, as a (data, model) mesh
    wall = spawn_workers(tmp, TP_WORLD, seed, {"device": device}, "rank")
    dm_world = TP_DM[0] * TP_DM[1]
    dm_wall = spawn_workers(tmp, dm_world, seed,
                            {"device": device, "mode": "dm"}, "dm")
    ranks = []
    for rank in range(TP_WORLD):
        with open(os.path.join(tmp, f"rank{rank}.json")) as fh:
            ranks.append(json.load(fh))
    teacher = torch.load(os.path.join(tmp, "teacher.pt"))
    b, b32 = [r["bf16"] for r in ranks], [r["fp32"] for r in ranks]
    note = (f"gloo through the host on one card ({card}; NCCL refuses two "
            f"ranks a device): the placement, not tensor parallelism's "
            f"speed")

    # every rank alike; the fp32 arms equal; bf16 (b) against (a)
    for key in ("tokens", "generate"):
        assert all(r[key] == b[0][key] for r in b), f"ranks differ: {key}"
    assert all(r["tokens"] == b32[0]["tokens"] for r in b32)
    assert b32[0]["tokens"] == a32["tokens"], \
        f"fp32 at tp_size {TP_WORLD} differs from tp_size 1: " \
        f"{b32[0]['tokens']} vs {a32['tokens']}"

    def reqs(arm):
        return [types.SimpleNamespace(request_id=i, prompt=p,
                                      output_tokens=t)
                for i, (p, t) in enumerate(zip(prompts, arm["tokens"]))]

    ties = divergences("serve_tp", reqs(b[0]), reqs(a), a_srv.engine, ref,
                       against=f"arm (a), one rank over {backend}")
    # arm (b)'s own logits, teacher-forced on its own tokens: the prefill
    # and first decode of two requests, and every parted request through
    # its first parted position, where (b)'s token must also lie within
    # TIE_FACTOR of (b)'s own largest |served - fp32| below the top logit
    worst, parted = 0.0, []
    for i, got in teacher.items():
        toks = b[0]["tokens"][i]
        full = np.concatenate([prompts[i], toks[:len(got) - 1]])[None]
        with torch.no_grad():
            want = ref.logits(torch.as_tensor(full, device=device))[0]
        want = want[len(prompts[i]) - 1:].float()
        got = got.to(device)
        rel = rel_err(got, want)
        assert math.isfinite(rel) and rel <= LOGITS_REL_TOL, \
            f"serve_tp: request {i}'s arm (b) logits vs the fp32 copy: " \
            f"rel err {rel} > {LOGITS_REL_TOL}"
        worst = max(worst, rel)
        d = first_difference(toks, a["tokens"][i])
        if d is not None:
            err = (got[d] - want[d]).abs().max().item()
            gap = (want[d].max() - want[d, int(toks[d])]).item()
            parted.append((i, d, round(gap, 5), round(err, 5), round(rel, 4)))
            assert gap <= TIE_FACTOR * err, \
                f"serve_tp: request {i}'s arm (b) token at {d} lies " \
                f"{gap:.4g} below the fp32 copy's top logit, more than " \
                f"{TIE_FACTOR} x its own error {err:.4g}"
    del ref
    # a rank holds half of every projection, the norms whole, half the KV
    want_params = predicted_rank_bytes(a["param_bytes"], TP_WORLD)
    for rank, r in enumerate(b):
        got = sum(r["param_bytes"].values())
        assert got == want_params, (rank, got, want_params)
        assert r["pool_bytes"] * TP_WORLD == a["pool_bytes"], \
            (rank, r["pool_bytes"], a["pool_bytes"])
        assert r["kv_heads"] * TP_WORLD == a["kv_heads"]
    # the kernels on every rank; the decode step's collectives
    launches = [a["launches"], a["generate_launches"]]
    for rank, r in enumerate([a] + b if device == "cuda" else []):
        for name in ("flash_attention_fwd", "paged_decode_attention_int8"):
            assert r["launches"][name] > 0, (rank, name, r["launches"])
        assert r["generate_launches"]["decode_attention_int8"] > 0, rank
    for r in b:
        launches += [r["launches"], r["generate_launches"]]
        comms = r["decode_comms"]
        got = {k: v["count"] for k, v in comms.items()}
        assert got == {"all_reduce": 2 * L + 1,
                       "all_gather_into_tensor": 1}, got
    comms = b[0]["decode_comms"]
    n_ops = sum(v["count"] for v in comms.values())
    log(f"[serve_tp] tinyllama-1.1B widths ({L} layers, GQA "
        f"{model.config.n_head}/{model.config.kv_heads}), bf16, int8 KV, "
        f"8 slots, prefill_chunk=64, paged_kv={PAGED_KV}; 8 requests (4 "
        f"share a 512-token prefix; prompts {min(map(len, prompts))}-"
        f"{max(map(len, prompts))}, new {min(budgets)}-{max(budgets)})")
    for label, arm in (("(a) one rank (no collective)", a),
                       (f"(b) {TP_WORLD} ranks", b[0])):
        log(f"[serve_tp] {label}: {arm['new_tokens']} tokens in "
            f"{arm['wall']:.2f} s, tokens/s {arm['tokens_per_s']:.1f}, step "
            f"gap p50 {arm['gap_p50']:.2f} ms p99 {arm['gap_p99']:.2f} ms, "
            f"TTFT p50 {arm['ttft_p50']:.2f} ms, {arm['decode_steps']} "
            f"decode steps, prefix-hit tokens {arm['hit_tokens']}; a "
            f"contiguous decode step with the comms logger on "
            f"{arm['decode_step_ms']:.2f} ms"
            + ("" if arm is a else f" ({note})"))
    log(f"[serve_tp] (b) a decode step's collectives (rank 0): "
        + ", ".join(f"{k} {v['count']} ops {v['bytes'] / 1e6:.3f} MB, mean "
                    f"{v['ms'] / v['count']:.3f} ms" for k, v in
                    sorted(comms.items()))
        + f" ({n_ops} ops, expected {2 * L} + 1 all-reduces (2 a layer and "
        f"the embedding) + 1 all-gather (the head); {note})")
    cr = b[0]["clock_reads"]
    assert all(r["clock_reads"] == cr for r in b), \
        [r["clock_reads"] for r in b]
    log(f"[serve_tp] (b) the group clock (model_group.GroupClock): "
        f"{cr['total']} reads over the world in {cr['steps']} server steps "
        f"(submissions included), {cr['step_min']}-{cr['step_max']} a step, "
        f"median {cr['step_median']:g}; each an all-gather of 16 bytes a "
        f"rank, on top of the model's collectives above; the same on every "
        f"rank ({note})")
    log(f"[serve_tp] tokens: both ranks identical; (b) vs (a): "
        f"{ties['same']} of {ties['n']} requests identical, worst gap / "
        f"error at a parting {ties['worst']:.3g} (limit {TIE_FACTOR}); fp32 "
        f"at {TP_FP32_LAYERS} layers, tp_size {TP_WORLD} vs 1: identical "
        f"({sum(map(len, a32['tokens']))} tokens); (b)'s logits teacher-"
        f"forced (requests {sorted(teacher)}, {sum(map(len, teacher.values()))}"
        f" positions) vs the fp32 one-rank copy: max rel err {worst:.4g} "
        f"(tol {LOGITS_REL_TOL}); at (b)'s partings from (a) (request, "
        f"position, gap below the top logit, (b)'s max |served - fp32|, "
        f"the request's rel err): {parted}")
    log(f"[serve_tp] bytes a rank: parameters "
        f"{[sum(r['param_bytes'].values()) for r in b]} (predicted "
        f"{want_params}) vs one rank {sum(a['param_bytes'].values())}; KV "
        f"pool {[r['pool_bytes'] for r in b]} vs {a['pool_bytes']} "
        f"({b[0]['kv_heads']} of {a['kv_heads']} KV heads)")
    log(f"[serve_tp] launches: (a) {a['launches']}; (b) rank 0 "
        f"{b[0]['launches']}, rank 1 {b[1]['launches']}; generate() "
        f"{[r['generate_launches']['decode_attention_int8'] for r in b]} "
        f"int8 decode launches; the two ranks took {wall:.1f} s (process "
        f"start and weight loads included)")
    # GPT-2 small's forward at tp_size 2 against one rank
    gb = [r["gpt2"] for r in ranks]
    assert all(g["tokens"] == gb[0]["tokens"] and g["mp"] == TP_WORLD
               for g in gb), "GPT-2 small: the ranks' argmax tokens differ"
    glogits = torch.load(os.path.join(tmp, "gpt2_logits.pt")).to(device)
    with torch.no_grad():
        gwant = gref.logits(torch.as_tensor(gids, device=device)).float()
    grel = rel_err(glogits, gwant)
    garel = rel_err(ga_logits.to(device), gwant)
    for label, err in (("tp_size 2", grel), ("tp_size 1", garel)):
        assert math.isfinite(err) and err <= LOGITS_REL_TOL, \
            f"serve_tp: GPT-2 small at {label}: logits vs the fp32 copy: " \
            f"rel err {err}"
    # where (b)'s argmax parts from (a)'s, a near-tie of the fp32 copy
    btok = glogits.argmax(-1)
    parted = (btok != ga_logits.to(device).argmax(-1)).nonzero().tolist()
    gworst = 0.0
    for i, t in parted:
        err = (glogits[i, t] - gwant[i, t]).abs().max().item()
        gap = (gwant[i, t].max() - gwant[i, t, btok[i, t]]).item()
        gworst = max(gworst, gap / max(err, 1e-30))
        assert gap <= TIE_FACTOR * err, \
            f"serve_tp: GPT-2 small row {i} position {t}: (b)'s argmax " \
            f"lies {gap:.4g} below the fp32 copy's top logit, more than " \
            f"{TIE_FACTOR} x its own error {err:.4g}"
    for g in gb:
        launches.append(g["launches"])
    launches.append(ga_launches)
    if device == "cuda":
        for g in gb + [{"launches": ga_launches}]:
            assert g["launches"]["flash_attention_fwd"] > 0, g["launches"]
    log(f"[serve_tp] GPT-2 small (GPT2LMHeadModel, 768/12/12, fused qkv "
        f"split per head, vocab 50257 whole on every rank, bf16) forward "
        f"of 4 x 64 tokens at tp_size {TP_WORLD} vs 1: logits vs the fp32 "
        f"copy max rel err {grel:.4g} (tp_size 1: {garel:.4g}; tol "
        f"{LOGITS_REL_TOL}); argmax parts from tp_size 1 at "
        f"{len(parted)} of {btok.numel()} positions, each a near-tie "
        f"(worst gap {gworst:.3g} x (b)'s own error, limit {TIE_FACTOR}); "
        f"both ranks identical; flash launches "
        f"{[g['launches']['flash_attention_fwd'] for g in gb]} (ranks), "
        f"{ga_launches['flash_attention_fwd']} (one rank)")
    del a_srv, model, gref
    fresh_device(device)
    dms = []
    for rank in range(dm_world):
        with open(os.path.join(tmp, f"dm{rank}.json")) as fh:
            dms.append(json.load(fh))
    launches += tp_keys_checks(
        [r["keys"] for r in ranks], dms, a_keys, small, qstate, kprompts,
        kbudgets, kspec, kids, torch.load(os.path.join(tmp, "keys_saved.pt")),
        seed, device, note, dm_wall)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-only", action="store_true",
                    help="build, then time the decode and paged kernels' "
                    "rows alone")
    ap.add_argument("--offload-only", action="store_true",
                    help="build, then run train_llama and the offload "
                    "phases (18-20) alone")
    ap.add_argument("--fleet-only", action="store_true",
                    help="build, then run the serving fleet's phases "
                    "(21-22) alone, on serve_paged's traffic")
    ap.add_argument("--resilience-only", action="store_true",
                    help="build, then run the serve_resilience phase alone "
                    "(with the spec phases it compares against)")
    ap.add_argument("--zero-dp-only", action="store_true",
                    help="build, then run train_zero_dp (23) alone")
    # train_zero_dp's arm (b) starts this file once a rank with these
    ap.add_argument("--zero-dp-worker", nargs=3,
                    metavar=("RANK", "WORLD", "DIR"), help=argparse.SUPPRESS)
    ap.add_argument("--zero-dp-spec", default="{}", help=argparse.SUPPRESS)
    ap.add_argument("--tp-only", action="store_true",
                    help="build, then run serve_tp (24) and its kernel rows "
                    "alone")
    # serve_tp's arm (b) starts this file once a rank with these
    ap.add_argument("--tp-worker", nargs=3, metavar=("RANK", "WORLD", "DIR"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--tp-spec", default="{}", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.zero_dp_worker:
        rank, world, tmp = args.zero_dp_worker
        return zero_dp_worker(int(rank), int(world), tmp, args.seed,
                              json.loads(args.zero_dp_spec))
    if args.tp_worker:
        rank, world, tmp = args.tp_worker
        return tp_worker(int(rank), int(world), tmp, args.seed,
                         json.loads(args.tp_spec))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t_start = time.perf_counter()

    card = phase_build()
    if args.decode_only:
        rows = {"decode_attention": decode_kernel_row(gen),
                "paged_decode_attention": paged_kernel(gen)}
        phase_int8_kernels(gen, decode_only=True, rows=rows)
        log(card)
        print(json.dumps({"decode_rows": rows}), flush=True)
        return 0
    if args.zero_dp_only:
        rows = tp_train_kernel_rows(gen)
        phase_train_zero_dp(args.seed)
        log(card)
        print(json.dumps({"tp_train_rows": rows}), flush=True)
        return 0
    if args.tp_only:
        rows = tp_kernel_rows(gen)
        phase_serve_tp(args.seed)
        log(card)
        print(json.dumps({"tp_rank_rows": rows}), flush=True)
        return 0
    if args.offload_only:
        llama = phase_train_llama(args.seed, LLAMA_TIMED_STEPS)
        offload_phases(args.seed, llama)
        log(card)
        return 0
    if args.fleet_only:
        import deepspeed_tpu_torch as dst

        model = gpt2_small(args.seed)
        vocab = model.config.vocab_size
        prompts, budgets = serve_paged_traffic(args.seed, vocab)
        warm = paged_warmup(np.random.default_rng(args.seed + 10), vocab)
        eager = dst.init_inference(model, config={"dtype": "bfloat16"})
        ref = fp32_reference(model, eager)
        colocated = colocated_arm(graph_engine(model), args.seed, warm,
                                  prompts, budgets)
        fleet_phases(model, args.seed, warm, prompts, budgets, colocated,
                     eager, ref)
        log(card)
        return 0
    if args.resilience_only:
        model = gpt2_small(args.seed)
        spec = phase_serve_spec(model, args.seed)
        straffic = ([r.prompt for r in spec["off"]["reqs"]],
                    [r.max_new_tokens for r in spec["off"]["reqs"]])
        spaged = phase_serve_spec_paged(model, args.seed, spec, *straffic)
        phase_serve_resilience(model, args.seed, *straffic,
                               spaged["no drafts"]["reqs"])
        log(card)
        return 0
    def lap(what: str) -> None:
        log(f"[smoke] {what} done at {time.perf_counter() - t_start:.1f} s")

    results = phase_kernels(gen)
    log("[kernels] bf16 times beside PERF.md's (H100 80GB HBM3, 700 W): "
        + ", ".join(f"{name} {results[name]['ms']:.4f} ms (recorded {ms})"
                    for name, ms in RECORDED_BF16_MS.items()))
    results.update(phase_int8_kernels(gen))
    phase_train_kernels(gen, results)
    results.update(phase_sparse_kernels(gen))
    # the serving and training kernels again at a rank's shapes under
    # tensor parallelism
    tp_rows = tp_kernel_rows(gen)
    tp_rows.update(tp_train_kernel_rows(gen))
    for name, row in tp_rows.items():
        results[name.split(" ")[0]].setdefault("tp_rank", {})[name] = row
    lap("kernel rows")
    import deepspeed_tpu_torch as dst

    seed = args.seed
    warm_rng = np.random.default_rng(seed + 10)
    model = gpt2_small(seed)
    vocab = model.config.vocab_size
    srv, reqs, launches, traffic = phase_serve(model, seed)
    ref = fp32_reference(model, srv.engine)
    phase_reference(ref, (reqs[0], reqs[-1]),
                    lambda p, c: served_path_logits(srv.engine, p, c),
                    "reference")
    geng = graph_engine(model)
    cap = phase_captured(
        "serve", srv, reqs, lambda: dst.ServingEngine(
            geng, num_slots=8, prefill_chunk=0, seed=seed,
            strict_recompile=True),
        [[warm_rng.integers(0, vocab, 40)]], *traffic, first_alone=False,
        check_launches=exact_launches("serve", "decode_attention", 12),
        kernel_ms=12 * results["decode_attention"]["ms"])
    runs = [launches, cap["launches"]]
    phase_generate_captured(srv.engine, geng, seed)
    psrv, preqs, paged_launches, ptraffic = phase_serve_paged(model, seed)
    hit = next(r for r in preqs if r.prefix_hit_tokens > 0)
    cold = max((r for r in preqs if r.prefix_hit_tokens == 0),
               key=lambda r: r.prompt_len)
    phase_reference(ref, (hit, cold),
                    lambda p, c: served_paged_logits(psrv, p, c),
                    "reference_paged")
    pwarm = paged_warmup(warm_rng, vocab)
    pgeng = graph_engine(model)
    pcap = phase_captured(
        "serve_paged", psrv, preqs, lambda: dst.ServingEngine(
            pgeng, num_slots=8, prefill_chunk=64, paged_kv=dict(PAGED_KV),
            seed=seed, strict_recompile=True),
        pwarm, *ptraffic, first_alone=True,
        check_launches=exact_launches("serve_paged",
                                      "paged_decode_attention", 12),
        kernel_ms=12 * results["paged_decode_attention"]["ms"])
    runs += [paged_launches, pcap["launches"]]
    phase_overlap_captured("serve_paged", graph_engine(model), preqs, pwarm,
                           *ptraffic, seed)
    lap("serve, serve_paged and their captured arms")
    runs += phase_cost_model(model, seed, pwarm, *ptraffic, preqs)
    runs += fleet_phases(model, seed, pwarm, *ptraffic, pcap, psrv.engine,
                         ref)
    del srv, ref, psrv, geng, pgeng, cap, pcap
    lap("cost_model, serve_disagg, serve_http")
    runs += phase_serve_storage(seed, results, pwarm)
    torch.cuda.empty_cache()
    spec = phase_serve_spec(model, seed)
    straffic = ([r.prompt for r in spec["off"]["reqs"]],
                [r.max_new_tokens for r in spec["off"]["reqs"]])
    spaged = phase_serve_spec_paged(model, seed, spec, *straffic)
    smodel = phase_serve_spec_model(model, seed, spaged,
                                    *(x[:8] for x in straffic))
    runs += [arm["launches"] for group in (spec, spaged)
             for arm in group.values() if "launches" in arm]
    runs.append(smodel["launches"])
    res = phase_serve_resilience(model, seed, *straffic,
                                 spaged["no drafts"]["reqs"])
    runs += [res["launches"], res["contiguous_launches"]]
    lap("serve_storage, the spec phases, serve_resilience")
    del model, spec, spaged, smodel, res
    torch.cuda.empty_cache()

    llama = tinyllama(seed)
    L = llama.config.n_layer
    bf16_ref = copy.deepcopy(llama)
    bf16_ref.replace_config(kv_cache_quant=False, decode_kernel="off",
                            use_flash_attention=False)
    qsrv, qreqs, int8_launches, qtraffic = phase_serve_int8(llama, seed)
    qwarm = paged_warmup(warm_rng, llama.config.vocab_size)
    qgeng = graph_engine(llama)
    qcap = phase_captured(
        "serve_int8", qsrv, qreqs, lambda: dst.ServingEngine(
            qgeng, num_slots=8, prefill_chunk=64, paged_kv=qtraffic[2],
            seed=seed, strict_recompile=True),
        qwarm, *qtraffic[:2], first_alone=True,
        check_launches=exact_launches("serve_int8",
                                      "paged_decode_attention_int8", L,
                                      PROJECTIONS),
        kernel_ms=L * (results["paged_decode_attention_int8"]["ms"]
                       + results["int8_matmul"]["ms"]))
    runs += [int8_launches, qcap["launches"]]
    creqs, contig_launches, csrv, ctraffic = phase_serve_int8_contiguous(
        qsrv, seed)
    ccap = phase_captured(
        "serve_int8_contiguous", csrv, creqs, lambda: dst.ServingEngine(
            qgeng, num_slots=4, prefill_chunk=0, paged_kv=False, seed=seed,
            strict_recompile=True),
        [[qwarm[0][1]]], *ctraffic, first_alone=False,
        check_launches=exact_launches("serve_int8_contiguous",
                                      "decode_attention_int8", L,
                                      PROJECTIONS),
        kernel_ms=L * (results["decode_attention_int8"]["ms"]
                       + results["int8_matmul"]["ms"]))
    runs += [contig_launches, ccap["launches"]]
    qspec = phase_serve_spec_int8(
        qgeng, seed, qtraffic[2], qsrv.engine,
        int8_variant(qsrv, seed).engine.module)
    qspec_launches = [arm["launches"] for arm in qspec.values()
                      if "launches" in arm]
    runs += qspec_launches
    served = (int8_launches, qcap["launches"], contig_launches,
              ccap["launches"], *qspec_launches)
    del qgeng, qcap, ccap, csrv, qspec
    prefill = sum(r["int8_matmul_prefill"] for r in served)
    results["int8_matmul"]["launches_by_regime"] = dict(
        decode=sum(r["int8_matmul"] for r in served) - prefill,
        prefill=prefill)
    log(f"[serve_int8] int8_matmul launches over the int8 serving phases "
        f"(their captured arms and serve_spec_int8 included) by regime: "
        f"{results['int8_matmul']['launches_by_regime']} (decode M <= 16, "
        f"prefill M > 16)")
    qhit = next(r for r in qreqs if r.prefix_hit_tokens > 0)
    qcold = max((r for r in qreqs if r.prefix_hit_tokens == 0),
                key=lambda r: r.prompt_len)
    phase_reference_int8(qsrv, bf16_ref, (qhit, qcold), (creqs[0], creqs[-1]),
                         seed)
    del llama, bf16_ref, qsrv
    torch.cuda.empty_cache()
    runs += phase_zero_inference(seed)
    lap("the int8 serving phases, zero_inference")

    _, _, train_launches, _ = phase_train(
        gpt2_medium(args.seed), args.seed, flagship_config(GAS), 3, "train")
    runs.append(train_launches)
    torch.cuda.empty_cache()
    _, _, fused_launches, _ = phase_train(
        gpt2_medium(args.seed, fused_ln_linear=True), args.seed,
        flagship_config(GAS), 2, "train_fused")
    runs.append(fused_launches)
    torch.cuda.empty_cache()
    phase_reference_train(args.seed)
    runs.extend(phase_train_sparse(args.seed, 3))
    phase_reference_sparse(args.seed)
    lap("train, train_fused, the sparse phases")
    llama = phase_train_llama(args.seed, LLAMA_TIMED_STEPS)
    runs.append(llama["launches"])
    phase_reference_llama(args.seed)
    lap("train_llama, reference_llama")
    runs.append(phase_checkpoint(args.seed, CHECKPOINT_GAS))
    lap("checkpoint")
    runs.extend(offload_phases(args.seed, llama))
    lap("the offload phases")
    del llama
    runs.append(phase_train_zero_dp(args.seed))
    lap("train_zero_dp")
    runs.extend(phase_serve_tp(args.seed))
    # each kernel's launches over the serving and training runs (each
    # counted from 0 just before its run and read just after)
    kernels = [dict(name=name, route="cuda", **KERNELS[name],
                    launches=sum(run[name] for run in runs),
                    **results[name])
               for name in KERNELS]
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    assert not missing, f"kernels never launched on the main paths: " \
        f"{missing}"
    log(f"[smoke] every phase passed in {time.perf_counter() - t_start:.1f} s "
        f"(the build included)")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
