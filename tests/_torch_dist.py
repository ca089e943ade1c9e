"""Multi-rank runs of the port on the CPU, for its data- and
tensor-parallel tests.

``spawn(scenario, world, tmp_path, timeout, **kwargs)`` starts ``world``
processes of this file (``start`` returns at once, its ``join()`` waits), each joining one gloo process group through a
``file://`` store under ``tmp_path`` (no fixed port: several test workers
spawn at once) with one intra-op thread, and running
``SCENARIOS[scenario](rank, world, **kwargs)``; the arguments travel in a
``torch.save`` file and each rank's result comes back in one. The workers
import the port and never JAX. A rank that exits non-zero, or a spawn
that outlives ``timeout`` seconds (every rank is then killed), raises.

``train_run(run, rank, world)`` is the training scenario's body: one
engine from a model spec, a config and global batches, run in the calling
process too (no process group: world 1) for the single-rank references.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Spawned:
    """The ranks of one :func:`start`: ``join()`` waits for them (all killed
    past the timeout) and returns each rank's result."""

    def __init__(self, scenario: str, world: int, tmp: str, timeout: float,
                 procs: list):
        self.scenario, self.world, self.tmp = scenario, world, tmp
        self.deadline = time.monotonic() + timeout
        self.timeout, self.procs = timeout, procs

    def join(self) -> list:
        try:
            for rank, (proc, log) in enumerate(self.procs):
                left = self.deadline - time.monotonic()
                try:
                    rc = proc.wait(timeout=max(left, 0.1))
                except subprocess.TimeoutExpired:
                    raise RuntimeError(
                        f"{self.scenario}: rank {rank} of {self.world} still "
                        f"running after {self.timeout} s")
                if rc != 0:
                    raise RuntimeError(
                        f"{self.scenario}: rank {rank} of {self.world} "
                        f"exited {rc}:\n{_tail(self.tmp, rank)}")
        finally:
            for proc, log in self.procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        return [torch.load(os.path.join(self.tmp, f"result{rank}.pt"),
                           weights_only=False) for rank in range(self.world)]


def start(scenario: str, world: int, tmp_path, timeout: float = 120.0,
          **kwargs) -> Spawned:
    """Start ``world`` ranks of ``scenario`` and return at once."""
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    torch.save(kwargs, os.path.join(tmp, "args.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = []
    for rank in range(world):
        log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), scenario, str(rank),
             str(world), tmp], stdout=log, stderr=subprocess.STDOUT,
            env=env, cwd=REPO), log))
    return Spawned(scenario, world, tmp, timeout, procs)


def spawn(scenario: str, world: int, tmp_path, timeout: float = 120.0,
          **kwargs) -> list:
    return start(scenario, world, tmp_path, timeout, **kwargs).join()


def _tail(tmp: str, rank: int) -> str:
    with open(os.path.join(tmp, f"rank{rank}.log")) as fh:
        return "".join(fh.readlines()[-30:])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def rank_rows(batch, rank: int, world: int, gas: int):
    """Rank ``rank``'s rows of a global batch: its contiguous block of each
    of the ``gas`` global micro-batches (the JAX engine's split)."""
    n = len(next(iter(batch.values())))
    m = n // (gas * world)
    idx = np.concatenate([np.arange(k * world * m + rank * m,
                                    k * world * m + (rank + 1) * m)
                          for k in range(gas)])
    return {k: np.asarray(v)[idx] for k, v in batch.items()}


class Squares(torch.nn.Module):
    """``mean(sum((x · w)², -1))`` in the parameter's dtype: each element of
    ``w`` has its own gradient, so an inf in one column of ``x`` makes only
    that element's gradient overflow."""

    def __init__(self, n: int = 8):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((n,), 0.5))

    def forward(self, batch):
        x = batch["x"].to(self.w.dtype)
        return ((x * self.w) ** 2).sum(-1).float().mean()


def build_model(spec):
    """A model from ``(fp32 config, fp32 state dict, compute dtype)``
    (GPT-2 or ``TransformerLM``: built in fp32, loaded, then switched to
    the compute dtype, so the engine's masters are the fp32 weights), or
    ``("squares", n)``."""
    from deepspeed_tpu_torch.models import gpt2, transformer_lm

    if spec[0] == "squares":
        return Squares(spec[1])
    cfg, state, dtype = spec
    if isinstance(cfg, gpt2.GPT2Config):
        model = gpt2.GPT2LMHeadModel(cfg)
    else:
        model = transformer_lm.TransformerLM(cfg)
    model.load_state_dict(state)
    if dtype != cfg.dtype:
        model.replace_config(dtype=dtype)
    return model


def train_run(run: dict, rank: int = 0, world: int = 1) -> dict:
    """One engine: ``run["model"]`` (config, state dict), ``run["config"]``,
    ``run["batches"]`` (global batches, one a step); optional ``mics``
    (the shard size), ``load`` (a checkpoint dir to resume first), ``save``
    (a dir to save to after the steps, followed by the ``next`` batches'
    steps). Returns the losses, the gathered fp32 targets and module state,
    bytes at rest and counters."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import mesh as mesh_mod
    from deepspeed_tpu_torch.utils import tensor_fragment as tf

    mesh_mod.reset_mesh()
    if run.get("mics"):
        from deepspeed_tpu_torch.runtime.zero.mics import MiCS_Init

        MiCS_Init(run["mics"])
    config = run["config"]
    gas = config["gradient_accumulation_steps"]
    model = run["model"] if isinstance(run["model"], torch.nn.Module) \
        else build_model(run["model"])
    engine, *_ = dst.initialize(model=model, config=config, device="cpu")
    out = {"bytes": engine.bytes_at_rest()}
    if run.get("load"):
        engine.load_checkpoint(run["load"])
    comm.comms_logger.reset()
    losses, norms = [], []
    # a rank's rows are its data-parallel block (the ranks of a model
    # group read the same rows)
    rank, world = engine.dp_rank, engine.dp_world_size
    for batch in run["batches"]:
        mine = rank_rows(batch, rank, world, gas)
        losses.append(float(engine.train_batch(batch=mine)))
        norms.append(float(engine.get_global_grad_norm()))
    out["comms"] = comm.comms_logger.totals()
    out["losses"] = losses
    out["norms"] = norms
    out["targets"] = {k: v.detach().float().clone() for k, v in
                      engine._named(engine._targets).items()}
    out["module"] = {k: v.detach().float().clone() for k, v in
                     engine._module_state_dict().items()}
    out["fp32_param"] = {n: tf.safe_get_full_fp32_param(engine, n)
                         for n in engine._param_names}
    out["skipped"] = engine.skipped_steps
    out["scale"] = engine.loss_scale_state
    out["max_live_blocks"] = engine._zero3.max_live_blocks \
        if engine._zero3 is not None else None
    if run.get("fragment"):
        out["fragment"] = _fragment(engine, tf)
    if run.get("save"):
        engine.save_checkpoint(run["save"])
        out["next_losses"] = [
            float(engine.train_batch(batch=rank_rows(b, rank, world, gas)))
            for b in run["next"]]
    return out


def _fragment(engine, tf) -> dict:
    """``tensor_fragment`` on a stage-3 engine's first sharded parameter
    and first whole one: the shapes of the whole master, moment and
    gradient read back, then a write of master + 1 read back (and the
    module's gathered copy following it)."""
    lays = engine._part.layouts
    names = [next(lay.name for lay in lays if lay.param_sharded),
             next(lay.name for lay in lays if not lay.param_sharded)]
    out = {}
    for name in names:
        master = tf.safe_get_full_fp32_param(engine, name)
        moment = tf.safe_get_full_optimizer_state(engine, name, "exp_avg")
        grad = tf.safe_get_full_grad(engine, name)
        tf.safe_set_full_fp32_param(engine, name, master + 1.0)
        back = tf.safe_get_full_fp32_param(engine, name)
        module = engine._module_state_dict()[name].float().numpy()
        out[name] = {
            "shapes": [m.shape for m in (master, moment, grad)],
            "set_reads_back": bool(np.array_equal(back, master + 1.0)),
            "module_follows": bool(np.array_equal(module, master + 1.0))}
    return out


def _train(rank: int, world: int, runs: dict, refuse=None,
           probe=None) -> dict:
    """``train_run`` for each of ``runs`` (rank 0 carries the tensors
    back), then each ``refuse`` (model spec, config)'s refusal message at
    this world (None: the engine was built), then with ``probe`` (keyword
    arguments) the tensor-parallel probe :func:`tp_probe`."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.parallel import mesh as mesh_mod

    results = {}
    for key, run in runs.items():
        res = train_run(run, rank, world)
        if rank != 0:
            res = {k: v for k, v in res.items()
                   if k not in ("targets", "module", "fp32_param")}
        results[key] = res
    refusals = []
    for spec, config in refuse or []:
        mesh_mod.reset_mesh()
        try:
            dst.initialize(model=build_model(spec), config=config,
                           device="cpu")
            refusals.append(None)
        except NotImplementedError as exc:
            refusals.append(str(exc))
    results["refusals"] = refusals
    if probe is not None:
        results["probe"] = tp_probe(rank, world, **probe)
    return results


# ---------------------------------------------------------------------------
# tensor-parallel training: the layers, dropout, refusals
# ---------------------------------------------------------------------------
def _layer_grads(rank: int, world: int) -> dict:
    """Each parallel layer over the model group against the plain layer on
    the whole weights (the same on every rank, from one seed): the largest
    |difference| of its output, input gradient and weight gradients (this
    rank's slice of the plain layer's)."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.module_inject import layers as ML
    from deepspeed_tpu_torch.module_inject.mappings import copy_to_group

    g = torch.Generator().manual_seed(11)
    B, T, C, N, V = 2, 3, 8, 12, 10
    n, v = N // world, V // world
    sl, vs = slice(rank * n, (rank + 1) * n), slice(rank * v, (rank + 1) * v)
    x = torch.randn(B, T, C, generator=g)
    h = torch.randn(B, T, N, generator=g)
    W1, b1 = torch.randn(N, C, generator=g), torch.randn(N, generator=g)
    W2, b2 = torch.randn(C, N, generator=g), torch.randn(C, generator=g)
    E = torch.randn(V, C, generator=g)
    ids = torch.randint(0, V, (B, T), generator=g)
    gy = {k: torch.randn(B, T, d, generator=g)
          for k, d in (("col", N), ("row", C), ("emb", C), ("head", V))}
    # every rank's upstream gradient for the shared KV heads (they differ)
    gshared = torch.randn(world, B, T, n, generator=g)

    def leaf(t):
        return torch.nn.Parameter(t.detach().clone())

    def plain(fn, up, *ts):
        ts = [leaf(t) for t in ts]
        y = fn(*ts)
        (y * up).sum().backward()
        return [y.detach()] + [t.grad for t in ts]

    def err(*pairs):
        return max(float((a - b).abs().max()) for a, b in pairs)

    out = {}
    # column-parallel: a plain Linear over a row slice behind copy_to_group
    xx = leaf(x)
    w, b = leaf(W1[sl]), leaf(b1[sl])
    y = F.linear(copy_to_group(xx), w, b)
    (y * gy["col"][..., sl]).sum().backward()
    want = plain(F.linear, gy["col"], x, W1, b1)
    out["column"] = err((y.detach(), want[0][..., sl]), (xx.grad, want[1]),
                        (w.grad, want[2][sl]), (b.grad, want[3][sl]))
    # row-parallel: a slice of the input features, the bias once
    row = ML.RowParallelLinear(n, C, True)
    row.weight, row.bias = leaf(W2[:, sl]), leaf(b2)
    hh = leaf(h[..., sl])
    y = row(hh)
    (y * gy["row"]).sum().backward()
    want = plain(F.linear, gy["row"], h, W2, b2)
    out["row"] = err((y.detach(), want[0]), (hh.grad, want[1][..., sl]),
                     (row.weight.grad, want[2][:, sl]),
                     (row.bias.grad, want[3]))
    # vocab-parallel embedding, an untied head and a tied head
    emb = ML.VocabParallelEmbedding(v, C, rank * v)
    emb.weight = leaf(E[vs])
    y = emb(ids)
    (y * gy["emb"]).sum().backward()
    want = plain(lambda e: F.embedding(ids, e), gy["emb"], E)
    out["embedding"] = err((y.detach(), want[0]),
                           (emb.weight.grad, want[1][vs]))
    want = plain(F.linear, gy["head"], x, E)
    head = ML.VocabParallelHead(v, C)
    head.weight = leaf(E[vs])
    xx = leaf(x)
    y = head(xx)
    (y * gy["head"]).sum().backward()
    out["head"] = err((y.detach(), want[0]), (xx.grad, want[1]),
                      (head.weight.grad, want[2][vs]))
    emb.weight.grad = None
    tied = ML.VocabParallelHead(v, C, tied=emb)
    xx = leaf(x)
    y = tied(xx)
    (y * gy["head"]).sum().backward()
    out["tied_head"] = err((y.detach(), want[0]), (xx.grad, want[1]),
                           (emb.weight.grad, want[2][vs]))
    # a KV projection every rank holds whole: its gradient is the sum of
    # the ranks' partial gradients
    shared = ML.SharedHeadsLinear(C, n, True, span=(0, n), total=n)
    shared.weight, shared.bias = leaf(W1[:n]), leaf(b1[:n])
    (shared(x) * gshared[rank]).sum().backward()
    want_w = torch.einsum("btn,btc->nc", gshared.sum(0), x)
    want_b = gshared.sum((0, 1, 2))
    out["shared_heads"] = err((shared.weight.grad, want_w),
                              (shared.bias.grad, want_b))
    return out


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def _comm(rank: int, world: int) -> dict:
    """Every collective over the world (again under the comms logger) and
    over the MiCS mesh's two axes, on inputs each rank derives from its
    rank."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import mesh as mesh_mod

    def x(shape, dtype=torch.float32):
        n = int(np.prod(shape))
        return (torch.arange(n, dtype=torch.float64).reshape(shape)
                * (rank + 1) + 0.25 * rank).to(dtype)

    def ops() -> dict:
        r = {}
        for op in ("sum", "avg", "max", "min"):
            r[f"all_reduce_{op}"] = comm.all_reduce(x((3, 4)), op=op)
        r["all_reduce_bf16"] = comm.all_reduce(x((2, 4), torch.bfloat16))
        r["gather0"] = comm.all_gather_into_tensor(x((2, 3)))
        r["gather1"] = comm.all_gather_into_tensor(x((2, 3)), axis=1)
        r["gather_stack"] = comm.all_gather_into_tensor(x((2, 3)), axis=1,
                                                        tiled=False)
        r["gather_bf16"] = comm.all_gather_into_tensor(
            x((5,), torch.bfloat16))
        r["scatter0"] = comm.reduce_scatter_tensor(x((8, 3)))
        r["scatter1"] = comm.reduce_scatter_tensor(x((3, 8)),
                                                   scatter_dimension=1)
        r["scatter_avg"] = comm.reduce_scatter_tensor(x((8, 3)), op="avg")
        r["a2a"] = comm.all_to_all_single(x((8, 2)))
        r["a2a_01"] = comm.all_to_all_single(x((4, 8)), split_axis=1,
                                             concat_axis=0)
        r["broadcast"] = comm.broadcast(x((4,)), src=world - 1)
        return r

    out = {"world": ops()}
    comm.configure(enabled=True)
    comm.comms_logger.reset()
    out["logged"] = ops()
    out["comms"] = comm.comms_logger.totals()
    comm.configure(enabled=False)
    out["host_sum"] = comm.all_reduce_host(np.array([rank, 1.0]))
    out["host_max"] = comm.all_reduce_host(np.array([rank, -rank]), op="max")
    out["host_gather"] = comm.all_gather_host(np.array([rank * 10, rank]))
    out["host_bcast"] = comm.broadcast_host(np.array([rank + 5]), src=1)
    comm.assert_same_across_ranks({"step": 3, "shape": (2, 4)})
    try:
        comm.assert_same_across_ranks({"step": rank})
        out["mismatch"] = None
    except RuntimeError as exc:
        out["mismatch"] = str(exc)
    for name, fn in (("ppermute", lambda: comm.ppermute(x((2,)), [])),
                     ("axis_index", comm.axis_index)):
        try:
            fn()
        except NotImplementedError as exc:
            out[name] = str(exc)
    comm.barrier()
    # the MiCS mesh: data_outer = world / 2 replica groups of data = 2
    mesh_mod.reset_mesh()
    mesh = mesh_mod.initialize_mesh(mics_shard_size=2)
    out["mics_shape"] = mesh.shape
    out["mics_ranks"] = {a: mesh.ranks(a) for a in ("data", "data_outer")}
    out["data_sum"] = comm.all_reduce(x((3,)), group="data")
    out["outer_sum"] = comm.all_reduce(x((3,)), group="data_outer")
    out["dp_sum"] = comm.all_reduce(x((3,)))
    out["data_gather"] = comm.all_gather_into_tensor(x((2,)), group="data")
    out["data_scatter"] = comm.reduce_scatter_tensor(x((4,)), group="data")
    out["sizes"] = {a: comm.get_world_size(a)
                    for a in ("data", "data_outer", "model")}
    out["dp_world"] = mesh_mod.get_data_parallel_world_size()
    out["dp_rank"] = mesh_mod.get_data_parallel_rank()
    return out


def _gloo_cuda(rank: int, world: int) -> dict:
    """On a card: the comm layer's all_gather, reduce_scatter and
    all_to_all over gloo with CUDA tensors against the exact results, fp32
    and bf16, dims 0 and 1."""
    from deepspeed_tpu_torch import comm

    out = {"backend": comm.get_backend()}
    for dtype in (torch.float32, torch.bfloat16):
        for dim in (0, 1):
            parts = [(torch.arange(48, device="cuda").reshape(8, 6)
                      * (r + 1)).to(dtype) for r in range(world)]
            whole = torch.cat(parts, dim)
            got = comm.all_gather_into_tensor(parts[rank], axis=dim)
            out[f"all_gather {dtype} {dim}"] = torch.equal(got, whole)
            k = whole.shape[dim] // world
            got = comm.reduce_scatter_tensor(whole.float(),
                                             scatter_dimension=dim)
            want = (whole.float() * world).narrow(dim, rank * k, k)
            out[f"reduce_scatter {dtype} {dim}"] = \
                torch.equal(got, want)
        got = comm.all_to_all_single(parts[rank])
        want = torch.cat([p.chunk(world)[rank] for p in parts])
        out[f"all_to_all {dtype}"] = torch.equal(got, want)
    return out


# ---------------------------------------------------------------------------
# tensor-parallel serving
# ---------------------------------------------------------------------------
def tp_engine(model, world: int, **config):
    """An fp32 CPU ``InferenceEngine`` over a model group of ``world``
    ranks from ``model`` = (``TransformerConfig``, full state dict): every
    rank builds the whole model on the host, the engine keeps its slice."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.transformer_lm import TransformerLM

    cfg, state = model
    return dst.init_inference(TransformerLM(cfg), model_parameters=state,
                              config={"dtype": "float32", "mp_size": world,
                                      **config}, device="cpu")


def no_leak(srv) -> bool:
    """Every slot free and every page free or held by the prefix cache."""
    pool = srv.pool
    held = len(pool.prefix.page_counts()) if getattr(pool, "prefix", None) \
        else 0
    free = pool.free_page_count + held == pool.num_pages \
        if hasattr(pool, "free_page_count") else True
    return free and pool.free_count == pool.num_slots


def serve(srv, prompts, budgets, **submit_kw) -> dict:
    """Submit every prompt (with ``submit_kw``), drain, audit; the tokens,
    each request's state and deadline stamp, the prefix-hit tokens, the
    cache rows and KV heads the pool holds, whether every slot and page
    came back, the clock reads that went over the world and the steps
    (``srv`` may be a ``ReplicaRouter``: its replicas are audited, the
    first one's reads and steps counted)."""
    from deepspeed_tpu_torch.serving import RequestState

    reqs = [srv.submit(p, max_new_tokens=int(n), **submit_kw)
            for p, n in zip(prompts, budgets)]
    srv.run_until_drained(max_steps=500)
    srv.check_invariants()
    servers = getattr(srv, "replicas", [srv])
    pool = servers[0].pool
    return {"tokens": [list(r.output_tokens) for r in reqs],
            "states": [r.state.value for r in reqs],
            "deadlines": [r.deadline_time for r in reqs],
            "finished": all(r.state is RequestState.FINISHED for r in reqs),
            "hit_tokens": sum(s.stats().get("prefix_hit_tokens", 0)
                              for s in servers),
            "no_leak": all(map(no_leak, servers)),
            "rows": pool.cache["k"].shape[1],
            "kv_heads": pool.cache["k"].shape[2],
            "clock_reads": getattr(servers[0]._now, "reads", 0),
            "steps": servers[0].step_id}


def _http(rank: int, srv, prompts, budgets) -> dict:
    """The HTTP front end over a model group: rank 0 serves
    ``ServingFrontend`` on a local port and streams every prompt through
    ``POST /v1/generate`` (SSE), then reads ``/healthz``; the other ranks
    follow its bridge. Returns the streamed tokens (rank 0) and whether
    every slot and page came back."""
    import asyncio
    import json

    from deepspeed_tpu_torch.serving import ServingFrontend

    fe = ServingFrontend(srv)
    if rank != 0:
        fe.bridge.follow()
        return {"no_leak": no_leak(srv)}

    async def request(port, method, path, body=None):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        payload = b"" if body is None else json.dumps(body).encode()
        writer.write(f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                     f"Content-Length: {len(payload)}\r\n\r\n".encode()
                     + payload)
        await writer.drain()
        raw = await reader.read()
        writer.close()
        return raw.partition(b"\r\n\r\n")[2].decode()

    async def generate(port, prompt, n):
        text = await request(port, "POST", "/v1/generate",
                             {"prompt": [int(t) for t in prompt],
                              "max_new_tokens": int(n)})
        return [json.loads(line[6:])["token"]
                for line in text.split("\n")
                if line.startswith("data: ") and '"token"' in line]

    async def run():
        await fe.start()
        try:
            tokens = await asyncio.gather(*[
                generate(fe.port, p, n) for p, n in zip(prompts, budgets)])
            health = json.loads(await request(fe.port, "GET", "/healthz"))
            metrics = await request(fe.port, "GET", "/metrics")
        finally:
            await fe.stop(drain=True)
        return list(tokens), health, metrics

    tokens, health, metrics = asyncio.run(run())
    return {"tokens": tokens, "group_size": health["group_size"],
            "metrics_group": f"serving_group_size {srv.mp_world_size}"
            in metrics, "no_leak": no_leak(srv)}


def _keys(rank: int, world: int, model, eng, prompts, budgets,
          server: dict) -> dict:
    """Every serving key over the model group, on ``server`` (paged
    ServingEngine keys) and the traffic: each running key's result (what
    :func:`serve` returns, and what the key computes), each key that still
    raises NotImplementedError its message."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference.zero_inference import \
        ZeroInferenceEngine
    from deepspeed_tpu_torch.models.transformer_lm import TransformerLM
    from deepspeed_tpu_torch.serving import FaultInjector, ReplicaRouter
    from deepspeed_tpu_torch.telemetry.costs import _model_terms

    def msg(fn):
        try:
            fn()
        except NotImplementedError as exc:
            return str(exc)
        return None

    def srv(**kw):
        return dst.ServingEngine(eng, max_queue_depth=32,
                                 **{**server, **kw})

    out = {}
    for key, kw in (("deadline_default_ms", dict(deadline_default_ms=1e6)),
                    ("step_wall_budget_ms", dict(step_wall_budget_ms=1e-6)),
                    ("degradation", dict(degradation=True)),
                    ("priority", dict(priority=True)),
                    ("overlap", dict(overlap=True)),
                    ("spec_decode", dict(spec_decode={"drafter": "ngram",
                                                      "k": 3}))):
        s = srv(**kw)
        out[key] = serve(s, prompts, budgets)
        out[key]["overruns"] = s.metrics.step_overruns
        if key == "spec_decode":
            out[key]["drafted"] = s.metrics.drafted
    out["deadline_ms"] = serve(srv(), prompts, budgets, deadline_ms=1e6)
    # a NaN row on rank 1 only: the guard fails it on every rank
    s = srv(guard_numerics=True, fault_injector=FaultInjector(
        seed=0, schedule={"nan_logits": [3]} if rank == 1 else {}))
    out["fault_injector"] = serve(s, prompts, budgets)
    s = srv(cost_model=True)
    out["cost_model"] = serve(s, prompts, budgets)
    full = TransformerLM(model[0], device="meta")
    out["cost_model"].update(
        flops=s.costs.flops_total, mine=_model_terms(eng.module),
        whole=_model_terms(full), mfu=s.efficiency_snapshot()["mfu"])
    pre, dec = srv(role="prefill"), srv(role="decode")
    out["role"] = serve(ReplicaRouter([pre, dec]), prompts, budgets)
    out["role"].update(page_nbytes=dec.pool.page_nbytes,
                       imported=dec.registry.counter(
                           "paging/pages_imported").value)
    out["router"] = serve(ReplicaRouter([srv(), srv()]), prompts, budgets)
    out["http"] = _http(rank, srv(), prompts, budgets)
    q = tp_engine(model, world, quant={"enabled": True})
    out["int8"] = {"generate": q.generate(prompts[0][None], 6).tolist(),
                   "bytes": sum(t.numel() * t.element_size() for t in
                                q.module.state_dict().values())}
    out.update({
        "enable_cuda_graph": msg(lambda: tp_engine(model, world,
                                                   enable_cuda_graph=True)),
        "zero": msg(lambda: tp_engine(model, world, zero={"stage": 3})),
        "zero_inference": msg(lambda: ZeroInferenceEngine(*model,
                                                          device="cpu"))})
    return out


def _gpt2_above_one_rank(world: int, ids) -> dict:
    """``GPT2LMHeadModel`` over the model group (refused until its fused
    qkv split per head): ``init_inference`` at ``mp_size`` = the world,
    its logits' largest relative error against the one-rank model's; and
    ``initialize`` with ``mesh.model`` = the world, two SGD steps, the
    first loss beside the one-rank model's loss on the same rows."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.parallel import mesh as mesh_mod

    def fresh():
        m = gpt2.GPT2LMHeadModel(gpt2.GPT2Config(
            vocab_size=64, n_positions=32, n_embd=32, n_layer=1, n_head=4,
            dtype=torch.float32))
        m.init_weights(torch.Generator().manual_seed(0))
        return m

    ids = torch.as_tensor(ids).long()
    with torch.no_grad():
        want = fresh().logits(ids)
        loss = float(fresh()({"input_ids": ids[:1]}))
    eng = dst.init_inference(fresh(), config={"dtype": "float32",
                                              "mp_size": world},
                             device="cpu")
    got = eng.forward(ids)
    mesh_mod.reset_mesh()
    engine, *_ = dst.initialize(
        model=fresh(), device="cpu",
        config={"train_micro_batch_size_per_gpu": 1,
                "mesh": {"model": world},
                "optimizer": {"type": "SGD", "params": {"lr": 0.1}}})
    losses = [float(engine.train_batch(batch={"input_ids": ids[:1]}))
              for _ in range(2)]
    return {"serve_rel": float(((got - want).norm(dim=-1)
                                / want.norm(dim=-1)).max()),
            "serve_mp": eng.mp_world_size,
            "train_mp": engine.mp_world_size,
            "train_losses": losses, "one_rank_loss": loss}


def _tp(rank: int, world: int, model, ids, new: int, servers: dict,
        prompts, budgets, refuse: bool = False, gpt2_family=None) -> dict:
    """``generate()`` and the forward's logits of ``ids`` over a model group
    of the world's ranks, then each of ``servers`` (label -> ServingEngine
    keys) over the traffic (at world 4 also over a ``(data=2, model=2)``
    mesh), ``generate()`` of ``gpt2_family`` (a second (config, state));
    with ``refuse`` GPT-2 above one rank (:func:`_gpt2_above_one_rank`),
    every serving key (:func:`_keys`, on the paged server), a forced
    digest mismatch (rank 1 reports another digest: every rank must
    raise) and a clock read rank 1 makes alone (every rank must raise)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.transformer_lm import TransformerLM
    from deepspeed_tpu_torch.parallel import mesh as mesh_mod
    from deepspeed_tpu_torch.serving.engine import RankDivergenceError

    mesh_mod.reset_mesh()
    eng = tp_engine(model, world)
    logits = eng.forward(ids).numpy()       # a collective: every rank
    out = {"generate": eng.generate(ids, max_new_tokens=new).tolist(),
           "logits": logits if rank == 0 else None,
           "kv_heads": eng.kv_cache_spec().kv_heads,
           "plan": eng.tp_plan, "mp": eng.mp_world_size,
           "params": {k: tuple(v.shape)
                      for k, v in eng.module.state_dict().items()}}
    out["servers"] = {
        label: serve(dst.ServingEngine(eng, **kw), prompts, budgets)
        for label, kw in servers.items()}
    if world == 4:
        # data 2 beside model 2: each data rank its own model group
        mesh_mod.reset_mesh()
        deng = dst.init_inference(TransformerLM(model[0]),
                                  model_parameters=model[1],
                                  config={"dtype": "float32"}, device="cpu",
                                  mesh=mesh_mod.build_mesh(data=2, model=2))
        out["data_and_model"] = dict(
            mp=deng.mp_world_size, dp=deng.dp_world_size,
            dp_rank=deng.dp_rank, servers={
                label: serve(dst.ServingEngine(deng, max_queue_depth=32,
                                               **kw), prompts, budgets)
                for label, kw in servers.items()})
    if gpt2_family is not None:
        out["gpt2_family"] = tp_engine(gpt2_family, world).generate(
            ids, max_new_tokens=new).tolist()
    if refuse:
        out["above_one_rank"] = _gpt2_above_one_rank(world, ids)
        mesh_mod.reset_mesh()
        eng = tp_engine(model, world)
        out["keys"] = _keys(rank, world, model, eng, prompts, budgets,
                            servers["paged"])
        srv = dst.ServingEngine(eng, num_slots=2)
        if rank == 1:
            srv._digest = lambda *args: 7
        srv.submit(prompts[0], max_new_tokens=2)
        try:
            srv.run_until_drained(max_steps=4)
            out["diverge"] = None
        except RankDivergenceError as exc:
            out["diverge"] = str(exc)
            out["diverge_leak"] = srv.pool.free_count == srv.pool.num_slots
        # a clock read on rank 1 alone meets rank 0's read in submit
        srv = dst.ServingEngine(eng, num_slots=2)
        try:
            if rank == 1:
                srv._now()
            srv.submit(prompts[0], max_new_tokens=2)
            out["clock_diverge"] = None
        except RankDivergenceError as exc:
            out["clock_diverge"] = str(exc)
    return out


class FakeClock:
    """A clock the script moves: ``t`` until ``tick()``."""

    def __init__(self, t: float, step: float):
        self.t, self.step = float(t), float(step)

    def __call__(self) -> float:
        return self.t

    def tick(self) -> None:
        self.t += self.step


def clocked_injector(mod, clock, **kw):
    """``mod.FaultInjector`` whose ``slow_dispatch`` moves ``clock`` by
    ``slow_ms`` instead of sleeping."""
    class Clocked(mod.FaultInjector):
        def maybe_sleep(self, point="slow_dispatch"):
            if self._roll(point):
                clock.t += self.slow_ms / 1e3
                return True
            return False

    return Clocked(**kw)


def clocked_run(res, srv, clock, prompts, budgets, plan) -> tuple:
    """Submit every prompt at step 0 (``plan[i]``: its submit keywords),
    step to the end with ``clock`` ticking a step (``res``: the package's
    ``serving.resilience``, whose injected faults a step may raise), and
    return each request's (state, finish and reject reasons, tokens,
    preemptions, class), each step's load state and the overruns."""
    reqs = [srv.submit(p, max_new_tokens=int(n), **kw)
            for p, n, kw in zip(prompts, budgets, plan)]
    loads = []
    for _ in range(300):
        if not (srv.pending or srv.live_count):
            break
        try:
            srv.step()
        except res.InjectedFault as exc:
            loads.append(exc.point)
        loads.append(srv._load.state.name if srv._load is not None
                      else None)
        clock.tick()
    return [(r.request_id, r.state.value, str(r.finish_reason),
             str(r.reject_reason), list(map(int, r.output_tokens)),
             r.preemptions, r.retry_after_s, r.priority_class)
            for r in reqs], loads, srv.metrics.step_overruns


def _tp_keys(rank: int, world: int, model, qmodel, ids, new: int,
             prompts, budgets, server: dict, clocked: dict) -> dict:
    """The serving keys the JAX TP server is held against over a model
    group of the world's ranks: the int8 storage tier at group sizes 8
    (no group crosses a shard boundary) and 64 (groups cross them), each
    rank's served (dequantized) weights, parametrizations, bytes, logits
    and tokens; an
    ``int8_weights`` model (``qmodel``) through ``int8_matmul``'s plain
    version: logits, tokens, a paged server's tokens; the small-model
    drafter; the cost model's flops; and the clocked keys (``clocked``:
    ServingEngine keys, with ``plan``, ``slow``, ``tick`` and ``t0``)
    with rank 0 on the fake clock the JAX server reads and every other
    rank on a clock that disagrees."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.transformer_lm import TransformerLM
    from deepspeed_tpu_torch.module_inject import (gather_tensor,
                                                   replace_module, tp_plans)
    from deepspeed_tpu_torch.parallel import mesh as mesh_mod
    from deepspeed_tpu_torch.serving import resilience

    def rest(module):
        return sum(t.numel() * t.element_size()
                   for t in module.state_dict().values())

    mesh_mod.reset_mesh()
    out = {}
    for gs in (8, 64):
        eng = tp_engine(model, world, quant={"enabled": True,
                                             "group_size": gs})
        mod = eng.module
        served = {k: getattr(mod.get_submodule(k.rpartition(".")[0]),
                             k.rpartition(".")[2]).detach().clone()
                  for k in model[1]}
        out[f"storage{gs}"] = dict(
            plan=eng.tp_plan, weights=served,
            dequant=sorted({type(m).__name__ for m in mod.modules()
                            if type(m).__name__.endswith("Dequant")}),
            bytes=rest(mod), logits=eng.forward(ids).numpy(),
            generate=eng.generate(ids, max_new_tokens=new).tolist())
    qeng = tp_engine(qmodel, world)
    # the int8 weights and their scales gather back to the whole tensors
    meta = TransformerLM(qmodel[0], device="meta")
    plans = tp_plans(meta, replace_module(meta, tp_size=world))
    hd = qmodel[0].n_embd // qmodel[0].n_head
    local = qeng.module.state_dict()
    gathered = {k: torch.equal(gather_tensor(plans, k, local[k], hd), t)
                for k, t in qmodel[1].items()
                if k.rpartition(".")[2] in ("weight", "scale")
                and "_proj" in k}
    out["int8_weights"] = dict(
        gathered=gathered,
        logits=qeng.forward(ids).numpy(),
        generate=qeng.generate(ids, max_new_tokens=new).tolist(),
        server=serve(dst.ServingEngine(qeng, max_queue_depth=32, **server),
                     prompts, budgets),
        kinds=sorted({type(m).__name__ for m in qeng.module.modules()
                      if "Quant" in type(m).__name__}))
    eng = tp_engine(model, world)
    drafter = tp_engine(model, world)
    out["spec_model"] = serve(dst.ServingEngine(
        eng, max_queue_depth=32, spec_decode={
            "drafter": "model", "k": 3, "draft_engine": drafter},
        **server), prompts, budgets)
    srv = dst.ServingEngine(eng, max_queue_depth=32, cost_model=True,
                            **server)
    out["cost"] = serve(srv, prompts, budgets)
    out["cost"]["flops"] = srv.costs.flops_total
    # rank 0 on the JAX server's clock, the others far off it
    kw = dict(clocked)
    plan, slow = kw.pop("plan"), kw.pop("slow")
    tick, t0 = kw.pop("tick"), kw.pop("t0")
    clock = FakeClock(t0, tick) if rank == 0 else \
        FakeClock(5e4 + 17 * rank, 7.0)
    fi = clocked_injector(resilience, clock, seed=0, slow_ms=50.0,
                          schedule={"slow_dispatch": slow})
    srv = dst.ServingEngine(eng, max_queue_depth=32, clock=clock,
                            fault_injector=fi, **{**server, **kw})
    out["clocked"] = clocked_run(resilience, srv, clock,
                                 prompts, budgets, plan)
    out["clocked_leak"] = no_leak(srv)
    return out


def tp_probe(rank: int, world: int, dropout_models=(), fused=None) -> dict:
    """Over a model group of the world's ranks (data 1): the comm layer's
    all-gather along the last axis, each parallel layer against the plain
    one (``_layer_grads``), the final hidden states of each of
    ``dropout_models`` (model specs, dropout on) after one training-mode
    forward through an engine (every rank of the group must hold the same
    residual stream), and ``fused`` (a GPT-2 spec with
    ``fused_ln_linear=True``): the error its step raises."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import mesh as mesh_mod

    mesh_mod.reset_mesh()
    mesh_mod.initialize_mesh(model=world)
    parts = [torch.arange(6.0).reshape(2, 3) * (r + 1) for r in range(world)]
    out = {"gather_last": torch.equal(
        comm.all_gather_into_tensor(parts[rank], group="model", axis=-1),
        torch.cat(parts, -1))}
    out["layers"] = _layer_grads(rank, world)
    config = {"train_micro_batch_size_per_gpu": 2,
              "mesh": {"model": world},
              "optimizer": {"type": "SGD", "params": {"lr": 0.1}}}
    ids = np.random.default_rng(3).integers(0, 60, (2, 8))
    out["hidden"] = []
    for spec in dropout_models:
        mesh_mod.reset_mesh()
        engine, *_ = dst.initialize(model=build_model(spec), config=config,
                                    device="cpu")
        module = engine.module
        module.seed_dropout(5)
        h = module.hidden(torch.as_tensor(ids), deterministic=False)
        out["hidden"].append((h.detach(),
                              module.hidden(torch.as_tensor(ids)).detach()))
    if fused is not None:
        mesh_mod.reset_mesh()
        engine, *_ = dst.initialize(model=build_model(fused), config=config,
                                    device="cpu")
        try:
            engine.train_batch(batch={"input_ids": ids})
            out["fused"] = None
        except ValueError as exc:
            out["fused"] = str(exc)
    return out


def _act_ckpt(rank: int, world: int) -> dict:
    """``checkpointing.checkpoint`` with ``partition_activations`` over a
    model group of the world's ranks: the bytes its saved input takes (a
    saved-tensor hook sees what the checkpoint keeps), the collectives
    its backward issues, and the value and gradients against the
    uncheckpointed function."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import mesh as mesh_mod
    from deepspeed_tpu_torch.runtime.activation_checkpointing import \
        checkpointing as ckpt

    mesh_mod.reset_mesh()
    mesh_mod.initialize_mesh(model=world)
    g = torch.Generator().manual_seed(0)
    w = torch.nn.Parameter(torch.randn(16, 16, generator=g) / 4)
    x0 = torch.randn(8, 16, generator=g)

    def f(a):
        h = torch.tanh(a @ w)
        return (h * h).sum()

    x = x0.clone().requires_grad_()
    f(x).backward()
    want = (x.grad.clone(), w.grad.clone())
    w.grad = None
    ckpt.reset()
    ckpt.configure(partition_activations=True)
    kept = []

    def pack(t):
        kept.append(t.numel() * t.element_size())
        return t

    x = x0.clone().requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = ckpt.checkpoint(f, x)
    comm.configure(enabled=True, prof_all=True)
    comm.comms_logger.reset()
    y.backward()
    comm.configure(enabled=False)
    ops = {k: v["count"] for k, v in comm.comms_logger.totals().items()}
    ckpt.reset()
    return {"kept": sum(kept), "whole": x0.numel() * x0.element_size(),
            "ops": ops, "value": float(y),
            "grad_err": max(float((x.grad - want[0]).abs().max()),
                            float((w.grad - want[1]).abs().max()))}


SCENARIOS = {"act_ckpt": _act_ckpt, "train": _train, "comm": _comm,
             "gloo_cuda": _gloo_cuda, "tp": _tp, "tp_keys": _tp_keys}


def main(argv) -> int:
    scenario, rank, world, tmp = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    from deepspeed_tpu_torch import comm

    comm.init_distributed(dist_backend="gloo", rank=rank, world_size=world,
                          init_method=f"file://{os.path.join(tmp, 'store')}",
                          timeout=90, verbose=False)
    kwargs = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
    result = SCENARIOS[scenario](rank, world, **kwargs)
    torch.save(result, os.path.join(tmp, f"result{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
