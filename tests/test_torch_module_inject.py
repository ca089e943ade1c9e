"""The port's module injection (``deepspeed_tpu_torch/module_inject``)
against the JAX package's, and its tensor-parallel layers and plans.

* ``flax_paths`` names every port parameter by the JAX leaf it comes from:
  the set of (path, shape) equals the JAX tree's, for llama, gpt2-family
  and bloom ``TransformerLM``s (tiny; the JAX shapes by ``jax.eval_shape``);
* ``auto_tp_rules`` over the port module, and over the JAX tree given to the
  port, equals the JAX ``auto_tp_rules`` at 2 and 4; ``get_policy_rules``
  and a truthy ``injection_policy`` through ``replace_module`` equal the
  JAX ones; each rule table resolves every parameter path to the JAX
  entries;
* the parallel layers over a group of one rank (no process group) compute
  what the plain layers do, bit for bit;
* ``tp_plan`` on one-rank views of a (data 1, model N) mesh (no process
  group: a plan reads only this rank's coordinate) splits whole heads,
  replicates the KV heads the query heads share, keeps attention whole
  where whole heads do not divide N, follows a policy that leaves a unit
  whole, and ``shard_state_dict``'s slices over the ranks concatenate to
  the full tensors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import module_inject as JI
from deepspeed_tpu.models import transformer_lm as JL
from deepspeed_tpu_torch import module_inject as MI
from deepspeed_tpu_torch.checkpoint.flax_import import flax_paths
from deepspeed_tpu_torch.models import gpt2 as PG
from deepspeed_tpu_torch.models import transformer_lm as PL
from deepspeed_tpu_torch.module_inject import layers as ML
from deepspeed_tpu_torch.parallel import mesh as PM

from _torch_threads import one_thread  # noqa: F401

TINY = dict(vocab_size=64, max_seq_len=32, n_embd=32, n_layer=2, n_head=4)
FAMILIES = {"llama": dict(n_kv_head=2), "gpt2": {}, "bloom": {}}


@pytest.fixture(scope="module")
def models():
    """family -> (JAX module, JAX shape tree, port module)."""
    out = {}
    for fam, extra in FAMILIES.items():
        jcfg = JL.transformer_config(fam, **TINY, **extra, dtype=jnp.float32)
        jmodel = JL.TransformerLM(jcfg)
        shapes = jax.eval_shape(lambda m=jmodel: m.init(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32),
            method=m.logits))["params"]
        fields = {f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(jcfg)}
        pmodel = PL.TransformerLM(PL.TransformerConfig(
            **{**fields, "dtype": torch.float32}))
        out[fam] = (jmodel, shapes, pmodel)
    return out


def _jax_leaves(shapes):
    return {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_flax_paths_name_the_jax_leaves(models, fam):
    _, shapes, pmodel = models[fam]
    assert dict(flax_paths(pmodel).values()) == _jax_leaves(shapes)


@pytest.mark.parametrize("fam", sorted(FAMILIES))
@pytest.mark.parametrize("n", [2, 4])
def test_auto_tp_rules_match_jax(models, fam, n):
    _, shapes, pmodel = models[fam]
    want = JI.auto_tp_rules(shapes, n).raw_rules
    assert MI.auto_tp_rules(pmodel, n).raw_rules == want
    assert MI.auto_tp_rules(jax.tree_util.tree_map(
        lambda s: tuple(s.shape), shapes), n).raw_rules == want
    excl = JI.auto_tp_rules(shapes, n, exclude=("mlp",)).raw_rules
    assert MI.auto_tp_rules(pmodel, n, exclude=("mlp",)).raw_rules == excl


POLICY = {r"attn/q_proj/kernel": (None, None, "model"),
          r"embed_tokens/embedding": ("model", None)}


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_policy_rules_and_injection_policy_match_jax(models, fam):
    jmodel, shapes, pmodel = models[fam]
    cases = [(JI.get_policy_rules(jmodel), MI.get_policy_rules(pmodel)),
             (JI.replace_module(jmodel, shapes, 2, injection_policy=POLICY),
              MI.replace_module(pmodel, tp_size=2, injection_policy=POLICY)),
             (JI.replace_module(jmodel, shapes, 2,
                                injection_policy=list(POLICY.items())),
              MI.replace_module(pmodel, tp_size=2,
                                injection_policy=list(POLICY.items()))),
             (JI.auto_tp_rules(shapes, 2), MI.auto_tp_rules(pmodel, 2))]
    paths = _jax_leaves(shapes)
    for want, got in cases:
        assert [(p, tuple(s)) for p, s in got.raw_rules] == \
            [(p, tuple(s)) for p, s in want.raw_rules]
        for path in paths:
            w, g = want.spec_for(path), got.spec_for(path)
            assert (g is None) == (w is None), path
            assert w is None or tuple(g) == tuple(w), path


def test_gpt2_rules_one_rank_only():
    """GPT-2's policy rules are the JAX ones at every ``tp_size`` (they
    were refused above one rank until the per-head qkv split was ported),
    and at ``tp_size`` 2 a rank's plan splits whole heads: its slice of
    the fused qkv is its heads' columns of each of the q, k and v blocks
    (and of the bias), its slice of ``attn.proj`` those columns' rows, the
    MLP and the even vocabulary split evenly, the norms and positions
    whole."""
    model = PG.GPT2LMHeadModel(PG.GPT2Config(
        vocab_size=64, n_positions=32, n_embd=32, n_layer=1, n_head=4,
        dtype=torch.float32))
    from deepspeed_tpu.models.gpt2 import gpt2_sharding_rules

    assert MI.get_policy_rules(model).raw_rules == gpt2_sharding_rules()
    assert MI.get_policy_rules(model, tp_size=2).raw_rules == \
        gpt2_sharding_rules()
    assert MI.get_policy_rules(torch.nn.Linear(2, 2)) is None
    model.init_weights(torch.Generator().manual_seed(3))
    full = model.state_dict()
    C, D, w = 32, 8, 16
    for rank in range(2):
        plan = _plan(model, 2, rank)
        assert (plan.q_heads, plan.vocab, plan.ffn) == (
            (2 * rank, 2 * rank + 2), (32 * rank, 32 * rank + 32),
            (64 * rank, 64 * rank + 64))
        part = MI.shard_state_dict(plan, full, D)
        cols = slice(w * rank, w * (rank + 1))
        for leaf in ("weight", "bias"):
            qkv = full[f"blocks.0.attn.qkv.{leaf}"]
            want = torch.cat([qkv[j * C:(j + 1) * C][cols] for j in range(3)])
            assert torch.equal(part[f"blocks.0.attn.qkv.{leaf}"], want)
        assert torch.equal(part["blocks.0.attn.proj.weight"],
                           full["blocks.0.attn.proj.weight"][:, cols])
        assert torch.equal(part["wte.weight"],
                           full["wte.weight"][32 * rank:32 * (rank + 1)])
        for key in ("blocks.0.attn.proj.bias", "blocks.0.ln_1.weight",
                    "wpe.weight"):
            assert torch.equal(part[key], full[key])
        # three pieces: this rank's heads in each of the q, k, v blocks
        assert plan.pieces("blocks.0.attn.qkv.weight", D) == (0, tuple(
            (j * C + w * rank, j * C + w * (rank + 1)) for j in range(3)))


def test_parallel_layers_at_one_rank_are_the_plain_layers():
    PM.reset_mesh()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 16, generator=g)
    lin = torch.nn.Linear(16, 8)
    par = ML.RowParallelLinear(16, 8, True)
    par.load_state_dict(lin.state_dict())
    assert torch.equal(par(x), torch.nn.functional.linear(x, lin.weight)
                       + lin.bias)
    emb = torch.nn.Embedding(10, 16)
    pemb = ML.VocabParallelEmbedding(10, 16, 0)
    pemb.load_state_dict(emb.state_dict())
    ids = torch.tensor([[0, 9, 3]])
    assert torch.equal(pemb(ids), emb(ids))
    # a block of rows [4, 8): ids outside it give zero rows
    part = ML.VocabParallelEmbedding(4, 16, 4)
    part.weight.data.copy_(emb.weight[4:8])
    got = part(torch.tensor([3, 4, 7, 8]))
    assert torch.equal(got[1:3], emb.weight[4:8:3]) and \
        not got[0].any() and not got[3].any()
    head = ML.VocabParallelHead(10, 16)
    head.weight.data.copy_(emb.weight)
    assert torch.equal(head(x), torch.nn.functional.linear(
        x.float(), emb.weight.float()))
    tied = ML.VocabParallelHead(10, 16, tied=pemb)
    assert not list(tied.parameters()) and torch.equal(
        tied(x), torch.nn.functional.linear(x, pemb.weight).float())


def _plan(model, n, rank, rules=None):
    mesh = PM.ProcessMesh(PM.MESH_AXES, (1, 1, 1, 1, n), rank)
    rules = rules or MI.get_policy_rules(model)
    return MI.tp_plan(model, rules, mesh)


def _lm(**kw):
    cfg = PL.transformer_config("llama", **{**TINY, **kw},
                                dtype=torch.float32)
    model = PL.TransformerLM(cfg)
    model.init_weights(torch.Generator().manual_seed(1))
    return model


@pytest.mark.parametrize("H,KV,D,n,want", [
    (4, 2, 8, 2, [((0, 2), (0, 1)), ((2, 4), (1, 2))]),
    (4, 2, 8, 4, [((0, 1), (0, 1)), ((1, 2), (0, 1)), ((2, 3), (1, 2)),
                  ((3, 4), (1, 2))]),
    (8, 8, 8, 2, [((0, 4), (0, 4)), ((4, 8), (4, 8))]),
    (4, 1, 8, 2, [((0, 2), (0, 1)), ((2, 4), (0, 1))]),
    # every projection divides by 3, but rank 0's 4 query heads read KV
    # heads 0, 0, 0, 1: no integer ratio, attention whole
    (12, 4, 12, 3, [(None, None)] * 3),
    (4, 4, 8, 8, [(None, None)] * 8),  # half heads: attention whole
])
def test_plan_splits_whole_heads(H, KV, D, n, want):
    model = _lm(n_embd=D * H, n_head=H, n_kv_head=KV, vocab_size=192)
    for rank, (q, kv) in enumerate(want):
        plan = _plan(model, n, rank)
        assert (plan.q_heads, plan.kv_heads) == (q, kv)
        assert plan.vocab == (rank * 192 // n, (rank + 1) * 192 // n)


def test_plan_follows_the_rules():
    model = _lm(n_kv_head=2)
    whole = MI.ShardingRules([(r"attn/q_proj/kernel", (None, None, "model"))])
    plan = _plan(model, 2, 0, whole)        # q alone: no unit splits
    assert plan == MI.TPPlan(2, 0)
    assert _plan(model, 1, 0) == MI.TPPlan(1, 0)
    odd = _lm(vocab_size=63)                # 63 rows: the vocab stays whole
    assert _plan(odd, 2, 1).vocab is None and _plan(odd, 2, 1).head is None


@pytest.mark.parametrize("fam,n", [("llama", 2), ("llama", 4),
                                   ("bloom", 2), ("gpt2", 4)])
def test_shard_state_dict_tiles_the_full_tensors(fam, n):
    cfg = PL.transformer_config(fam, **TINY, **FAMILIES[fam],
                                dtype=torch.float32)
    model = PL.TransformerLM(cfg)
    model.init_weights(torch.Generator().manual_seed(2))
    full = model.state_dict()
    plans = [_plan(model, n, r) for r in range(n)]
    parts = [MI.shard_state_dict(plan, full, cfg.head_dim) for plan in plans]
    for key, t in full.items():
        cuts = [plan.pieces(key, cfg.head_dim) for plan in plans]
        if cuts[0] is None:
            assert all(torch.equal(p[key], t) for p in parts), key
            continue
        # each distinct block once (ranks sharing a KV head hold it alike)
        blocks = {}
        for cut, part in zip(cuts, parts):
            assert torch.equal(blocks.setdefault(cut, part[key]),
                               part[key]), key
        got = torch.cat([blocks[c] for c in sorted(blocks)], cuts[0][0])
        assert torch.equal(got, t), key
