"""Speculative decoding on an engine mesh, against the reference's.

The verify forwards on gloo ranks (``tests/torch_ranks.py``) against the
reference's ``forward_verify`` on the same inputs, float32 logits within
1e-4: llama at tp = 2 (row 2 at W = 4 on each rank's heads), Mixtral at
tp x ep = 2 x 2 and DeepSeek at tp x ep = 2 x 2 (row 5 on each rank's
heads) under a capacity that drops routed pairs, Gemma-2 and Gemma-3 at
tp = 2.  Then the port's mesh engines with ``speculative="ngram"``: greedy
and seeded streams equal to ``JaxLlmEngine``'s on the same mesh and to the
port's one-card engine's, with equal drafted and accepted counts, for the
tiny chat model's trained weights at tp = 2 and sp = 2 (its vocabulary
padded from 481 to 482 rows so tp divides it; Mixtral and DeepSeek at
tp x ep in ``tests/test_torch_mesh_spec_moe.py``), and the CLI's
``--tensor-parallel-size 2 --speculative ngram``."""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.models import deepseek as jds
from dynamo_tpu.models import gemma2 as jg2
from dynamo_tpu.models import gemma3 as jg3
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import mixtral as jmx
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm.protocols.common import SamplingOptions
from dynamo_tpu_torch.models import deepseek, gemma2, gemma3, llama, mixtral
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.parallel.mesh import MeshConfig
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_engine import CFG as CHAT_CFG
from tests.test_torch_engine import JCFG as CHAT_JCFG
from tests.test_torch_engine import JPARAMS as CHAT_JPARAMS
from tests.test_torch_engine import collect, request
from tests.test_torch_llama import tree_to_numpy
from tests.test_torch_mesh import LLAMA, MLA, MOE
from tests.torch_ranks import RankPool

ATOL = 1e-4   # float32: the row-parallel partial sums add in another order
BLOCKS = (32, 4)
W = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def chat_model(vocab: int = 482):
    """(port cfg, reference cfg, reference tree) of the tiny chat model in
    float32 with its vocabulary padded to ``vocab`` rows: zero embedding
    rows and zero head columns, the same on both sides."""
    tree = tree_to_numpy(CHAT_JPARAMS)
    pad = vocab - CHAT_CFG.vocab_size
    tree["embed"] = np.concatenate([tree["embed"], np.zeros((pad, tree["embed"].shape[1]),
                                                            tree["embed"].dtype)])
    tree["lm_head"] = np.concatenate(
        [tree["lm_head"], np.zeros((tree["lm_head"].shape[0], pad), tree["lm_head"].dtype)], 1)
    return (dataclasses.replace(CHAT_CFG, vocab_size=vocab),
            dataclasses.replace(CHAT_JCFG, vocab_size=vocab), tree)


def model(name: str, **over):
    """(registry key, reference module, port cfg, reference cfg) at the
    mesh tests' tiny geometries, float32."""
    if name == "llama":
        return ("llama", jl, llama.LlamaConfig(**{**LLAMA, **over}, dtype=torch.float32),
                jl.LlamaConfig(**{**LLAMA, **over}, dtype=jnp.float32))
    if name == "mixtral":
        return ("mixtral", jmx, mixtral.MixtralConfig(**{**MOE, **over}, dtype=torch.float32),
                jmx.MixtralConfig(**{**MOE, **over}, dtype=jnp.float32))
    if name == "deepseek":
        return ("deepseek_v2", jds,
                deepseek.DeepseekConfig(**{**MLA, **over}, dtype=torch.float32),
                jds.DeepseekConfig(**{**MLA, **over}, dtype=jnp.float32))
    mod, jmod = (gemma2, jg2) if name == "gemma2" else (gemma3, jg3)
    ours = mod.Gemma2Config if name == "gemma2" else mod.Gemma3Config
    ref = jmod.Gemma2Config if name == "gemma2" else jmod.Gemma3Config
    return (name, jmod, dataclasses.replace(ours.tiny(), dtype=torch.float32, **over),
            dataclasses.replace(ref.tiny(), dtype=jnp.float32, **over))


def verify_steps(vocab: int):
    """A prompt of 12 tokens prefilled into lane 0's blocks, then a verify
    window of W tokens on two lanes: lane 0 over its prompt, lane 1 over
    nothing but its own window."""
    rng = np.random.default_rng(4)
    prompt = np.zeros(16, np.int32)
    prompt[:12] = rng.integers(2, vocab, 12)
    ids = np.arange(8, dtype=np.int32)
    tables = np.stack([ids, ids + 8]).astype(np.int32)
    ctx = np.array([12 + W, W], np.int32)
    slots = np.stack([[tables[0, p // 4] * 4 + p % 4 for p in range(12, 12 + W)],
                      [tables[1, p // 4] * 4 + p % 4 for p in range(W)]]).astype(np.int32)
    return [("prefill", [prompt, ids, np.int32(12), np.int32(0)]),
            ("verify", [rng.integers(2, vocab, (2, W)).astype(np.int32), tables, ctx, slots])]


def reference_verify(name, jmod, jcfg, tree) -> np.ndarray:
    """The reference's prefill then ``forward_verify`` (its XLA attention)
    on one device."""
    prefix = {"deepseek_v2": "deepseek"}.get(name, name)
    cache = (jds.init_kv_cache(jcfg, *BLOCKS) if jmod is jds
             else jl.init_kv_cache(jcfg, *BLOCKS))
    cos, sin = (jl if jmod is jmx else jmod).make_rope_tables(jcfg)
    fwd = {kind: jax.jit(lambda p, c, *a, f=getattr(jmod, f"{prefix}_forward_{kind}"):
                         f(p, jcfg, a[0], c, *a[1:], cos, sin))
           for kind in ("prefill", "verify")}
    for kind, inputs in verify_steps(jcfg.vocab_size):
        logits, cache = fwd[kind](tree, cache, *[jnp.asarray(a) for a in inputs])
    return np.asarray(logits)


@pytest.mark.parametrize("name,sizes", [
    ("llama", dict(tp=2)), ("mixtral", dict(tp=2, ep=2)), ("deepseek", dict(tp=2, ep=2)),
    ("gemma2", dict(tp=2)), ("gemma3", dict(tp=2)),
])
def test_verify_forwards_match_the_reference(pool, name, sizes):
    over = dict(capacity_factor=1.0) if name in ("mixtral", "deepseek") else {}
    family, jmod, cfg, jcfg = model(name, **over)
    tree = jax.tree.map(np.asarray, jmod.init_params(jcfg, jax.random.PRNGKey(6)))
    ref = reference_verify(family, jmod, jcfg, tree)
    world = MeshConfig(**sizes).total()
    ours = pool.run(world, sizes, "forwards", family={"deepseek_v2": "deepseek"}.get(
        family, family), cfg=cfg, params=tree, blocks=BLOCKS, steps=verify_steps(cfg.vocab_size))
    assert ours[1].shape == ref.shape == (2, W, cfg.vocab_size)
    np.testing.assert_allclose(ours[1], ref, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

RUN = list(range(10, 40)) + [10, 11]
PATTERN = [7, 11, 19, 7, 11, 19, 7, 11, 19, 7, 11]
SPEC = dict(num_blocks=64, block_size=4, max_batch_size=4, prefill_buckets=(16, 32, 64),
            max_model_len=96, decode_overlap=False, speculative="ngram", spec_tokens=3)


def spec_requests():
    seeded = SamplingOptions(temperature=1.2, seed=21)
    return [request(RUN, 16, ignore_eos=True), request(PATTERN, 10, ignore_eos=True),
            request(RUN[:20], 8, seeded, ignore_eos=True), request([5, 9, 13, 5, 9], 8,
                                                                   ignore_eos=True)]


async def serve_queued(engine, ctx_cls, reqs):
    """Every request queued before the engine thread starts, so every
    engine schedules the same steps."""
    tasks = [asyncio.ensure_future(collect(engine, r, ctx_cls)) for r in reqs]
    await asyncio.sleep(0.05)
    engine.start()
    try:
        return await asyncio.gather(*tasks), engine.stats()
    finally:
        engine.stop()


def spec_counts(stats) -> tuple:
    return tuple(stats[k] for k in ("spec_drafted_tokens_total", "spec_accepted_tokens_total"))


@pytest.mark.parametrize("name,sizes", [("chat", dict(tp=2)), ("chat", dict(sp=2))])
def test_speculative_streams_match_the_reference_mesh_engine(name, sizes):
    """Greedy and seeded speculative streams of the port's mesh engine
    (every verify window on every rank) equal the reference engine's on the
    same mesh and the port's one-card engine's, with equal draft counts.
    The MoE cases: ``tests/test_torch_mesh_spec_moe.py``."""
    check_speculative_streams(name, sizes)


def check_speculative_streams(name: str, sizes: dict) -> None:
    """The tiny chat model, or a MoE model whose tied embeddings make its
    greedy lanes echo their inputs (every window drafts) routing at a
    capacity that drops pairs: its speculative streams on the mesh, on the
    reference's mesh and on one card, and their draft counts, equal."""
    if name == "chat":
        cfg, jcfg, tree = chat_model()
        family = "llama"
    else:
        family, jmod, cfg, jcfg = model(name, capacity_factor=1.0, tie_word_embeddings=True)
        tree = jax.tree.map(np.asarray, jmod.init_params(jcfg, jax.random.PRNGKey(8)))
    over = dict(model_family=family, **SPEC)
    reqs = spec_requests()
    ref, ref_stats = asyncio.run(serve_queued(JaxLlmEngine(JaxEngineConfig(
        model=jcfg, mesh=jmesh.MeshConfig(**sizes), **over), params=tree), JaxContext, reqs))
    params = params_from_jax(tree, "cpu")
    ours, stats = asyncio.run(serve_queued(TorchLlmEngine(EngineConfig(
        model=cfg, mesh=MeshConfig(**sizes), **over), params=params, device="cpu"),
        Context, reqs))
    one, one_stats = asyncio.run(serve_queued(TorchLlmEngine(EngineConfig(
        model=cfg, **over), params=params, device="cpu"), Context, reqs))
    assert ours == ref == one
    assert spec_counts(stats) == spec_counts(ref_stats) == spec_counts(one_stats)
    assert stats["spec_accepted_tokens_total"] > 0
    assert stats["spec_verify_steps_total"] == one_stats["spec_verify_steps_total"] > 0
    assert stats["mesh_step_time"]["verify"]["steps"] == stats["spec_verify_steps_total"]


def test_cli_serves_a_batch_on_a_tp_mesh_with_speculation(tmp_path):
    """``run --tensor-parallel-size 2 --speculative ngram``: the CLI's worker
    serves every prompt of a batch file from a speculative tp = 2 engine
    (rank 0 in the CLI's process, its shard worker a child)."""
    import json

    from tests.test_torch_tp_cli import model_dir, run

    batch = tmp_path / "prompts.jsonl"
    batch.write_text('abc abc abc abc\n{"prompt": "hello there"}\n')
    out = run(model_dir(tmp_path, vocab_size=512), batch, "--tensor-parallel-size", "2",
              "--speculative", "ngram")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(line) for line in out.stdout.splitlines()]
    assert [d["prompt"] for d in lines] == ["abc abc abc abc", "hello there"]
    assert all(d["response"] for d in lines)
    assert "tp=2" in out.stderr and "speculative lanes keep their verify route" in out.stderr
