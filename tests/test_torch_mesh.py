"""The port's mesh sharding against the reference's ``NamedSharding``: for
every leaf of llama (untied, with Qwen2's biases and Qwen3's q/k norms),
Mixtral, DeepSeek and their int8 trees, each rank's ``shard_params`` slice
is bitwise the reference's addressable shard of the same leaf on the same
mesh coordinate (its ``param_specs`` / ``quantize_specs`` at tp = 2 and 4,
ep = 2 and ep x tp = 2 x 2).  Also ``MeshConfig`` and ``make_mesh``'s
rules (the reference's fields and messages; two ranks on one card only
over gloo, named), an uneven shard refused with the reference's message,
and the engine's mesh refusals."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.models import deepseek as jds
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import mixtral as jmx
from dynamo_tpu.models.registry import get_family as jax_family
from dynamo_tpu.ops.quant import quantize_params as jax_quantize
from dynamo_tpu.ops.quant import quantize_specs as jax_quantize_specs
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.models import deepseek, llama, mixtral
from dynamo_tpu_torch.ops.quant import QuantizedMatrix, quantize_specs
from dynamo_tpu_torch.parallel import mesh as pmesh
from dynamo_tpu_torch.parallel.mesh import Mesh, MeshConfig

SIZES = {"tp2": dict(tp=2), "tp4": dict(tp=4), "ep2": dict(ep=2), "ep2tp2": dict(ep=2, tp=2)}

LLAMA = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=8,
             num_kv_heads=4, head_dim=16, max_position_embeddings=256, rope_theta=10000.0,
             tie_word_embeddings=False)
LLAMA_VARIANTS = {
    "llama": {}, "qwen2": dict(attention_bias=True), "qwen3": dict(qk_norm=True),
    "bf16": dict(tie_word_embeddings=True),
}
MOE = dict(LLAMA, intermediate_size=96, num_experts=4, experts_per_token=2, capacity_factor=4.0)
MLA = dict(vocab_size=512, hidden_size=64, num_layers=3, num_heads=4, q_lora_rank=32,
           kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
           intermediate_size=128, first_k_dense=1, moe_intermediate_size=48, num_experts=4,
           experts_per_token=2, n_shared_experts=1, capacity_factor=4.0,
           max_position_embeddings=256, tie_word_embeddings=False)


def port_meshes(sizes: dict) -> list[Mesh]:
    cfg = MeshConfig(**sizes)
    return [Mesh(cfg, r, cfg.total(), torch.device("cpu"), "gloo", {})
            for r in range(cfg.total())]


def ref_shards(tree, specs, sizes: dict) -> list:
    """Per rank (mesh coordinate in the reference's device order), the
    numpy tree of its addressable shards."""
    cfg = jmesh.MeshConfig(**sizes)
    mesh = jmesh.make_mesh(cfg, devices=jax.devices()[: cfg.total()])
    placed = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs)
    devices = list(mesh.devices.flat)

    def on(rank):
        return jax.tree.map(lambda a: np.asarray(next(
            sh.data for sh in a.addressable_shards if sh.device == devices[rank])), placed)

    return [on(r) for r in range(cfg.total())]


def leaves(tree, path=()):
    """(path, bytes view, shape) of every leaf, quantized leaves as q and s."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif hasattr(tree, "q") and hasattr(tree, "s"):
        yield from leaves(tree.q, path + ("q",))
        yield from leaves(tree.s, path + ("s",))
    elif isinstance(tree, torch.Tensor):
        yield path, tree.contiguous().view(torch.uint8).numpy().tobytes(), tuple(tree.shape)
    else:
        a = np.ascontiguousarray(tree)
        yield path, a.view(np.uint8).tobytes(), a.shape


def assert_bitwise(port_tree, ref_tree) -> None:
    ours, ref = list(leaves(port_tree)), list(leaves(ref_tree))
    assert [p for p, _, _ in ours] == [p for p, _, _ in ref]
    for (path, a, sa), (_, b, sb) in zip(ours, ref):
        assert sa == sb, (path, sa, sb)
        assert a == b, path


def case(family: str, variant: str):
    """(reference numpy tree, its specs, port cfg, port shard fn)."""
    if family == "llama":
        over = LLAMA_VARIANTS[variant]
        dt = (jnp.bfloat16, torch.bfloat16) if variant == "bf16" else (jnp.float32, torch.float32)
        jcfg = jl.LlamaConfig(**{**LLAMA, **over, "dtype": dt[0]})
        cfg = llama.LlamaConfig(**{**LLAMA, **over, "dtype": dt[1]})
        tree = jl.init_params(jcfg, jax.random.PRNGKey(0))
        return tree, jl.param_specs(jcfg), cfg, llama.shard_params
    if family == "mixtral":
        jcfg = jmx.MixtralConfig(**MOE, dtype=jnp.float32)
        cfg = mixtral.MixtralConfig(**MOE, dtype=torch.float32)
        return (jmx.init_params(jcfg, jax.random.PRNGKey(1)), jmx.param_specs(jcfg), cfg,
                mixtral.shard_params)
    jcfg = jds.DeepseekConfig(**MLA, dtype=jnp.float32)
    cfg = deepseek.DeepseekConfig(**MLA, dtype=torch.float32)
    return (jds.init_params(jcfg, jax.random.PRNGKey(2)), jds.param_specs(jcfg), cfg,
            deepseek.shard_params)


QUANT_LEAVES = {"llama": jax_family("llama").quant_leaves,
                "mixtral": jax_family("mixtral").quant_leaves,
                "deepseek": jax_family("deepseek_v2").quant_leaves}


# tp = 4 on llama only (the tiny MoE and MLA geometries have 4 heads, 2
# kv heads); the int8 tree on llama, bf16, Mixtral and DeepSeek
SHARD_CASES = [
    (family, variant, sizes, int8)
    for family, variant in (("llama", "llama"), ("llama", "qwen2"), ("llama", "qwen3"),
                            ("llama", "bf16"), ("mixtral", ""), ("deepseek", ""))
    for sizes in SIZES
    for int8 in (False, True)
    if (family == "llama" or sizes != "tp4") and not (int8 and variant in ("qwen2", "qwen3"))
]


@pytest.mark.parametrize("family,variant,sizes,int8", SHARD_CASES)
def test_shards_are_the_reference_named_shards(family, variant, sizes, int8):
    tree, specs, cfg, shard = case(family, variant)
    tree = jax.tree.map(np.asarray, tree)
    if int8:
        tree = jax_quantize(tree, QUANT_LEAVES[family])
        specs = jax_quantize_specs(specs, QUANT_LEAVES[family])
    refs = ref_shards(tree, specs, SIZES[sizes])
    params = llama.params_from_jax(tree, "cpu")
    for mesh, ref in zip(port_meshes(SIZES[sizes]), refs):
        assert_bitwise(shard(params, cfg, mesh), ref)


def test_specs_are_the_references():
    """Every family's spec tree, as tuples, is the reference's
    PartitionSpecs; the cache's too; the int8 twin keeps the scale's
    contraction axis whole."""
    for family, variant in (("llama", "qwen2"), ("llama", "qwen3"), ("mixtral", ""),
                            ("deepseek", "")):
        _, ref_specs, cfg, _ = case(family, variant)
        mod = {"llama": llama, "mixtral": mixtral, "deepseek": deepseek}[family]
        assert jax.tree.map(tuple, ref_specs) == mod.param_specs(cfg)
    assert tuple(jl.kv_cache_spec()) == llama.kv_cache_spec()
    jcfg = jds.DeepseekConfig(**MLA)
    assert {k: tuple(v) for k, v in jds.kv_cache_specs(jcfg).items()} == \
        deepseek.kv_cache_specs(deepseek.DeepseekConfig(**MLA))
    q = quantize_specs(llama.param_specs(llama.LlamaConfig(**LLAMA)), llama.QUANT_LEAVES)
    wo = q["layers"]["wo"]
    assert isinstance(wo, QuantizedMatrix) and wo.q == ("pp", "tp", None)
    assert wo.s == ("pp", None, None)


def test_mesh_config_is_the_references():
    assert pmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    fields = [f.name for f in dataclasses.fields(MeshConfig)]
    assert fields == [f.name for f in dataclasses.fields(jmesh.MeshConfig)]
    cfg = MeshConfig(dp=2, ep=2, tp=2)
    assert cfg.total() == jmesh.MeshConfig(dp=2, ep=2, tp=2).total() == 8
    assert cfg.axis_sizes() == jmesh.MeshConfig(dp=2, ep=2, tp=2).axis_sizes()
    assert MeshConfig.tp_only(4) == MeshConfig(tp=4)
    # rank r is the reference's device r: tp innermost
    coords = [m.coords for m in port_meshes(dict(dp=2, ep=2, tp=2))]
    assert coords[1] == dict(dp=0, pp=0, ep=0, tp=1, sp=0)
    assert coords[2] == dict(dp=0, pp=0, ep=1, tp=0, sp=0)
    assert coords[4] == dict(dp=1, pp=0, ep=0, tp=0, sp=0)


def test_device_range_and_shared_cards(monkeypatch):
    """A mesh wider than the host's cards is refused with the reference's
    message; two ranks share one card only over gloo named by the caller
    (the argument or DYN_MESH_BACKEND), never by a silent switch."""
    with pytest.raises(ValueError) as ref:
        jmesh.make_mesh(jmesh.MeshConfig(tp=16))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(ValueError) as ours:
        pmesh.resolve_backend(MeshConfig(tp=16), "cuda", None, 16)
    assert str(ours.value).startswith(str(ref.value))  # "mesh needs devices [0, 16), have 8"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("DYN_MESH_BACKEND", raising=False)
    with pytest.raises(ValueError, match=r"mesh needs devices \[0, 2\), have 1; ranks share "
                                         r"a card only over gloo"):
        pmesh.resolve_backend(MeshConfig(tp=2), "cuda", None, 2)
    with pytest.raises(ValueError, match="mesh needs devices"):
        pmesh.resolve_backend(MeshConfig(tp=2), "cuda", "nccl", 2)
    assert pmesh.resolve_backend(MeshConfig(tp=2), "cuda", "gloo", 2) == "gloo"
    monkeypatch.setenv("DYN_MESH_BACKEND", "gloo")
    assert pmesh.resolve_backend(MeshConfig(tp=2), "cuda", None, 2) == "gloo"
    assert [pmesh.rank_device(MeshConfig(tp=2), "cuda", r) for r in (0, 1)] == \
        [torch.device("cuda", 0)] * 2
    assert pmesh.resolve_backend(MeshConfig(tp=2), "cpu", None, 2) == "gloo"
    with pytest.raises(ValueError, match="nccl needs cards"):
        pmesh.resolve_backend(MeshConfig(tp=2), "cpu", "nccl", 2)
    with pytest.raises(ValueError, match="no process group"):
        pmesh.make_mesh(MeshConfig(tp=2), device_type="cpu")


def test_uneven_shard_refused_like_the_reference():
    """The tiny chat model's vocabulary (481) does not split over tp = 2:
    the reference's device_put refuses it, and so does the port, with the
    same words; nothing is padded."""
    cfg = jmesh.MeshConfig(tp=2)
    mesh = jmesh.make_mesh(cfg, devices=jax.devices()[:2])
    leaf = np.zeros((481, 64), np.float32)
    with pytest.raises(ValueError) as ref:
        jax.device_put(leaf, NamedSharding(mesh, jl.param_specs(jl.LlamaConfig())["embed"]))
    with pytest.raises(ValueError) as ours:
        pmesh.shard_leaf(torch.from_numpy(leaf), ("tp", None), port_meshes(dict(tp=2))[0], "embed")
    tail = "which implies that the global size of its dimension 0 should be divisible by 2, " \
           "but it is equal to 481 (full shape: (481, 64))"
    assert tail in str(ref.value) and tail in str(ours.value)


CFG = llama.LlamaConfig(**{**LLAMA, "tie_word_embeddings": True, "dtype": torch.float32})
JCFG = jl.LlamaConfig(**{**LLAMA, "tie_word_embeddings": True, "dtype": jnp.float32})


def test_engine_refuses_dp_like_the_reference():
    with pytest.raises(ValueError) as ref:
        JaxLlmEngine(JaxEngineConfig(model=JCFG, mesh=jmesh.MeshConfig(dp=2)))
    with pytest.raises(ValueError) as ours:
        TorchLlmEngine(EngineConfig(model=CFG, mesh=MeshConfig(dp=2)), device="cpu")
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("mesh,over,words", [
    (MeshConfig(pp=2, sp=2), {}, "pp=2 composes with tp (all families) and ep (MoE families "
                                 "with a pipelined decode); got {'sp': 2} for family 'llama'"),
    (MeshConfig(pp=2), dict(max_batch_size=3),
     "max_batch_size=3 must be divisible by the pp axis (2): pipeline microbatches split the "
     "decode batch evenly"),
    (MeshConfig(pp=4), dict(max_batch_size=4),
     "num_layers=2 must be divisible by the pp axis (4): layers split evenly into stages"),
    (MeshConfig(pp=2), dict(speculative="ngram"),
     "speculative decoding does not support pp meshes"),
    (MeshConfig(sp=2), dict(model=mixtral.MixtralConfig(**MOE, dtype=torch.float32),
                            model_family="mixtral", host_offload_blocks=8),
     "KV offload tiers configured but unusable: this model family/config has no prefix "
     "caching"),
    (MeshConfig(tp=3), {}, "num_heads=8 is not divisible by the tp axis (3)"),
])
def test_engine_refuses_later_mesh_items_by_name(mesh, over, words):
    """The reference's refusals on a mesh, word for word: speculation on a
    pp mesh, the offload tiers where an sp mesh turns prefix caching off
    (a family whose continued prefill does not ring), an uneven head
    split."""
    with pytest.raises(ValueError) as exc:
        TorchLlmEngine(EngineConfig(**{"model": CFG, "mesh": mesh, **over}), device="cpu")
    assert words in str(exc.value)


@pytest.mark.parametrize("family", ["gemma2", "gemma3"])
def test_engine_refuses_gemma2_and_gemma3_on_a_mesh(family):
    """Gemma-2 and Gemma-3 now serve on a mesh: their specs are the
    reference's (dynamo_tpu/models/gemma2.py:162, gemma3.py:180), and each
    tp rank's slice is bitwise the reference's shard."""
    from dynamo_tpu.models import gemma2 as jg2
    from dynamo_tpu.models import gemma3 as jg3
    from dynamo_tpu_torch.models import gemma2, gemma3
    from dynamo_tpu_torch.models.registry import get_family

    mod, jmod = {"gemma2": (gemma2, jg2), "gemma3": (gemma3, jg3)}[family]
    model = {"gemma2": gemma2.Gemma2Config, "gemma3": gemma3.Gemma3Config}[family].tiny()
    jcfg = {"gemma2": jg2.Gemma2Config, "gemma3": jg3.Gemma3Config}[family].tiny()
    fam = get_family(family)
    assert fam.decode_accepts_tp_mesh and fam.param_specs(model) == mod.param_specs(model)
    assert jax.tree.map(tuple, jmod.param_specs(jcfg)) == fam.param_specs(model)
    tree = jax.tree.map(np.asarray, jmod.init_params(jcfg, jax.random.PRNGKey(0)))
    ref = ref_shards(tree, jmod.param_specs(jcfg), dict(tp=2))
    full = llama.params_from_jax(tree, "cpu")
    for rank, mesh in enumerate(port_meshes(dict(tp=2))):
        assert_bitwise(mod.shard_params(full, model, mesh), ref[rank])
