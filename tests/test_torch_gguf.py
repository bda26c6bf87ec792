"""The port's GGUF support (dynamo_tpu_torch/llm/gguf.py) against the JAX
package's (dynamo_tpu/llm/gguf.py): files written by either writer read
back the same by both readers; config, model card and tokenizer equal the
reference's; ``load_gguf_weights`` leaf for leaf bitwise the JAX loader's
for F32, F16, Q8_0 and Q4_0 tensors (both dequantize in numpy), in float32
and bfloat16; every quantized format's dequant the reference's; and an
engine served from GGUF weights (device="cpu") gives the greedy stream of
``JaxLlmEngine`` on the JAX loader's weights."""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.llm import gguf as jax_gguf
from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
from dynamo_tpu_torch.llm import gguf
from dynamo_tpu_torch.llm.protocols.common import (
    Annotated,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context

JCFG = jax_llama.LlamaConfig(
    vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=8, max_position_embeddings=128,
    rope_theta=10000.0, tie_word_embeddings=False, dtype=jnp.float32,
)
NAMES = {
    "attn_norm": "attn_norm.weight", "wq": "attn_q.weight", "wk": "attn_k.weight",
    "wv": "attn_v.weight", "wo": "attn_output.weight", "mlp_norm": "ffn_norm.weight",
    "w_gate": "ffn_gate.weight", "w_up": "ffn_up.weight", "w_down": "ffn_down.weight",
}
QUANT = {"Q8_0": (gguf.GGML_Q8_0, gguf.quantize_q8_0),
         "Q4_0": (gguf.GGML_Q4_0, gguf.quantize_q4_0)}


def export(path, params: dict, kind: str, writer=gguf.write_gguf, tokenizer="gpt2") -> None:
    """The reference test's exporter: norms in F32, every matrix in
    ``kind`` (F32, F16 or a quantized type), projections stored [out, in]."""

    def enc(t: np.ndarray):
        t = np.asarray(t, np.float32)
        if t.ndim == 1 or kind == "F32":
            return t
        if kind == "F16":
            return t.astype(np.float16)
        ggml_type, quantize = QUANT[kind]
        return (ggml_type, t.shape, quantize(t))

    tensors = {"token_embd.weight": enc(params["embed"]),
               "output_norm.weight": enc(params["final_norm"]),
               "output.weight": enc(np.asarray(params["lm_head"]).T)}
    for i in range(JCFG.num_layers):
        for ours, name in NAMES.items():
            t = np.asarray(params["layers"][ours][i], np.float32)
            tensors[f"blk.{i}.{name}"] = enc(t.T if ours.startswith("w") else t)
    meta = {
        "general.architecture": "llama", "general.name": "tiny-test",
        "llama.embedding_length": JCFG.hidden_size,
        "llama.feed_forward_length": JCFG.intermediate_size,
        "llama.block_count": JCFG.num_layers, "llama.attention.head_count": JCFG.num_heads,
        "llama.attention.head_count_kv": JCFG.num_kv_heads,
        "llama.attention.key_length": JCFG.head_dim,
        "llama.attention.layer_norm_rms_epsilon": JCFG.rms_norm_eps,
        "llama.context_length": JCFG.max_position_embeddings,
        "llama.rope.freq_base": JCFG.rope_theta, "llama.vocab_size": JCFG.vocab_size,
        "tokenizer.ggml.eos_token_id": 0, "tokenizer.chat_template": "{{ messages }}",
    }
    if tokenizer == "gpt2":
        meta.update({"tokenizer.ggml.model": "gpt2",
                     "tokenizer.ggml.tokens": ["<pad>", "a", "b", "ab", "c"],
                     "tokenizer.ggml.merges": ["a b"]})
    else:
        meta.update({"tokenizer.ggml.model": "llama",
                     "tokenizer.ggml.tokens": ["<unk>", "▁a", "▁b", "c", "▁"]
                     + [f"<0x{i:02X}>" for i in range(256)],
                     "tokenizer.ggml.scores": [0.0, -1.0, -2.0, -3.0, -4.0] + [-10.0] * 256})
    writer(path, meta, tensors)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("gguf")
    params = jax.tree.map(np.asarray, jax_llama.init_params(JCFG, jax.random.PRNGKey(7)))
    out = {}
    for kind in ("F32", "F16", "Q8_0", "Q4_0"):
        out[kind] = root / f"tiny-{kind}.gguf"
        export(out[kind], params, kind)
    out["by_reference_writer"] = root / "ref.gguf"
    export(out["by_reference_writer"], params, "Q8_0", writer=jax_gguf.write_gguf)
    out["spm"] = root / "spm.gguf"
    export(out["spm"], params, "F32", tokenizer="llama")
    return out


@pytest.mark.parametrize("kind", ["F32", "F16", "Q8_0", "Q4_0"])
def test_both_readers_read_both_writers(files, kind):
    ours, ref = gguf.GGUFFile(files[kind]), jax_gguf.GGUFFile(files[kind])
    assert ours.version == ref.version == 3
    assert ours.metadata == ref.metadata
    assert ours.data_start == ref.data_start
    assert {n: (t.shape, t.ggml_type, t.offset) for n, t in ours.tensors.items()} == \
        {n: (t.shape, t.ggml_type, t.offset) for n, t in ref.tensors.items()}
    for name in ours.tensors:
        np.testing.assert_array_equal(ours.tensor_data(name), ref.tensor_data(name))
    # the writers are byte for byte the same
    if kind == "Q8_0":
        assert files["Q8_0"].read_bytes() == files["by_reference_writer"].read_bytes()


def test_config_card_and_tokenizer_equal_the_reference(files):
    path = files["Q8_0"]
    ours = gguf.config_from_gguf(gguf.GGUFFile(path))
    ref = jax_gguf.config_from_gguf(jax_gguf.GGUFFile(path))
    fields = [f.name for f in dataclasses.fields(ours) if f.name != "dtype"]
    assert {f: getattr(ours, f) for f in fields} == {f: getattr(ref, f) for f in fields}
    assert not ours.tie_word_embeddings  # output.weight present
    assert dataclasses.asdict(gguf.mdc_from_gguf(path)) == \
        dataclasses.asdict(jax_gguf.mdc_from_gguf(path))
    for f in ("Q8_0", "spm"):
        mine = gguf.tokenizer_from_gguf(gguf.GGUFFile(files[f]))
        theirs = jax_gguf.tokenizer_from_gguf(jax_gguf.GGUFFile(files[f]))
        for text in ("ab", "a b c", "abc ab", "zé"):
            assert mine.encode(text).ids == theirs.encode(text).ids
            assert mine.decode(mine.encode(text).ids) == theirs.decode(theirs.encode(text).ids)


@pytest.mark.parametrize("kind", ["F32", "F16", "Q8_0", "Q4_0"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_bitwise_the_jax_loaders(files, kind, dtype):
    jcfg = dataclasses.replace(jax_gguf.config_from_gguf(jax_gguf.GGUFFile(files[kind])),
                               dtype=getattr(jnp, dtype))
    cfg = dataclasses.replace(gguf.config_from_gguf(gguf.GGUFFile(files[kind])),
                              dtype=getattr(torch, dtype))
    want = jax_gguf.load_gguf_weights(jcfg, jax_gguf.GGUFFile(files[kind]))
    got = gguf.load_gguf_weights(cfg, gguf.GGUFFile(files[kind]), "cpu")
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == 3 + len(got["layers"])
    for path, leaf in flat:
        node = got
        for k in path:
            node = node[k.key]
        assert node.dtype == cfg.dtype and tuple(node.shape) == leaf.shape
        a = node.view(torch.int16 if dtype == "bfloat16" else torch.int32).numpy()
        b = np.asarray(leaf).view(np.int16 if dtype == "bfloat16" else np.int32)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", sorted(gguf.GGML_BLOCK_SIZES))
def test_every_dequant_is_the_reference(fmt):
    block_bytes, _ = gguf.GGML_BLOCK_SIZES[fmt]
    raw = np.random.default_rng(fmt).integers(0, 256, (8, block_bytes), dtype=np.uint8)
    # finite fp16 scales: clear the exponent's top bit of each scale field
    raw[:, 1] &= 0x3F
    if fmt in (gguf.GGML_Q4_1, gguf.GGML_Q5_1, gguf.GGML_Q4_K, gguf.GGML_Q5_K):
        raw[:, 3] &= 0x3F
    if fmt == gguf.GGML_Q6_K:
        raw[:, 209] &= 0x3F
    np.testing.assert_array_equal(gguf._DEQUANT[fmt](raw), jax_gguf._DEQUANT[fmt](raw))


def _request(tokens, n=6) -> dict:
    return PreprocessedRequest(token_ids=list(tokens), sampling=SamplingOptions(use_greedy=True),
                               stop=StopConditions(max_tokens=n, ignore_eos=True),
                               eos_token_ids=[0]).to_wire()


async def _stream(engine, req, ctx_cls) -> list:
    out = []
    async for item in await engine.generate(ctx_cls(req)):
        ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
        if ann.data is not None:
            out.extend(ann.data.token_ids)
    return out


@pytest.mark.parametrize("kind", ["F16", "Q4_0"])
async def test_engine_on_gguf_weights_matches_reference(files, kind):
    jg, g = jax_gguf.GGUFFile(files[kind]), gguf.GGUFFile(files[kind])
    jcfg = dataclasses.replace(jax_gguf.config_from_gguf(jg), dtype=jnp.float32)
    cfg = dataclasses.replace(gguf.config_from_gguf(g), dtype=torch.float32)
    kw = dict(num_blocks=32, block_size=4, max_batch_size=4, prefill_buckets=(16, 32),
              max_model_len=64, decode_overlap=False)
    ref = JaxLlmEngine(JaxEngineConfig(model=jcfg, **kw),
                       params=jax_gguf.load_gguf_weights(jcfg, jg))
    ours = TorchLlmEngine(EngineConfig(model=cfg, **kw),
                          params=gguf.load_gguf_weights(cfg, g, "cpu"), device="cpu")
    prompts = [list(range(1, 9)), [5, 9, 2], list(range(10, 30))]
    got = []
    for engine, ctx_cls in ((ref, JaxContext), (ours, Context)):
        engine.start()
        try:
            got.append(await asyncio.gather(*[_stream(engine, _request(p), ctx_cls)
                                              for p in prompts]))
        finally:
            engine.stop()
    assert got[1] == got[0]
    assert all(len(s) == 6 for s in got[1])
