"""Model family registry (counterpart of dynamo_tpu/models/registry.py).

Binds an HF ``model_type`` to the functional pieces the engine needs: the
llama family and the llama-geometry variants that differ from it in config
flags or checkpoint quirks (``mistral``, ``qwen2``, ``qwen3``, ``phi3``'s
fused tensors, ``gemma``'s GeGLU, embedding scale and (1 + w) norms); the
Mixtral-class sparse-MoE families (``mixtral``, ``qwen3_moe``) on
``ops/moe.py``; Gemma-2 and Gemma-3 text (``gemma2``, ``gemma3``,
``gemma3_text``), whose per-layer windows, soft-capping and query scale
keep their attention plain, as the reference's stays in XLA, and which
have no unified forward (the engine serves them on the split step); and
the DeepSeek MLA family (``deepseek_v2``, ``deepseek_v3``), whose hooks
give the engine its latent cache and its rope tables.  Each family also
gives its ``param_specs`` and ``cache_specs`` (the reference's
PartitionSpecs, as tuples of axis names) and takes ``mesh=`` in its split
prefill and decode forwards: the engine serves it on a tensor, expert and
pipeline mesh.  The llama family's prefill forwards ring over sp
(``supports_sp``, ``prefix_prefill_accepts_sp``), and the llama and MoE
families pipeline their decode over pp (``forward_decode_pp``), as the
reference's flags say.  Every family with mesh forwards also takes
``mesh=`` in its verify and embeds prefill (``verify_accepts_mesh``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class ModelFamily:
    name: str
    config_from_hf: Callable[[Any], Any]
    # (cfg, generator, device) -> params
    init_params: Callable
    # (cfg, num_blocks, block_size, dtype, device) -> {"k", "v"}; the two
    # may differ in width (the MLA latent and rope-key caches)
    init_kv_cache: Callable
    # (cfg, device, max_len) -> (cos, sin)
    make_rope_tables: Callable
    forward_decode: Callable
    # the ragged unified step (chunked-prefill spans and decode tokens in
    # one pass); None = the engine keeps the split prefill and decode steps
    # (unified fallback "no_family_forward")
    forward_unified: Callable | None = None
    # HF safetensors loader: (cfg, model_dir, device) -> params
    load_weights: Callable | None = None
    # the split prefill step: (params, cfg, tokens, cache, block_ids,
    # seq_len, start_pos, cos, sin) -> (last logits [vocab], cache)
    forward_prefill: Callable | None = None
    # continued prefill over a resident prefix: (params, cfg, tail, cache,
    # full_block_ids, tail_block_ids, tail_len, start_pos, cos, sin)
    forward_prefill_with_prefix: Callable | None = None
    # speculative verification: (params, cfg, tokens [b, w], cache,
    # block_tables, context_lens, slot_ids [b, w], cos, sin) -> logits [b, w, vocab]
    forward_verify: Callable | None = None
    # (cfg, w) -> None: raises ValueError when the family's verify kernel
    # cannot take a window of w positions
    check_verify_width: Callable | None = None
    # the unified step's planner: (cfg, *, block_size, tb_tokens, device,
    # cache_dtype) ->
    # a work_plan.Planner (``plan(page_count)`` -> forward_unified's
    # ``plan``, ``caps(num_tb)`` the fixed capacity of a token bucket's
    # plans), or None where its kernel takes no plan
    unified_planner: Callable | None = None
    # (cfg) -> the largest tb_tokens the unified step's kernel takes (a
    # tuned or forced token-block size above it falls back to the default)
    unified_max_tb: Callable | None = None
    # parameter names (dict keys anywhere in the tree) that the engine's
    # quantize="int8" stores as int8 QuantizedMatrix weights
    quant_leaves: tuple[str, ...] = ()
    # prefill from precomputed input embeddings (multimodal: vision patches
    # spliced before the text): forward_prefill's contract with
    # ``input_embeds [seq_pad, hidden]`` for the tokens; None = the family
    # serves no multimodal request
    forward_prefill_embeds: Callable | None = None
    # the token-embedding lookup, (params, cfg, token_ids) -> [n, hidden],
    # input-embedding quirks (gemma's sqrt(hidden) scale) included, so the
    # engine's multimodal splice stays family-agnostic
    embed: Callable | None = None
    # the reference's PartitionSpecs as tuples of axis names: (cfg) -> a
    # tree of specs matching the parameters; None = the family serves on
    # no mesh
    param_specs: Callable | None = None
    # (cfg) -> {"k", "v"} specs of the cache; None = the llama family's
    # (the layer axis over pp, kv heads over tp)
    kv_cache_specs: Callable | None = None
    # the split prefill and decode forwards take mesh=, the decode running
    # its attention (the paged kernel; Gemma-2/3's plain form) on each tp
    # rank's head shard; False = the engine refuses a mesh by name
    decode_accepts_tp_mesh: bool = False
    # forward_prefill (and _embeds) take an sp mesh: the bucket split over
    # the ranks of sp, attention around the ring (ops/ring_attention.py)
    supports_sp: bool = False
    # forward_prefill_with_prefix rings the tail over sp and folds in the
    # resident prefix: chunked prefill and prefix caching compose with sp
    prefix_prefill_accepts_sp: bool = False
    # the decode pipelined over pp: forward_decode's contract with mesh=
    # and microbatches= (parallel/pipeline.py); None = the stages in turn
    forward_decode_pp: Callable | None = None
    # forward_verify (and forward_prefill_embeds, where the family has one)
    # take mesh=, the verify's attention on each tp rank's head shard (row 2
    # at W > 1, row 5, or Gemma-2/3's plain form): speculation and
    # multimodal prefill serve on a mesh
    verify_accepts_mesh: bool = False

    def forward_prefill_spliced(self, params, cfg, token_ids, kv_cache, embeds, n_patch,
                                block_ids, seq_len, start_pos, cos, sin, *, mesh=None):
        """The multimodal prefill: ``embeds`` [seq_pad, hidden] float32 (the
        patch embeddings, zero past ``n_patch``) in rows [0, n_patch), the
        text's token embeddings (``embed``) after them, through
        ``forward_prefill_embeds``.  On a mesh every rank splices (the
        embedding may be vocab-sharded: its lookup sums over tp)."""
        from dynamo_tpu_torch.parallel.pipeline import first_stage

        pos = torch.arange(token_ids.shape[0], device=token_ids.device)
        x = embeds.to(cfg.dtype)
        if first_stage(mesh):  # a later pp stage takes its rows from the previous one
            kw = {} if mesh is None else {"mesh": mesh}
            x = torch.where((pos < n_patch)[:, None], x, self.embed(params, cfg, token_ids, **kw))
        kw = {} if mesh is None else {"mesh": mesh}
        return self.forward_prefill_embeds(params, cfg, x, kv_cache, block_ids, seq_len,
                                           start_pos, cos, sin, **kw)

    def mesh_param_specs(self, cfg, mesh) -> dict:
        """The specs a rank of ``mesh`` slices its weights by: the family's,
        a pp stage keeping its own layers where the family pipelines its
        decode (``parallel.pipeline.stage_specs``)."""
        specs = self.param_specs(cfg)
        if self.forward_decode_pp is None:
            return specs
        from dynamo_tpu_torch.parallel.pipeline import stage_specs

        return stage_specs(specs, mesh)

    def cache_specs(self, cfg) -> dict:
        """The cache's specs (``kv_cache_specs``, else the llama family's)."""
        if self.kv_cache_specs is not None:
            return self.kv_cache_specs(cfg)
        from dynamo_tpu_torch.models import llama

        return llama.cache_specs(cfg)


def _llama_like_family(name: str, config_tweak=None, *, config_from_hf=None,
                       load_weights=None) -> ModelFamily:
    """One ModelFamily construction for every llama-geometry variant;
    ``config_tweak(dict)`` mutates the HF config before parsing, and
    ``config_from_hf`` / ``load_weights`` replace the parse or the load of
    a family with checkpoint quirks (phi3, gemma)."""
    from dynamo_tpu_torch.models import llama

    def default_config_from_hf(config):
        if not isinstance(config, dict):
            config = json.loads(Path(config).read_text())
        config = dict(config)
        if config_tweak is not None:
            config_tweak(config)
        return llama.LlamaConfig.from_hf_config(config)

    return ModelFamily(
        name=name,
        config_from_hf=config_from_hf or default_config_from_hf,
        init_params=llama.init_params,
        init_kv_cache=llama.init_kv_cache,
        make_rope_tables=llama.make_rope_tables,
        forward_decode=llama.llama_forward_decode,
        forward_unified=llama.llama_forward_unified,
        load_weights=load_weights or llama.load_hf_weights,
        forward_prefill=llama.llama_forward_prefill,
        forward_prefill_with_prefix=llama.llama_forward_prefill_with_prefix,
        forward_verify=llama.llama_forward_verify,
        check_verify_width=llama.check_verify_width,
        unified_planner=llama.unified_planner,
        unified_max_tb=llama.unified_max_tb,
        quant_leaves=llama.QUANT_LEAVES,
        forward_prefill_embeds=llama.llama_forward_prefill_embeds,
        embed=llama._embed,
        param_specs=llama.param_specs,
        decode_accepts_tp_mesh=True,
        supports_sp=True,
        prefix_prefill_accepts_sp=True,
        forward_decode_pp=llama.llama_forward_decode_pp,
        verify_accepts_mesh=True,
    )


def _phi3_family() -> ModelFamily:
    # Phi-3 = llama math with fused checkpoint tensors (split at load) and
    # an always-on sliding window; longrope variants refused at parse
    from dynamo_tpu_torch.models import llama

    return _llama_like_family("phi3", config_from_hf=llama.phi3_config_from_hf,
                              load_weights=llama.phi3_load_hf_weights)


def _gemma_family() -> ModelFamily:
    # Gemma-1 = llama skeleton + GeGLU, sqrt(hidden) embedding scale and
    # (1 + w) RMSNorm baked in at load
    from dynamo_tpu_torch.models import llama

    return _llama_like_family("gemma", config_from_hf=llama.gemma_config_from_hf,
                              load_weights=llama.gemma_load_hf_weights)


def _moe_family(name: str) -> ModelFamily:
    # Mixtral-class routed experts on the llama attention trunk; qwen3_moe
    # adds per-head q/k RMSNorm (from_hf_config infers it from model_type).
    # The cache, rope tables, verify width and unified planner are llama's
    from dynamo_tpu_torch.models import llama, mixtral

    return ModelFamily(
        name=name,
        config_from_hf=mixtral.MixtralConfig.from_hf_config,
        init_params=mixtral.init_params,
        init_kv_cache=llama.init_kv_cache,
        make_rope_tables=llama.make_rope_tables,
        forward_decode=mixtral.mixtral_forward_decode,
        forward_unified=mixtral.mixtral_forward_unified,
        load_weights=mixtral.load_hf_weights,
        forward_prefill=mixtral.mixtral_forward_prefill,
        forward_prefill_with_prefix=mixtral.mixtral_forward_prefill_with_prefix,
        forward_verify=mixtral.mixtral_forward_verify,
        check_verify_width=llama.check_verify_width,
        unified_planner=llama.unified_planner,
        unified_max_tb=llama.unified_max_tb,
        quant_leaves=llama.QUANT_LEAVES,
        param_specs=mixtral.param_specs,
        decode_accepts_tp_mesh=True,
        forward_decode_pp=mixtral.mixtral_forward_decode_pp,
        verify_accepts_mesh=True,
    )


def _gemma2_family() -> ModelFamily:
    # Gemma-2 = alternating local/global attention, attention and final
    # logit soft-capping, sandwich norms, query_pre_attn_scalar; no unified
    # forward (the reference registers none)
    from dynamo_tpu_torch.models import gemma2, llama

    return ModelFamily(
        name="gemma2",
        config_from_hf=gemma2.Gemma2Config.from_hf_config,
        init_params=gemma2.init_params,
        init_kv_cache=llama.init_kv_cache,
        make_rope_tables=gemma2.make_rope_tables,
        forward_decode=gemma2.gemma2_forward_decode,
        load_weights=gemma2.load_hf_weights,
        forward_prefill=gemma2.gemma2_forward_prefill,
        forward_prefill_with_prefix=gemma2.gemma2_forward_prefill_with_prefix,
        forward_verify=gemma2.gemma2_forward_verify,
        quant_leaves=llama.QUANT_LEAVES,
        param_specs=gemma2.param_specs,
        decode_accepts_tp_mesh=True,
        verify_accepts_mesh=True,
    )


def _gemma3_family() -> ModelFamily:
    # Gemma-3 text = the Gemma-2 machinery + a 5:1 local/global pattern,
    # dual rope bases packed on the feature axis and per-head (1 + w) q/k
    # norms, no soft-capping; a multimodal config parses its text_config
    # and image input takes the embeds prefill
    from dynamo_tpu_torch.models import gemma3, llama

    return ModelFamily(
        name="gemma3",
        config_from_hf=gemma3.Gemma3Config.from_hf_config,
        init_params=gemma3.init_params,
        init_kv_cache=llama.init_kv_cache,
        make_rope_tables=gemma3.make_rope_tables,
        forward_decode=gemma3.gemma3_forward_decode,
        load_weights=gemma3.load_hf_weights,
        forward_prefill=gemma3.gemma3_forward_prefill,
        forward_prefill_with_prefix=gemma3.gemma3_forward_prefill_with_prefix,
        forward_verify=gemma3.gemma3_forward_verify,
        quant_leaves=llama.QUANT_LEAVES,
        forward_prefill_embeds=gemma3.gemma3_forward_prefill_embeds,
        embed=llama._embed,
        param_specs=gemma3.param_specs,
        decode_accepts_tp_mesh=True,
        verify_accepts_mesh=True,
    )


def _deepseek_family() -> ModelFamily:
    from dynamo_tpu_torch.models import deepseek

    return ModelFamily(
        name="deepseek",
        config_from_hf=deepseek.DeepseekConfig.from_hf_config,
        init_params=deepseek.init_params,
        init_kv_cache=deepseek.init_kv_cache,
        make_rope_tables=deepseek.make_rope_tables,
        forward_decode=deepseek.deepseek_forward_decode,
        forward_unified=deepseek.deepseek_forward_unified,
        load_weights=deepseek.load_hf_weights,
        forward_prefill=deepseek.deepseek_forward_prefill,
        forward_prefill_with_prefix=deepseek.deepseek_forward_prefill_with_prefix,
        forward_verify=deepseek.deepseek_forward_verify,
        unified_planner=deepseek.unified_planner,
        unified_max_tb=deepseek.unified_max_tb,
        quant_leaves=deepseek.QUANT_LEAVES,
        param_specs=deepseek.param_specs,
        kv_cache_specs=deepseek.kv_cache_specs,
        decode_accepts_tp_mesh=True,
        verify_accepts_mesh=True,
    )


_FAMILIES: dict[str, Callable[[], ModelFamily]] = {
    "llama": lambda: _llama_like_family("llama"),
    # Mistral = llama geometry + sliding-window attention from config.json
    "mistral": lambda: _llama_like_family("llama"),
    # Qwen2/2.5 = llama geometry + attention qkv biases
    "qwen2": lambda: _llama_like_family(
        "qwen2", lambda c: c.setdefault("attention_bias", True)
    ),
    # Qwen3 = llama geometry + per-head q/k RMSNorm before rope
    "qwen3": lambda: _llama_like_family("qwen3", lambda c: c.update(qk_norm=True)),
    "phi3": _phi3_family,
    "gemma": _gemma_family,
    "gemma2": _gemma2_family,
    "gemma3": _gemma3_family,
    "gemma3_text": _gemma3_family,
    "mixtral": lambda: _moe_family("mixtral"),
    "qwen3_moe": lambda: _moe_family("qwen3_moe"),
    # the MLA architectures only: classic DeepSeek-MoE ("deepseek") uses
    # conventional attention and would need a family of its own
    "deepseek_v2": _deepseek_family,
    "deepseek_v3": _deepseek_family,
}


def known_families() -> list[str]:
    return sorted(_FAMILIES)


def get_family(model_type: str) -> ModelFamily:
    factory = _FAMILIES.get(model_type)
    if factory is None:
        raise ValueError(
            f"unknown model family {model_type!r}; known: {sorted(_FAMILIES)}"
        )
    return factory()
