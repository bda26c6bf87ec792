"""Model family registry (counterpart of dynamo_tpu/models/registry.py).

Binds an HF ``model_type`` to the functional pieces the engine needs: the
llama family and the llama-geometry variants that differ from it only in
config flags, and the DeepSeek MLA family (``deepseek_v2``,
``deepseek_v3``), whose hooks give the engine its latent cache and its rope
tables.  Mixtral and qwen3_moe (on ``ops/moe.py``), then gemma and phi3
(checkpoint quirks), come with later slices.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable


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
    forward_unified: Callable
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
    # parameter names (dict keys anywhere in the tree) that the engine's
    # quantize="int8" stores as int8 QuantizedMatrix weights
    quant_leaves: tuple[str, ...] = ()


def _llama_like_family(name: str, config_tweak=None) -> ModelFamily:
    """One ModelFamily construction for every llama-geometry variant;
    ``config_tweak(dict)`` mutates the HF config before parsing."""
    from dynamo_tpu_torch.models import llama

    def config_from_hf(config):
        if not isinstance(config, dict):
            config = json.loads(Path(config).read_text())
        config = dict(config)
        if config_tweak is not None:
            config_tweak(config)
        return llama.LlamaConfig.from_hf_config(config)

    return ModelFamily(
        name=name,
        config_from_hf=config_from_hf,
        init_params=llama.init_params,
        init_kv_cache=llama.init_kv_cache,
        make_rope_tables=llama.make_rope_tables,
        forward_decode=llama.llama_forward_decode,
        forward_unified=llama.llama_forward_unified,
        load_weights=llama.load_hf_weights,
        forward_prefill=llama.llama_forward_prefill,
        forward_prefill_with_prefix=llama.llama_forward_prefill_with_prefix,
        forward_verify=llama.llama_forward_verify,
        check_verify_width=llama.check_verify_width,
        unified_planner=llama.unified_planner,
        quant_leaves=llama.QUANT_LEAVES,
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
        quant_leaves=deepseek.QUANT_LEAVES,
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
