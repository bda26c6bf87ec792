"""Serving assembly for the port: engine construction and the in-process
HTTP stack (counterpart of dynamo_tpu/serve.py).

``serve_http`` wires HTTP → preprocessor → backend → engine in one process.
The reference's distributed runtime, discovery and KV router come with a
later slice of the port.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass
from pathlib import Path

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.http import HttpService, ModelManager
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import ChatPreprocessor, CompletionPreprocessor
from dynamo_tpu_torch.llm.tokenizer import HfTokenizer
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("serve")


def build_torch_engine(
    model_dir: str | Path, mdc: ModelDeploymentCard, *, device=None, **overrides,
):
    """A TorchLlmEngine from a local model dir: ``config.json``, weights
    from safetensors when present, random-initialized on the device from
    the engine seed otherwise.  ``overrides`` go to EngineConfig.  Runs on
    the CUDA card unless ``device="cpu"``."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchLlmEngine
    from dynamo_tpu_torch.models.registry import get_family, known_families

    dev = resolve_device(device)
    model_dir = Path(model_dir)
    hf_config = json.loads((model_dir / "config.json").read_text())
    model_type = hf_config.get("model_type", "llama")
    family_name = model_type if model_type in known_families() else "llama"
    family = get_family(family_name)
    cfg = family.config_from_hf(hf_config)
    defaults = dict(
        model=cfg,
        model_family=family_name,
        block_size=mdc.kv_block_size,
        num_blocks=overrides.pop("num_blocks", 256),
        max_batch_size=overrides.pop("max_batch_size", 8),
        max_model_len=overrides.pop("max_model_len", mdc.context_length),
    )
    defaults.update(overrides)
    config = EngineConfig(**defaults)
    params = None
    if family.load_weights is not None:
        try:
            params = family.load_weights(cfg, model_dir, dev)
            logger.info("loaded weights from %s", model_dir)
        except FileNotFoundError:
            logger.warning("no safetensors in %s — random-initializing weights", model_dir)
    return TorchLlmEngine(config, params=params, device=dev)


@dataclass
class HttpHandle:
    service: HttpService
    engine: object

    async def shutdown(self) -> None:
        await self.service.stop()
        self.engine.stop()


async def serve_http(
    model_dir: str | Path,
    *,
    model_name: str | None = None,
    host: str = "0.0.0.0",
    port: int = 8080,
    device=None,
    warmup_prompt_lens=None,
    **engine_overrides,
) -> HttpHandle:
    """Start the engine and an OpenAI HTTP frontend over it, in process.
    ``engine_overrides`` go to EngineConfig (e.g. ``speculative="ngram",
    spec_tokens=4``, ``host_offload_blocks=64``).  Weight loading, and the
    mount of a remote KV store, run off the event loop.  Every serving
    graph is captured (``TorchLlmEngine.warmup``) before the frontend takes
    a request, as the reference warms before its model registers: the first
    request pays no capture.  ``warmup_prompt_lens`` (the prompt lengths the
    traffic brings) warms the split prefill's keys of those lengths alone,
    as the reference's ``aot_precompile(prompt_lens)``; by default every
    key whose activations fit the free device memory is warmed."""
    mdc = ModelDeploymentCard.from_local_path(model_dir, name=model_name)
    engine = await asyncio.to_thread(
        build_torch_engine, model_dir, mdc, device=device, **engine_overrides
    )
    engine.start()
    try:
        await engine.warmup(warmup_prompt_lens)
    except BaseException:
        engine.stop()
        raise
    tokenizer = HfTokenizer.from_model_dir(model_dir)
    backend = Backend(tokenizer)
    manager = ModelManager()
    manager.add_chat_model(mdc.name, ChatPreprocessor(mdc, tokenizer).wrap(backend.wrap(engine)))
    manager.add_completion_model(
        mdc.name, CompletionPreprocessor(mdc, tokenizer).wrap(backend.wrap(engine))
    )
    service = HttpService(manager, host=host, port=port)
    try:
        await service.start()
    except BaseException:
        engine.stop()
        raise
    return HttpHandle(service=service, engine=engine)
