"""Serve OpenAI ``/v1/embeddings`` with the port's embedding engine
(counterpart of examples/embeddings/serve_embeddings.py; reference: the
embedding model type in llmctl, launch/llmctl/src/main.rs:114-180, and
/v1/embeddings lib/llm/src/http/service/openai.rs:572-577).

    python -m dynamo_tpu_torch.examples.embeddings.serve_embeddings \\
        --model tests/data/tiny-chat-model --port 8080 [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import json
from pathlib import Path

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine.embedding import EmbeddingEngineConfig, TorchEmbeddingEngine
from dynamo_tpu_torch.llm.http import HttpService, ModelManager
from dynamo_tpu_torch.llm.tokenizer import HfTokenizer
from dynamo_tpu_torch.models.registry import get_family
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

logger = get_logger("examples.embeddings")


def build_engine(model_dir: str | Path, max_length: int = 512,
                 device=None) -> TorchEmbeddingEngine:
    """The embedding engine of a local model dir: its config.json, weights
    from safetensors when present, else random from the seed."""
    model_dir = Path(model_dir)
    dev = resolve_device(device)
    hf_config = json.loads((model_dir / "config.json").read_text())
    family = get_family(hf_config.get("model_type", "llama"))
    cfg = family.config_from_hf(hf_config)
    tokenizer = HfTokenizer.from_file(model_dir / "tokenizer.json")
    params = None
    try:
        params = family.load_weights(cfg, model_dir, dev)
    except FileNotFoundError:
        logger.warning("no safetensors in %s — random-initializing", model_dir)
    return TorchEmbeddingEngine(EmbeddingEngineConfig(model=cfg, max_length=max_length),
                                tokenizer, params=params, device=dev)


async def amain(model_dir: str, model_name: str, port: int, max_length: int,
                device=None) -> int:
    engine = build_engine(model_dir, max_length, device)
    manager = ModelManager()
    manager.add_embedding_model(model_name, engine)
    service = HttpService(manager, host="127.0.0.1", port=port)
    await service.start()
    logger.info("embeddings: http://127.0.0.1:%d/v1/embeddings (model=%s)", service.port,
                model_name)
    try:
        await asyncio.Event().wait()
    finally:
        await service.stop()
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", required=True)
    parser.add_argument("--model-name", default="embed-model")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--max-length", type=int, default=512)
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (default: the CUDA card)")
    args = parser.parse_args()
    configure_logging()
    return asyncio.run(amain(args.model, args.model_name, args.port, args.max_length,
                             args.device))


if __name__ == "__main__":
    raise SystemExit(main())
