"""Launch an LLM example graph (a copy of the repository's
examples/llm/launch.py on the port).

    python -m dynamo_tpu_torch.examples.llm.launch agg --model /path/to/hf-model --port 8080
    python -m dynamo_tpu_torch.examples.llm.launch disagg_router -f dynamo_tpu_torch/examples/llm/configs/disagg.yaml

Runs until interrupted; serves OpenAI-compatible HTTP on the configured port.
"""

from __future__ import annotations

import argparse
import asyncio

from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.utils.config import RuntimeConfig
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

from dynamo_tpu_torch.examples.llm.common import LlmGraphConfig
from dynamo_tpu_torch.examples.llm.graphs import GRAPHS

logger = get_logger("examples.llm")


async def amain(args: argparse.Namespace) -> int:
    cfg = LlmGraphConfig.load(
        args.config,
        **{
            k: v
            for k, v in dict(
                model_dir=args.model,
                model_name=args.model_name,
                engine_kind=args.engine,
                num_workers=args.workers,
                http_port=args.port,
                device=args.device,
            ).items()
            if v is not None
        },
    )
    rt = await DistributedRuntime.create(
        RuntimeConfig.from_env(control_plane=args.control_plane)
    )
    handle = await GRAPHS[args.graph](rt, cfg)
    logger.info(
        "graph %s up: http://%s:%d/v1/chat/completions (model=%s)",
        args.graph, cfg.http_host, handle.frontend.port, cfg.model_name,
    )
    try:
        await rt.wait_for_shutdown()
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        await handle.shutdown()
        await rt.close()
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("graph", choices=sorted(GRAPHS))
    parser.add_argument("--model", help="local HF model dir (config.json [+ safetensors])")
    parser.add_argument("--model-name", default=None)
    parser.add_argument("--engine", default=None, choices=["torch", "mocker", "echo"])
    parser.add_argument("--workers", type=int, default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="cpu to run the torch engines on the CPU (default: the card)")
    parser.add_argument("-f", "--config", default=None, help="graph config YAML")
    parser.add_argument("--control-plane", default="memory://example")
    args = parser.parse_args()
    configure_logging()
    return asyncio.run(amain(args))


if __name__ == "__main__":
    raise SystemExit(main())
