"""Worker entrypoint for subprocess-mode service graphs (a copy of
dynamo_tpu/sdk/runner.py; the serve_dynamo.py analog, reference:
deploy/sdk/.../cli/serve_dynamo.py): load ``module:Class``, connect the
control plane, deploy the service, run until signalled."""

from __future__ import annotations

import argparse
import asyncio
import signal

from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.sdk.graph import deploy_service, resolve_entry
from dynamo_tpu_torch.utils.config import RuntimeConfig
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

logger = get_logger("sdk.runner")


async def amain(target: str, control_plane: str) -> int:
    configure_logging()
    cls = resolve_entry(target)

    runtime = await DistributedRuntime.create(RuntimeConfig(control_plane=control_plane))
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, runtime.shutdown)

    handles = await deploy_service(runtime, cls)
    logger.info("service %s up", target)
    await runtime.wait_for_shutdown()
    for handle in handles:
        await handle.shutdown(drain_timeout=10)
    await runtime.close()
    return 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("target", help="module:Class of the @service")
    parser.add_argument("--control-plane", default="127.0.0.1:2379")
    args = parser.parse_args()
    return asyncio.run(amain(args.target, args.control_plane))


if __name__ == "__main__":
    raise SystemExit(main())
