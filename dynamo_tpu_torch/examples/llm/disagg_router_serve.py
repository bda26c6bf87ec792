"""Disaggregated + KV-routed serving, one OS process per deployable unit (a
copy of the repository's examples/llm/disagg_router_serve.py on the port).

One command from a clean checkout:

    python -m dynamo_tpu_torch.examples.llm.disagg_router_serve --model tests/data/tiny-chat-model

brings up, under the SDK process supervisor (sdk/supervisor.py):

- the **dynctl control plane** (in this orchestrator process),
- a **frontend** process — OpenAI HTTP + preprocessor + KV-aware router,
- a **decode worker** process — torch engine behind the remote-prefill
  decision (DisaggDecodeEngine),
- N **prefill worker** processes — pumps draining the shared prefill
  queue, shipping finished KV blocks to the decode engine over the
  transfer plane.

Then tokens stream over curl:

    curl -N http://127.0.0.1:8080/v1/chat/completions \\
      -H 'Content-Type: application/json' \\
      -d '{"model": "tiny", "stream": true, \\
           "messages": [{"role": "user", "content": "hello"}]}'

This is the reference's ``dynamo serve graphs.disagg_router:Frontend``
deployment shape (reference: examples/llm/graphs/disagg_router.py:16-24)
as separately-deployable units.  Two deliberate architectural differences:
the processor and the KV router ride inside the frontend process (one
fewer network hop per token than frontend→processor→router chains — see
docs/architecture.md); a fleet that wants routing decisions outside the
frontend deploys ``python -m dynamo_tpu_torch.components.router_service``
instead (the repository's examples/router_standalone shows that wiring).
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys

from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

logger = get_logger("examples.disagg_router_serve")


def _role_cmd(args: argparse.Namespace, role: str) -> list[str]:
    cmd = [
        sys.executable, "-m", "dynamo_tpu_torch.examples.llm.disagg_router_serve",
        "--role", role,
        "--control-plane", args.control_plane,
        "--model", args.model,
        "--model-name", args.model_name,
        "--port", str(args.port),
    ]
    if args.max_local_prefill_length is not None:
        cmd += ["--max-local-prefill-length", str(args.max_local_prefill_length)]
    return cmd


async def orchestrate(args: argparse.Namespace) -> int:
    from dynamo_tpu_torch.runtime.controlplane.server import ControlPlaneServer
    from dynamo_tpu_torch.sdk.supervisor import ProcessSpec, ProcessSupervisor

    server = ControlPlaneServer(port=args.control_plane_port)
    await server.start()
    args.control_plane = f"127.0.0.1:{server.port}"
    logger.info("control plane on %s", args.control_plane)

    sup = ProcessSupervisor()
    # everything from the first spawn onward runs under the finally, so a
    # SIGINT/exception during bring-up still tears the fleet down instead
    # of orphaning worker processes on the HTTP port
    try:
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        # workers first: the frontend's model watcher picks the model up
        # whenever registration lands, so strict ordering is not required —
        # but starting engines early overlaps their compile time
        sup.add_watcher(ProcessSpec(name="decode", cmd=_role_cmd(args, "decode")))
        sup.add_watcher(
            ProcessSpec(name="prefill", cmd=_role_cmd(args, "prefill")),
            replicas=args.prefill_workers,
        )
        sup.add_watcher(ProcessSpec(name="frontend", cmd=_role_cmd(args, "frontend")))
        await sup.start()

        print(
            f"\ndisagg_router up — {1 + 1 + args.prefill_workers} processes + "
            "control plane.\nTry:\n"
            f"  curl -N http://127.0.0.1:{args.port}/v1/chat/completions \\\n"
            "    -H 'Content-Type: application/json' \\\n"
            f"    -d '{{\"model\": \"{args.model_name}\", \"stream\": true, "
            '"messages": [{"role": "user", "content": "hello"}]}}\'\n',
            flush=True,
        )
        await stop.wait()
    finally:
        await sup.stop()
        await server.stop()
    return 0


async def run_role(args: argparse.Namespace) -> int:
    from dynamo_tpu_torch.llm.disagg import PrefillQueue
    from dynamo_tpu_torch.runtime.client import RouterMode
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    from dynamo_tpu_torch.examples.llm.common import (
        LlmGraphConfig,
        launch_disagg_decode_worker,
        launch_frontend,
        launch_prefill_workers,
    )

    cfg = LlmGraphConfig.load(
        None,
        model_dir=args.model,
        model_name=args.model_name,
        http_port=args.port,
        num_prefill_workers=1,  # one pump per prefill PROCESS; scale via --prefill-workers
        **(
            {"max_local_prefill_length": args.max_local_prefill_length}
            if args.max_local_prefill_length is not None
            else {}
        ),
    )
    rt = await DistributedRuntime.create(
        RuntimeConfig.from_env(control_plane=args.control_plane)
    )
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, rt.shutdown)

    handles: list = []
    try:
        if args.role == "frontend":
            service, watcher = await launch_frontend(rt, cfg, RouterMode.KV)
            handles = [watcher, service]
        elif args.role == "decode":
            queue = PrefillQueue(rt, rt.config.namespace, "backend")
            handles = [await launch_disagg_decode_worker(rt, cfg, queue)]
        elif args.role == "prefill":
            queue = PrefillQueue(rt, rt.config.namespace, "backend")
            handles = list(await launch_prefill_workers(rt, cfg, queue))
        else:  # pragma: no cover — argparse choices gate this
            raise ValueError(f"unknown role {args.role}")
        logger.info("%s up", args.role)
        await rt.wait_for_shutdown()
    finally:
        for handle in reversed(handles):
            stop = getattr(handle, "shutdown", None) or getattr(handle, "stop")
            await stop()
        await rt.close()
    return 0


def main(argv: list[str] | None = None) -> int:
    configure_logging()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--role", choices=["frontend", "decode", "prefill"])
    parser.add_argument("--model", default="tests/data/tiny-chat-model",
                        help="HF model dir (config.json [+ safetensors])")
    parser.add_argument("--model-name", default="tiny")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--prefill-workers", type=int, default=1)
    parser.add_argument("--control-plane", default=None,
                        help="(role processes) dynctl address host:port")
    parser.add_argument("--control-plane-port", type=int, default=0,
                        help="(orchestrator) dynctl listen port; 0 = ephemeral")
    parser.add_argument("--max-local-prefill-length", type=int, default=None,
                        help="prompts longer than this go to the prefill fleet")
    args = parser.parse_args(argv)
    if args.role:
        if not args.control_plane:
            parser.error("--role requires --control-plane")
        return asyncio.run(run_role(args))
    return asyncio.run(orchestrate(args))


if __name__ == "__main__":
    raise SystemExit(main())
