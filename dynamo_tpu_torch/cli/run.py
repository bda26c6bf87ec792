"""dynamo-tpu-torch run — the port's single-command launcher (counterpart of
``dynamo-tpu run``).

``run in=<http|text|batch:FILE|none> out=<torch|echo|mocker|dyn>``:

- ``out=torch|echo|mocker`` serves an engine on an endpoint and registers
  its model (``serve_worker``; ``mocker`` is the simulated engine of
  ``llm/mocker.py``); with ``in=http`` a frontend runs in the same process
  over the memory control plane (``serve_frontend``), as the reference's
  single-command mode does.
- ``in=text`` reads one prompt a line from stdin and prints each answer (an
  empty line ends it); ``in=batch:FILE`` answers every line of FILE (plain
  text, or JSON objects with a ``prompt``) with one JSON line
  ``{"prompt", "response"}``.  Both go through the whole pipeline
  (discovery, preprocessor, router, backend, engine) as chat requests.
- ``in=none out=torch --control-plane HOST:PORT`` is a worker alone, which
  registers with a ``dynctl serve`` control plane.
- ``in=http out=dyn --control-plane HOST:PORT`` is a frontend alone: it
  discovers the workers' models there and routes each request
  (``--router-mode round_robin|random|kv``).

The engine runs on the CUDA card unless ``--device cpu`` is given.
``--warmup`` captures every serving graph before the model registers.
``--speculative ngram`` turns on prompt-lookup speculative decoding
(``--spec-tokens``, ``--spec-ngram``).  ``--host-offload-blocks N`` mounts the
KV offload tiers below the device cache (G2 host memory, then
``--disk-offload-blocks`` on disk and ``--remote-kv-store HOST:PORT``).
``--kv-cache-dtype fp8`` stores the KV cache in fp8 e4m3fn and
``--quantize int8`` serves int8 weight-only projections.

Examples:
  python -m dynamo_tpu_torch.cli.run run in=http out=torch \\
      --model-path tests/data/tiny-chat-model --port 8080 --warmup
  python -m dynamo_tpu_torch.cli.run run in=batch:prompts.jsonl out=torch \
      --model-path tests/data/tiny-chat-model --device cpu
  python -m dynamo_tpu_torch.cli.dynctl serve --port 2379
  python -m dynamo_tpu_torch.cli.run run in=none out=torch \\
      --model-path tests/data/tiny-chat-model --control-plane 127.0.0.1:2379
  python -m dynamo_tpu_torch.cli.run run in=http out=dyn \\
      --control-plane 127.0.0.1:2379 --router-mode kv --port 8080
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
import sys

from dynamo_tpu_torch.runtime.client import RouterMode
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

logger = get_logger("cli.run")

INPUTS = ("http", "text", "none")  # and batch:FILE
OUTPUTS = ("torch", "echo", "mocker", "dyn")
LOCAL_ENGINES = ("torch", "echo", "mocker")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="dynamo-tpu-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="serve a model")
    run.add_argument("io", nargs="*",
                     help="in=<http|text|batch:FILE|none> out=<torch|echo|mocker|dyn>")
    run.add_argument("--model-path", help="local model dir (tokenizer/config/weights)")
    run.add_argument("--model-name", help="served model name (default: dir name)")
    run.add_argument("--host", default="0.0.0.0")
    run.add_argument("--port", type=int, default=8080)
    run.add_argument("--control-plane", default=None, metavar="HOST:PORT",
                     help="dynctl control plane (default: in-process memory)")
    run.add_argument("--namespace", default="dynamo")
    run.add_argument("--component", default="backend")
    run.add_argument("--endpoint", default="generate")
    run.add_argument("--router-mode", choices=[m.value for m in RouterMode],
                     default="round_robin")
    run.add_argument("--request-template", default=None,
                     help="JSON file with default model/temperature/max_tokens")
    run.add_argument("--device", default=None,
                     help="torch device (default: the CUDA card; 'cpu' to run "
                          "on the CPU)")
    run.add_argument("--num-blocks", type=int, default=256, help="KV cache blocks")
    run.add_argument("--max-batch-size", type=int, default=8)
    run.add_argument("--context-length", type=int, default=None)
    run.add_argument("--tensor-parallel-size", type=int, default=1,
                     help="serve on a tp mesh of this many ranks (one process a rank; "
                          "this process is rank 0 and starts the others; ranks share a "
                          "card only over gloo named by DYN_MESH_BACKEND=gloo)")
    run.add_argument("--seed", type=int, default=0,
                     help="seed of random-initialized weights and sampling")
    run.add_argument("--warmup", action="store_true",
                     help="capture every serving graph before registering")
    run.add_argument("--speculative", choices=["ngram"], default=None,
                     help="speculative decoding (ngram = prompt-lookup "
                          "self-drafting with exact greedy verification)")
    run.add_argument("--spec-tokens", type=int, default=4,
                     help="draft tokens verified per step")
    run.add_argument("--spec-ngram", type=int, default=2,
                     help="lookup n-gram width for ngram drafting")
    run.add_argument("--kv-cache-dtype", choices=["fp8", "bf16", "f32"],
                     default=None,
                     help="KV cache storage dtype (fp8 halves KV bytes; "
                          "default: model dtype)")
    run.add_argument("--quantize", choices=["int8"], default=None,
                     help="weight-only quantization (int8 projections, "
                          "dequantized at use)")
    run.add_argument("--host-offload-blocks", type=int, default=0,
                     help="G2 host-DRAM KV tier size (0 = off): device "
                          "evictions offload here and restore on prefix hit")
    run.add_argument("--disk-offload-blocks", type=int, default=0,
                     help="G3 SSD KV tier size (needs --host-offload-blocks)")
    run.add_argument("--remote-kv-store", default=None, metavar="HOST:PORT",
                     help="G4 remote KV tier: a block-store server "
                          "(python -m dynamo_tpu_torch.llm.block_manager.remote); "
                          "bottom-tier evictions cascade there over TCP")
    run.add_argument("--warmup-prompt-lens", type=int, nargs="+", default=None,
                     metavar="N",
                     help="with --warmup, warm the split prefill graphs of "
                          "these prompt lengths alone (default: every length "
                          "whose activations fit the free device memory)")
    args = parser.parse_args(argv)

    args.input, args.output = "http", "torch"
    for tok in args.io:
        if tok.startswith("in="):
            args.input = tok[3:]
        elif tok.startswith("out="):
            args.output = tok[4:]
        else:
            parser.error(f"unrecognized positional {tok!r} (want in=... / out=...)")
    if args.input not in INPUTS and not args.input.startswith("batch:"):
        parser.error(f"in={args.input}: this launcher takes in=http, in=text, "
                     "in=batch:FILE or in=none")
    if args.output not in OUTPUTS:
        parser.error(f"out={args.output}: this launcher takes out=torch, out=echo, "
                     "out=mocker or out=dyn")
    if args.output == "dyn" and args.input == "none":
        parser.error("out=dyn is a frontend alone: it needs in=http, in=text or "
                     "in=batch:FILE")
    if args.output == "dyn" and not args.control_plane:
        parser.error("out=dyn discovers workers on a control plane: give "
                     "--control-plane HOST:PORT")
    if args.input == "none" and not args.control_plane:
        parser.error("in=none is a worker alone: give --control-plane HOST:PORT "
                     "for a frontend to find it")
    if args.output != "dyn" and not args.model_path:
        parser.error("--model-path is required for a local engine")
    return args


def engine_overrides(args: argparse.Namespace) -> dict:
    """The EngineConfig fields the parsed flags set."""
    overrides = dict(
        num_blocks=args.num_blocks, max_batch_size=args.max_batch_size, seed=args.seed,
    )
    if args.context_length:
        overrides["max_model_len"] = args.context_length
    if args.tensor_parallel_size > 1:
        from dynamo_tpu_torch.parallel.mesh import MeshConfig

        overrides["mesh"] = MeshConfig(tp=args.tensor_parallel_size)
    if args.speculative:
        overrides.update(speculative=args.speculative, spec_tokens=args.spec_tokens,
                         spec_ngram=args.spec_ngram)
    if args.kv_cache_dtype:
        overrides["kv_cache_dtype"] = args.kv_cache_dtype
    if args.quantize:
        overrides["quantize"] = args.quantize
    if args.host_offload_blocks:
        overrides["host_offload_blocks"] = args.host_offload_blocks
    if args.disk_offload_blocks:
        overrides["disk_offload_blocks"] = args.disk_offload_blocks
    if args.remote_kv_store:
        overrides["remote_store_addr"] = args.remote_kv_store
    return overrides


async def _run(args) -> int:
    configure_logging()
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.serve import serve_frontend, serve_worker
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    runtime = await DistributedRuntime.create(
        RuntimeConfig(control_plane=args.control_plane or "memory",
                      namespace=args.namespace)
    )
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, runtime.shutdown)
    worker = service = watcher = None
    try:
        if args.output in LOCAL_ENGINES:
            overrides = {}
            if args.output == "torch":
                overrides = dict(engine_overrides(args), device=args.device,
                                 warmup=args.warmup,
                                 warmup_prompt_lens=args.warmup_prompt_lens)
            worker = await serve_worker(
                runtime, args.model_path, model_name=args.model_name,
                namespace=args.namespace, component=args.component,
                endpoint=args.endpoint, engine_kind=args.output, **overrides,
            )
        if args.input == "http":
            service, watcher = await serve_frontend(
                runtime, host=args.host, port=args.port,
                router_mode=RouterMode(args.router_mode),
                request_template=args.request_template,
            )
            print(f"listening on http://{args.host}:{service.port}/v1",
                  file=sys.stderr, flush=True)
        elif args.input == "none":
            print("worker running; ctrl-c to stop", file=sys.stderr, flush=True)
        else:
            await _run_local_io(runtime, args)
            return 0
        await runtime.wait_for_shutdown()
    finally:
        if watcher is not None:
            await watcher.stop()
        if service is not None:
            await service.stop()
        if worker is not None:
            await worker.shutdown()
        await runtime.close()
    return 0


async def _run_local_io(runtime, args) -> None:
    """in=text REPL / in=batch:FILE one-shot, through the full pipeline (a
    copy of the reference's ``_run_local_io``)."""
    from dynamo_tpu_torch.llm.discovery import ModelWatcher
    from dynamo_tpu_torch.llm.http.service import ModelManager
    from dynamo_tpu_torch.llm.protocols.aggregator import aggregate_chat_stream
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.runtime.engine import Context

    manager = ModelManager()
    watcher = ModelWatcher(runtime, manager, router_mode=RouterMode(args.router_mode))
    await watcher.start()
    for _ in range(100):
        if manager.model_names():
            break
        await asyncio.sleep(0.05)
    names = manager.model_names()
    if not names:
        print("no models registered", file=sys.stderr)
        await watcher.stop()
        return
    model = names[0]
    engine = manager.chat_engines[model]

    async def ask(prompt: str) -> str:
        req = ChatCompletionRequest.model_validate(
            {"model": model, "messages": [{"role": "user", "content": prompt}]}
        )
        stream = await engine.generate(Context(req))

        async def data_only():
            async for ann in stream:
                if not ann.is_annotation() and ann.data is not None:
                    yield ann.data

        response = await aggregate_chat_stream(data_only())
        return response.choices[0].message.content if response.choices else ""

    try:
        if args.input == "text":
            print(f"interactive mode, model={model}; empty line exits", file=sys.stderr)
            loop = asyncio.get_running_loop()
            while True:
                line = await loop.run_in_executor(None, sys.stdin.readline)
                line = line.strip()
                if not line:
                    break
                print(await ask(line), flush=True)
        else:
            path = args.input[len("batch:"):]
            with open(path) as f:
                prompts = [json.loads(l)["prompt"] if l.strip().startswith("{") else l.strip()
                           for l in f if l.strip()]
            for prompt in prompts:
                print(json.dumps({"prompt": prompt, "response": await ask(prompt)}), flush=True)
    finally:
        await watcher.stop()


def main(argv=None) -> int:
    args = parse_args(argv)
    return asyncio.run(_run(args))


if __name__ == "__main__":
    raise SystemExit(main())
