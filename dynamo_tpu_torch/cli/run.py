"""dynamo-tpu-torch run — the port's single-command launcher.

``dynamo-tpu-torch run in=http out=torch --model-path DIR [--device cpu]``
serves a model over the OpenAI HTTP API from one process (counterpart of
``dynamo-tpu run in=http out=jax``).  The engine runs on the CUDA card
unless ``--device cpu`` is given.  ``--speculative ngram`` turns on
prompt-lookup speculative decoding (``--spec-tokens``, ``--spec-ngram``);
such an engine runs every prefill through the split prefill step.
``--host-offload-blocks N`` mounts the KV offload tiers below the device
cache (G2 host memory, then ``--disk-offload-blocks`` on disk and
``--remote-kv-store HOST:PORT``): evicted prefix blocks restore on a later
prefix hit instead of being recomputed.  ``--kv-cache-dtype fp8`` stores
the KV cache in fp8 e4m3fn (the kernels upcast it at load) and
``--quantize int8`` serves int8 weight-only projections.

Example:
  python -m dynamo_tpu_torch.cli.run run in=http out=torch \\
      --model-path tests/data/tiny-chat-model --port 8080 [--speculative ngram]
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys

from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

logger = get_logger("cli.run")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="dynamo-tpu-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="serve a model")
    run.add_argument("io", nargs="*", help="in=http out=torch")
    run.add_argument("--model-path", required=True,
                     help="local model dir (tokenizer/config/weights)")
    run.add_argument("--model-name", help="served model name (default: dir name)")
    run.add_argument("--host", default="0.0.0.0")
    run.add_argument("--port", type=int, default=8080)
    run.add_argument("--device", default=None,
                     help="torch device (default: the CUDA card; 'cpu' to run "
                          "on the CPU)")
    run.add_argument("--num-blocks", type=int, default=256, help="KV cache blocks")
    run.add_argument("--max-batch-size", type=int, default=8)
    run.add_argument("--context-length", type=int, default=None)
    run.add_argument("--seed", type=int, default=0,
                     help="seed of random-initialized weights and sampling")
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
    args = parser.parse_args(argv)

    args.input, args.output = "http", "torch"
    for tok in args.io:
        if tok.startswith("in="):
            args.input = tok[3:]
        elif tok.startswith("out="):
            args.output = tok[4:]
        else:
            parser.error(f"unrecognized positional {tok!r} (want in=... / out=...)")
    if args.input != "http" or args.output != "torch":
        parser.error("this launcher serves in=http out=torch")
    return args


def engine_overrides(args: argparse.Namespace) -> dict:
    """The EngineConfig fields the parsed flags set."""
    overrides = dict(
        num_blocks=args.num_blocks, max_batch_size=args.max_batch_size, seed=args.seed,
    )
    if args.context_length:
        overrides["max_model_len"] = args.context_length
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
    from dynamo_tpu_torch.serve import serve_http

    handle = await serve_http(
        args.model_path, model_name=args.model_name, host=args.host,
        port=args.port, device=args.device, **engine_overrides(args),
    )
    print(f"listening on http://{args.host}:{handle.service.port}/v1", file=sys.stderr, flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    try:
        await stop.wait()
    finally:
        await handle.shutdown()
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    return asyncio.run(_run(args))


if __name__ == "__main__":
    raise SystemExit(main())
