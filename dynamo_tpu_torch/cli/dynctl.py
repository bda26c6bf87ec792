"""dynctl — run the standalone control-plane server (counterpart of
dynamo_tpu/cli/dynctl.py, its ``serve`` verb).

Usage:
  python -m dynamo_tpu_torch.cli.dynctl serve [--host H] [--port P]

Workers (``run in=none out=torch --control-plane H:P``) and frontends
(``run in=http out=dyn --control-plane H:P``) meet on it.  The reference's
admin verbs (list-models, list-instances, remove-model, drain, migrate,
topology, flight) come with a later slice of the port.
"""

from __future__ import annotations

import argparse
import asyncio


async def _amain(args) -> int:
    from dynamo_tpu_torch.runtime.controlplane.server import run_server

    await run_server(args.host, args.port)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="dynctl")
    sub = parser.add_subparsers(dest="cmd", required=True)
    serve = sub.add_parser("serve", help="run the control-plane server")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=2379)
    args = parser.parse_args(argv)
    return asyncio.run(_amain(args))


if __name__ == "__main__":
    raise SystemExit(main())
