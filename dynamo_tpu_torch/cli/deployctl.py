"""Deployment CLI: build a graph artifact, push it, deploy it.

The reference's ``dynamo build`` / ``dynamo deploy`` pair (reference:
deploy/sdk/src/dynamo/sdk/cli/deployment.py) — against this repo's
api-store (deploy/api_store.py) and operator (deploy/operator.py), with
GPU resources and the port's image (``dynamo-tpu-torch:latest``):

    # render an SDK graph to a manifest file
    python -m dynamo_tpu_torch.cli.deployctl build \\
        dynamo_tpu_torch.examples.hello_world.hello_world:Frontend \\
        --out frontend.graph.json

    # push it to the api-store as a versioned artifact
    python -m dynamo_tpu_torch.cli.deployctl push frontend.graph.json \\
        --store http://api-store:8085 --name chat --version v1

    # build+push in one step
    python -m dynamo_tpu_torch.cli.deployctl build <entry> --store http://... --version v1

    # deploy a stored artifact (applies the graph CR; the operator's watch
    # reconciles it into component CRs / Deployments / Services)
    python -m dynamo_tpu_torch.cli.deployctl deploy chat v1 --store http://api-store:8085

    # list artifacts
    python -m dynamo_tpu_torch.cli.deployctl list --store http://api-store:8085
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from dynamo_tpu_torch.deploy.crds import DEFAULT_IMAGE
from dynamo_tpu_torch.deploy.deployment import (
    build_graph_manifest,
    deploy_artifact,
    fetch_artifact,
    push_artifact,
)
from dynamo_tpu_torch.utils.logging import configure_logging


def _build(args) -> int:
    manifest = build_graph_manifest(
        args.entry,
        name=args.name,
        namespace=args.namespace,
        image=args.image,
        control_plane=args.control_plane,
    )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(manifest, f, indent=2)
        print(f"wrote {args.out}")
    else:
        print(json.dumps(manifest, indent=2))
    if args.store:
        name = args.name or manifest["metadata"]["name"]
        record = asyncio.run(
            push_artifact(args.store, name, args.version, manifest)
        )
        print(f"pushed {name}:{args.version} → {args.store}")
        return 0 if record else 1
    return 0


def _push(args) -> int:
    with open(args.manifest) as f:
        manifest = json.load(f)
    name = args.name or manifest.get("metadata", {}).get("name")
    if not name:
        print("error: --name required (manifest has no metadata.name)", file=sys.stderr)
        return 2
    asyncio.run(push_artifact(args.store, name, args.version, manifest))
    print(f"pushed {name}:{args.version} → {args.store}")
    return 0


def _deploy(args) -> int:
    from dynamo_tpu_torch.deploy.operator import KubectlClient

    async def run() -> None:
        record = await fetch_artifact(args.store, args.name, args.version)
        await deploy_artifact(
            KubectlClient(), record, namespace=args.namespace or None
        )

    asyncio.run(run())
    print(f"deployed {args.name}:{args.version}")
    return 0


def _list(args) -> int:
    import aiohttp

    async def run() -> list:
        async with aiohttp.ClientSession() as session:
            async with session.get(
                f"{args.store.rstrip('/')}/api/v1/graphs"
            ) as resp:
                resp.raise_for_status()
                return await resp.json()

    for row in asyncio.run(run()):
        print(f"{row['name']}\t{','.join(row['versions'])}")
    return 0


def main(argv=None) -> int:
    configure_logging()
    parser = argparse.ArgumentParser(prog="deployctl", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="render an SDK graph to a manifest")
    b.add_argument("entry", help="module:ClassName of the entry @service")
    b.add_argument("--name", default=None, help="graph name (default: entry service)")
    b.add_argument("--namespace", default="default")
    b.add_argument("--image", default=DEFAULT_IMAGE)
    b.add_argument("--control-plane", default="dynctl:2379")
    b.add_argument("--out", default=None, help="write manifest JSON here")
    b.add_argument("--store", default=None, help="api-store URL (push after build)")
    b.add_argument("--version", default="v1")
    b.set_defaults(fn=_build)

    p = sub.add_parser("push", help="push a built manifest to the api-store")
    p.add_argument("manifest", help="manifest JSON file from `build --out`")
    p.add_argument("--store", required=True)
    p.add_argument("--name", default=None)
    p.add_argument("--version", default="v1")
    p.set_defaults(fn=_push)

    d = sub.add_parser("deploy", help="apply a stored artifact's graph CR")
    d.add_argument("name")
    d.add_argument("version")
    d.add_argument("--store", required=True)
    d.add_argument("--namespace", default=None)
    d.set_defaults(fn=_deploy)

    ls = sub.add_parser("list", help="list artifacts in the api-store")
    ls.add_argument("--store", required=True)
    ls.set_defaults(fn=_list)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
