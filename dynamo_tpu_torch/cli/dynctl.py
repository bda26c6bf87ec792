"""dynctl — run the standalone control-plane server, or administer models
registered in it (the reference's etcd+NATS deployment and llmctl admin CLI
in one tool: launch/llmctl/src/main.rs).  A copy of dynamo_tpu/cli/dynctl.py.

Usage:
  python -m dynamo_tpu_torch.cli.dynctl serve [--host H] [--port P]
  python -m dynamo_tpu_torch.cli.dynctl list-models   [--control-plane H:P]
  python -m dynamo_tpu_torch.cli.dynctl list-instances [--control-plane H:P]
  python -m dynamo_tpu_torch.cli.dynctl remove-model NAME [--control-plane H:P]
  python -m dynamo_tpu_torch.cli.dynctl drain INSTANCE_ID [--timeout S] [--control-plane H:P]
  python -m dynamo_tpu_torch.cli.dynctl migrate REQUEST_ID DST [--reason R] [--control-plane H:P]
  python -m dynamo_tpu_torch.cli.dynctl topology [--json] [--control-plane H:P]
  python -m dynamo_tpu_torch.cli.dynctl flight dump [INSTANCE_ID] [--control-plane H:P]
"""

from __future__ import annotations

import argparse
import asyncio
import json


def render_topology(d: dict) -> str:
    """``dynctl topology``'s table of a ``TopologyMap.to_dict()``: the
    nodes, then the links with their measured and prior bandwidth, RTT and
    probe count (a live map's measurements included)."""
    if not d["nodes"]:
        return "(no topology cards published)"
    lines = [f"{'WORKER':<18} {'ROLE':<8} {'SLICE':<10} {'HOST':<16} ADDRESS"]
    for wid, card in d["nodes"].items():
        lines.append(
            f"{wid:<18} {card['role'] or '-':<8} "
            f"{card['slice_label'] or '-':<10} "
            f"{card['host'] or '-':<16} {card['transfer_address'] or '-'}"
        )
    if d["links"]:
        lines.append("")
        lines.append(
            f"{'A':<18} {'B':<18} {'HOP':<6} {'MEASURED':>12} "
            f"{'PRIOR':>12} {'RTT':>9} {'PROBES':>7}"
        )
        for link in d["links"]:
            measured = (
                f"{link['measured_bps'] / 1e9:.2f}GB/s"
                if link["measured_bps"] > 0 else "-"
            )
            rtt = f"{link['rtt_s'] * 1e3:.2f}ms" if link["rtt_s"] > 0 else "-"
            lines.append(
                f"{link['a']:<18} {link['b']:<18} "
                f"{link['hop'] or '?':<6} {measured:>12} "
                f"{link['prior_bps'] / 1e9:>10.1f}GB/s "
                f"{rtt:>9} {link['probes_total']:>7}"
            )
    lines.append("")
    lines.append(
        f"informative={d['informative']} "
        f"links={sum(1 for _ in d['links'])} age={d['age_s']:.1f}s"
    )
    return "\n".join(lines)


async def _amain(args) -> int:
    if args.cmd == "serve":
        from dynamo_tpu_torch.runtime.controlplane.server import run_server

        await run_server(args.host, args.port)
        return 0

    from dynamo_tpu_torch.llm.discovery import MODELS_PREFIX, ModelEntry
    from dynamo_tpu_torch.runtime.component import ROOT_PATH
    from dynamo_tpu_torch.runtime.controlplane import connect_control_plane

    plane = await connect_control_plane(args.control_plane)
    try:
        if args.cmd == "list-models":
            entries = await plane.kv.get_prefix(MODELS_PREFIX)
            for e in entries:
                entry = ModelEntry.from_json(e.value)
                print(
                    f"{entry.name}\t{entry.endpoint_path()}\t{entry.instance_id:016x}\t"
                    f"{','.join(entry.model_types)}"
                )
            if not entries:
                print("(no models registered)")
        elif args.cmd == "list-instances":
            entries = await plane.kv.get_prefix(ROOT_PATH)
            for e in entries:
                if "/instances/" in e.key:
                    d = json.loads(e.value)
                    print(f"{d['namespace']}.{d['component']}.{d['endpoint']}\t{d['instance_id']:016x}")
        elif args.cmd == "remove-model":
            n = await plane.kv.delete_prefix(f"{MODELS_PREFIX}{args.name}/")
            print(f"removed {n} registration(s) for {args.name}")
        elif args.cmd == "topology":
            from dynamo_tpu_torch.topology.card import CARDS_PREFIX, TopologyCard
            from dynamo_tpu_torch.topology.map import TopologyMap

            topo = TopologyMap()
            for e in await plane.kv.get_prefix(CARDS_PREFIX):
                topo.upsert(TopologyCard.from_json(e.value))
            if args.json:
                print(json.dumps(topo.to_dict(), indent=2))
            else:
                print(render_topology(topo.to_dict()))
        elif args.cmd == "drain":
            from dynamo_tpu_torch.runtime.component import ctl_subject

            needle = args.instance.lower()
            if needle.startswith("0x"):
                needle = needle[2:]
            matches = []
            for e in await plane.kv.get_prefix(ROOT_PATH):
                if "/instances/" not in e.key:
                    continue
                d = json.loads(e.value)
                hex16 = f"{d['instance_id']:016x}"
                if needle in (hex16, f"{d['instance_id']:x}") or hex16.startswith(needle):
                    matches.append(d)
            if not matches:
                print(f"no instance matches {args.instance!r}")
                return 1
            if len(matches) > 1:
                print(f"ambiguous instance id {args.instance!r} ({len(matches)} matches)")
                return 1
            inst = matches[0]
            budget = args.timeout or 30.0
            reply = await plane.bus.request(
                ctl_subject(inst["subject"]),
                json.dumps({"op": "drain", "timeout_s": args.timeout}).encode(),
                timeout=budget + 10.0,
            )
            result = json.loads(reply.decode())
            # the lease is revoked before the worker replies; confirm the
            # instance really is gone from the view
            gone = not any(
                "/instances/" in e.key
                and json.loads(e.value)["instance_id"] == inst["instance_id"]
                for e in await plane.kv.get_prefix(ROOT_PATH)
            )
            print(
                f"drained {inst['subject']}: ok={result.get('ok')} "
                f"handed_off={result.get('handed_off')} "
                f"duration={result.get('duration_s')}s deregistered={gone}"
            )
            return 0 if result.get("ok") and gone else 1
        elif args.cmd == "flight":
            from dynamo_tpu_torch.runtime.component import ctl_subject

            # resolve instances: an explicit id (hex prefix ok) or, with no
            # argument, every registered instance gets a dump request
            needle = (args.instance or "").lower()
            if needle.startswith("0x"):
                needle = needle[2:]
            matches = []
            for e in await plane.kv.get_prefix(ROOT_PATH):
                if "/instances/" not in e.key:
                    continue
                d = json.loads(e.value)
                hex16 = f"{d['instance_id']:016x}"
                if (not needle or needle in (hex16, f"{d['instance_id']:x}")
                        or hex16.startswith(needle)):
                    matches.append(d)
            if not matches:
                print(
                    f"no instance matches {args.instance!r}" if args.instance
                    else "(no instances registered)"
                )
                return 1
            if args.instance and len(matches) > 1:
                print(f"ambiguous instance id {args.instance!r} ({len(matches)} matches)")
                return 1
            failed = False
            for inst in matches:
                try:
                    reply = await plane.bus.request(
                        ctl_subject(inst["subject"]),
                        json.dumps({"op": "flight_dump"}).encode(),
                        timeout=args.timeout,
                    )
                    result = json.loads(reply.decode())
                except (asyncio.TimeoutError, RuntimeError):
                    print(f"{inst['subject']}: no reply (worker gone?)")
                    failed = True
                    continue
                if not result.get("ok"):
                    print(f"{inst['subject']}: {result.get('error', 'dump failed')}")
                    failed = True
                    continue
                paths = result.get("paths") or []
                if not result.get("enabled", True):
                    print(f"{inst['subject']}: flight recorder disabled (DYN_FLIGHT=0)")
                elif not paths:
                    print(f"{inst['subject']}: no recorders live (nothing dumped)")
                else:
                    for path in paths:
                        print(f"{inst['subject']}: {path}")
            return 1 if failed else 0
        elif args.cmd == "migrate":
            from dynamo_tpu_torch.runtime.migration import MIGRATE_SUBJECT

            op = {
                "op": "migrate",
                "request_id": args.request_id,
                "dst": args.dst,
                "reason": args.reason,
            }
            try:
                # only the dispatcher that owns the request replies; the
                # flip itself is bounded by DYN_MIGRATE_FLIP_TIMEOUT_S on
                # the owning side, so pad generously here
                reply = await plane.bus.request(
                    MIGRATE_SUBJECT, json.dumps(op).encode(), timeout=args.timeout
                )
            except (asyncio.TimeoutError, RuntimeError) as exc:
                # a remote control plane wraps the bus timeout in the RPC
                # error channel (RuntimeError), the in-memory one raises it
                if isinstance(exc, RuntimeError) and "Timeout" not in repr(exc):
                    raise
                print(
                    f"no dispatcher owns request {args.request_id!r} "
                    "(wrong id, already finished, or DYN_MIGRATE=0)"
                )
                return 1
            result = json.loads(reply.decode())
            if result.get("ok"):
                print(
                    f"migrated {result['request_id']}: "
                    f"{result['src']} -> {result['dst']} "
                    f"(hop={result.get('hop') or '?'} "
                    f"hidden={result.get('hidden_s')}s)"
                )
                return 0
            print(f"migrate failed: {result.get('error')}")
            return 1
    finally:
        await plane.close()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="dynctl")
    sub = parser.add_subparsers(dest="cmd", required=True)
    serve = sub.add_parser("serve", help="run the control-plane server")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=2379)
    for name in ("list-models", "list-instances"):
        p = sub.add_parser(name)
        p.add_argument("--control-plane", default="127.0.0.1:2379")
    topo = sub.add_parser(
        "topology", help="dump the fleet topology map (nodes + classified links)"
    )
    topo.add_argument("--json", action="store_true", help="emit the map as JSON")
    topo.add_argument("--control-plane", default="127.0.0.1:2379")
    rm = sub.add_parser("remove-model")
    rm.add_argument("name")
    rm.add_argument("--control-plane", default="127.0.0.1:2379")
    drain = sub.add_parser(
        "drain", help="gracefully empty a worker, then deregister it"
    )
    drain.add_argument("instance", help="instance id (hex, prefix ok)")
    drain.add_argument("--timeout", type=float, default=None,
                       help="drain budget in seconds (default DYN_DRAIN_TIMEOUT_S)")
    drain.add_argument("--control-plane", default="127.0.0.1:2379")
    mig = sub.add_parser(
        "migrate", help="move one live decode session to another worker"
    )
    mig.add_argument("request_id",
                     help="id of the in-flight session: the request/trace id "
                          "(x-request-id header, frontend logs) or the "
                          "dispatcher's internal session id")
    mig.add_argument("dst", nargs="?", default=None,
                     help="destination instance id (hex, prefix ok); omit to "
                          "let the coordinator pick the cheapest-hop worker")
    mig.add_argument("--reason", default="manual",
                     help="migration reason; anything but 'manual' also "
                          "authorizes a DCN-hop destination")
    mig.add_argument("--timeout", type=float, default=30.0,
                     help="seconds to wait for the owning dispatcher's reply")
    mig.add_argument("--control-plane", default="127.0.0.1:2379")
    fl = sub.add_parser(
        "flight", help="perf flight recorder operations (dump)"
    )
    fl.add_argument("action", choices=["dump"],
                    help="dump: write every live recorder's ring to JSONL")
    fl.add_argument("instance", nargs="?", default=None,
                    help="instance id (hex, prefix ok); omit to dump every "
                         "registered instance")
    fl.add_argument("--timeout", type=float, default=10.0,
                    help="seconds to wait for each worker's reply")
    fl.add_argument("--control-plane", default="127.0.0.1:2379")
    args = parser.parse_args(argv)
    return asyncio.run(_amain(args))


if __name__ == "__main__":
    raise SystemExit(main())
