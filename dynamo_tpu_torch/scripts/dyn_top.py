#!/usr/bin/env python
"""dyn_top: a live ``top`` for a dynamo-tpu fleet.

Polls the metrics service (per-worker ``dyn_worker_*`` gauges) and the HTTP
frontend (``/metrics`` + ``/slo``) and renders one screen: per-worker MFU /
bandwidth utilization / goodput / KV usage / queue depth, fleet aggregates,
frontend in-flight + SLO burn rates.

Usage::

    python -m dynamo_tpu_torch.scripts.dyn_top \
        --frontend http://127.0.0.1:8080 \
        --worker   http://127.0.0.1:9091 \
        [--interval 2] [--once] [--json]

Either base URL may be omitted to watch one surface.  ``--once`` renders a
single frame and exits; ``--json`` emits the snapshot as JSON instead of a
table (``--once --json`` is the machine mode used by tier-1 tests and
benches).  stdlib only — usable on any node that can reach the endpoints.

``--flight`` switches to the flight-recorder tail: print the newest
``flight-*.jsonl`` dump (``--once``) or follow new dumps as they land
(default).  ``--flight-dir`` overrides the dump directory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

_METRIC_LINE_HEAD = ("#",)

# dyn_worker_* gauge → snapshot key (per-worker table columns)
WORKER_FIELDS = {
    "dyn_worker_mfu_perc": "mfu_perc",
    "dyn_worker_bandwidth_util_perc": "bandwidth_util_perc",
    "dyn_worker_goodput_tokens_per_second": "goodput_tokens_per_second",
    "dyn_worker_cache_usage_perc": "kv_usage_perc",
    "dyn_worker_kv_active_blocks": "kv_active_blocks",
    "dyn_worker_requests_running": "running",
    "dyn_worker_requests_waiting": "waiting",
    "dyn_worker_batch_occupancy_perc": "batch_occupancy_perc",
    "dyn_worker_preemptions": "preemptions",
    "dyn_worker_unified_windows": "unified_windows",
    "dyn_worker_admission_drains": "admission_drains",
    "dyn_worker_prefill_tokens": "prefill_tokens",
    "dyn_worker_decode_tokens": "decode_tokens",
    "dyn_worker_tokens_emitted": "tokens_emitted",
    "dyn_worker_wasted_tokens": "wasted_tokens",
    "dyn_prefetch_hits_total": "prefetch_hits",
    "dyn_prefetch_misses_total": "prefetch_misses",
    "dyn_prefetch_stale_total": "prefetch_stale",
    "dyn_prefetch_hidden_seconds": "prefetch_hidden_seconds",
    "dyn_disagg_remote_prefills_total": "disagg_remote_prefills",
    "dyn_disagg_kv_transfer_parts_total": "disagg_kv_transfer_parts",
    "dyn_disagg_transfer_hidden_ratio": "disagg_transfer_hidden_ratio",
    "dyn_flight_records_total": "flight_records",
    "dyn_flight_dropped_total": "flight_dropped",
    "dyn_flight_dumps_total": "flight_dumps",
    "dyn_flight_buffer_bytes": "flight_buffer_bytes",
}

# offload-tier occupancy gauges carry a second label (tier) and nest under
# workers[wid]["offload_tiers"][tier]
TIER_FIELDS = {
    "dyn_worker_offload_blocks": "blocks",
    "dyn_worker_offload_blocks_used": "used",
    "dyn_worker_offload_blocks_pinned": "pinned",
}

# planner autopilot gauges (labeled by pool, not worker): latest decision
# targets and observed per-replica capacity, nested under snap["planner"]
PLANNER_FIELDS = {
    "dyn_planner_target_replicas": "target_replicas",
    "dyn_planner_observed_capacity_tok_s": "observed_capacity_tok_s",
}

# topology-plane placement info (value always 1; the facts ride as labels):
# slice label + inbound hop class per worker → the SLICE/HOP column
TOPOLOGY_INFO_FAMILY = "dyn_topology_worker_info"

# flight-recorder last-dump info (value always 1; the reason rides as a
# label) → the FLIGHT column's dump annotation
FLIGHT_INFO_FAMILY = "dyn_flight_last_dump_info"


def parse_prometheus(text: str) -> list[tuple[str, dict, float]]:
    """Minimal text-exposition parser: (family, labels, value) samples."""
    out: list[tuple[str, dict, float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith(_METRIC_LINE_HEAD):
            continue
        try:
            metric, value_str = line.rsplit(" ", 1)
            value = float(value_str)
        except ValueError:
            continue
        labels: dict[str, str] = {}
        name = metric
        if "{" in metric and metric.endswith("}"):
            name, _, label_body = metric.partition("{")
            for pair in label_body[:-1].split(","):
                if "=" not in pair:
                    continue
                k, _, v = pair.partition("=")
                labels[k.strip()] = v.strip().strip('"')
        out.append((name, labels, value))
    return out


def _fetch(url: str, timeout: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as resp:  # noqa: S310
        return resp.read().decode("utf-8", "replace")


def collect_snapshot(
    frontend: str | None = None,
    worker: str | None = None,
    timeout: float = 5.0,
) -> dict:
    """One fleet snapshot (the ``--json`` payload).  Unreachable surfaces
    degrade to an ``error`` field rather than failing the whole frame —
    a top must keep rendering while half the fleet restarts."""
    snap: dict = {"ts": time.time(), "workers": {}, "fleet": {}, "frontend": {}}

    if worker:
        try:
            samples = parse_prometheus(_fetch(worker.rstrip("/") + "/metrics", timeout))
        except (OSError, urllib.error.URLError) as exc:
            snap["workers_error"] = str(exc)
            samples = []
        workers: dict[str, dict] = {}
        planner: dict = {}
        for name, labels, value in samples:
            if name == "dyn_planner_burn_rate_input":
                planner["burn_rate_input"] = value
                continue
            pkey = PLANNER_FIELDS.get(name)
            if pkey is not None and "pool" in labels:
                planner.setdefault("pools", {}).setdefault(
                    labels["pool"], {}
                )[pkey] = value
                continue
            if "worker" not in labels:
                continue
            if name == TOPOLOGY_INFO_FAMILY:
                row = workers.setdefault(labels["worker"], {})
                row["slice"] = labels.get("slice", "-")
                row["hop"] = labels.get("hop", "-")
                continue
            if name == FLIGHT_INFO_FAMILY:
                row = workers.setdefault(labels["worker"], {})
                row["flight_last_dump_reason"] = labels.get("reason", "-")
                continue
            tier_key = TIER_FIELDS.get(name)
            if tier_key is not None and "tier" in labels:
                row = workers.setdefault(labels["worker"], {})
                row.setdefault("offload_tiers", {}).setdefault(
                    labels["tier"], {}
                )[tier_key] = value
                continue
            key = WORKER_FIELDS.get(name)
            if key is None:
                continue
            workers.setdefault(labels["worker"], {})[key] = value
        for row in workers.values():
            judged = row.get("prefetch_hits", 0.0) + row.get("prefetch_misses", 0.0)
            if judged:
                row["prefetch_hit_ratio"] = row.get("prefetch_hits", 0.0) / judged
        snap["workers"] = workers
        if planner:
            snap["planner"] = planner
        if workers:
            rows = list(workers.values())
            snap["fleet"] = {
                "workers": len(rows),
                "goodput_tokens_per_second": sum(
                    r.get("goodput_tokens_per_second", 0.0) for r in rows
                ),
                "mfu_perc_avg": sum(r.get("mfu_perc", 0.0) for r in rows) / len(rows),
                "kv_usage_perc_avg": sum(
                    r.get("kv_usage_perc", 0.0) for r in rows
                ) / len(rows),
                "waiting": sum(r.get("waiting", 0.0) for r in rows),
                "running": sum(r.get("running", 0.0) for r in rows),
            }

    if frontend:
        base = frontend.rstrip("/")
        front: dict = {}
        try:
            samples = parse_prometheus(_fetch(base + "/metrics", timeout))
            front["inflight"] = sum(
                v for n, _l, v in samples
                if n == "dyn_llm_http_service_inflight_requests"
            )
            front["requests_total"] = sum(
                v for n, _l, v in samples
                if n == "dyn_llm_http_service_requests_total"
            )
            front["shed_total"] = sum(
                v for n, _l, v in samples if n == "dyn_shed_total"
            )
            # live-migration activity rides the frontend's counter surface
            # (the coordinator lives in the frontend's push router)
            front["migrations_committed"] = sum(
                v for n, _l, v in samples
                if n == "dyn_migration_committed_total"
            )
            front["migrations_aborted"] = sum(
                v for n, _l, v in samples
                if n == "dyn_migration_aborted_total"
            )
        except (OSError, urllib.error.URLError) as exc:
            front["error"] = str(exc)
        try:
            front["slo"] = json.loads(_fetch(base + "/slo", timeout))
        except (OSError, urllib.error.URLError, ValueError) as exc:
            # /metrics answering but /slo down is a degraded frontend, not a
            # dead one — keep the keys distinct so --once can tell them apart
            front["slo_error"] = str(exc)
        snap["frontend"] = front

    return snap


# -- flight-dump tailing -----------------------------------------------------
def flight_dump_dir(override: str | None = None) -> Path:
    """Where the flight recorder writes its JSONL dumps.  Mirrors
    dynamo_tpu_torch.observability.flight.flight_dir() — duplicated so dyn_top
    stays stdlib-only and usable on nodes without the package installed."""
    if override:
        return Path(override)
    env = os.environ.get("DYN_FLIGHT_DIR")  # dynlint: disable=knob-registry -- stdlib-only tool, no package import
    if env:
        return Path(env)
    cache = os.environ.get("DYN_CACHE_DIR")  # dynlint: disable=knob-registry -- stdlib-only tool, no package import
    if cache:
        return Path(cache) / "flight"
    return Path.home() / ".cache" / "dynamo_tpu_torch" / "flight"


def latest_flight_dump(directory: Path) -> Path | None:
    dumps = sorted(
        directory.glob("flight-*.jsonl"),
        key=lambda p: p.stat().st_mtime,
    )
    return dumps[-1] if dumps else None


def format_flight_record(rec: dict) -> str:
    """One human line per flight record: monotonic timestamp, kind, and the
    remaining fields as k=v in recorded order."""
    t = rec.get("t")
    head = f"{t:12.3f}" if isinstance(t, (int, float)) else f"{'-':>12}"
    kind = str(rec.get("kind", "?"))
    if kind == "event":
        kind = f"event:{rec.get('event', '?')}"
    body = " ".join(
        f"{k}={v}" for k, v in rec.items()
        if k not in ("t", "kind", "event", "schema_version")
    )
    return f"{head}  {kind:<22} {body}"


def tail_flight(
    directory: Path, follow: bool, interval: float, as_json: bool
) -> int:
    """Print the newest flight dump; with ``follow``, keep polling for a
    newer dump file and print its records as they land (``tail -F`` across
    dump generations)."""
    current: Path | None = None
    printed = 0
    while True:
        newest = latest_flight_dump(directory)
        if newest is None:
            if not follow:
                print(f"no flight dumps under {directory}")
                return 1
        else:
            if newest != current:
                current, printed = newest, 0
                if not as_json:
                    print(f"== {current}")
            lines = current.read_text().splitlines()
            for line in lines[printed:]:
                if not line.strip():
                    continue
                if as_json:
                    print(line)
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    print(line)
                    continue
                if "records" in rec and "kind" not in rec:
                    print(
                        f"# dump source={rec.get('source')} "
                        f"reason={rec.get('reason')} records={rec.get('records')} "
                        f"at={rec.get('dumped_at')}"
                    )
                else:
                    print(format_flight_record(rec))
            printed = len(lines)
        if not follow:
            return 0
        sys.stdout.flush()
        time.sleep(interval)


# -- rendering ---------------------------------------------------------------
def _pct(value: float | None) -> str:
    return "-" if value is None else f"{100.0 * value:5.1f}%"


def _num(value: float | None, width: int = 8) -> str:
    if value is None:
        return "-".rjust(width)
    if value >= 1e6:
        return f"{value / 1e6:.1f}M".rjust(width)
    if value >= 1e4:
        return f"{value / 1e3:.1f}k".rjust(width)
    return f"{value:.6g}".rjust(width)


def render_table(snap: dict) -> str:
    lines: list[str] = []
    ts = time.strftime("%H:%M:%S", time.localtime(snap.get("ts", time.time())))
    lines.append(f"dynamo-tpu fleet — {ts}")
    workers = snap.get("workers") or {}
    if snap.get("workers_error"):
        lines.append(f"  workers: unreachable ({snap['workers_error']})")
    if workers:
        lines.append(
            f"  {'WORKER':<10} {'SLICE/HOP':>10} {'MFU':>7} {'BW':>7} "
            f"{'GOODPUT/s':>10} "
            f"{'KV':>7} {'OCC':>7} {'RUN':>5} {'WAIT':>5} {'PREEMPT':>8} "
            f"{'WASTED':>8} {'PF-HIT':>7} {'UNI':>6} {'DRAIN':>6} "
            f"{'XFER-HID':>8} {'FLIGHT':>8}"
        )
        for wid in sorted(workers):
            r = workers[wid]
            placement = (
                f"{r.get('slice', '-')}/{r.get('hop', '-')}"
                if ("slice" in r or "hop" in r) else "-"
            )
            lines.append(
                f"  {wid:<10} {placement:>10} {_pct(r.get('mfu_perc')):>7} "
                f"{_pct(r.get('bandwidth_util_perc')):>7} "
                f"{_num(r.get('goodput_tokens_per_second'), 10)} "
                f"{_pct(r.get('kv_usage_perc')):>7} "
                f"{_pct(r.get('batch_occupancy_perc')):>7} "
                f"{_num(r.get('running'), 5)} {_num(r.get('waiting'), 5)} "
                f"{_num(r.get('preemptions'), 8)} {_num(r.get('wasted_tokens'), 8)} "
                f"{_pct(r.get('prefetch_hit_ratio')):>7} "
                f"{_num(r.get('unified_windows'), 6)} "
                f"{_num(r.get('admission_drains'), 6)} "
                f"{_pct(r.get('disagg_transfer_hidden_ratio') if r.get('disagg_remote_prefills') else None):>8} "
                f"{_num(r.get('flight_records'), 8)}"
            )
            if r.get("flight_dumps") or r.get("flight_dropped"):
                lines.append(
                    "  " + " " * 10 + " flight: "
                    f"dumps={r.get('flight_dumps', 0):g} "
                    f"last={r.get('flight_last_dump_reason', '-')} "
                    f"buf={_num(r.get('flight_buffer_bytes'), 1).strip()}B "
                    f"dropped={r.get('flight_dropped', 0):g}"
                )
            tiers = r.get("offload_tiers") or {}
            if tiers:
                cells = []
                for tier in sorted(tiers):
                    t = tiers[tier]
                    cell = f"{tier} {t.get('used', 0):g}/{t.get('blocks', 0):g}"
                    if t.get("pinned"):
                        cell += f" (pin {t['pinned']:g})"
                    cells.append(cell)
                hidden = r.get("prefetch_hidden_seconds")
                tail = (
                    f"   hidden {hidden:.2f}s" if hidden else ""
                )
                lines.append("  " + " " * 10 + " tiers: " + "  ".join(cells) + tail)
        fleet = snap.get("fleet") or {}
        if fleet:
            lines.append(
                f"  {'FLEET':<10} {'':>10} {_pct(fleet.get('mfu_perc_avg')):>7} {'':>7} "
                f"{_num(fleet.get('goodput_tokens_per_second'), 10)} "
                f"{_pct(fleet.get('kv_usage_perc_avg')):>7} {'':>7} "
                f"{_num(fleet.get('running'), 5)} {_num(fleet.get('waiting'), 5)}"
            )
    planner = snap.get("planner") or {}
    if planner:
        cells = []
        for pool in sorted(planner.get("pools") or {}):
            row = planner["pools"][pool]
            cell = f"{pool}={row.get('target_replicas', 0):g}"
            cap = row.get("observed_capacity_tok_s")
            if cap:
                cell += f" ({cap:.0f} tok/s/replica)"
            cells.append(cell)
        burn = planner.get("burn_rate_input")
        tail = f"   burn-in={burn:.2f}" if burn is not None else ""
        lines.append("  PLANNER    targets: " + "  ".join(cells) + tail)
    front = snap.get("frontend") or {}
    if front:
        lines.append("")
        if front.get("error"):
            lines.append(f"  frontend: unreachable ({front['error']})")
        else:
            lines.append(
                f"  frontend: inflight={front.get('inflight', 0):g} "
                f"requests={front.get('requests_total', 0):g} "
                f"shed={front.get('shed_total', 0):g} "
                f"mig={front.get('migrations_committed', 0):g}"
                + (
                    f" (aborted {front['migrations_aborted']:g})"
                    if front.get("migrations_aborted") else ""
                )
            )
        if front.get("slo_error"):
            lines.append(f"  slo: unreachable ({front['slo_error']})")
        slo = front.get("slo") or {}
        objectives = slo.get("objectives") or {}
        if objectives:
            windows = [str(int(w)) for w in slo.get("windows_s", [])]
            header = "  SLO burn   " + " ".join(f"{w + 's':>10}" for w in windows)
            lines.append(header)
            for name, obj in objectives.items():
                cells = []
                for w in windows:
                    rate = (obj.get("windows", {}).get(w) or {}).get("burn_rate", 0.0)
                    cells.append(f"{rate:>10.2f}")
                target = obj.get("target")
                lines.append(
                    f"  {name:<10} " + " ".join(cells) + f"   (target {target:g})"
                )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--frontend", help="frontend base URL (http://host:port)")
    parser.add_argument("--worker", help="metrics service base URL")
    parser.add_argument("--interval", type=float, default=2.0)
    parser.add_argument("--once", action="store_true", help="one frame, then exit")
    parser.add_argument("--json", action="store_true", help="emit JSON snapshots")
    parser.add_argument("--timeout", type=float, default=5.0)
    parser.add_argument("--flight", action="store_true",
                        help="tail the newest flight-recorder dump instead "
                             "of polling /metrics (local files, no URLs)")
    parser.add_argument("--flight-dir", default=None,
                        help="flight dump directory (default: DYN_FLIGHT_DIR "
                             "/ DYN_CACHE_DIR/flight / ~/.cache/dynamo_tpu_torch/flight)")
    args = parser.parse_args(argv)
    if args.flight:
        return tail_flight(
            flight_dump_dir(args.flight_dir),
            follow=not args.once,
            interval=args.interval,
            as_json=args.json,
        )
    if not args.frontend and not args.worker:
        parser.error("give --frontend and/or --worker")

    while True:
        snap = collect_snapshot(args.frontend, args.worker, args.timeout)
        if args.json:
            print(json.dumps(snap))
        else:
            if not args.once:
                sys.stdout.write("\x1b[2J\x1b[H")  # clear screen, home cursor
            print(render_table(snap))
        if args.once:
            # exit nonzero only when EVERY requested surface was
            # unreachable: a bench gating on --once must not mistake a
            # reachable-but-idle fleet (no workers registered yet, or /slo
            # alone down) for a dead one
            worker_up = args.worker and "workers_error" not in snap
            frontend_up = args.frontend and not snap["frontend"].get("error")
            return 0 if (worker_up or frontend_up) else 1
        sys.stdout.flush()
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
