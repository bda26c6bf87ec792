"""Sum a device trace written by ``utils/profiling.py`` (a Chrome trace of
``torch.profiler``; ``DYN_PROFILER_TRACE_DIR``).

    python -m dynamo_tpu_torch.bench.trace_summary TRACE [--window bench.burst]
        [--match ragged_tc_kernel ...] [--top 25]

``TRACE`` is a trace file or a directory (its newest ``trace_*.json.gz``).
Prints one JSON object:

- ``window_ms``, ``device_busy_ms``, ``device_idle_share``: the span of the
  ``--window`` annotation's ranges (host clock; the first range's start to
  the last one's end) against the union of device activity (kernels,
  copies, sets) inside it;
- ``kernels_top``: device ms and launches by kernel name inside the window;
- ``annotations``: for each annotation the engine or the model makes
  (``split_prefill``, ``split_prefill_attention``, ``unified_window``,
  ``verify_window``; ``annotations=`` names others), its ranges inside the
  window and the device ms of the kernels launched within
  them (on the launching thread; a graph replay's kernels belong to its
  launch);
- ``matches``: device ms and launches of the kernels whose name holds each
  ``--match`` substring.

Times are the profiler's: device time comes from the card's own activity
records, so it is measured only in a trace taken on the card.
"""

from __future__ import annotations

import argparse
import bisect
import gzip
import json
import sys
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ENGINE_ANNOTATIONS = ("split_prefill", "split_prefill_attention", "unified_window",
                      "verify_window")


def load_events(path: str | Path) -> list[dict]:
    path = Path(path)
    if path.is_dir():
        traces = sorted(path.glob("trace_*.json*"), key=lambda p: p.stat().st_mtime)
        if not traces:
            raise FileNotFoundError(f"no trace_*.json[.gz] in {path}")
        path = traces[-1]
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def _union_ms(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def summarize(events: list[dict], window: str = "bench.burst", match=(), top: int = 25,
              annotations=ENGINE_ANNOTATIONS) -> dict:
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    names = annotations
    annotations = [e for e in spans if e.get("cat") == "user_annotation"]
    win = [e for e in annotations if e["name"] == window]
    if not win:
        raise ValueError(f"no {window!r} annotation in the trace")
    w0 = min(e["ts"] for e in win)
    w1 = max(e["ts"] + e["dur"] for e in win)
    inside = [e for e in spans if w0 <= e["ts"] < w1]
    device = [e for e in inside if e.get("cat") in DEVICE_CATS]
    kernels = [e for e in device if e["cat"] == "kernel"]
    busy = _union_ms([(e["ts"], min(e["ts"] + e["dur"], w1)) for e in device])

    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        acc = by_name[e["name"]]
        acc[0] += e["dur"] / 1e3
        acc[1] += 1
    kernels_top = [
        {"name": name[:160], "ms": round(ms, 3), "launches": n}
        for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    ]

    # a kernel belongs to every annotation range that holds its launch on
    # the launching thread (the runtime call with the kernel's correlation)
    launch = {}
    for e in spans:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (e["pid"], e["tid"], e["ts"])
    ranges: dict[tuple, tuple[list, list]] = {}
    counts: dict[str, int] = defaultdict(int)
    for e in sorted(annotations, key=lambda e: e["ts"]):
        if e["name"] in names and w0 <= e["ts"] < w1:
            starts, ends = ranges.setdefault((e["pid"], e["tid"], e["name"]), ([], []))
            starts.append(e["ts"])
            ends.append(e["ts"] + e["dur"])
            counts[e["name"]] += 1
    device_ms: dict[str, float] = defaultdict(float)
    for e in kernels:
        where = launch.get(e.get("args", {}).get("correlation"))
        if where is None:
            continue
        for name in counts:
            starts, ends = ranges.get((where[0], where[1], name), ((), ()))
            i = bisect.bisect_right(starts, where[2]) - 1
            if i >= 0 and where[2] < ends[i]:
                device_ms[name] += e["dur"] / 1e3
    return {
        "window": window,
        "window_ms": round((w1 - w0) / 1e3, 3),
        "device_busy_ms": round(busy, 3),
        "device_idle_share": round(1.0 - busy / ((w1 - w0) / 1e3), 4),
        "kernel_launches": len(kernels),
        "kernels_top": kernels_top,
        "annotations": {
            name: {"ranges": n, "device_ms": round(device_ms[name], 3),
                   "device_ms_per_range": round(device_ms[name] / n, 4)}
            for name, n in sorted(counts.items())
        },
        "matches": {
            m: {"ms": round(sum(ms for k, (ms, _) in by_name.items() if m in k), 3),
                "launches": sum(n for k, (_, n) in by_name.items() if m in k)}
            for m in match
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="a trace file, or a directory of them (the newest)")
    ap.add_argument("--window", default="bench.burst",
                    help="the annotation whose span is summed (default bench.burst)")
    ap.add_argument("--match", action="append", default=[],
                    help="a kernel-name substring to total apart (repeatable)")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    print(json.dumps(summarize(load_events(args.trace), args.window, args.match, args.top)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
