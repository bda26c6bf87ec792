#!/usr/bin/env python
"""Migration bench: run the shipped ``migration`` scenario and distill the
headline numbers into ``MIGRATION_BENCH_CUDA.json``.

The scenario (dynamo_tpu_torch/scenarios/specs/migration.json) soaks a routed
3-worker mocker fleet and live-migrates sessions mid-decode three ways —
explicit migration events under load, a graceful drain under load, and the
planner's defragmentation loop over a long-context phase.  The runner
verifies every completed stream byte-for-byte against the unmigrated greedy
reference (``verify_outputs``), so the bench's "zero loss" and
"byte-identical" claims come straight from the artifact, not from a second
reference run.

The headline defrag measurement is a controlled A/B: the long-context
``defrag`` phase is re-run with the defrag loop disabled (same seed, same
traffic) and the cross-worker KV-occupancy variance (``kv_occ_var`` in the
tick series) averaged over the phase is compared — the planner loop is
doing its job when the variance with defrag ON sits below the OFF control.

Usage::

    python -m dynamo_tpu_torch.scripts.migration_bench \
        [--out MIGRATION_BENCH_CUDA.json] [--speedup 8.0]

Exit code 0 = scenario passed and wrote the artifact; 1 = a phase failed
(the artifact is still written, with ``passed: false``).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parents[2]


def _mean(xs: list[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0


def _phase_var(artifact: dict, phase: str) -> tuple[float, float, int]:
    """(mean kv_occ_var, mean kv_occ_spread, tick count) over one phase."""
    ticks = [
        t for t in artifact.get("ticks", [])
        if t.get("phase") == phase and "kv_occ_var" in t
    ]
    return (
        _mean([t["kv_occ_var"] for t in ticks]),
        _mean([t["kv_occ_spread"] for t in ticks]),
        len(ticks),
    )


def summarize(artifact: dict, control: dict | None = None) -> dict:
    """Distill a migration-scenario artifact (plus the optional
    defrag-disabled control run of the defrag phase) into the bench
    record."""
    phases = artifact.get("phases", [])
    by_name = {p["name"]: p for p in phases}
    migrations = dict(artifact.get("migrations") or {})
    moves = migrations.pop("defrag_moves", []) or []

    variance: dict = {}
    on_var, on_spread, on_ticks = _phase_var(artifact, "defrag")
    if on_ticks:
        variance = {
            "phase": "defrag",
            "defrag_on": {
                "kv_occ_var": round(on_var, 6),
                "kv_occ_spread": round(on_spread, 4),
                "ticks": on_ticks,
            },
        }
    if control is not None:
        off_var, off_spread, off_ticks = _phase_var(control, "defrag")
        variance["defrag_off"] = {
            "kv_occ_var": round(off_var, 6),
            "kv_occ_spread": round(off_spread, 4),
            "ticks": off_ticks,
        }
        variance["kv_occ_var_drop"] = round(off_var - on_var, 6)
        variance["kv_occ_var_drop_ratio"] = (
            round((off_var - on_var) / off_var, 4) if off_var else 0.0
        )

    outputs = {
        "verified": sum(
            (p.get("outputs") or {}).get("verified", 0) for p in phases
        ),
        "corrupt": sum(
            (p.get("outputs") or {}).get("corrupt", 0) for p in phases
        ),
    }
    requests = {
        "completed": sum(p["requests"]["completed"] for p in phases),
        "failed": sum(p["requests"]["failed"] for p in phases),
    }
    return {
        "scenario": artifact.get("scenario"),
        "passed": bool(artifact.get("passed")),
        "requests": requests,
        "zero_failed": requests["failed"] == 0,
        "outputs": outputs,
        "byte_identical": outputs["corrupt"] == 0 and outputs["verified"] > 0,
        "migrations": {
            **migrations,
            "defrag_moves": len(moves),
            "per_phase": {
                name: (p.get("migrations") or {}).get("committed", 0)
                for name, p in by_name.items()
            },
        },
        "kv_occupancy_variance": variance,
        "phase_failures": {
            p["name"]: p["assertions"]["failures"]
            for p in phases if p["assertions"]["failures"]
        },
    }


def _control_spec(spec):
    """The SAME full scenario with only the defrag loop switched off — the
    A/B control for the occupancy-variance measurement.  All phases run so
    the defrag phase inherits identical fleet state (including the worker
    the drain phase removed); only the defrag phase's migration floor is
    relaxed (without the loop there is nothing to commit there)."""
    from dynamo_tpu_torch.scenarios.spec import ScenarioSpec

    control = ScenarioSpec.from_dict(spec.to_dict())
    control.autopilot.defrag = False
    for phase in control.phases:
        if phase.name == "defrag":
            phase.assertions.min_migrations_committed = 0
    return control


async def amain(out: Path, speedup: float | None) -> int:
    from dynamo_tpu_torch.robustness import counters
    from dynamo_tpu_torch.robustness.faults import FAULTS
    from dynamo_tpu_torch.scenarios.runner import run_scenario
    from dynamo_tpu_torch.scenarios.spec import ScenarioSpec, builtin_spec_path

    counters.reset()
    FAULTS.reset()
    spec = ScenarioSpec.load(builtin_spec_path("migration"))
    if speedup is not None:
        spec.speedup = speedup
    artifact = await run_scenario(spec.validate(), name="migration-bench")
    counters.reset()
    FAULTS.reset()
    control = await run_scenario(
        _control_spec(spec).validate(), name="migration-bench-control"
    )
    record = summarize(artifact, control)
    out.write_text(json.dumps(record, indent=2) + "\n")
    print(json.dumps(record, indent=2))
    print(f"wrote {out}")
    return 0 if record["passed"] else 1


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--out", type=Path, default=_REPO_ROOT / "MIGRATION_BENCH_CUDA.json"
    )
    parser.add_argument(
        "--speedup", type=float, default=None,
        help="override the spec's simulation speedup",
    )
    args = parser.parse_args(argv)
    return asyncio.run(amain(args.out, args.speedup))


if __name__ == "__main__":
    sys.exit(main())
