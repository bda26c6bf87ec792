"""Scenario soak CLI.

Run a scenario spec against a live routed mocker fleet and write the
SCENARIO_SOAK_CUDA.json artifact:

    python -m dynamo_tpu_torch.scenarios.soak                      # shipped default
    python -m dynamo_tpu_torch.scenarios.soak --spec my_soak.json  # custom spec
    python -m dynamo_tpu_torch.scenarios.soak --list               # shipped specs
    python -m dynamo_tpu_torch.scenarios.soak --spec torch_soak    # TorchLlmEngine
                                                  # workers on the card
                                                  # (--device cpu: tiny model)

Exit code 0 iff every phase's assertions held AND (when the spec sets
``autopilot.expect_decision``) the planner executed at least one burn/SLA
driven decision mid-soak.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path

from dynamo_tpu_torch.scenarios.runner import run_scenario
from dynamo_tpu_torch.scenarios.spec import ScenarioSpec, builtin_spec_path


def _specs_dir() -> Path:
    return builtin_spec_path("_").parent


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", default=None,
                    help="path to a scenario JSON, or a shipped spec name "
                         "(default: default_soak)")
    ap.add_argument("--out", default="SCENARIO_SOAK_CUDA.json",
                    help="artifact path (default: SCENARIO_SOAK_CUDA.json)")
    ap.add_argument("--speedup", type=float, default=None,
                    help="override the spec's sim-time compression")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the spec's seed")
    ap.add_argument("--device", default=None,
                    help="torch fleets: the device every worker runs on "
                         "(default: the CUDA card; cpu serves the tiny model)")
    ap.add_argument("--list", action="store_true", help="list shipped specs")
    args = ap.parse_args(argv)

    if args.list:
        for p in sorted(_specs_dir().glob("*.json")):
            print(p.stem)
        return 0

    raw = args.spec or "default_soak"
    path = Path(raw) if Path(raw).exists() else builtin_spec_path(raw)
    if not path.exists():
        print(f"no such spec: {raw}", file=sys.stderr)
        return 2
    spec = ScenarioSpec.load(path)
    if args.speedup is not None:
        spec.speedup = args.speedup
    if args.seed is not None:
        spec.seed = args.seed

    from dynamo_tpu_torch.bench.perfgate import provenance_stamp

    artifact = asyncio.run(run_scenario(spec, fleet_options={"device": args.device}))
    artifact["generated_at"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    # shared provenance header: lets bench/perfgate.py refuse to diff
    # artifacts from an incompatible schema generation
    artifact["provenance"] = provenance_stamp()
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
        f.write("\n")

    for phase in artifact["phases"]:
        ok = phase["assertions"]["passed"]
        print(f"[{'PASS' if ok else 'FAIL'}] {phase['name']:<18} "
              f"{phase['requests']['completed']}/{phase['requests']['submitted']} ok  "
              f"burn={phase['burn_rates']}  "
              f"goodput={phase['goodput_tok_s_mean']} tok/s  "
              f"mfu={phase['mfu_mean']}")
        for failure in phase["assertions"]["failures"]:
            print(f"       - {failure}")
    planner = artifact["planner"]
    print(f"planner: {len(planner['decisions'])} decisions, "
          f"{planner['steering_decisions']} burn/SLA-driven, "
          f"{len(planner['scale_events'])} scale events executed")
    print(f"{'PASS' if artifact['passed'] else 'FAIL'}: "
          f"{artifact['scenario']} ({artifact['sim_s']} sim-s "
          f"in {artifact['wall_s']} wall-s) → {args.out}")
    return 0 if artifact["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
