#!/usr/bin/env python
"""Chaos smoke: serve on CPU under a canned fault schedule, assert recovery.

Brings up the full serving stack in one process — dynctl control-plane
server, two echo workers, HTTP frontend with tight admission control — then:

1. arms a fault schedule (``DYN_FAULTS`` env if set, else the schedule from
   the canned scenario spec ``dynamo_tpu_torch/scenarios/specs/chaos_smoke.json``
   — kill the control-plane connection once and one worker stream
   pre-first-token);
2. runs a multi-request serve phase and asserts **every** request completed
   (reconnect + safe retry both observable:
   ``dyn_cp_reconnects_total >= 1``, ``dyn_retries_total >= 1``);
3. fires a saturation burst and asserts overload surfaces as 429/503 with
   ``Retry-After`` (``dyn_shed_total >= 1``) instead of timeouts;
4. kills a worker stream **mid-decode** (``dp.send:nth=4``) and asserts the
   dispatcher's generation journal resumed it on the peer with zero
   client-visible failures (``dyn_resume_success_total >= 1``);
5. live-migrates a mid-decode stream to the peer worker and asserts the
   client saw a byte-identical stream (``dyn_migration_committed_total >=
   1``), then injects a destination death mid-handoff
   (``migrate.handoff:once``) and asserts the migration aborted back to
   the source with the stream still completing byte-identically
   (``dyn_migration_aborted_total`` moved, exactly-once either way);
6. gracefully drains one worker and asserts it deregistered (instance gone
   from the control-plane view) while the survivor keeps serving 200s.

Exit code 0 = recovered; 1 = a request failed or a recovery counter stayed
flat (printed).  Runs in tier-1 via tests/test_torch_ops_tools.py.

Usage (from the repository root; echo workers, no device)::

    python -m dynamo_tpu_torch.scripts.chaos_smoke [--requests 6] [--burst 20]
"""

from __future__ import annotations

import argparse
import asyncio
import sys
from pathlib import Path

from dynamo_tpu_torch.utils import knobs

# the repository's tiny model: its tokenizer and card serve the echo workers
MODEL_DIR = str(Path(__file__).resolve().parents[2] / "tests" / "data" / "tiny-chat-model")
# last-resort fallback if the shipped spec file is missing/unreadable
_FALLBACK_SCHEDULE = "cp.recv:once;worker.generate:nth=2"


def _canned() -> tuple[int, int, str]:
    """(requests, burst, schedule) from the shipped scenario spec — the
    canned chaos phases live in specs/chaos_smoke.json, not in code."""
    try:
        from dynamo_tpu_torch.scenarios.spec import ScenarioSpec, builtin_spec_path

        spec = ScenarioSpec.load(builtin_spec_path("chaos_smoke"))
        serve, burst = spec.phases[0], spec.phases[1]
        return (
            serve.traffic.requests or 6,
            burst.traffic.requests or 20,
            serve.faults[0].schedule if serve.faults else _FALLBACK_SCHEDULE,
        )
    except Exception:  # noqa: BLE001 — the gate must run even if the spec rots
        return 6, 20, _FALLBACK_SCHEDULE


DEFAULT_SCHEDULE = _canned()[2]


async def _chat(client, i: int) -> int:
    r = await client.post(
        "/v1/chat/completions",
        json={
            "model": "tiny",
            "messages": [{"role": "user", "content": f"chaos request {i}"}],
            "max_tokens": 8,
        },
        timeout=60,
    )
    return r.status_code


async def amain(
    requests: int | None = None, burst: int | None = None,
    schedule: str | None = None,
) -> int:
    import json as _json
    import os

    import httpx

    from dynamo_tpu_torch.robustness import AdmissionConfig, counters
    from dynamo_tpu_torch.robustness.faults import FAULTS
    from dynamo_tpu_torch.runtime.controlplane.server import ControlPlaneServer
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.serve import serve_frontend, serve_worker
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    spec_requests, spec_burst, spec_schedule = _canned()
    requests = spec_requests if requests is None else requests
    burst = spec_burst if burst is None else burst
    schedule = schedule or knobs.get("DYN_FAULTS") or spec_schedule
    # a DYN_FAULTS env schedule is armed at import — disarm it for bring-up
    # (the schedule targets the serve phase; cp.recv:once firing on the
    # connect handshake would fail setup, not test recovery) and start the
    # recovery counters from zero so the assertions below are absolute
    FAULTS.reset()
    counters.reset()
    failures: list[str] = []

    def check(ok: bool, what: str) -> None:
        print(("ok   " if ok else "FAIL ") + what)
        if not ok:
            failures.append(what)

    cp = ControlPlaneServer(port=0)
    await cp.start()
    runtime = await DistributedRuntime.create(
        RuntimeConfig(control_plane=f"127.0.0.1:{cp.port}")
    )
    workers, service, watcher = [], None, None
    try:
        for _ in range(2):
            workers.append(
                await serve_worker(runtime, MODEL_DIR, model_name="tiny", engine_kind="echo")
            )
        service, watcher = await serve_frontend(
            runtime, host="127.0.0.1", port=0,
            admission=AdmissionConfig(
                max_inflight=1, max_queue_depth=2,
                queue_timeout_s=10.0, retry_after_s=1.0,
            ),
        )
        async with httpx.AsyncClient(
            base_url=f"http://127.0.0.1:{service.port}",
            limits=httpx.Limits(max_connections=64),
        ) as client:
            for _ in range(100):
                r = await client.get("/v1/models")
                if any(m["id"] == "tiny" for m in r.json().get("data", [])):
                    break
                await asyncio.sleep(0.1)

            # arm only once the stack is up: the schedule targets the serve
            # phase, not worker bring-up.  reset() first — a DYN_FAULTS env
            # schedule was already armed at import, and arming it again
            # here would double every spec (nth fires twice, etc.)
            FAULTS.reset()
            FAULTS.arm(schedule)
            print(f"armed fault schedule: {schedule}")

            # phase 1 — every request must complete despite the faults
            statuses = [await _chat(client, i) for i in range(requests)]
            check(
                all(s == 200 for s in statuses),
                f"serve phase: {statuses.count(200)}/{requests} requests ok "
                f"(statuses {sorted(set(statuses))})",
            )
            check(
                counters.get("dyn_cp_reconnects_total") >= 1,
                f"control-plane reconnected (dyn_cp_reconnects_total="
                f"{counters.get('dyn_cp_reconnects_total')})",
            )
            check(
                counters.get("dyn_retries_total") >= 1,
                f"pre-first-token retry happened (dyn_retries_total="
                f"{counters.get('dyn_retries_total')})",
            )

            # phase 2 — saturation burst: overload must shed, not time out
            responses = await asyncio.gather(
                *[
                    client.post(
                        "/v1/chat/completions",
                        json={
                            "model": "tiny",
                            "messages": [{"role": "user", "content": "burst"}],
                            "max_tokens": 4,
                        },
                        timeout=60,
                    )
                    for _ in range(burst)
                ]
            )
            codes = [r.status_code for r in responses]
            shed = [r for r in responses if r.status_code in (429, 503)]
            check(
                all(c in (200, 429, 503) for c in codes),
                f"burst: only 200/429/503 (saw {sorted(set(codes))})",
            )
            check(len(shed) >= 1, f"burst shed {len(shed)}/{burst} requests")
            check(
                all("retry-after" in r.headers for r in shed),
                "every shed response carries Retry-After",
            )
            check(
                counters.get("dyn_shed_total") >= len(shed),
                f"dyn_shed_total={counters.get('dyn_shed_total')}",
            )

            # the counters are on the scrape surface too
            r = await client.get("/metrics")
            check(
                "dyn_cp_reconnects_total" in r.text and "dyn_shed_total" in r.text,
                "resilience counters exported on /metrics",
            )

            # phase 3 — worker kill mid-decode: the 4th mid-stream write
            # dies AFTER tokens reached the client; the dispatcher's
            # generation journal must resume the stream on the peer with
            # exactly-once delivery (no client-visible failure)
            FAULTS.reset()
            FAULTS.arm("dp.send:nth=4")
            resumes_before = counters.get("dyn_resume_success_total")
            statuses = [await _chat(client, 100 + i) for i in range(3)]
            check(
                all(s == 200 for s in statuses),
                f"worker-kill phase: {statuses.count(200)}/3 requests ok "
                f"(statuses {sorted(set(statuses))})",
            )
            check(
                counters.get("dyn_resume_success_total") >= resumes_before + 1,
                f"mid-stream resume happened (dyn_resume_success_total="
                f"{counters.get('dyn_resume_success_total')})",
            )

            # phase 5 — live migration: move a mid-decode stream to the
            # peer worker (client must see a byte-identical stream), then
            # kill the destination mid-handoff and assert the migration
            # aborts cleanly back to the source (exactly-once either way)
            FAULTS.reset()
            for w in workers:
                # echo streams are instant by default; pace them so a
                # stream is still live long enough to migrate mid-decode
                w.engine.token_delay_s = 0.03
            pipelines = getattr(watcher, "_pipelines", {})
            mig = next(
                (
                    p["router"].migrations
                    for p in pipelines.values()
                    if p.get("router") is not None
                    and p["router"].migrations is not None
                ),
                None,
            )
            check(mig is not None, "migration coordinator on the frontend router")
            if mig is not None:
                long_prompt = "migrate " * 120

                async def _stream_chat() -> tuple[int, str]:
                    text: list[str] = []
                    async with client.stream(
                        "POST", "/v1/chat/completions",
                        json={
                            "model": "tiny",
                            "messages": [
                                {"role": "user", "content": long_prompt}
                            ],
                            "max_tokens": 64, "stream": True,
                        },
                        timeout=60,
                    ) as r:
                        status = r.status_code
                        async for line in r.aiter_lines():
                            if not line.startswith("data:") or line.endswith(
                                "[DONE]"
                            ):
                                continue
                            chunk = _json.loads(line[5:])
                            for c in chunk.get("choices", []):
                                text.append(
                                    (c.get("delta") or {}).get("content") or ""
                                )
                    return status, "".join(text)

                async def _migrate_first_session() -> dict | None:
                    for _ in range(300):
                        sessions = mig.sessions()
                        if sessions:
                            rid = sorted(sessions)[0]
                            return await mig.migrate(rid, reason="manual")
                        await asyncio.sleep(0.01)
                    return None

                # unmigrated run fixes the exactly-once reference text
                status, reference = await _stream_chat()
                check(
                    status == 200 and bool(reference),
                    "migration baseline stream ok",
                )

                task = asyncio.ensure_future(_stream_chat())
                result = await _migrate_first_session()
                status, text = await task
                check(
                    bool(result and result.get("ok")),
                    f"live migration committed: {result}",
                )
                check(
                    status == 200 and text == reference,
                    "migrated stream byte-identical to the unmigrated baseline",
                )
                check(
                    counters.get("dyn_migration_committed_total") >= 1,
                    f"dyn_migration_committed_total="
                    f"{counters.get('dyn_migration_committed_total')}",
                )

                # destination death mid-handoff: abort, finish on the source
                FAULTS.arm("migrate.handoff:once")
                aborts_before = counters.get("dyn_migration_aborted_total")
                task = asyncio.ensure_future(_stream_chat())
                result = await _migrate_first_session()
                status, text = await task
                check(
                    bool(result) and not result.get("ok"),
                    f"fault-injected migration aborted: {result}",
                )
                check(
                    counters.get("dyn_migration_aborted_total")
                    >= aborts_before + 1,
                    f"dyn_migration_aborted_total="
                    f"{counters.get('dyn_migration_aborted_total')}",
                )
                check(
                    status == 200 and text == reference,
                    "aborted-migration stream completed on the source, "
                    "byte-identical",
                )
            for w in workers:
                w.engine.token_delay_s = 0.0

            # phase 6 — graceful drain: one worker empties and deregisters;
            # the survivor keeps serving with zero 5xx
            FAULTS.reset()
            from dynamo_tpu_torch.runtime.component import ROOT_PATH

            drained = workers[-1]
            drained_id = drained.service.instance.instance_id
            result = await drained.drain()
            check(bool(result.get("ok")), f"drain completed: {result}")
            gone = not any(
                "/instances/" in e.key
                and _json.loads(e.value)["instance_id"] == drained_id
                for e in await runtime.plane.kv.get_prefix(ROOT_PATH)
            )
            check(gone, "drained instance deregistered from control plane")
            statuses = [await _chat(client, 200 + i) for i in range(3)]
            check(
                all(s == 200 for s in statuses),
                f"post-drain: {statuses.count(200)}/3 requests ok on survivor "
                f"(statuses {sorted(set(statuses))})",
            )
    finally:
        if watcher is not None:
            await watcher.stop()
        if service is not None:
            await service.stop()
        for w in workers:
            await w.shutdown()
        await runtime.close()
        await cp.stop()

    if failures:
        print(f"chaos smoke FAILED ({len(failures)} check(s))")
        return 1
    print("chaos smoke passed")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--requests", type=int, default=None,
                        help="serve-phase request count (default: from spec)")
    parser.add_argument("--burst", type=int, default=None,
                        help="burst size (default: from spec)")
    parser.add_argument("--faults", help=f"fault schedule (default {DEFAULT_SCHEDULE})")
    args = parser.parse_args(argv)
    return asyncio.run(amain(args.requests, args.burst, args.faults))


if __name__ == "__main__":
    sys.exit(main())
