"""ScenarioRunner: drive a SoakFleet through a scenario spec.

One run = phases in order.  Per phase the runner

- replays the phase's traffic plan (open-loop Poisson arrivals and/or
  closed-loop multi-turn sessions) against the fleet's dispatcher, with
  frontend-style pre-first-token retries;
- arms ``DYN_FAULTS`` schedules at their phase-relative times (chaos
  mid-phase, exactly where production faults land);
- feeds every TTFT/ITL/error outcome into the SloTracker on the SIMULATED
  clock, and samples ``/slo`` + the metrics service each tick via
  ``scripts.dyn_top.collect_snapshot`` (the artifact's time series);
- steps the planner autopilot on its own cadence — burn rates and per-pool
  utilization in, replica decisions out, executed live through
  ``LocalConnector`` → ``SoakFleet.set_replicas`` while traffic flows;
- evaluates the phase's assertions on PHASE-LOCAL counts when it drains.

``run()`` returns the artifact dict (SCENARIO_SOAK_CUDA.json): per-phase
TTFT/ITL percentiles, burn rates, MFU/goodput, injected faults, planner
decision log, dyn_top snapshots, and a pass/fail verdict per assertion.
"""

from __future__ import annotations

import asyncio
import random
import time

from dynamo_tpu_torch.llm.protocols.common import (
    Annotated,
    LLMEngineOutput,
    PreprocessedRequest,
    StopConditions,
)
from dynamo_tpu_torch.observability import flight as flight_obs
from dynamo_tpu_torch.observability.slo import SloConfig, SloObjective, SloTracker
from dynamo_tpu_torch.planner import (
    DefragConfig,
    Defragmenter,
    PerfProfile,
    Planner,
    PlannerConfig,
    PlannerStatePublisher,
    ProfilePoint,
    sample_from_endpoints,
)
from dynamo_tpu_torch.planner.connectors import LocalConnector
from dynamo_tpu_torch.robustness import counters
from dynamo_tpu_torch.robustness.faults import FAULTS
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.scenarios.fleet import SoakFleet
from dynamo_tpu_torch.scenarios.spec import Phase, ScenarioSpec
from dynamo_tpu_torch.scenarios.traffic import PhasePlan, plan_phase, prompt_tokens
from dynamo_tpu_torch.scripts.dyn_top import collect_snapshot
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("scenarios.runner")


def _pctile(xs: list[float], q: float) -> float | None:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))] if xs else None


def _slo_config(spec: ScenarioSpec) -> SloConfig:
    s = spec.slo
    return SloConfig(
        objectives=(
            SloObjective("ttft", s.ttft_target, threshold_s=s.ttft_s),
            SloObjective("itl", s.itl_target, threshold_s=s.itl_s),
            SloObjective("error_rate", s.error_target),
        ),
        windows_s=tuple(float(w) for w in s.windows_s),
        shed_burn_threshold=s.shed_burn,
    )


def _bootstrap_profile(spec: ScenarioSpec) -> PerfProfile:
    p = spec.autopilot.profile
    mk = lambda isl, osl: ProfilePoint(  # noqa: E731
        isl=isl, osl=osl,
        prefill_tok_s=float(p.get("prefill_tok_s", 50_000.0)),
        decode_tok_s=float(p.get("decode_tok_s", 5_000.0)),
        ttft_s=float(p.get("ttft_s", 0.02)),
        itl_s=float(p.get("itl_s", 0.01)),
    )
    return PerfProfile([mk(16, 8), mk(8192, 1024)])


class _PhaseStats:
    """Phase-local observation store (assertions are evaluated on these, so
    one phase's damage cannot fail its neighbor)."""

    def __init__(self) -> None:
        self.ttfts: list[float] = []
        self.itls: list[float] = []
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.retries = 0
        self.abandoned = 0
        self.by_kind: dict[str, int] = {}
        # verify_outputs bookkeeping: completed requests whose streamed
        # tokens matched / diverged from the deterministic greedy reference
        self.verified = 0
        self.corrupt = 0

    def burn(self, spec: ScenarioSpec) -> dict[str, float]:
        s = spec.slo

        def _rate(bad: int, total: int, target: float) -> float:
            if not total:
                return 0.0
            return (bad / total) / max(1.0 - target, 1e-9)

        ttft_bad = sum(1 for t in self.ttfts if t > s.ttft_s)
        itl_bad = sum(1 for t in self.itls if t > s.itl_s)
        finished = self.completed + self.failed
        return {
            "ttft": _rate(ttft_bad, len(self.ttfts), s.ttft_target),
            "itl": _rate(itl_bad, len(self.itls), s.itl_target),
            "error_rate": _rate(self.failed, finished, s.error_target),
        }


class ScenarioRunner:
    def __init__(self, spec: ScenarioSpec, *, name: str | None = None,
                 fleet_options: dict | None = None):
        self.spec = spec.validate()
        # SoakFleet keywords: model_config / device / _params_cache for a
        # torch fleet (its model, its device, parameters made beforehand)
        self.fleet_options = dict(fleet_options or {})
        self.fleet: SoakFleet | None = None
        self.slo = SloTracker(_slo_config(spec))
        self.planner: Planner | None = None
        self.state_pub: PlannerStatePublisher | None = None
        self._t0_wall = 0.0
        self.decisions: list[dict] = []
        self.ticks: list[dict] = []
        self.top_snapshots: list[dict] = []
        self._name = name or f"{spec.name}-{spec.seed}"
        # autopilot sampling window state
        self._window_submitted = 0
        self._window_isl: list[int] = []
        self._window_osl: list[int] = []
        self._window_ttfts: list[float] = []
        self._window_itls: list[float] = []
        self._next_plan_t = 0.0
        # planner-driven defragmentation (autopilot.defrag)
        self.defrag: Defragmenter | None = None
        self._next_defrag_t = 0.0

    # -- simulated clock -----------------------------------------------------
    def sim_now(self) -> float:
        return (time.monotonic() - self._t0_wall) * self.spec.speedup

    async def _sim_sleep_until(self, sim_t: float) -> None:
        delay = (sim_t - self.sim_now()) / self.spec.speedup
        if delay > 0:
            await asyncio.sleep(delay)

    # -- request execution ---------------------------------------------------
    async def _execute(self, stats: _PhaseStats, tokens: list[int], osl: int,
                       kind: str, history: list[int] | None = None) -> bool:
        """Send one request; returns success.  Pre-first-token failures are
        retried (the frontend's retry role — KV-affine dispatch is direct,
        so PushRouter's own retry is bypassed and the caller must re-issue).
        ``history`` (session mode) collects the streamed tokens."""
        spec = self.spec
        stats.submitted += 1
        stats.by_kind[kind] = stats.by_kind.get(kind, 0) + 1
        self._window_submitted += 1
        self._window_isl.append(len(tokens))
        self._window_osl.append(osl)
        wire = PreprocessedRequest(
            token_ids=list(tokens),
            stop=StopConditions(max_tokens=osl, ignore_eos=True),
            eos_token_ids=[],
        ).to_wire()
        for attempt in range(spec.retry_max + 1):
            t0 = self.sim_now()
            ttft = None
            last_emit = None
            got: list[int] = []
            try:
                stream = await self.fleet.dispatcher.generate(Context(dict(wire)))
                async for item in stream:
                    ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
                    if ann.data is None or not ann.data.token_ids:
                        continue
                    now = self.sim_now()
                    if ttft is None:
                        ttft = now - t0
                        stats.ttfts.append(ttft)
                        self._window_ttfts.append(ttft)
                        self.slo.observe_latency("ttft", ttft, now=now)
                    elif last_emit is not None:
                        itl = now - last_emit
                        stats.itls.append(itl)
                        self._window_itls.append(itl)
                        self.slo.observe_latency("itl", itl, now=now)
                    last_emit = now
                    got.extend(ann.data.token_ids)
                    if history is not None:
                        history.extend(ann.data.token_ids)
                stats.completed += 1
                if spec.verify_outputs:
                    if spec.fleet.engine == "mocker":
                        # the mocker's greedy chain is fully determined by
                        # the prompt's last token — so the reference an
                        # unmigrated run would stream is computable without
                        # running it, and any resume/migration replay or
                        # drop shows up here
                        last = tokens[-1] if tokens else -1
                        expected = [(last + 1 + i) % 1000 for i in range(osl)]
                    else:
                        # real engines sample real logits: the strongest
                        # engine-agnostic invariant is the token COUNT the
                        # stop conditions demand (ignore_eos + max_tokens)
                        expected = None
                    if (got == expected if expected is not None
                            else len(got) == osl):
                        stats.verified += 1
                    else:
                        stats.corrupt += 1
                        logger.warning(
                            "output diverged from greedy reference "
                            "(kind=%s len=%d want=%d)", kind, len(got), osl,
                        )
                self.slo.observe_outcome("error_rate", True, now=self.sim_now())
                return True
            except asyncio.CancelledError:
                stats.abandoned += 1
                raise
            except Exception as exc:  # noqa: BLE001 — chaos faults land here
                if ttft is None and attempt < spec.retry_max:
                    stats.retries += 1
                    counters.incr("dyn_retries_total")
                    continue
                logger.debug("request failed (%s attempts): %s", attempt + 1, exc)
                stats.failed += 1
                self.slo.observe_outcome("error_rate", False, now=self.sim_now())
                return False
        return False

    async def _run_arrival(self, stats: _PhaseStats, phase_t0: float,
                           arrival, rng: random.Random) -> None:
        await self._sim_sleep_until(phase_t0 + arrival.at_s)
        await self._execute(
            stats, prompt_tokens(arrival.isl, rng), arrival.osl, arrival.kind
        )

    async def _run_session(self, stats: _PhaseStats, phase_t0: float,
                           sess) -> None:
        """Closed-loop multi-turn session: each turn's prompt embeds the
        actual streamed history (chat clients echo assistant tokens)."""
        await self._sim_sleep_until(phase_t0 + sess.start_s)
        history = list(sess.system_tokens)
        for i, turn in enumerate(sess.turns):
            if i and turn.arrival_gap_s:
                await asyncio.sleep(turn.arrival_gap_s / self.spec.speedup)
            history.extend(turn.user_tokens)
            await self._execute(stats, history, turn.osl, "session",
                                history=history)

    # -- chaos ---------------------------------------------------------------
    async def _arm_later(self, phase: Phase, ev, phase_t0: float,
                         armed: list) -> None:
        await self._sim_sleep_until(phase_t0 + ev.at_s)
        FAULTS.arm(ev.schedule)
        armed.append({"t": round(self.sim_now(), 3), "schedule": ev.schedule})
        logger.info("phase %s: armed faults %r", phase.name, ev.schedule)

    async def _kill_later(self, phase: Phase, ev, phase_t0: float,
                          killed: list) -> None:
        await self._sim_sleep_until(phase_t0 + ev.at_s)
        wid = await self.fleet.kill_worker(ev.pool, mode=ev.mode)
        killed.append({
            "t": round(self.sim_now(), 3), "pool": ev.pool, "mode": ev.mode,
            "worker": None if wid is None else f"{wid:x}",
        })
        logger.info("phase %s: %s worker %s in pool %s",
                    phase.name, ev.mode, wid, ev.pool)

    async def _migrate_later(self, phase: Phase, ev, phase_t0: float,
                             migrated: list) -> None:
        """MigrationEvent: live-migrate up to ``count`` in-flight sessions,
        each to the coordinator's cheapest-hop pick.  Refusals (session
        finished between listing and migrating, no destination) are recorded
        and skipped — the event keeps walking the registry until it commits
        ``count`` moves or runs out of sessions."""
        await self._sim_sleep_until(phase_t0 + ev.at_s)
        coord = getattr(self.fleet.push, "migrations", None)
        if coord is None:
            migrated.append({"t": round(self.sim_now(), 3),
                             "error": "migration disabled (DYN_MIGRATE=0)"})
            return
        committed = 0
        for rid in sorted(coord.sessions()):
            if committed >= ev.count:
                break
            res = await coord.migrate(rid, None, reason=ev.reason)
            migrated.append({
                "t": round(self.sim_now(), 3), "request": rid,
                "ok": bool(res.get("ok")), "src": res.get("src"),
                "dst": res.get("dst"), "hop": res.get("hop"),
                "error": res.get("error"),
            })
            if res.get("ok"):
                committed += 1
        logger.info("phase %s: migration event committed %d/%d",
                    phase.name, committed, ev.count)

    # -- defrag ---------------------------------------------------------------
    def _occupancy(self) -> dict[int, float]:
        """Per-worker KV occupancy from the live metrics aggregator."""
        snap = self.fleet.metrics_service.aggregator.snapshot()
        return {
            wid: float(getattr(m, "gpu_cache_usage_perc", 0.0))
            for wid, m in snap.workers.items()
        }

    # -- autopilot -----------------------------------------------------------
    async def _autopilot_step(self, phase_name: str) -> None:
        ap = self.spec.autopilot
        interval = max(ap.interval_s, 1e-6)
        now = self.sim_now()
        # request_rate in WALL req/s (sim rate × speedup) so demand matches
        # the mocker's wall-clock goodput capacity units
        rate_sim = self._window_submitted / interval
        mean = lambda xs, d: (sum(xs) / len(xs)) if xs else d  # noqa: E731
        sample = sample_from_endpoints(
            self.fleet.metrics_service.aggregator.snapshot(),
            request_rate=rate_sim * self.spec.speedup,
            avg_isl=mean(self._window_isl, 64.0),
            avg_osl=mean(self._window_osl, 16.0),
            ttft_s=mean(self._window_ttfts, 0.0),
            itl_s=mean(self._window_itls, 0.0),
            roles=self.fleet.roles(),
            slo_status=self.slo.status(now),
        )
        self._window_submitted = 0
        self._window_isl.clear()
        self._window_osl.clear()
        self._window_ttfts.clear()
        self._window_itls.clear()
        decision = await self.planner.step(sample, now=now)
        self.decisions.append({
            "t": round(now, 3),
            "phase": phase_name,
            "reason": decision.reason,
            "num_prefill": decision.num_prefill,
            "num_decode": decision.num_decode,
            "burn_input": round(self.planner.worst_burn_input, 4),
            "request_rate_sim": round(rate_sim, 3),
            "executed": {
                pool: self.fleet.replica_count(pool)
                for pool in self.spec.fleet.pools
            },
        })

    # -- ticks ---------------------------------------------------------------
    def _capture_top(self) -> dict:
        return collect_snapshot(
            frontend=self.fleet.frontend_url,
            worker=self.fleet.worker_url,
            timeout=3.0,
        )

    async def _tick(self, phase_name: str) -> None:
        snap = await asyncio.to_thread(self._capture_top)
        fleet = snap.get("fleet") or {}
        now = self.sim_now()
        # cross-worker KV-occupancy dispersion: the defrag loop's input and
        # the migration bench's before/after measurement
        occ = self._occupancy()
        mean_occ = sum(occ.values()) / len(occ) if occ else 0.0
        var = (
            sum((v - mean_occ) ** 2 for v in occ.values()) / len(occ)
            if occ else 0.0
        )
        self.ticks.append({
            "t": round(now, 3),
            "phase": phase_name,
            "workers": fleet.get("workers", 0),
            "goodput_tok_s": round(fleet.get("goodput_tokens_per_second", 0.0), 2),
            "mfu": round(fleet.get("mfu_perc_avg", 0.0), 4),
            "waiting": fleet.get("waiting", 0),
            "running": fleet.get("running", 0),
            "worst_burn": round(self.slo.worst_burn_rate(now), 3),
            "kv_occ_mean": round(mean_occ, 4),
            "kv_occ_var": round(var, 6),
            "kv_occ_spread": round(Defragmenter.spread(occ), 4),
            "planner": snap.get("planner"),
        })

    # -- phase ---------------------------------------------------------------
    async def _run_phase(self, phase: Phase) -> dict:
        spec = self.spec
        plan: PhasePlan = plan_phase(phase, spec.seed)
        stats = _PhaseStats()
        rng = random.Random((spec.seed, phase.name, "prompts").__repr__())
        phase_t0 = self.sim_now()
        faults_before = counters.get("dyn_faults_injected_total")
        armed: list = []
        ticks_before = len(self.ticks)
        selections_before = dict(self.fleet.selection_counts)

        work = [
            asyncio.ensure_future(self._run_arrival(stats, phase_t0, a, rng))
            for a in plan.arrivals
        ] + [
            asyncio.ensure_future(self._run_session(stats, phase_t0, s))
            for s in plan.sessions
        ]
        killed: list = []
        migrated: list = []
        mig_before = {
            k: counters.get(f"dyn_migration_{k}_total")
            for k in ("started", "committed", "aborted", "failed")
        }
        chaos = [
            asyncio.ensure_future(self._arm_later(phase, ev, phase_t0, armed))
            for ev in phase.faults
        ] + [
            asyncio.ensure_future(self._kill_later(phase, ev, phase_t0, killed))
            for ev in phase.worker_kills
        ] + [
            asyncio.ensure_future(
                self._migrate_later(phase, ev, phase_t0, migrated)
            )
            for ev in phase.migrations
        ]

        # tick/autopilot loop for the phase duration
        mid_captured = False
        while self.sim_now() - phase_t0 < phase.duration_s:
            await asyncio.sleep(spec.tick_s / spec.speedup)
            await self._tick(phase.name)
            now = self.sim_now()
            if spec.autopilot.enabled and now >= self._next_plan_t:
                self._next_plan_t = now + spec.autopilot.interval_s
                await self._autopilot_step(phase.name)
            if self.defrag is not None and now >= self._next_defrag_t:
                self._next_defrag_t = now + spec.autopilot.interval_s
                await self.defrag.step(self._occupancy(), now=now)
            if not mid_captured and now - phase_t0 >= phase.duration_s / 2:
                mid_captured = True
                snap = await asyncio.to_thread(self._capture_top)
                snap["phase"] = phase.name
                self.top_snapshots.append(snap)

        # drain: give in-flight requests a bounded grace window
        if work:
            done, pending = await asyncio.wait(
                work, timeout=spec.drain_s / spec.speedup
            )
            for task in pending:
                task.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
        for task in chaos:
            task.cancel()
        await asyncio.gather(*chaos, return_exceptions=True)

        burn = stats.burn(spec)
        phase_ticks = self.ticks[ticks_before:]
        mean_tick = lambda key: (  # noqa: E731
            sum(t[key] for t in phase_ticks) / len(phase_ticks)
            if phase_ticks else 0.0
        )
        goodput = mean_tick("goodput_tok_s")
        mfu = mean_tick("mfu")

        failures: list[str] = []
        a = phase.assertions
        for objective, ceiling in (a.max_burn_rate or {}).items():
            got = burn.get(objective)
            if got is None:
                failures.append(f"unknown objective in max_burn_rate: {objective}")
            elif got > ceiling:
                failures.append(
                    f"burn[{objective}]={got:.2f} exceeds ceiling {ceiling}"
                )
        if a.min_goodput_tok_s and goodput < a.min_goodput_tok_s:
            failures.append(
                f"goodput {goodput:.1f} tok/s below floor {a.min_goodput_tok_s}"
            )
        if a.min_mfu and mfu < a.min_mfu:
            failures.append(f"mfu {mfu:.3f} below floor {a.min_mfu}")
        if a.min_completed and stats.completed < a.min_completed:
            failures.append(
                f"completed {stats.completed} below floor {a.min_completed}"
            )
        mig_counts = {
            k: counters.get(f"dyn_migration_{k}_total") - v
            for k, v in mig_before.items()
        }
        if (
            a.min_migrations_committed
            and mig_counts["committed"] < a.min_migrations_committed
        ):
            failures.append(
                f"migrations committed {mig_counts['committed']} below floor "
                f"{a.min_migrations_committed}"
            )
        if a.max_failed >= 0 and stats.failed > a.max_failed:
            failures.append(
                f"failed requests {stats.failed} exceed ceiling {a.max_failed}"
            )
        if spec.verify_outputs and stats.corrupt:
            failures.append(
                f"{stats.corrupt} completed request(s) streamed tokens "
                "diverging from the greedy reference"
            )

        # topology-aware routing: where did this phase's selections land?
        topology_view = None
        if spec.fleet.slices:
            by_slice: dict[str, int] = {}
            for wid, count in self.fleet.selection_counts.items():
                delta = count - selections_before.get(wid, 0)
                if delta > 0:
                    label = self.fleet.slice_of(wid) or "-"
                    by_slice[label] = by_slice.get(label, 0) + delta
            total_sel = sum(by_slice.values())
            near = by_slice.get(self.fleet.near_slice, 0)
            near_fraction = near / total_sel if total_sel else 0.0
            topology_view = {
                "near_slice": self.fleet.near_slice,
                "selections_by_slice": by_slice,
                "near_fraction": round(near_fraction, 4),
            }
            if a.min_near_slice_fraction:
                if not total_sel:
                    failures.append(
                        "min_near_slice_fraction set but no routed selections "
                        "observed (policy must be kv)"
                    )
                elif near_fraction < a.min_near_slice_fraction:
                    failures.append(
                        f"near-slice fraction {near_fraction:.2f} below floor "
                        f"{a.min_near_slice_fraction} ({by_slice})"
                    )
        elif a.min_near_slice_fraction:
            failures.append(
                "min_near_slice_fraction set but fleet.slices is empty"
            )

        ms = lambda x: None if x is None else round(x * 1000.0, 2)  # noqa: E731
        return {
            "name": phase.name,
            "traffic": phase.traffic.kind,
            "duration_s": phase.duration_s,
            "requests": {
                "planned": plan.expected_requests,
                "submitted": stats.submitted,
                "completed": stats.completed,
                "failed": stats.failed,
                "retries": stats.retries,
                "abandoned_in_drain": stats.abandoned,
                "by_kind": stats.by_kind,
            },
            # simulated milliseconds (speedup-independent)
            "ttft_sim_ms": {
                "p50": ms(_pctile(stats.ttfts, 0.5)),
                "p90": ms(_pctile(stats.ttfts, 0.9)),
                "p99": ms(_pctile(stats.ttfts, 0.99)),
            },
            "itl_sim_ms": {
                "p50": ms(_pctile(stats.itls, 0.5)),
                "p90": ms(_pctile(stats.itls, 0.9)),
                "p99": ms(_pctile(stats.itls, 0.99)),
            },
            "burn_rates": {k: round(v, 3) for k, v in burn.items()},
            "goodput_tok_s_mean": round(goodput, 2),
            "mfu_mean": round(mfu, 4),
            "faults": {
                "armed": armed,
                "injected": counters.get("dyn_faults_injected_total") - faults_before,
                "fired": dict(FAULTS.fired),
            },
            "worker_kills": killed,
            "migrations": {"events": migrated, **mig_counts},
            "outputs": (
                {"verified": stats.verified, "corrupt": stats.corrupt}
                if spec.verify_outputs else None
            ),
            "topology": topology_view,
            "resumes": {
                "attempts": counters.get("dyn_resume_attempts_total"),
                "succeeded": counters.get("dyn_resume_success_total"),
            },
            "assertions": {"passed": not failures, "failures": failures},
        }

    # -- the run -------------------------------------------------------------
    async def run(self) -> dict:
        spec = self.spec
        FAULTS.reset()
        flight_dumps: list[str] = []
        wall_start = time.monotonic()
        self._t0_wall = wall_start
        self.fleet = SoakFleet(
            spec=spec, slo=self.slo, sim_now=self.sim_now, name=self._name,
            **self.fleet_options,
        )
        phases: list[dict] = []
        try:
            await self.fleet.start()
            if spec.autopilot.enabled:
                ap = spec.autopilot
                connector = LocalConnector(
                    self.fleet, prefill_watcher="prefill", decode_watcher="decode"
                )
                self.planner = Planner(
                    _bootstrap_profile(spec), connector,
                    PlannerConfig(
                        adjustment_interval_s=ap.interval_s,
                        predictor="ewma",
                        min_prefill=ap.min_prefill, max_prefill=ap.max_prefill,
                        min_decode=ap.min_decode, max_decode=ap.max_decode,
                        max_total_chips=ap.max_total_chips,
                        burn_upscale=ap.burn_upscale,
                        burn_hold=ap.burn_hold,
                        cooldown_s=ap.cooldown_s,
                        rebalance=ap.rebalance,
                        rebalance_occupancy=ap.rebalance_occupancy,
                        saturation_occupancy=ap.saturation_occupancy,
                        scale_down_headroom=ap.scale_down_headroom,
                    ),
                    clock=self.sim_now,
                )
                self.state_pub = PlannerStatePublisher(
                    self.fleet.comp, clock=self.sim_now
                )
                self.planner.state_publisher = self.state_pub
            if spec.autopilot.defrag:
                coord = getattr(self.fleet.push, "migrations", None)
                if coord is None:
                    logger.warning(
                        "autopilot.defrag set but live migration is disabled "
                        "(DYN_MIGRATE=0); defrag loop stays off"
                    )
                else:
                    ap = spec.autopilot
                    self.defrag = Defragmenter(
                        coord,
                        DefragConfig(
                            enabled=True,
                            occupancy_spread=ap.defrag_spread,
                            min_occupancy=ap.defrag_min_occupancy,
                            max_per_step=ap.defrag_max_per_step,
                            cooldown_s=ap.defrag_cooldown_s,
                        ),
                        clock=self.sim_now,
                    )

            # re-zero the simulated clock: fleet bring-up wall time must not
            # eat into phase 1's simulated window
            self._t0_wall = time.monotonic()
            self._next_plan_t = spec.autopilot.interval_s
            self._next_defrag_t = spec.autopilot.interval_s

            for phase in spec.phases:
                logger.info("phase %s starting at sim t=%.1fs",
                            phase.name, self.sim_now())
                phases.append(await self._run_phase(phase))
            # close the observability loop before teardown: every live
            # engine's flight ring becomes a JSONL artifact the planner's
            # replay_trace() can fit predictors from
            flight_dumps = [str(p) for p in flight_obs.dump_all("soak_end")]
        finally:
            FAULTS.reset()
            if self.fleet is not None:
                await self.fleet.stop()

        steered = [d for d in self.decisions if d["reason"] != "load"]
        passed = all(p["assertions"]["passed"] for p in phases)
        if spec.autopilot.expect_decision and not steered:
            passed = False
        return {
            "scenario": spec.name,
            "seed": spec.seed,
            "speedup": spec.speedup,
            "policy": spec.fleet.policy,
            "pools": dict(spec.fleet.pools),
            "topology": (
                None if self.fleet.topo_watch is None
                else self.fleet.topo_watch.map.to_dict()
            ),
            "wall_s": round(time.monotonic() - wall_start, 2),
            "sim_s": round(self.sim_now(), 2),
            "phases": phases,
            "planner": {
                "enabled": spec.autopilot.enabled,
                "decisions": self.decisions,
                "steering_decisions": len(steered),
                "scale_events": list(self.fleet.scale_log),
            },
            "migrations": {
                "committed": counters.get("dyn_migration_committed_total"),
                "aborted": counters.get("dyn_migration_aborted_total"),
                "failed": counters.get("dyn_migration_failed_total"),
                "defrag_moves": (
                    [] if self.defrag is None else list(self.defrag.moves)
                ),
            },
            "slo": self.slo.status(self.sim_now()),
            "flight": {
                "enabled": flight_obs.flight_enabled(),
                "dumps": flight_dumps,
            },
            "ticks": self.ticks,
            "dyn_top_snapshots": self.top_snapshots,
            "passed": passed,
        }


async def run_scenario(spec: ScenarioSpec, *, name: str | None = None,
                       fleet_options: dict | None = None) -> dict:
    return await ScenarioRunner(spec, name=name, fleet_options=fleet_options).run()
