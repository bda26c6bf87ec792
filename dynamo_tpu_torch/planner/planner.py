"""Planner core loop (a copy of dynamo_tpu/planner/planner.py; its chip
budget counts cards here, under the reference's field names).

Every ``adjustment_interval``: observe (request rate, ISL/OSL, TTFT/ITL) →
apply correction factors vs the profile → predict next-interval load →
compute required prefill/decode replicas → scale via the connector, within
min/max bounds and chip budget (reference: planner_core.py:162-240,
planner_sla.py:115).

Disaggregation-aware: prefill replicas are sized from predicted prompt
tokens/s against profiled prefill throughput; decode replicas from predicted
generated tokens/s against profiled decode throughput (degraded by the
observed correction factor).

SLO-native autopilot: when the sample carries burn rates (frontend ``/slo``,
``sample_from_slo_status``) the planner escalates the BURNING pool past what
the demand math asked for — TTFT burn grows the prefill pool, ITL burn the
decode pool, error burn both — and while any objective burns (or within
``cooldown_s`` of a scale-up) it refuses to scale below the current fleet.
At the chip budget it rebalances instead of growing: one replica moves from
an idle pool (occupancy under ``rebalance_occupancy``, own objective not
burning) to the burning pool, the FlowKV-style load-aware split for
disaggregated prefill/decode fleets.
"""

from __future__ import annotations

import asyncio
import math
import time
from dataclasses import dataclass, field

from dynamo_tpu_torch.planner.load_predictor import make_predictor
from dynamo_tpu_torch.planner.perf_interpolation import PerfProfile
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("planner")


@dataclass
class WorkloadSample:
    request_rate: float        # req/s
    avg_isl: float             # prompt tokens/request
    avg_osl: float             # generated tokens/request
    ttft_s: float = 0.0
    itl_s: float = 0.0
    # Observed fleet utilization (observability/perf.py via the metrics
    # service): when present, the planner sizes replicas from REAL measured
    # per-replica throughput instead of interpolating the offline profile —
    # the profile stays as bootstrap and fallback.
    observed_prefill_tok_s: float = 0.0   # fleet prompt tokens/s actually served
    observed_decode_tok_s: float = 0.0    # fleet emitted tokens/s (goodput)
    num_prefill_replicas: int = 0
    num_decode_replicas: int = 0
    # mean decode-lane occupancy across the fleet: observed throughput only
    # counts as CAPACITY when measured near saturation (an idle replica's
    # low goodput is headroom, not a ceiling)
    avg_occupancy: float = 0.0
    # SLO burn-rate inputs (frontend /slo, worst window per objective):
    # bad-fraction / error-budget — >1 means the objective is burning faster
    # than its budget.  0 disables the burn terms (legacy callers).
    ttft_burn_rate: float = 0.0
    itl_burn_rate: float = 0.0
    error_burn_rate: float = 0.0
    # utilization headroom inputs: per-pool occupancy lets the planner see
    # that one pool idles while the other burns (rebalance signal); avg_mfu
    # rides along for decision logs and the dyn_planner_* gauges
    prefill_occupancy: float = 0.0
    decode_occupancy: float = 0.0
    avg_mfu: float = 0.0
    # topology: the set of slice labels each pool's replicas live on (from
    # the fleet TopologyMap).  Empty = unknown — the slice-aware rebalance
    # guard stays inert, preserving the pre-topology planner exactly.
    prefill_slices: tuple = ()
    decode_slices: tuple = ()


def burn_rates_from_slo(status: dict | None) -> dict[str, float]:
    """Worst-window burn rate per objective from a frontend ``/slo`` payload
    (observability/slo.SloTracker.status()).  Tolerates payloads without the
    per-objective ``worst_burn_rate`` field by scanning the windows."""
    out: dict[str, float] = {}
    if not status:
        return out
    for name, obj in (status.get("objectives") or {}).items():
        worst = obj.get("worst_burn_rate")
        if worst is None:
            windows = obj.get("windows") or {}
            worst = max(
                (w.get("burn_rate", 0.0) for w in windows.values()), default=0.0
            )
        out[name] = float(worst)
    return out


def sample_from_endpoints(
    endpoints,
    *,
    request_rate: float,
    avg_isl: float,
    avg_osl: float,
    ttft_s: float = 0.0,
    itl_s: float = 0.0,
    roles: dict[int, str] | None = None,
    slo_status: dict | None = None,
    slices: dict[int, str] | None = None,
) -> WorkloadSample:
    """Build a WorkloadSample from a live fleet snapshot
    (llm/kv_router/metrics_aggregator.ProcessedEndpoints): per-worker
    goodput sums into the observed capacity terms.

    Disaggregated fleets carry a role per worker — ``roles`` maps
    worker_id → "prefill"/"decode" and overrides any role the worker
    self-reported in its ForwardPassMetrics.  Workers with no role serve
    both phases and count in both pools.  Single-pool deployments (no roles
    anywhere) degrade to the legacy behavior: the same worker set reported
    for both pools.

    ``slo_status`` is the frontend ``/slo`` JSON; when given, the worst
    window per objective becomes the sample's burn-rate inputs.

    ``slices`` maps worker_id → discovered slice label (fleet TopologyMap);
    the per-pool slice sets feed the planner's cross-slice rebalance guard.
    """
    worker_map = dict(getattr(endpoints, "workers", {}))
    roles = roles or {}
    slices = slices or {}

    def _role(wid, m) -> str:
        return roles.get(wid) or str(getattr(m, "role", "") or "")

    prefill_pool = [
        m for wid, m in worker_map.items() if _role(wid, m) in ("", "prefill")
    ]
    decode_pool = [
        m for wid, m in worker_map.items() if _role(wid, m) in ("", "decode")
    ]

    def _pool_slices(role: str) -> tuple:
        return tuple(sorted({
            slices[wid] for wid, m in worker_map.items()
            if wid in slices and slices[wid] and _role(wid, m) in ("", role)
        }))

    def _occ(pool) -> float:
        return (
            sum(getattr(m, "batch_occupancy_perc", 0.0) for m in pool) / len(pool)
            if pool else 0.0
        )

    workers = list(worker_map.values())
    goodput = sum(getattr(m, "goodput_tokens_per_second", 0.0) for m in decode_pool)
    prefill = sum(getattr(m, "prefill_tokens_per_second", 0.0) for m in prefill_pool)
    mfu = (
        sum(getattr(m, "mfu_perc", 0.0) for m in workers) / len(workers)
        if workers else 0.0
    )
    burn = burn_rates_from_slo(slo_status)
    return WorkloadSample(
        avg_occupancy=_occ(workers),
        request_rate=request_rate,
        avg_isl=avg_isl,
        avg_osl=avg_osl,
        ttft_s=ttft_s,
        itl_s=itl_s,
        observed_prefill_tok_s=prefill,
        observed_decode_tok_s=goodput,
        num_prefill_replicas=len(prefill_pool),
        num_decode_replicas=len(decode_pool),
        prefill_occupancy=_occ(prefill_pool),
        decode_occupancy=_occ(decode_pool),
        avg_mfu=mfu,
        ttft_burn_rate=burn.get("ttft", 0.0),
        itl_burn_rate=burn.get("itl", 0.0),
        error_burn_rate=burn.get("error_rate", burn.get("error", 0.0)),
        prefill_slices=_pool_slices("prefill"),
        decode_slices=_pool_slices("decode"),
    )


@dataclass
class PlannerConfig:
    adjustment_interval_s: float = 30.0
    predictor: str = "ewma"
    min_prefill: int = 1
    max_prefill: int = 8
    min_decode: int = 1
    max_decode: int = 8
    max_total_chips: int = 16
    chips_per_prefill: int = 1
    chips_per_decode: int = 1
    # SLA targets (0 disables the SLA term)
    ttft_target_s: float = 0.0
    itl_target_s: float = 0.0
    scale_down_headroom: float = 1.3   # keep 30% slack before scaling down
    # min fleet decode-lane occupancy for an observed-throughput sample to
    # update the capacity estimate (see WorkloadSample.avg_occupancy)
    saturation_occupancy: float = 0.8
    # -- SLO-native autopilot knobs (0 disables the corresponding term) ----
    # burn rate above which the burning pool is grown past the demand math
    burn_upscale: float = 1.0
    # while any objective's burn exceeds this, never scale below the current
    # fleet (latency recovery needs the capacity it is about to get)
    burn_hold: float = 0.25
    # after a burn/SLA scale-up, refuse scale-down for this long — stops the
    # flap where the freshly-grown fleet looks idle the next interval
    cooldown_s: float = 60.0
    # at the chip budget, move a replica from an idle pool (occupancy below
    # rebalance_occupancy, own objective not burning) to the burning pool
    rebalance: bool = True
    rebalance_occupancy: float = 0.5
    # pool-per-slice awareness: when the two pools' discovered slice sets
    # are disjoint, a rebalance would move a replica across DCN and split a
    # hot prefill↔decode pair — refuse the move (demand scaling unaffected)
    rebalance_slice_aware: bool = True


@dataclass
class PlannerDecision:
    num_prefill: int
    num_decode: int
    reason: str = ""


class Planner:
    def __init__(
        self,
        profile: PerfProfile,
        connector,
        config: PlannerConfig | None = None,
        clock=time.monotonic,
    ):
        self.profile = profile
        self.connector = connector
        self.config = config or PlannerConfig()
        self._clock = clock
        self._rate_pred = make_predictor(self.config.predictor)
        self._isl_pred = make_predictor(self.config.predictor)
        self._osl_pred = make_predictor(self.config.predictor)
        # correction factors: observed perf / profiled perf (reference:
        # planner_core.py correction factors)
        self._ttft_correction = 1.0
        self._itl_correction = 1.0
        # observed per-replica throughput (EWMA over samples that carried
        # utilization): replaces the profile interpolation as the capacity
        # denominator once real measurements exist
        self._prefill_cap_obs = 0.0
        self._decode_cap_obs = 0.0
        # SLO-autopilot state from the latest sample: current fleet shape,
        # per-objective burn, per-pool occupancy (0 / unknown ⇒ the burn and
        # rebalance terms stay inert and the legacy demand math rules)
        self._cur_prefill = 0
        self._cur_decode = 0
        self._burn: dict[str, float] = {"ttft": 0.0, "itl": 0.0, "error": 0.0}
        self._prefill_occ = 0.0
        self._decode_occ = 0.0
        self._prefill_slices: tuple = ()
        self._decode_slices: tuple = ()
        self._cooldown_until = float("-inf")
        self.last_decision: PlannerDecision | None = None
        self._task: asyncio.Task | None = None
        self.metrics_source = None  # set for loop mode
        # optional planner/state.PlannerStatePublisher: step() emits a
        # PlannerStateEvent after every executed decision
        self.state_publisher = None

    # observed per-replica capacity accessors (dyn_planner_* gauges)
    @property
    def observed_prefill_capacity(self) -> float:
        return self._prefill_cap_obs

    @property
    def observed_decode_capacity(self) -> float:
        return self._decode_cap_obs

    @property
    def worst_burn_input(self) -> float:
        return max(self._burn.values(), default=0.0)

    # -- one planning step -------------------------------------------------
    def observe(self, sample: WorkloadSample) -> None:
        self._rate_pred.observe(sample.request_rate)
        self._isl_pred.observe(sample.avg_isl)
        self._osl_pred.observe(sample.avg_osl)
        if sample.ttft_s > 0:
            expected = self.profile.ttft_s(sample.avg_isl, sample.avg_osl)
            if expected > 0:
                self._ttft_correction = sample.ttft_s / expected
        if sample.itl_s > 0:
            expected = self.profile.itl_s(sample.avg_isl, sample.avg_osl)
            if expected > 0:
                self._itl_correction = sample.itl_s / expected
        self._cur_prefill = sample.num_prefill_replicas
        self._cur_decode = sample.num_decode_replicas
        self._burn = {
            "ttft": sample.ttft_burn_rate,
            "itl": sample.itl_burn_rate,
            "error": sample.error_burn_rate,
        }
        self._prefill_occ = sample.prefill_occupancy or sample.avg_occupancy
        self._decode_occ = sample.decode_occupancy or sample.avg_occupancy
        self._prefill_slices = tuple(sample.prefill_slices)
        self._decode_slices = tuple(sample.decode_slices)
        # real utilization (when the sample carries it): EWMA of measured
        # per-replica throughput.  Only samples with actual flow update it —
        # an idle interval says nothing about capacity.
        alpha = 0.5
        if sample.avg_occupancy < self.config.saturation_occupancy:
            return
        if sample.num_prefill_replicas > 0 and sample.observed_prefill_tok_s > 0:
            per_replica = sample.observed_prefill_tok_s / sample.num_prefill_replicas
            self._prefill_cap_obs = (
                per_replica if self._prefill_cap_obs == 0
                else alpha * per_replica + (1 - alpha) * self._prefill_cap_obs
            )
        if sample.num_decode_replicas > 0 and sample.observed_decode_tok_s > 0:
            per_replica = sample.observed_decode_tok_s / sample.num_decode_replicas
            self._decode_cap_obs = (
                per_replica if self._decode_cap_obs == 0
                else alpha * per_replica + (1 - alpha) * self._decode_cap_obs
            )

    def plan(self, now: float | None = None) -> PlannerDecision:
        cfg = self.config
        now = self._clock() if now is None else now
        rate = self._rate_pred.predict()
        isl = max(self._isl_pred.predict(), 1.0)
        osl = max(self._osl_pred.predict(), 1.0)

        prefill_demand = rate * isl          # prompt tokens/s
        decode_demand = rate * osl           # generated tokens/s

        # capacity: measured per-replica throughput at saturation beats the
        # offline profile; the profile bootstraps and serves cold fleets
        prefill_capacity = self._prefill_cap_obs or (
            self.profile.prefill_tok_s(isl, osl) / max(self._ttft_correction, 1e-6)
        )
        decode_capacity = self._decode_cap_obs or (
            self.profile.decode_tok_s(isl, osl) / max(self._itl_correction, 1e-6)
        )

        num_prefill = math.ceil(prefill_demand / max(prefill_capacity, 1e-6) * cfg.scale_down_headroom) if prefill_demand else cfg.min_prefill
        num_decode = math.ceil(decode_demand / max(decode_capacity, 1e-6) * cfg.scale_down_headroom) if decode_demand else cfg.min_decode

        # SLA escalation: if observed latency breaches target, add capacity
        reasons: list[str] = []
        if cfg.ttft_target_s and self._ttft_correction * self.profile.ttft_s(isl, osl) > cfg.ttft_target_s:
            num_prefill += 1
            reasons.append("ttft_sla")
        if cfg.itl_target_s and self._itl_correction * self.profile.itl_s(isl, osl) > cfg.itl_target_s:
            num_decode += 1
            reasons.append("itl_sla")

        # SLO burn escalation: a burning objective grows ITS pool past the
        # demand math, relative to the fleet we actually have — demand says
        # what SHOULD suffice, burn says it demonstrably doesn't
        burn = self._burn
        cur_p, cur_d = self._cur_prefill, self._cur_decode
        if cfg.burn_upscale > 0:
            if burn["ttft"] > cfg.burn_upscale and cur_p > 0:
                num_prefill = max(num_prefill, cur_p + 1)
                reasons.append("ttft_burn")
            if burn["itl"] > cfg.burn_upscale and cur_d > 0:
                num_decode = max(num_decode, cur_d + 1)
                reasons.append("itl_burn")
            if burn["error"] > cfg.burn_upscale and (cur_p > 0 or cur_d > 0):
                num_prefill = max(num_prefill, cur_p + 1) if cur_p else num_prefill
                num_decode = max(num_decode, cur_d + 1) if cur_d else num_decode
                reasons.append("error_burn")

        # hold: while burning (or cooling down from a scale-up) never drop
        # below the current fleet — recovery needs the capacity to drain the
        # backlog, and a fresh scale-up must not be undone the next tick
        burning = cfg.burn_hold > 0 and max(burn.values()) > cfg.burn_hold
        cooling = now < self._cooldown_until
        if burning or cooling:
            if cur_p > 0:
                num_prefill = max(num_prefill, cur_p)
            if cur_d > 0:
                num_decode = max(num_decode, cur_d)
            if burning and "burn" not in "".join(reasons):
                reasons.append("burn_hold")

        num_prefill = min(max(num_prefill, cfg.min_prefill), cfg.max_prefill)
        num_decode = min(max(num_decode, cfg.min_decode), cfg.max_decode)
        want_prefill, want_decode = num_prefill, num_decode

        # chip budget: shrink the larger pool first
        while (
            num_prefill * cfg.chips_per_prefill + num_decode * cfg.chips_per_decode
            > cfg.max_total_chips
        ):
            if num_prefill * cfg.chips_per_prefill >= num_decode * cfg.chips_per_decode and num_prefill > cfg.min_prefill:
                num_prefill -= 1
            elif num_decode > cfg.min_decode:
                num_decode -= 1
            else:
                break

        # rebalance at the budget: the clamped pool stays starved while the
        # other pool idles below the occupancy bar and its own objective is
        # quiet — shift one replica toward the burn instead of giving up
        if cfg.rebalance and cfg.burn_upscale > 0:
            prefill_starved = (
                want_prefill > num_prefill and burn["ttft"] > cfg.burn_upscale
            )
            decode_starved = (
                want_decode > num_decode and burn["itl"] > cfg.burn_upscale
            )
            def _fits(p: int, d: int) -> bool:
                return (
                    p * cfg.chips_per_prefill + d * cfg.chips_per_decode
                    <= cfg.max_total_chips
                )

            # slice guard: with both pools' placements known and sharing no
            # slice, the moved replica would land a DCN hop away from every
            # partner — the transfer bill eats what the rebalance buys
            cross_slice = (
                cfg.rebalance_slice_aware
                and self._prefill_slices and self._decode_slices
                and not set(self._prefill_slices) & set(self._decode_slices)
            )
            if cross_slice and (prefill_starved or decode_starved):
                reasons.append("rebalance_blocked_cross_slice")
            elif (
                prefill_starved and not decode_starved
                and num_decode > cfg.min_decode
                and self._decode_occ < cfg.rebalance_occupancy
                and burn["itl"] <= cfg.burn_hold
                and _fits(num_prefill + 1, num_decode - 1)
            ):
                num_decode -= 1
                num_prefill += 1
                reasons.append("rebalance_to_prefill")
            elif (
                decode_starved and not prefill_starved
                and num_prefill > cfg.min_prefill
                and self._prefill_occ < cfg.rebalance_occupancy
                and burn["ttft"] <= cfg.burn_hold
                and _fits(num_prefill - 1, num_decode + 1)
            ):
                num_prefill -= 1
                num_decode += 1
                reasons.append("rebalance_to_decode")

        # arm the cooldown when the decision grows a pool past the current
        # fleet (only meaningful when the current shape is known)
        if cfg.cooldown_s > 0 and (
            (cur_p > 0 and num_prefill > cur_p) or (cur_d > 0 and num_decode > cur_d)
        ):
            self._cooldown_until = now + cfg.cooldown_s

        reason = "+".join(reasons) if reasons else "load"
        decision = PlannerDecision(num_prefill=num_prefill, num_decode=num_decode, reason=reason)
        self.last_decision = decision
        return decision

    async def step(
        self, sample: WorkloadSample, now: float | None = None
    ) -> PlannerDecision:
        self.observe(sample)
        decision = self.plan(now=now)
        await self.connector.scale(decision)
        if self.state_publisher is not None:
            try:
                await self.state_publisher.publish_decision(self, decision)
            except Exception:  # noqa: BLE001 — observability must not stop scaling
                logger.exception("planner state publish failed")
        return decision

    # -- loop mode -----------------------------------------------------------
    def start(self, metrics_source) -> None:
        """metrics_source: async callable returning WorkloadSample."""
        self.metrics_source = metrics_source
        self._task = spawn_logged(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _loop(self) -> None:
        while True:
            try:
                sample = await self.metrics_source()
                decision = await self.step(sample)
                logger.info(
                    "planner: rate=%.2f → prefill=%d decode=%d (%s)",
                    sample.request_rate, decision.num_prefill, decision.num_decode,
                    decision.reason,
                )
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                logger.exception("planner step failed")
            await asyncio.sleep(self.config.adjustment_interval_s)
