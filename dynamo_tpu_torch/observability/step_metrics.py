"""Engine step telemetry (a copy of dynamo_tpu/observability/step_metrics.py).

The engine's device loop calls :meth:`StepTelemetry.observe_step` once per
scheduler iteration (plain Python assignments under the GIL — safe to read
from the asyncio thread); ``TorchLlmEngine.stats()`` merges the snapshot
under the reference's key names.
"""

from __future__ import annotations

import time
from dataclasses import dataclass


@dataclass
class StepSnapshot:
    """State of the most recent engine step."""

    iteration: int = 0
    num_running: int = 0
    num_waiting: int = 0
    batch_occupancy_perc: float = 0.0   # running lanes / max_batch_size
    kv_usage_perc: float = 0.0          # used blocks / pool blocks
    kv_active_blocks: int = 0
    step_duration_s: float = 0.0
    timestamp_s: float = 0.0
    prefill_tokens: int = 0             # prompt tokens computed this step
    decode_tokens: int = 0              # decode positions computed this step


class StepTelemetry:
    """Latest-step snapshot + monotone counters, cheap enough for every step."""

    def __init__(self, max_batch_size: int):
        self.max_batch_size = max(max_batch_size, 1)
        self.snapshot = StepSnapshot()
        self.steps_total = 0
        self.busy_steps_total = 0        # steps with at least one running lane
        self.step_time_total_s = 0.0

    def observe_step(
        self,
        *,
        iteration: int,
        num_running: int,
        num_waiting: int,
        kv_active_blocks: int,
        kv_total_blocks: int,
        step_duration_s: float,
        prefill_tokens: int = 0,
        decode_tokens: int = 0,
    ) -> None:
        self.snapshot = StepSnapshot(
            iteration=iteration,
            num_running=num_running,
            num_waiting=num_waiting,
            batch_occupancy_perc=num_running / self.max_batch_size,
            kv_usage_perc=(
                kv_active_blocks / kv_total_blocks if kv_total_blocks else 0.0
            ),
            kv_active_blocks=kv_active_blocks,
            step_duration_s=step_duration_s,
            timestamp_s=time.time(),
            prefill_tokens=prefill_tokens,
            decode_tokens=decode_tokens,
        )
        self.steps_total += 1
        if num_running:
            self.busy_steps_total += 1
        self.step_time_total_s += step_duration_s

    def stats(self) -> dict:
        """The ``step_*`` names are the state AT the latest step, a coherent
        point-in-time view."""
        s = self.snapshot
        return {
            "batch_occupancy_perc": s.batch_occupancy_perc,
            "step_num_running": s.num_running,
            "step_num_waiting": s.num_waiting,
            "step_kv_usage_perc": s.kv_usage_perc,
            "step_kv_active_blocks": s.kv_active_blocks,
            "engine_steps_total": self.steps_total,
            "engine_busy_steps_total": self.busy_steps_total,
            "engine_step_time_total_s": self.step_time_total_s,
            "last_step_duration_s": s.step_duration_s,
        }
