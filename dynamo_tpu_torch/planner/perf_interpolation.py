"""Profiled performance interpolation (reference: components/planner/
.../utils/perf_interpolation.py).

A profile is a grid of measured points (isl, osl, concurrency →
prefill_throughput tok/s/chip, decode_throughput, ttft, itl); the planner
interpolates between the nearest profiled points to estimate capacity at the
current workload.  Profiles come from ``benchmarks/profile_sla.py`` runs on
the target card.

A copy of dynamo_tpu/planner/perf_interpolation.py.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path


@dataclass
class ProfilePoint:
    isl: int
    osl: int
    concurrency: int = 1
    prefill_tok_s: float = 0.0   # prompt tokens/s/chip during prefill
    decode_tok_s: float = 0.0    # generated tokens/s/chip during decode
    ttft_s: float = 0.0
    itl_s: float = 0.0


class PerfProfile:
    def __init__(self, points: list[ProfilePoint]):
        if not points:
            raise ValueError("empty profile")
        self.points = points

    @classmethod
    def load(cls, path: str | Path) -> "PerfProfile":
        data = json.loads(Path(path).read_text())
        return cls([ProfilePoint(**p) for p in data["points"]])

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps({"points": [asdict(p) for p in self.points]}))

    def concurrencies(self) -> list[int]:
        return sorted({p.concurrency for p in self.points})

    def _interp(
        self, isl: float, osl: float, field: str, concurrency: int | None = None
    ) -> float:
        """Inverse-distance-weighted interpolation over the (isl, osl) grid —
        robust to irregular profile grids.  Interpolation is always within
        ONE concurrency level (blending single-stream and saturated numbers
        would be meaningless); default = the lowest profiled level."""
        if concurrency is None:
            concurrency = self.concurrencies()[0]
        pts = [p for p in self.points if p.concurrency == concurrency]
        if not pts:
            raise ValueError(
                f"no profiled points at concurrency={concurrency} "
                f"(have {self.concurrencies()})"
            )
        weights = 0.0
        acc = 0.0
        for p in pts:
            d2 = ((p.isl - isl) / 512.0) ** 2 + ((p.osl - osl) / 128.0) ** 2
            if d2 < 1e-12:
                return getattr(p, field)
            w = 1.0 / d2
            weights += w
            acc += w * getattr(p, field)
        return acc / weights

    def prefill_tok_s(self, isl: float, osl: float, concurrency: int | None = None) -> float:
        return self._interp(isl, osl, "prefill_tok_s", concurrency)

    def decode_tok_s(self, isl: float, osl: float, concurrency: int | None = None) -> float:
        return self._interp(isl, osl, "decode_tok_s", concurrency)

    def ttft_s(self, isl: float, osl: float, concurrency: int | None = None) -> float:
        return self._interp(isl, osl, "ttft_s", concurrency)

    def itl_s(self, isl: float, osl: float, concurrency: int | None = None) -> float:
        return self._interp(isl, osl, "itl_s", concurrency)
