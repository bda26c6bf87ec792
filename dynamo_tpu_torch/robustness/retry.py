"""Exponential backoff with jitter (reconnects, resubscribes, retries).

(Reference posture: etcd/NATS clients reconnect forever with capped
exponential backoff; jitter keeps a restarted control plane from being
stampeded by every client retrying in phase.)
"""

from __future__ import annotations

import math
import random

from dynamo_tpu_torch.utils import knobs


class Backoff:
    """Capped exponential backoff.  ``rng`` may be seeded for deterministic
    chaos tests.

    Two jitter modes:

    - *equal* (default): each delay is multiplied by ``1 ± jitter`` — the
      retry cadence stays recognizable in logs, but a fleet that failed in
      phase stays mostly in phase (±20 % of the same schedule).
    - *full* (``full_jitter=True``): each delay is drawn uniformly from
      ``[0, min(cap, initial·factor^n)]`` (AWS "full jitter") — the spread
      covers the whole interval, which is what actually de-synchronizes a
      reconnect storm across a fleet after a control-plane restart.
    """

    def __init__(
        self,
        initial: float = 0.05,
        factor: float = 2.0,
        max_delay: float = 2.0,
        jitter: float = 0.2,
        rng: random.Random | None = None,
        full_jitter: bool = False,
    ):
        self.initial = initial
        self.factor = factor
        self.max_delay = max_delay
        self.jitter = jitter
        self.full_jitter = full_jitter
        self.attempts = 0
        self._rng = rng or random.Random()

    @classmethod
    def from_env(cls, prefix: str, **defaults) -> "Backoff":
        """Read the registered ``{prefix}_BACKOFF_S`` /
        ``{prefix}_BACKOFF_MAX_S`` knobs on top of ``defaults`` (an unset knob
        leaves its default, an unparseable one gives the registered default)."""
        for suffix, key in (("_BACKOFF_S", "initial"), ("_BACKOFF_MAX_S", "max_delay")):
            if knobs.is_set(prefix + suffix):
                defaults[key] = knobs.get(prefix + suffix)
        return cls(**defaults)

    def _base(self) -> float:
        """``min(initial·factor^attempts, max_delay)`` without overflow: a
        long-lived reconnect loop (days of attempts) would otherwise crash
        in ``factor ** attempts`` — Python floats raise OverflowError around
        2.0**1024 — so the exponent is clamped to the smallest value whose
        uncapped delay already exceeds the cap (larger exponents cannot
        change the ``min``)."""
        exponent = self.attempts
        if self.factor > 1.0 and self.initial > 0:
            ceiling = math.log(
                max(self.max_delay / self.initial, 1.0), self.factor
            )
            exponent = min(exponent, int(ceiling) + 1)
        return min(self.initial * (self.factor ** exponent), self.max_delay)

    def next(self) -> float:
        delay = self._base()
        self.attempts += 1
        if self.full_jitter:
            return self._rng.uniform(0.0, delay)
        if self.jitter:
            delay *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return max(delay, 0.0)

    def reset(self) -> None:
        self.attempts = 0
