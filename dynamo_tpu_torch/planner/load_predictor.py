"""Load predictors, a copy of dynamo_tpu/planner/load_predictor.py
(reference: components/planner/.../utils/load_predictor.py
— constant / ARIMA / Prophet).  Here: constant, EWMA, linear-trend, an
AR(p)-with-differencing forecaster fitted by least squares (the ARIMA(p,d,0)
role), and a seasonal trend decomposition (the Prophet role) — numpy-only,
no pandas/pmdarima/Prophet runtime.

Every predictor also answers ``predict_ahead(steps)`` — the ``steps``-tick
forecast the planner needs to act BEFORE a load crest instead of reacting
at it — and ``replay_trace()`` fits a predictor offline from a flight
recorder dump (observability/flight.py), so a soak's telemetry closes the
loop back into planning."""

from __future__ import annotations

from collections import deque
from pathlib import Path

import numpy as np


class ConstantPredictor:
    """Next value = last observation."""

    def __init__(self, **_):
        self._last = 0.0

    def observe(self, value: float) -> None:
        self._last = value

    def predict(self) -> float:
        return self._last

    def predict_ahead(self, steps: int = 1) -> float:
        return self.predict()


class EwmaPredictor:
    """Exponentially-weighted moving average."""

    def __init__(self, alpha: float = 0.5, **_):
        self.alpha = alpha
        self._value: float | None = None

    def observe(self, value: float) -> None:
        if self._value is None:
            self._value = value
        else:
            self._value = self.alpha * value + (1 - self.alpha) * self._value

    def predict(self) -> float:
        return self._value or 0.0

    def predict_ahead(self, steps: int = 1) -> float:
        # the EWMA level is a flat forecast at any horizon
        return self.predict()


class LinearTrendPredictor:
    """Least-squares line over a sliding window, extrapolated one step."""

    def __init__(self, window: int = 8, **_):
        self._obs: deque[float] = deque(maxlen=window)

    def observe(self, value: float) -> None:
        self._obs.append(value)

    def predict(self) -> float:
        return self.predict_ahead(1)

    def predict_ahead(self, steps: int = 1) -> float:
        n = len(self._obs)
        if n == 0:
            return 0.0
        if n == 1:
            return self._obs[0]
        xs = range(n)
        mean_x = (n - 1) / 2
        mean_y = sum(self._obs) / n
        cov = sum((x - mean_x) * (y - mean_y) for x, y in zip(xs, self._obs))
        var = sum((x - mean_x) ** 2 for x in xs)
        slope = cov / var if var else 0.0
        return max(0.0, mean_y + slope * (n - 1 + steps - mean_x))


class ArPredictor:
    """ARIMA(p, d, 0) by ordinary least squares over a sliding window.

    The series is differenced ``d`` times, an order-``p`` autoregression is
    fitted with ``np.linalg.lstsq`` (with intercept), the one-step forecast
    is produced in the differenced domain and integrated back.  Falls back
    to last-value while the window is shorter than ``2p + d + 1``."""

    def __init__(self, p: int = 3, d: int = 1, window: int = 64, **_):
        if p < 1 or d < 0:
            raise ValueError("ArPredictor needs p >= 1, d >= 0")
        self.p = p
        self.d = d
        self._obs: deque[float] = deque(maxlen=max(window, 2 * p + d + 4))

    def observe(self, value: float) -> None:
        self._obs.append(float(value))

    def predict(self) -> float:
        y = np.asarray(self._obs, np.float64)
        if y.size == 0:
            return 0.0
        z = y.copy()
        for _ in range(self.d):
            if z.size < 2:
                return float(y[-1])
            z = np.diff(z)
        if z.size < 2 * self.p + 1:
            return float(y[-1])
        # lagged design matrix: z[t] ~ c + sum_i phi_i * z[t-i]
        rows = z.size - self.p
        X = np.ones((rows, self.p + 1))
        for i in range(1, self.p + 1):
            X[:, i] = z[self.p - i : self.p - i + rows]
        target = z[self.p :]
        coef, *_ = np.linalg.lstsq(X, target, rcond=None)
        z_next = coef[0] + coef[1:] @ z[-1 : -self.p - 1 : -1]
        # integrate the differencing back: forecast = last level(s) + z_next
        forecast = z_next
        tail = y.copy()
        for _ in range(self.d):
            forecast = forecast + tail[-1]
            tail = np.diff(tail) if tail.size > 1 else tail
        return float(max(0.0, forecast))

    def predict_ahead(self, steps: int = 1) -> float:
        # roll the one-step forecast forward, feeding each prediction back
        # as an observation (the standard iterated AR multi-step forecast);
        # the window is restored afterwards, so this is side-effect free
        saved = list(self._obs)
        try:
            value = self.predict()
            for _ in range(int(steps) - 1):
                self._obs.append(value)
                value = self.predict()
            return value
        finally:
            self._obs.clear()
            self._obs.extend(saved)


class SeasonalPredictor:
    """Seasonal-trend decomposition forecast (the Prophet role): a linear
    trend is fitted on the window, per-phase seasonal offsets (period ``m``)
    are averaged over the detrended series, and the one-step forecast is
    trend(t+1) + season((t+1) mod m).  Falls back to last-value until two
    full periods are observed."""

    def __init__(self, period: int = 12, window: int = 96, **_):
        if period < 2:
            raise ValueError("SeasonalPredictor needs period >= 2")
        self.period = period
        self._obs: deque[float] = deque(maxlen=max(window, 4 * period))
        self._t = 0  # absolute index of the NEXT observation (phase anchor)

    def observe(self, value: float) -> None:
        self._obs.append(float(value))
        self._t += 1

    def predict(self) -> float:
        return self.predict_ahead(1)

    def predict_ahead(self, steps: int = 1) -> float:
        y = np.asarray(self._obs, np.float64)
        n = y.size
        if n == 0:
            return 0.0
        if n < 2 * self.period:
            return float(y[-1])
        m = self.period
        # JOINT least squares of trend + seasonal phase dummies: fitting
        # trend first then averaging residuals leaks (a sinusoid correlates
        # with t even over whole periods), so solve them together
        xs = np.arange(n, dtype=np.float64)
        start = self._t - n  # absolute index of window position 0
        phases = ((start + np.arange(n)) % m).astype(int)
        X = np.zeros((n, m + 1))
        X[:, 0] = xs
        X[:, 1] = 1.0
        for ph in range(m - 1):  # last phase is the baseline
            X[:, 2 + ph] = phases == ph
        coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        x_next = np.zeros(m + 1)
        x_next[0] = n - 1 + steps
        x_next[1] = 1.0
        next_phase = (self._t - 1 + steps) % m
        if next_phase < m - 1:
            x_next[2 + next_phase] = 1.0
        return float(max(0.0, coef @ x_next))


def make_predictor(kind: str = "constant", **kwargs):
    return {
        "constant": ConstantPredictor,
        "ewma": EwmaPredictor,
        "linear": LinearTrendPredictor,
        "ar": ArPredictor,
        "arima": ArPredictor,
        "seasonal": SeasonalPredictor,
        "prophet": SeasonalPredictor,
    }[kind](**kwargs)


def replay_trace(
    source,
    *,
    kind: str = "seasonal",
    field: str = "num_running",
    bucket_s: float = 1.0,
    agg: str = "mean",
    **kwargs,
):
    """Fit a predictor offline from a flight-recorder trace.

    ``source`` is a flight dump path (observability/flight.py JSONL) or an
    iterable of already-loaded record dicts.  The trace's ``step`` records
    are bucketed into a regular ``bucket_s`` series on the recorder's
    monotonic clock — ``field`` per bucket, aggregated by ``agg``
    ("mean" for level signals like num_running, "sum" for rate signals
    like decode_tokens) — and replayed through ``make_predictor(kind)``.
    Gaps hold the last level under "mean" and read zero under "sum".

    Returns the fitted predictor, ready for ``predict_ahead()``."""
    if isinstance(source, (str, Path)):
        from dynamo_tpu_torch.observability.flight import load_dump

        _header, records = load_dump(source)
    else:
        records = list(source)
    if agg not in ("mean", "sum"):
        raise ValueError(f"agg must be mean|sum, got {agg!r}")
    steps = [
        r for r in records
        if r.get("kind") == "step" and field in r and "t" in r
    ]
    if not steps:
        raise ValueError(f"no step records carrying {field!r} in the trace")
    if bucket_s <= 0:
        raise ValueError("bucket_s must be > 0")
    t0 = min(float(r["t"]) for r in steps)
    buckets: dict[int, list[float]] = {}
    for r in steps:
        idx = int((float(r["t"]) - t0) / bucket_s)
        buckets.setdefault(idx, []).append(float(r[field]))
    predictor = make_predictor(kind, **kwargs)
    level = 0.0
    for i in range(max(buckets) + 1):
        vals = buckets.get(i)
        if vals:
            level = sum(vals) if agg == "sum" else sum(vals) / len(vals)
        elif agg == "sum":
            level = 0.0
        predictor.observe(level)
    return predictor
