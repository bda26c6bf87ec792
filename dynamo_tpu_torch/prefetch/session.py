"""Session-aware next-turn prediction.

A multi-turn session is identified by its prefix hash chain: turn N+1's
prompt embeds turn N's whole history, so turn N's final block hash appears
*verbatim* inside turn N+1's chain (hashes chain their parents — a hash is
the whole prefix ending at that block).  That makes session tracking
tokenizer- and content-free: observe each request's chain, match it to the
session whose recorded tip it contains, and model the inter-turn gap.

The gap model is an EWMA over observed think times (PRESERVE, arxiv
2501.08192 models returning-session arrival the same way).  A predicted
arrival fires once per turn, ``lead_s`` before the expected time, giving
the pager that long to page the session's blocks up-tier.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field


@dataclass
class _Session:
    tip: int                         # last block hash of the latest turn's chain
    hashes: list[int]                # the latest turn's full chain
    last_arrival: float
    gap_ewma: float | None = None    # seconds between consecutive turns
    fired: bool = False              # predicted hint already emitted for next turn
    turns: int = 1


@dataclass
class Prediction:
    block_hashes: list[int] = field(default_factory=list)
    predicted_at: float = 0.0        # expected arrival time


class SessionPredictor:
    """Tracks sessions by prefix hash chain and predicts next-turn arrivals.

    Single-consumer (the forwarder's event loop); bounded to
    ``max_sessions`` by LRU on last arrival.
    """

    def __init__(
        self,
        *,
        lead_s: float = 1.0,
        alpha: float = 0.5,
        min_gap_s: float = 0.05,
        max_sessions: int = 4096,
        clock=time.monotonic,
    ):
        self.lead_s = lead_s
        self.alpha = alpha
        self.min_gap_s = min_gap_s
        self.max_sessions = max_sessions
        self._clock = clock
        # tip hash -> session (a session is re-keyed to its new tip each turn)
        self._sessions: OrderedDict[int, _Session] = OrderedDict()
        self.turns_observed = 0
        self.sessions_tracked = 0

    def observe(self, block_hashes: list[int], now: float | None = None) -> bool:
        """Record an arrival.  Returns True when it continued a known
        session (and the gap model updated)."""
        if not block_hashes:
            return False
        now = self._clock() if now is None else now
        self.turns_observed += 1
        # walk the chain from the END: the longest (newest) matching tip wins
        # when one session's history embeds another's
        matched = None
        for h in reversed(block_hashes):
            sess = self._sessions.get(h)
            if sess is not None:
                matched = (h, sess)
                break
        tip = block_hashes[-1]
        if matched is None:
            self._sessions[tip] = _Session(
                tip=tip, hashes=list(block_hashes), last_arrival=now
            )
            self._sessions.move_to_end(tip)
            self.sessions_tracked += 1
            self._evict()
            return False
        old_tip, sess = matched
        gap = max(now - sess.last_arrival, self.min_gap_s)
        sess.gap_ewma = (
            gap if sess.gap_ewma is None
            else self.alpha * gap + (1.0 - self.alpha) * sess.gap_ewma
        )
        sess.last_arrival = now
        sess.hashes = list(block_hashes)
        sess.fired = False
        sess.turns += 1
        if old_tip != tip:
            del self._sessions[old_tip]
            sess.tip = tip
            self._sessions[tip] = sess
        self._sessions.move_to_end(tip)
        self._evict()
        return True

    def due(self, now: float | None = None) -> list[Prediction]:
        """Predictions whose fire time (expected arrival − lead) has come.
        Each next-turn prediction fires exactly once."""
        now = self._clock() if now is None else now
        out: list[Prediction] = []
        for sess in self._sessions.values():
            if sess.fired or sess.gap_ewma is None:
                continue
            expected = sess.last_arrival + sess.gap_ewma
            if now >= expected - self.lead_s:
                sess.fired = True
                out.append(
                    Prediction(block_hashes=list(sess.hashes), predicted_at=expected)
                )
        return out

    def _evict(self) -> None:
        while len(self._sessions) > self.max_sessions:
            self._sessions.popitem(last=False)

    def __len__(self) -> int:
        return len(self._sessions)
