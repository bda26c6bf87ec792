"""Synthetic trace generation with shared-prefix structure.

(Reference: benchmarks/data_generator/synthesizer.py — mooncake-style traces
with a prefix tree, hasher/sampler/prefix_analyzer.)  Requests are token-id
sequences drawn from a random prefix tree, so KV-aware routing and prefix
caching see realistic overlap; arrival times follow a Poisson process.

A copy of dynamo_tpu/bench/data_generator.py; ``analyze_prefix_sharing``
hashes blocks with the port's ``llm/kv_router/hashing.py``.
"""

from __future__ import annotations

import json
import math
import random
from dataclasses import asdict, dataclass, field
from pathlib import Path


@dataclass
class TraceRequest:
    request_id: int
    arrival_s: float
    token_ids: list[int]
    osl: int

    @property
    def isl(self) -> int:
        return len(self.token_ids)


@dataclass
class SynthesizerConfig:
    num_requests: int = 256
    request_rate: float = 8.0          # Poisson arrivals/s
    vocab_size: int = 32_000
    # prefix tree: depth levels × branching, each node contributing a span
    tree_depth: int = 3
    tree_branching: int = 4
    prefix_span_tokens: int = 64       # tokens contributed per tree level
    unique_suffix_tokens: int = 128    # per-request unique tail (mean)
    osl_mean: int = 128
    seed: int = 0


class TraceSynthesizer:
    def __init__(self, config: SynthesizerConfig):
        self.config = config
        self._rng = random.Random(config.seed)
        # materialize the prefix tree: path -> token span
        self._spans: dict[tuple, list[int]] = {}

    def _span(self, path: tuple) -> list[int]:
        span = self._spans.get(path)
        if span is None:
            rng = random.Random(hash((self.config.seed, path)) & 0xFFFFFFFF)
            span = [rng.randrange(10, self.config.vocab_size) for _ in range(self.config.prefix_span_tokens)]
            self._spans[path] = span
        return span

    def generate(self) -> list[TraceRequest]:
        cfg = self.config
        requests = []
        t = 0.0
        for i in range(cfg.num_requests):
            t += self._rng.expovariate(cfg.request_rate)
            # random path through the tree
            path: tuple = ()
            tokens: list[int] = []
            depth = self._rng.randint(1, cfg.tree_depth)
            for _ in range(depth):
                path = path + (self._rng.randrange(cfg.tree_branching),)
                tokens.extend(self._span(path))
            n_suffix = max(1, int(self._rng.expovariate(1.0 / cfg.unique_suffix_tokens)))
            tokens.extend(
                self._rng.randrange(10, cfg.vocab_size) for _ in range(n_suffix)
            )
            osl = max(1, int(self._rng.expovariate(1.0 / cfg.osl_mean)))
            requests.append(TraceRequest(request_id=i, arrival_s=t, token_ids=tokens, osl=osl))
        return requests

    def write_jsonl(self, path: str | Path) -> list[TraceRequest]:
        requests = self.generate()
        with open(path, "w") as f:
            for r in requests:
                f.write(json.dumps(asdict(r)) + "\n")
        return requests


@dataclass
class SessionTurn:
    arrival_gap_s: float        # gap after the previous turn's last token
    user_tokens: list[int]      # this turn's new user input
    osl: int                    # assistant tokens to generate


@dataclass
class Session:
    session_id: int
    start_s: float
    system_tokens: list[int]    # session prefix (system prompt / doc context)
    turns: list[SessionTurn]


@dataclass
class SessionConfig:
    """Multi-turn chat workload (reference: the KV-routing 3x-TTFT claim is
    demonstrated on multi-turn traffic, docs/architecture/architecture.md:86-91):
    each session's growing history is ITS OWN prefix, so sessions spread load
    across workers while an affine router turns every follow-up turn into a
    tail-only prefill."""

    num_sessions: int = 40
    turns_per_session: int = 5
    session_rate: float = 3.0          # Poisson session starts/s
    system_tokens: int = 768           # per-session shared prefix
    user_tokens_per_turn: int = 64
    turn_gap_mean_s: float = 3.0       # think time between turns
    osl: int = 24
    vocab_size: int = 32_000
    seed: int = 0


def generate_sessions(cfg: SessionConfig) -> list[Session]:
    rng = random.Random(cfg.seed)
    sessions = []
    t = 0.0
    for sid in range(cfg.num_sessions):
        t += rng.expovariate(cfg.session_rate)
        turns = [
            SessionTurn(
                arrival_gap_s=(
                    0.0 if i == 0 else rng.expovariate(1.0 / cfg.turn_gap_mean_s)
                ),
                user_tokens=[
                    rng.randrange(10, cfg.vocab_size)
                    for _ in range(cfg.user_tokens_per_turn)
                ],
                osl=cfg.osl,
            )
            for i in range(cfg.turns_per_session)
        ]
        sessions.append(
            Session(
                session_id=sid,
                start_s=t,
                system_tokens=[
                    rng.randrange(10, cfg.vocab_size)
                    for _ in range(cfg.system_tokens)
                ],
                turns=turns,
            )
        )
    return sessions


def load_trace(path: str | Path) -> list[TraceRequest]:
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                d = json.loads(line)
                out.append(TraceRequest(**d))
    return out


def analyze_prefix_sharing(requests: list[TraceRequest], block_size: int = 16) -> dict:
    """Prefix-overlap statistics (reference: prefix_analyzer) — what fraction
    of request blocks are shared with at least one earlier request."""
    from dynamo_tpu_torch.llm.kv_router.hashing import compute_block_hashes

    seen: set[int] = set()
    total_blocks = 0
    shared_blocks = 0
    for r in requests:
        hashes = compute_block_hashes(r.token_ids, block_size)
        total_blocks += len(hashes)
        for h in hashes:
            if h in seen:
                shared_blocks += 1
            else:
                seen.add(h)
    return {
        "total_blocks": total_blocks,
        "shared_blocks": shared_blocks,
        "sharing_ratio": shared_blocks / total_blocks if total_blocks else 0.0,
        "mean_isl": sum(r.isl for r in requests) / len(requests) if requests else 0,
        "mean_osl": sum(r.osl for r in requests) / len(requests) if requests else 0,
    }
