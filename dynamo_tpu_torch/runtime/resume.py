"""Mid-stream resumable generation: the journal + resume wire protocol.

When a worker dies after the first token, the dispatch path used to truncate
the stream (first-token was the retry boundary).  This module is the
seam that moves the boundary: the dispatcher keeps a per-request
:class:`GenerationJournal` (prompt hash + every token the client has been
shown + the sampling state that makes replay deterministic), and on a
mid-stream transport failure re-dispatches the *original* request with a
``resume_from`` payload attached.

Two ways a fresh worker can honor it — negotiated per-stream, not per-fleet:

- **Replay (default, engine-agnostic).**  An engine that has never heard of
  ``resume_from`` simply replays the request from token zero
  (``PreprocessedRequest.from_wire`` ignores unknown keys).  The
  dispatcher-side :func:`dedupe_stream` cursor drops exactly the first
  ``len(accepted)`` generated tokens, so the client stream is byte-identical
  under greedy decoding and replay-identical under seeded sampling.  The
  replayed prefix rides the radix/prefix-cache paths, so it is usually a
  cache hit, not recomputation.
- **Continuation (resume-aware engines).**  An engine that calls
  :func:`apply_resume` extends the prompt with the accepted tokens, shrinks
  ``max_tokens`` accordingly, and emits :func:`ack_item` as the FIRST stream
  item.  The cursor sees the ack, drops nothing, and swallows the ack before
  it can reach the client.

Resume is only offered for requests whose replay is deterministic: greedy
(``use_greedy``, or temperature unset/<= 0 — the same predicate the engines
use) or explicitly seeded.  Anything else keeps today's behavior: an honest
truncation error instead of silently divergent text.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, AsyncIterator

from dynamo_tpu_torch.utils import knobs

# Annotation event a resume-aware engine emits as its first item to signal
# "I continued from your accepted tokens — nothing to dedupe".
RESUME_ACK_EVENT = "dyn.resume.ack"


def _is_deterministic(sampling: dict) -> bool:
    """Same greedy predicate the engines apply (engine.py / mocker), plus
    explicit seeding: either way a replay reproduces the accepted prefix."""
    if sampling.get("use_greedy"):
        return True
    if sampling.get("seed") is not None:
        return True
    temperature = sampling.get("temperature")
    return temperature is None or temperature <= 0.0


class GenerationJournal:
    """Everything needed to resume one in-flight generation elsewhere.

    Records at the *yield* point — the accepted list is exactly the tokens
    the caller has observed, so a second failure mid-resumed-stream resumes
    from the grown cursor, and ``resume_request`` is always built against
    the original wire request captured at construction.
    """

    def __init__(self, wire_request: dict):
        self.request = wire_request
        token_ids = wire_request.get("token_ids") or []
        self.prompt_hash = hashlib.sha256(
            json.dumps(list(token_ids)).encode()
        ).hexdigest()
        sampling = wire_request.get("sampling") or {}
        self.sampling = {
            k: sampling.get(k) for k in ("use_greedy", "seed", "temperature")
            if sampling.get(k) is not None
        }
        # only LLM wire requests (token_ids present) are resumable: for an
        # arbitrary endpoint payload a replay would duplicate stream items
        # the dedupe cursor cannot see
        self.resumable = isinstance(
            wire_request.get("token_ids"), list
        ) and _is_deterministic(sampling)
        self.accepted: list[int] = []
        self.resumes = 0
        # memory bound: accepted tokens beyond this fold into the base
        # prompt, so a very long stream's journal stays O(cap), not O(osl)
        self.max_items = knobs.get("DYN_RESUME_JOURNAL_MAX_ITEMS") or 0
        self.folded = 0
        self.finished = False

    @property
    def total_recorded(self) -> int:
        """Tokens recorded over the request's whole lifetime — fold-invariant,
        so migration snapshots can be diffed across a fold boundary."""
        return self.folded + len(self.accepted)

    def _fold(self, count: int) -> None:
        """Move the ``count`` oldest accepted tokens into the base prompt.

        A resume built afterwards replays/continues from the grown prompt
        with a correspondingly smaller accepted tail and max_tokens budget —
        semantically identical, just with the cursor's oldest prefix baked
        into ``token_ids``.  The captured request is never mutated in place;
        the journal swaps in a rewritten copy."""
        if count <= 0 or not self.resumable:
            return
        prefix, self.accepted = self.accepted[:count], self.accepted[count:]
        wire = dict(self.request)
        wire["token_ids"] = list(wire.get("token_ids") or []) + prefix
        stop = dict(wire.get("stop") or {})
        max_tokens = stop.get("max_tokens")
        if max_tokens is not None:
            stop["max_tokens"] = max(int(max_tokens) - len(prefix), 1)
            wire["stop"] = stop
        self.request = wire
        self.folded += len(prefix)
        self.prompt_hash = hashlib.sha256(
            json.dumps(list(wire["token_ids"])).encode()
        ).hexdigest()

    def record(self, item: dict) -> None:
        """Note a wire item the caller is about to see (post-dedupe)."""
        if not isinstance(item, dict):
            return
        data = item.get("data")
        if isinstance(data, dict):
            self.accepted.extend(data.get("token_ids") or [])
            if self.max_items > 0 and len(self.accepted) > self.max_items:
                self._fold(len(self.accepted) - self.max_items)

    def finish(self) -> None:
        """The stream delivered its finish item: release the retained tokens
        now instead of waiting for the request object graph to die."""
        self.finished = True
        self.folded = self.total_recorded
        self.accepted = []

    def resume_payload(self) -> dict:
        # penalty counts / stop-sequence progress are a pure function of the
        # accepted ids, so shipping the ids ships that state too
        return {
            "v": 1,
            "prompt_hash": self.prompt_hash,
            "accepted": list(self.accepted),
            "sampling": dict(self.sampling),
        }

    def resume_request(self) -> dict:
        """The original wire request plus the resume cursor.  Unaware
        engines ignore the extra key and replay; aware engines continue."""
        wire = dict(self.request)
        wire["resume_from"] = self.resume_payload()
        return wire


def apply_resume(wire: dict) -> tuple[dict, int]:
    """Engine-side continuation: rewrite a ``resume_from`` request so the
    engine picks up where the dead worker stopped.

    Returns ``(request, accepted_count)``.  ``accepted_count == 0`` means no
    resume was requested (or nothing had been accepted — a plain replay is
    then identical to a fresh run).  When positive, the returned request has
    the accepted tokens appended to ``token_ids`` and ``max_tokens`` reduced
    to the remaining budget, and the engine MUST emit :func:`ack_item` as
    its first stream item so the dispatcher's cursor knows not to dedupe.
    """
    payload = wire.get("resume_from")
    if not isinstance(payload, dict):
        return wire, 0
    out = dict(wire)
    out.pop("resume_from", None)
    accepted = list(payload.get("accepted") or [])
    if not accepted:
        return out, 0
    out["token_ids"] = list(wire.get("token_ids") or []) + accepted
    stop = dict(out.get("stop") or {})
    max_tokens = stop.get("max_tokens")
    if max_tokens is not None:
        stop["max_tokens"] = max(int(max_tokens) - len(accepted), 1)
        out["stop"] = stop
    return out, len(accepted)


def ack_item(accepted_count: int) -> dict:
    """The wire item a continuation-mode engine emits first (an annotation:
    no ``data`` key, so nothing downstream mistakes it for tokens)."""
    return {
        "event": RESUME_ACK_EVENT,
        "comment": [json.dumps({"accepted": accepted_count})],
    }


async def dedupe_stream(
    stream: AsyncIterator[dict], skip: int, *, ack_skip: int = 0
) -> AsyncIterator[dict]:
    """Exactly-once cursor over a resumed stream.

    Replay mode: drop the first ``skip`` generated tokens (count-based — a
    new token that happens to equal an old one must NOT be dropped, so no
    content matching).  Continuation mode: the first item is a
    ``dyn.resume.ack`` annotation — swallow it, then drop ``ack_skip``
    tokens.  A plain resume leaves ``ack_skip`` at 0 (the continuation
    starts exactly at the cursor); a live-migration handoff passes the
    tokens the *source kept decoding* between the journal snapshot shipped
    to the destination and the flip commit — the destination regenerates
    that window, and dropping it is what makes the flip exactly-once.  A
    finish_reason landing inside the dropped prefix is preserved on an
    empty-token item so the stream still terminates cleanly.
    """
    first = True
    remaining = skip
    async for item in stream:
        if first:
            first = False
            if isinstance(item, dict) and item.get("event") == RESUME_ACK_EVENT:
                remaining = ack_skip
                continue
        if remaining > 0 and isinstance(item, dict):
            data = item.get("data")
            if isinstance(data, dict):
                tokens = data.get("token_ids") or []
                if tokens:
                    if len(tokens) <= remaining:
                        remaining -= len(tokens)
                        if data.get("finish_reason"):
                            rewritten: dict[str, Any] = dict(item)
                            rewritten["data"] = {**data, "token_ids": []}
                            yield rewritten
                        continue
                    rewritten = dict(item)
                    rewritten["data"] = {**data, "token_ids": tokens[remaining:]}
                    remaining = 0
                    yield rewritten
                    continue
        yield item
