"""Frontend hint source: announce a request the moment it enters the
admission path, before dispatch.

The HTTP frontend sees the request *earliest* — before preprocessing,
queueing and routing — so its hint gives the pager the whole
admission+dispatch window to page the prefix up-tier.  The frontend
itself holds no tokenizer; the ModelWatcher registers one per model as it
builds the pipeline (the same tokenizer the preprocessor uses, so the
hint's hash chain matches the engine's allocator exactly).

Emission is strictly fire-and-forget: tokenize + hash runs on the event
loop (sub-ms for chat-sized prompts), the bus publish is a background
task, and no failure may surface into request handling.
"""

from __future__ import annotations

import asyncio
from typing import Callable

from dynamo_tpu_torch.llm.kv_router.hashing import compute_block_hashes
from dynamo_tpu_torch.prefetch.hints import SOURCE_ARRIVAL, PrefetchHint
from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("prefetch.frontend")


class FrontendHinter:
    """Per-model arrival-hint emitters, registered by the ModelWatcher."""

    def __init__(self) -> None:
        # model name -> (tokenize(request_model) -> list[int] | None,
        #               block_size, async publish(bytes))
        self._models: dict[str, tuple[Callable, int, Callable]] = {}
        self.hints_emitted = 0
        self.hints_skipped = 0

    def register_model(
        self, name: str, tokenize: Callable, block_size: int, publish: Callable
    ) -> None:
        self._models[name] = (tokenize, block_size, publish)

    def remove_model(self, name: str) -> None:
        self._models.pop(name, None)

    def on_request(self, model: str, request_model) -> None:
        """Called by the HTTP handlers right after validation (the request
        has entered admission; dispatch has not started).  Tokenize+hash
        runs synchronously HERE — the hint's entire value is leaving
        before the dispatch path starts (deferring it to a thread loses
        the race against the request's own preprocessing, measured live) —
        and stays bounded because the registered tokenize callbacks cap
        the rendered text at DYN_PREFETCH_HINT_CHARS.  Only the bus
        publish is deferred."""
        entry = self._models.get(model)
        if entry is None:
            return
        tokenize, block_size, publish = entry
        try:
            token_ids = tokenize(request_model)
            hashes = compute_block_hashes(token_ids or [], block_size)
        except Exception:  # noqa: BLE001 — a hint must never fail a request
            logger.debug("prefetch hint tokenization failed", exc_info=True)
            hashes = []
        if not hashes:
            self.hints_skipped += 1
            return
        self.hints_emitted += 1
        hint = PrefetchHint(block_hashes=hashes, source=SOURCE_ARRIVAL)

        async def _publish() -> None:
            try:
                await publish(hint.to_json())
            except Exception:  # noqa: BLE001
                logger.debug("prefetch hint publish failed", exc_info=True)

        spawn_logged(_publish())
