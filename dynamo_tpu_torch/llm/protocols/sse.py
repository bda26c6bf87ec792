"""Server-Sent Events codec (reference: lib/llm/src/protocols/codec.rs).

Encodes ``Annotated`` items into SSE wire lines and decodes them back —
data lines carry JSON payloads, ``event:``/``comment`` lines carry
annotations, and the stream terminates with ``data: [DONE]``.
"""

from __future__ import annotations

import json
from typing import AsyncIterator

DONE = "[DONE]"


def encode_event(data: str | None = None, event: str | None = None, comments: list[str] | None = None) -> str:
    lines: list[str] = []
    for comment in comments or []:
        lines.append(f": {comment}")
    if event is not None:
        lines.append(f"event: {event}")
    if data is not None:
        lines.append(f"data: {data}")
    return "\n".join(lines) + "\n\n"


def encode_done() -> str:
    return encode_event(data=DONE)


class SseDecoder:
    """Incremental SSE parser: feed bytes, get (event, data, comments) tuples."""

    def __init__(self) -> None:
        self._buffer = ""

    def feed(self, chunk: bytes | str) -> list[dict]:
        if isinstance(chunk, bytes):
            chunk = chunk.decode("utf-8")
        self._buffer += chunk
        events: list[dict] = []
        while "\n\n" in self._buffer:
            raw, _, self._buffer = self._buffer.partition("\n\n")
            event: dict = {"event": None, "data": None, "comments": []}
            data_lines: list[str] = []
            for line in raw.split("\n"):
                if line.startswith(": "):
                    event["comments"].append(line[2:])
                elif line.startswith(":"):
                    event["comments"].append(line[1:])
                elif line.startswith("event:"):
                    event["event"] = line[len("event:"):].strip()
                elif line.startswith("data:"):
                    data_lines.append(line[len("data:"):].strip())
            if data_lines:
                event["data"] = "\n".join(data_lines)
            if event["data"] is not None or event["event"] is not None or event["comments"]:
                events.append(event)
        return events


async def sse_json_stream(byte_stream: AsyncIterator[bytes]) -> AsyncIterator[dict]:
    """Decode an SSE byte stream into parsed-JSON data events (stops at DONE)."""
    decoder = SseDecoder()
    async for chunk in byte_stream:
        for event in decoder.feed(chunk):
            if event["data"] == DONE:
                return
            if event["data"] is not None:
                yield json.loads(event["data"])
