"""Request template: server-side defaults applied to incoming OpenAI
requests (reference: lib/llm/src/request_template.rs — default model /
temperature / max tokens from a JSON file)."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path


@dataclass
class RequestTemplate:
    model: str | None = None
    temperature: float | None = None
    max_completion_tokens: int | None = None

    @classmethod
    def load(cls, path: str | Path) -> "RequestTemplate":
        d = json.loads(Path(path).read_text())
        return cls(
            model=d.get("model"),
            temperature=d.get("temperature"),
            max_completion_tokens=d.get("max_completion_tokens") or d.get("max_tokens"),
        )

    def apply(self, body: dict) -> dict:
        """Fill missing fields in a raw request body (never overrides)."""
        if self.model and not body.get("model"):
            body["model"] = self.model
        if self.temperature is not None and body.get("temperature") is None:
            body["temperature"] = self.temperature
        if self.max_completion_tokens is not None and not (
            body.get("max_tokens") or body.get("max_completion_tokens")
        ):
            body["max_completion_tokens"] = self.max_completion_tokens
        return body
