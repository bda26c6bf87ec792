"""Model Deployment Card (MDC).

Identity + artifacts of a served model (reference:
lib/llm/src/model_card/model.rs:86): where the tokenizer/config/weights live,
context length, KV block size, eos ids, and the chat template.  Published to
the control-plane KV store (with TTL refresh via the serving instance's
lease) and large artifacts via the object store.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class ModelDeploymentCard:
    name: str
    path: str | None = None                  # local dir with tokenizer/config
    context_length: int = 4096
    kv_block_size: int = 16
    eos_token_ids: list[int] = field(default_factory=list)
    chat_template: str | None = None
    model_type: str = "llama"
    checksum: str = ""

    def finalize(self) -> "ModelDeploymentCard":
        if not self.checksum:
            payload = json.dumps(
                [self.name, self.path, self.context_length, self.kv_block_size],
                sort_keys=True,
            ).encode()
            self.checksum = hashlib.sha256(payload).hexdigest()[:16]
        return self

    @classmethod
    def from_local_path(cls, path: str | Path, name: str | None = None) -> "ModelDeploymentCard":
        """Build an MDC from a local model directory (tokenizer.json +
        tokenizer_config.json + config.json)."""
        path = Path(path)
        name = name or path.name
        context_length = 4096
        chat_template = None
        eos_ids: list[int] = []
        model_type = "llama"

        config_path = path / "tokenizer_config.json"
        if config_path.exists():
            config = json.loads(config_path.read_text())
            chat_template = config.get("chat_template")
            context_length = config.get("model_max_length") or context_length

        model_config_path = path / "config.json"
        if model_config_path.exists():
            config = json.loads(model_config_path.read_text())
            model_type = config.get("model_type", model_type)
            context_length = min(
                context_length, config.get("max_position_embeddings", context_length)
            )
            eos = config.get("eos_token_id")
            if isinstance(eos, int):
                eos_ids.append(eos)
            elif isinstance(eos, list):
                eos_ids.extend(eos)

        return cls(
            name=name,
            path=str(path),
            context_length=context_length,
            eos_token_ids=eos_ids,
            chat_template=chat_template,
            model_type=model_type,
        ).finalize()

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "name": self.name,
                "path": self.path,
                "context_length": self.context_length,
                "kv_block_size": self.kv_block_size,
                "eos_token_ids": self.eos_token_ids,
                "chat_template": self.chat_template,
                "model_type": self.model_type,
                "checksum": self.checksum,
            }
        ).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "ModelDeploymentCard":
        d = json.loads(data)
        return cls(**d)
