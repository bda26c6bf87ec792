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
import os
import uuid
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

    # -- artifact distribution (reference: lib/runtime/src/transports/nats.rs:
    # 123-211 — NATS object store carries MDC artifacts so frontends on other
    # machines can build tokenizer pipelines without a shared filesystem) ----

    async def publish_artifacts(self, store) -> int:
        """Upload this model's small artifacts (tokenizer/config/template
        files — never weights) to the object store under this card's
        checksum.  Returns the number of files uploaded."""
        if not self.path:
            return 0
        src = Path(self.path)
        uploaded = 0
        for fname in ARTIFACT_FILES:
            f = src / fname
            if f.exists():
                await store.object_put(ARTIFACT_BUCKET, f"{self.checksum}/{fname}", f.read_bytes())
                uploaded += 1
        return uploaded

    async def fetch_artifacts(self, store, cache_dir: str | Path | None = None) -> Path | None:
        """Download this card's artifacts into a local cache dir and point
        ``self.path`` at it.  Returns the dir, or None if the store holds
        nothing for this checksum (e.g. a worker that never published)."""
        from dynamo_tpu_torch.llm.hub import cache_base

        dest = cache_base(cache_dir) / "mdc" / self.checksum
        fetched = 0
        for fname in ARTIFACT_FILES:
            if (dest / fname).exists():
                fetched += 1
                continue
            data = await store.object_get(ARTIFACT_BUCKET, f"{self.checksum}/{fname}")
            if data is None:
                continue
            dest.mkdir(parents=True, exist_ok=True)
            # per-process-unique temp name: concurrent fetchers sharing a
            # cache dir must never truncate each other's in-flight write
            tmp = dest / f".{fname}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
            tmp.write_bytes(data)
            tmp.rename(dest / fname)  # atomic publish
            fetched += 1
        if fetched == 0:
            return None
        self.path = str(dest)
        return dest


ARTIFACT_BUCKET = "mdc-artifacts"
ARTIFACT_FILES = (
    "tokenizer.json",
    "tokenizer.model",
    "tokenizer_config.json",
    "config.json",
    "special_tokens_map.json",
    "generation_config.json",
)
