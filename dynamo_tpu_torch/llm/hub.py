"""The on-disk cache root (counterpart of dynamo_tpu/llm/hub.py's
``cache_base``).  The port resolves local model directories only: nothing
here downloads."""

from __future__ import annotations

from pathlib import Path

from dynamo_tpu_torch.utils import knobs


def cache_base(cache_dir: str | Path | None = None) -> Path:
    """Shared on-disk cache root (MDC artifacts)."""
    return Path(
        cache_dir
        or knobs.get("DYN_CACHE_DIR")
        or Path.home() / ".cache" / "dynamo_tpu_torch"
    )
