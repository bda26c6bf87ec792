"""Model resolution: local path | cache | HuggingFace Hub download
(counterpart of dynamo_tpu/llm/hub.py).

The reference resolves model names through the HF hub with a local content
cache (lib/llm/src/hub.rs:32 ``from_hf`` — volume-mounted cache keyed by
repo, skip-if-present download of config/tokenizer/weights).  Same contract
here:

- an existing local directory (or GGUF file) is used as-is;
- otherwise ``{cache}/hub/{org}--{repo}`` is checked;
- otherwise the repo is downloaded into the cache via ``huggingface_hub``
  (offline/air-gapped environments get a clear error instead of a hang —
  pass ``allow_download=False`` or set ``DYN_OFFLINE=1`` to skip the
  network entirely).

The default downloader imports ``huggingface_hub`` inside the call: where
the package is missing, the download fails like any other, as a
``FileNotFoundError`` naming the cause.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

from dynamo_tpu_torch.utils import knobs
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("llm.hub")

# files a serving worker needs: model card + tokenizer + weights
DOWNLOAD_PATTERNS = [
    "config.json",
    "generation_config.json",
    "tokenizer.json",
    "tokenizer.model",  # SPM-only repos ship this instead of tokenizer.json
    "tokenizer_config.json",
    "special_tokens_map.json",
    "*.safetensors",
    "*.safetensors.index.json",
]


def cache_base(cache_dir: str | Path | None = None) -> Path:
    """Shared on-disk cache root (hub snapshots, MDC artifacts)."""
    return Path(
        cache_dir
        or knobs.get("DYN_CACHE_DIR")
        or Path.home() / ".cache" / "dynamo_tpu_torch"
    )


def _hf_download(repo_id: str, dest: Path) -> None:
    """Default downloader: huggingface_hub snapshot into ``dest``."""
    from huggingface_hub import snapshot_download

    snapshot_download(
        repo_id=repo_id,
        local_dir=str(dest),
        allow_patterns=DOWNLOAD_PATTERNS,
    )


def classify_model_dir(path: Path) -> str:
    """One classification for resolution decisions:
    - "complete": config + a loadable tokenizer;
    - "unloadable_spm": only an SPM tokenizer.model and the conversion
      deps (sentencepiece/transformers) are missing — actionable error;
    - "incomplete": anything else (download / keep looking)."""
    from dynamo_tpu_torch.llm.tokenizer import spm_conversion_available

    if not (path / "config.json").exists():
        return "incomplete"
    if (path / "tokenizer.json").exists():
        return "complete"
    if (path / "tokenizer.model").exists():
        return "complete" if spm_conversion_available() else "unloadable_spm"
    return "incomplete"


def is_complete(path: Path) -> bool:
    return classify_model_dir(path) == "complete"


def resolve_model(
    name_or_path: str | Path,
    *,
    cache_dir: str | Path | None = None,
    downloader: Callable[[str, Path], None] | None = None,
    allow_download: bool = True,
) -> Path:
    """Resolve a model reference to a local directory (or GGUF file).

    ``downloader(repo_id, dest)`` is injectable for tests and air-gapped
    mirrors; the default uses ``huggingface_hub``.
    """
    p = Path(name_or_path)
    if p.exists():
        return p

    name = str(name_or_path)
    if name.startswith((".", "/")) or "/" not in name:
        raise FileNotFoundError(f"model path {name!r} does not exist")

    dest = cache_base(cache_dir) / "hub" / name.replace("/", "--")
    if is_complete(dest):
        logger.info("model %s served from cache %s", name, dest)
        return dest
    _reject_unloadable_spm(name, dest)

    if not allow_download or knobs.get("DYN_OFFLINE"):
        raise FileNotFoundError(
            f"model {name!r} is not cached at {dest} and downloads are "
            "disabled (DYN_OFFLINE=1 / allow_download=False)"
        )

    dest.mkdir(parents=True, exist_ok=True)
    fetch = downloader or _hf_download
    try:
        logger.info("downloading %s into %s", name, dest)
        fetch(name, dest)
    except Exception as exc:  # noqa: BLE001 — surface a usable error
        raise FileNotFoundError(
            f"model {name!r}: hub download failed ({exc}); provide a local "
            "path, pre-populate the cache, or fix network access"
        ) from exc
    _reject_unloadable_spm(name, dest)
    if not is_complete(dest):
        raise FileNotFoundError(
            f"model {name!r}: download completed but {dest} lacks "
            "config.json or a tokenizer (tokenizer.json/tokenizer.model)"
        )
    return dest


def _reject_unloadable_spm(name: str, dest: Path) -> None:
    """A cached dir whose only tokenizer is an SPM tokenizer.model in an
    environment without the conversion deps must fail with the actionable
    cause — not re-download on every resolve, not claim the tokenizer is
    missing."""
    if classify_model_dir(dest) == "unloadable_spm":
        raise FileNotFoundError(
            f"model {name!r} at {dest} ships only a SentencePiece "
            "tokenizer.model and the 'sentencepiece'/'transformers' packages "
            "needed to convert it are not installed; install them or provide "
            "a tokenizer.json"
        )
