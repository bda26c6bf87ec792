"""The port's model resolution (``dynamo_tpu_torch/llm/hub.py``) against the
reference's: tests/llm/test_hub.py's six cases, each run on both packages
with the same injected downloader (nothing downloads), plus the default
downloader without ``huggingface_hub`` and ``serve_worker`` resolving a
cached ``org--repo`` directory."""

import itertools
import json
import shutil
import sys
from pathlib import Path

import pytest

from dynamo_tpu.llm import hub as jax_hub
from dynamo_tpu_torch.llm import hub as torch_hub

ROOT = Path(__file__).parent.parent
MODEL_DIR = ROOT / "tests" / "data" / "tiny-chat-model"
COMPLETE = {"config.json": json.dumps({"model_type": "llama"}), "tokenizer.json": "{}"}
HUBS = pytest.mark.parametrize("hub", [jax_hub, torch_hub], ids=["jax", "torch"])
_names = itertools.count()


def fake_downloader(files: dict[str, str]):
    calls = []

    def fetch(repo_id: str, dest: Path) -> None:
        calls.append(repo_id)
        for fname, content in files.items():
            (dest / fname).write_text(content)

    fetch.calls = calls
    return fetch


def test_the_port_keeps_the_reference_patterns():
    assert torch_hub.DOWNLOAD_PATTERNS == jax_hub.DOWNLOAD_PATTERNS


@HUBS
def test_local_path_passthrough(hub, tmp_path):
    assert hub.resolve_model(tmp_path) == tmp_path


@HUBS
def test_download_then_cache_hit(hub, tmp_path, monkeypatch):
    monkeypatch.setenv("DYN_CACHE_DIR", str(tmp_path))
    fetch = fake_downloader(COMPLETE)
    p1 = hub.resolve_model("org/model-7b", downloader=fetch)
    assert p1 == tmp_path / "hub" / "org--model-7b"
    assert (p1 / "config.json").exists()
    assert fetch.calls == ["org/model-7b"]
    # second resolution: cache hit, no download
    assert hub.resolve_model("org/model-7b", downloader=fetch) == p1
    assert fetch.calls == ["org/model-7b"]


@HUBS
def test_offline_mode_refuses_download(hub, tmp_path, monkeypatch):
    monkeypatch.setenv("DYN_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("DYN_OFFLINE", "1")
    fetch = fake_downloader(COMPLETE)
    with pytest.raises(FileNotFoundError, match="downloads are disabled"):
        hub.resolve_model("org/model-7b", downloader=fetch)
    assert fetch.calls == []


@HUBS
def test_incomplete_download_rejected(hub, tmp_path, monkeypatch):
    monkeypatch.setenv("DYN_CACHE_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="lacks"):
        hub.resolve_model("org/broken", downloader=fake_downloader({"config.json": "{}"}))


@HUBS
def test_failed_download_surfaces_cause(hub, tmp_path, monkeypatch):
    monkeypatch.setenv("DYN_CACHE_DIR", str(tmp_path))

    def boom(repo_id, dest):
        raise ConnectionError("no egress")

    with pytest.raises(FileNotFoundError, match="no egress"):
        hub.resolve_model("org/model", downloader=boom)


@HUBS
def test_bare_name_rejected(hub):
    with pytest.raises(FileNotFoundError, match="does not exist"):
        hub.resolve_model("not-a-repo-or-path")


@HUBS
def test_unloadable_spm_names_the_cause(hub, tmp_path, monkeypatch):
    """A cached directory with only an SPM tokenizer.model, where the
    conversion packages are missing, fails with that cause and is not
    downloaded again."""
    monkeypatch.setenv("DYN_CACHE_DIR", str(tmp_path))
    tok = __import__(hub.__name__.rsplit(".", 1)[0] + ".tokenizer", fromlist=["x"])
    monkeypatch.setattr(tok, "spm_conversion_available", lambda: False)
    dest = tmp_path / "hub" / "org--spm"
    dest.mkdir(parents=True)
    (dest / "config.json").write_text("{}")
    (dest / "tokenizer.model").write_bytes(b"spm")
    fetch = fake_downloader(COMPLETE)
    with pytest.raises(FileNotFoundError, match="SentencePiece"):
        hub.resolve_model("org/spm", downloader=fetch)
    assert fetch.calls == []


@HUBS
def test_default_downloader_without_huggingface_hub(hub, tmp_path, monkeypatch):
    """Where ``huggingface_hub`` is not installed (the card machine), the
    default downloader's ImportError surfaces as the resolver's
    FileNotFoundError with the cause."""
    monkeypatch.setenv("DYN_CACHE_DIR", str(tmp_path))
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(FileNotFoundError, match="huggingface_hub") as info:
        hub.resolve_model("org/model")
    assert isinstance(info.value.__cause__, ImportError)


async def test_serve_worker_resolves_a_cached_repo(tmp_path, monkeypatch):
    """``serve_worker`` given a repo id serves the cached ``org--repo``
    directory (offline, so a miss could not download), and registers the
    model its card names."""
    from dynamo_tpu_torch.llm.discovery import MODELS_PREFIX
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.serve import serve_worker
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    monkeypatch.setenv("DYN_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("DYN_OFFLINE", "1")
    shutil.copytree(MODEL_DIR, tmp_path / "hub" / "org--tiny-chat")
    rt = await DistributedRuntime.create(
        RuntimeConfig(control_plane=f"memory://hub-{next(_names)}"))
    worker = None
    try:
        worker = await serve_worker(rt, "org/tiny-chat", model_name="tiny",
                                    engine_kind="echo")
        entries = await rt.plane.kv.get_prefix(MODELS_PREFIX)
        cards = [json.loads(e.value)["mdc"] for e in entries]
        assert [c["name"] for c in cards] == ["tiny"]
        with pytest.raises(FileNotFoundError, match="downloads are disabled"):
            await serve_worker(rt, "org/not-cached", engine_kind="echo")
    finally:
        if worker:
            await worker.shutdown()
        await rt.close()
