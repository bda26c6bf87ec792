"""Shared helpers for holding the port's profiling scripts
(``dynamo_tpu_torch/scripts/profile_decode.py``, ``spec_vs_fused.py``) to
the reference's (``scripts/profile_decode.py``, ``spec_vs_fused.py``) on the
CPU: the reference scripts imported from ``scripts/``, and every stream a
``JaxLlmEngine`` serves recorded as (prompt, output token ids), as the
port's scripts record theirs."""

import contextlib
import sys
from pathlib import Path

from dynamo_tpu.engine.engine import JaxLlmEngine

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def reference_script(name: str):
    """Import ``scripts/<name>.py`` (the reference's tool)."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    return __import__(name)


class _Recorded:
    def __init__(self, stream, out: list):
        self._stream = stream
        self._out = out

    def __aiter__(self):
        return self._gen()

    async def _gen(self):
        async for item in self._stream:
            self._out.extend((item.get("data") or {}).get("token_ids") or [])
            yield item


@contextlib.contextmanager
def recording_jax_streams(monkeypatch, streams: list):
    """Every ``JaxLlmEngine.generate`` inside appends (prompt, output token
    ids) to ``streams``, in call order."""
    original = JaxLlmEngine.generate

    async def generate(self, request):
        out: list[int] = []
        streams.append((list(request.data["token_ids"]), out))
        return _Recorded(await original(self, request), out)

    with monkeypatch.context() as m:
        m.setattr(JaxLlmEngine, "generate", generate)
        yield


def by_prompt(streams: list) -> list:
    """Streams in an order independent of arrival: sorted by prompt."""
    return sorted((tuple(p), tuple(t)) for p, t in streams)
