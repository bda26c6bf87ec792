"""Backend operator: detokenization + stop-condition enforcement.

Sits between the preprocessor and the engine (reference: lib/llm/src/backend.rs:63-80):
forward passes the PreprocessedRequest through; backward incrementally
detokenizes engine token deltas and runs the hidden stop-sequence "jail" —
text that might be the prefix of a stop sequence is held back until it either
completes (finish, truncate) or diverges (release).
"""

from __future__ import annotations

from typing import AsyncIterator

from dynamo_tpu_torch.llm.protocols.common import (
    Annotated,
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
    StopConditions,
)
from dynamo_tpu_torch.llm.tokenizer import HfTokenizer
from dynamo_tpu_torch.runtime.engine import Context, Operator, ResponseStream


class StopSequenceJail:
    """Holds back text that could become a stop sequence.

    ``push(delta) -> (released_text, matched)``: released text safe to emit;
    ``matched`` True when a stop sequence completed (released text excludes it).
    """

    def __init__(self, stop_sequences: list[str]):
        self.stops = [s for s in stop_sequences if s]
        self._held = ""

    def push(self, delta: str) -> tuple[str, bool]:
        if not self.stops:
            return delta, False
        text = self._held + delta
        # full match anywhere in the accumulated window?
        for stop in self.stops:
            idx = text.find(stop)
            if idx != -1:
                self._held = ""
                return text[:idx], True
        # hold the longest suffix that is a proper prefix of any stop
        max_hold = 0
        for stop in self.stops:
            for k in range(min(len(stop) - 1, len(text)), 0, -1):
                if text.endswith(stop[:k]):
                    max_hold = max(max_hold, k)
                    break
        if max_hold:
            self._held = text[-max_hold:]
            return text[:-max_hold], False
        self._held = ""
        return text, False

    def flush(self) -> str:
        held, self._held = self._held, ""
        return held


class Backend(Operator):
    """Wire-dict operator: PreprocessedRequest dicts in, Annotated
    LLMEngineOutput dicts out (with ``text`` filled in)."""

    def __init__(self, tokenizer: HfTokenizer):
        self.tokenizer = tokenizer

    async def preprocess(self, request: Context[dict]) -> Context[dict]:
        return request

    async def postprocess(
        self, stream: ResponseStream[dict], request: Context[dict]
    ) -> ResponseStream[dict]:
        pre = PreprocessedRequest.from_wire(request.data)
        decode = self.tokenizer.decode_stream()
        jail = StopSequenceJail(pre.stop.stop)
        ctx = request.ctx

        async def gen() -> AsyncIterator[dict]:
            finished = False
            async for item in stream:
                if finished:
                    break
                ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
                if ann.is_annotation() or ann.data is None:
                    yield item
                    continue
                out: LLMEngineOutput = ann.data
                if out.finish_reason is FinishReason.ERROR:
                    # an engine-side failure must not masquerade as a clean
                    # stop: raise so unary handlers return 500 and SSE
                    # streams emit an error event (the diagnostic would
                    # otherwise be dropped entirely)
                    raise RuntimeError(out.error or "engine error")
                text_parts: list[str] = []
                finish = out.finish_reason
                consumed = 0
                for token_id in out.token_ids:
                    if _is_stop_token(token_id, pre):
                        if finish is None:
                            finish = FinishReason.STOP
                        finished = True
                        break
                    consumed += 1
                    piece = decode.step(token_id)
                    if piece is None:
                        continue
                    released, matched = jail.push(piece)
                    if released:
                        text_parts.append(released)
                    if matched:
                        finish = FinishReason.STOP
                        finished = True
                        break
                if finish is not None and not finished:
                    finished = True
                if consumed < len(out.token_ids):
                    # a stop cut the burst short: keep tokens/logprobs in sync
                    out.token_ids = out.token_ids[:consumed]
                    if out.logprobs is not None:
                        out.logprobs = out.logprobs[:consumed]
                    if out.top_logprobs is not None:
                        out.top_logprobs = out.top_logprobs[:consumed]
                out.text = "".join(text_parts)
                out.finish_reason = finish
                yield Annotated.from_data(out).to_wire(LLMEngineOutput.to_wire)
                if finished:
                    # tell the engine to stop producing (graceful upstream stop)
                    ctx.stop_generating()
                    break

        return ResponseStream(gen(), ctx)


def _is_stop_token(token_id: int, pre: PreprocessedRequest) -> bool:
    if pre.stop.ignore_eos:
        return token_id in pre.stop.stop_token_ids
    return token_id in pre.eos_token_ids or token_id in pre.stop.stop_token_ids
