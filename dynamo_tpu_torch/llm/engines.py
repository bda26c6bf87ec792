"""Built-in trivial engines (reference: lib/llm/src/engines.rs:83-161).

- ``EchoEngineCore`` — token-level echo: streams the prompt's token ids back
  one per step.  Sits behind the full preprocessor/backend pipeline, so it
  exercises tokenization, detokenization, stop handling, SSE — everything but
  a real model.
- ``EchoEngineFull`` — text-level echo implementing the OpenAI-typed engine
  directly (no pre/post processing).
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator

from dynamo_tpu_torch.llm.protocols.common import (
    Annotated,
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.runtime.engine import Context, ResponseStream

# matches the reference's simulated token cadence (engines.rs: token delay)
DEFAULT_TOKEN_DELAY_S = 0.0


class EchoEngineCore:
    """PreprocessedRequest wire dicts in → Annotated[LLMEngineOutput] wire out."""

    def __init__(self, token_delay_s: float = DEFAULT_TOKEN_DELAY_S):
        self.token_delay_s = token_delay_s

    async def generate(self, request: Context[dict]) -> ResponseStream[dict]:
        if request.data.get("image") is not None or request.data.get("video") is not None:
            # same contract as JaxLlmEngine.generate: a modality payload
            # reaching a text-only engine is a deployment without an
            # encoder, not a payload to silently drop
            raise ValueError(
                "this model deployment does not accept image/video input"
            )
        if request.data.get("output_format"):
            # echoed prompt tokens are not constrained output — reject like
            # an engine without a mask table would
            raise ValueError(
                "this model deployment does not support guided decoding"
            )
        pre = PreprocessedRequest.from_wire(request.data)
        ctx = request.ctx

        async def gen() -> AsyncIterator[dict]:
            budget = pre.stop.max_tokens or len(pre.token_ids)
            emitted = 0
            for token_id in pre.token_ids:
                if ctx.is_stopped or emitted >= budget:
                    break
                if self.token_delay_s:
                    await asyncio.sleep(self.token_delay_s)
                emitted += 1
                finish = FinishReason.LENGTH if emitted >= budget else None
                yield Annotated.from_data(
                    LLMEngineOutput(token_ids=[token_id], finish_reason=finish)
                ).to_wire(LLMEngineOutput.to_wire)
            else:
                if emitted < budget:
                    yield Annotated.from_data(
                        LLMEngineOutput(token_ids=[], finish_reason=FinishReason.STOP)
                    ).to_wire(LLMEngineOutput.to_wire)

        return ResponseStream(gen(), ctx)
