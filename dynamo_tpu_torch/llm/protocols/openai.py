"""OpenAI-compatible API types (pydantic).

Request/response surface of the HTTP frontend (reference:
lib/llm/src/protocols/openai.rs and openai/{chat_completions,completions,
embeddings}).  The ``ext`` field mirrors the reference's ``nvext`` extension
block (annotations, ignore_eos, greedy sampling).
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Literal, Union

from pydantic import BaseModel, ConfigDict, Field, field_validator

from dynamo_tpu_torch.llm.protocols.common import (
    FinishReason,
    SamplingOptions,
    StopConditions,
)


class Ext(BaseModel):
    """Extension block (reference: nvext)."""

    model_config = ConfigDict(extra="allow")
    annotations: list[str] = Field(default_factory=list)
    ignore_eos: bool | None = None
    greed_sampling: bool | None = None
    use_raw_prompt: bool | None = None


class ContentPart(BaseModel):
    model_config = ConfigDict(extra="allow")
    type: str
    text: str | None = None
    image_url: dict[str, Any] | None = None


class FunctionDef(BaseModel):
    """A callable tool's schema (OpenAI function-calling surface)."""

    model_config = ConfigDict(extra="allow")
    name: str
    description: str | None = None
    parameters: dict[str, Any] | None = None
    strict: bool | None = None


class ToolDef(BaseModel):
    model_config = ConfigDict(extra="allow")
    type: Literal["function"]
    function: FunctionDef


class NamedToolChoice(BaseModel):
    """``tool_choice={"type": "function", "function": {"name": ...}}``."""

    model_config = ConfigDict(extra="allow")
    type: Literal["function"]
    function: FunctionDef


# "none" | "auto" | "required" | a specific named function — typed instead
# of Any so a malformed tool_choice is a structured 400 at the protocol
# boundary, not a downstream surprise (reference validates in
# lib/llm/src/protocols/openai/chat_completions.rs via typed serde enums)
ToolChoice = Union[Literal["none", "auto", "required"], NamedToolChoice]


class _SamplingValidators(BaseModel):
    """Shared range checks for the sampling fields both request surfaces
    carry.  Ranges follow the OpenAI API contract (the reference enforces
    the same bounds in its typed request structs,
    lib/llm/src/protocols/common.rs); violations become structured 400s
    with the offending ``param`` named (llm/http/service.py)."""

    temperature: float | None = Field(None, ge=0.0, le=2.0)
    top_p: float | None = Field(None, ge=0.0, le=1.0)
    # extension accepted by most servers; -1 = disabled (vLLM convention)
    top_k: int | None = None
    presence_penalty: float | None = Field(None, ge=-2.0, le=2.0)
    frequency_penalty: float | None = Field(None, ge=-2.0, le=2.0)
    n: int | None = Field(1, ge=1, le=16)
    logit_bias: dict[str, float] | None = None
    stop: Union[str, list[str], None] = None

    @field_validator("top_k")
    @classmethod
    def _top_k_range(cls, v):
        if v is not None and v != -1 and v < 1:
            raise ValueError("top_k must be -1 (disabled) or >= 1")
        return v

    @field_validator("logit_bias")
    @classmethod
    def _logit_bias_range(cls, v):
        if v is None:
            return v
        for key, bias in v.items():
            try:
                int(key)
            except ValueError:
                raise ValueError(
                    f"logit_bias keys must be token ids, got {key!r}"
                ) from None
            if not -100.0 <= bias <= 100.0:
                raise ValueError(
                    f"logit_bias values must be in [-100, 100], got {bias}"
                )
        return v

    @field_validator("stop")
    @classmethod
    def _stop_shape(cls, v):
        if isinstance(v, list):
            if len(v) > 4:
                raise ValueError("stop accepts at most 4 sequences")
            if any(not s for s in v):
                raise ValueError("stop sequences must be non-empty")
        elif v == "":
            raise ValueError("stop sequences must be non-empty")
        return v


class ChatMessage(BaseModel):
    model_config = ConfigDict(extra="allow")
    role: Literal["system", "user", "assistant", "tool", "developer"]
    content: Union[str, list[ContentPart], None] = None
    name: str | None = None
    tool_calls: list[dict[str, Any]] | None = None
    tool_call_id: str | None = None

    def text(self) -> str:
        if isinstance(self.content, str):
            return self.content
        if self.content is None:
            return ""
        return "".join(p.text or "" for p in self.content if p.type == "text")


class ChatCompletionRequest(_SamplingValidators):
    model_config = ConfigDict(extra="allow")
    model: str
    messages: list[ChatMessage] = Field(min_length=1)
    stream: bool = False
    stream_options: dict[str, Any] | None = None
    max_tokens: int | None = Field(None, ge=1)
    max_completion_tokens: int | None = Field(None, ge=1)
    seed: int | None = None
    logprobs: bool | None = None
    top_logprobs: int | None = Field(None, ge=0, le=20)
    user: str | None = None
    tools: list[ToolDef] | None = None
    tool_choice: ToolChoice | None = None
    response_format: dict[str, Any] | None = None
    ext: Ext | None = None

    def stop_list(self) -> list[str]:
        if self.stop is None:
            return []
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)

    def sampling_options(self) -> SamplingOptions:
        return SamplingOptions(
            temperature=self.temperature,
            top_p=self.top_p,
            top_k=self.top_k,
            frequency_penalty=self.frequency_penalty,
            presence_penalty=self.presence_penalty,
            seed=self.seed,
            n=self.n or 1,
            use_greedy=bool(self.ext and self.ext.greed_sampling),
            top_logprobs=(self.top_logprobs or 0) if self.logprobs else 0,
            logit_bias=(
                {int(k): float(v) for k, v in self.logit_bias.items()}
                if self.logit_bias else None
            ),
        )

    def stop_conditions(self) -> StopConditions:
        return StopConditions(
            max_tokens=self.max_completion_tokens or self.max_tokens,
            stop=self.stop_list(),
            ignore_eos=bool(self.ext and self.ext.ignore_eos),
        )


class CompletionRequest(_SamplingValidators):
    model_config = ConfigDict(extra="allow")
    model: str
    prompt: Union[str, list[str], list[int], list[list[int]]]
    suffix: str | None = None
    max_tokens: int | None = Field(16, ge=1)
    stream: bool = False
    stream_options: dict[str, Any] | None = None
    logprobs: int | None = Field(None, ge=0, le=5)
    echo: bool | None = None
    seed: int | None = None
    user: str | None = None
    ext: Ext | None = None

    def stop_list(self) -> list[str]:
        if self.stop is None:
            return []
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)

    def sampling_options(self) -> SamplingOptions:
        return SamplingOptions(
            temperature=self.temperature,
            top_p=self.top_p,
            top_k=self.top_k,
            frequency_penalty=self.frequency_penalty,
            presence_penalty=self.presence_penalty,
            seed=self.seed,
            n=self.n or 1,
            use_greedy=bool(self.ext and self.ext.greed_sampling),
            top_logprobs=self.logprobs or 0,
            logit_bias=(
                {int(k): float(v) for k, v in self.logit_bias.items()}
                if self.logit_bias else None
            ),
        )

    def stop_conditions(self) -> StopConditions:
        return StopConditions(
            max_tokens=self.max_tokens,
            stop=self.stop_list(),
            ignore_eos=bool(self.ext and self.ext.ignore_eos),
        )


class EmbeddingRequest(BaseModel):
    model_config = ConfigDict(extra="allow")
    model: str
    input: Union[str, list[str], list[int], list[list[int]]]
    encoding_format: Literal["float", "base64"] = "float"
    user: str | None = None


# ---------------------------------------------------------------------------
# Responses
# ---------------------------------------------------------------------------


class Usage(BaseModel):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0


class ChatDelta(BaseModel):
    role: str | None = None
    content: str | None = None
    tool_calls: list[dict[str, Any]] | None = None


class ChatChunkChoice(BaseModel):
    index: int = 0
    delta: ChatDelta
    finish_reason: str | None = None
    logprobs: Any | None = None


class ChatCompletionChunk(BaseModel):
    id: str
    object: Literal["chat.completion.chunk"] = "chat.completion.chunk"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: list[ChatChunkChoice] = Field(default_factory=list)
    usage: Usage | None = None


class ChatChoice(BaseModel):
    index: int = 0
    message: ChatMessage
    finish_reason: str | None = None
    logprobs: Any | None = None


class ChatCompletionResponse(BaseModel):
    id: str
    object: Literal["chat.completion"] = "chat.completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: list[ChatChoice] = Field(default_factory=list)
    usage: Usage | None = None


class CompletionChoice(BaseModel):
    index: int = 0
    text: str = ""
    finish_reason: str | None = None
    logprobs: Any | None = None


class CompletionResponse(BaseModel):
    id: str
    object: Literal["text_completion"] = "text_completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: list[CompletionChoice] = Field(default_factory=list)
    usage: Usage | None = None


class EmbeddingData(BaseModel):
    object: Literal["embedding"] = "embedding"
    index: int
    # list of floats, or a base64-packed float32 buffer (encoding_format=base64)
    embedding: list[float] | str


class EmbeddingResponse(BaseModel):
    object: Literal["list"] = "list"
    data: list[EmbeddingData] = Field(default_factory=list)
    model: str = ""
    usage: Usage | None = None


class ModelInfo(BaseModel):
    id: str
    object: Literal["model"] = "model"
    created: int = Field(default_factory=lambda: int(time.time()))
    owned_by: str = "dynamo-tpu"


class ModelList(BaseModel):
    object: Literal["list"] = "list"
    data: list[ModelInfo] = Field(default_factory=list)


def new_request_id(prefix: str = "chatcmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def finish_reason_to_openai(reason: FinishReason | None) -> str | None:
    if reason is None:
        return None
    return {
        FinishReason.STOP: "stop",
        FinishReason.LENGTH: "length",
        FinishReason.CANCELLED: "stop",
        FinishReason.ERROR: "stop",
        FinishReason.CONTENT_FILTER: "content_filter",
    }[reason]
