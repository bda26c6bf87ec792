"""Delta aggregation: fold a streamed response into a unary response for
non-streaming clients (reference:
lib/llm/src/protocols/openai/chat_completions/aggregator.rs,
completions/aggregator.rs).
"""

from __future__ import annotations

from typing import AsyncIterator

from dynamo_tpu_torch.llm.protocols.openai import (
    ChatChoice,
    ChatCompletionChunk,
    ChatCompletionResponse,
    ChatMessage,
    CompletionChoice,
    CompletionResponse,
    Usage,
)


async def aggregate_chat_stream(
    chunks: AsyncIterator[ChatCompletionChunk],
) -> ChatCompletionResponse:
    response_id = ""
    model = ""
    created = 0
    usage: Usage | None = None
    # per-choice accumulation
    contents: dict[int, list[str]] = {}
    roles: dict[int, str] = {}
    finish: dict[int, str | None] = {}
    tool_calls: dict[int, list[dict]] = {}
    logprob_content: dict[int, list[dict]] = {}

    async for chunk in chunks:
        response_id = chunk.id or response_id
        model = chunk.model or model
        created = chunk.created or created
        if chunk.usage is not None:
            usage = chunk.usage
        for choice in chunk.choices:
            idx = choice.index
            contents.setdefault(idx, [])
            if choice.delta.role:
                roles[idx] = choice.delta.role
            if choice.delta.content:
                contents[idx].append(choice.delta.content)
            if choice.delta.tool_calls:
                tool_calls.setdefault(idx, []).extend(choice.delta.tool_calls)
            if choice.finish_reason is not None:
                finish[idx] = choice.finish_reason
            if choice.logprobs and choice.logprobs.get("content"):
                logprob_content.setdefault(idx, []).extend(choice.logprobs["content"])

    choices = [
        ChatChoice(
            index=idx,
            message=ChatMessage(
                role=roles.get(idx, "assistant"),  # type: ignore[arg-type]
                content="".join(parts),
                tool_calls=tool_calls.get(idx) or None,
            ),
            finish_reason=finish.get(idx),
            logprobs=(
                {"content": logprob_content[idx]} if idx in logprob_content else None
            ),
        )
        for idx, parts in sorted(contents.items())
    ]
    return ChatCompletionResponse(
        id=response_id, model=model, created=created, choices=choices, usage=usage
    )


async def aggregate_completion_stream(
    chunks: AsyncIterator[CompletionResponse],
) -> CompletionResponse:
    response_id = ""
    model = ""
    created = 0
    usage: Usage | None = None
    texts: dict[int, list[str]] = {}
    finish: dict[int, str | None] = {}
    lp_tokens: dict[int, list[str]] = {}
    lp_values: dict[int, list[float]] = {}
    lp_offsets: dict[int, list[int]] = {}
    lp_top: dict[int, list] = {}

    async for chunk in chunks:
        response_id = chunk.id or response_id
        model = chunk.model or model
        created = chunk.created or created
        if chunk.usage is not None:
            usage = chunk.usage
        for choice in chunk.choices:
            texts.setdefault(choice.index, [])
            if choice.text:
                texts[choice.index].append(choice.text)
            if choice.finish_reason is not None:
                finish[choice.index] = choice.finish_reason
            if choice.logprobs:
                lp_tokens.setdefault(choice.index, []).extend(
                    choice.logprobs.get("tokens", [])
                )
                lp_values.setdefault(choice.index, []).extend(
                    choice.logprobs.get("token_logprobs", [])
                )
                lp_offsets.setdefault(choice.index, []).extend(
                    choice.logprobs.get("text_offset") or []
                )
                # keep top rows PARALLEL to tokens: a chunk without
                # alternatives contributes empty rows, never a shift
                n_toks = len(choice.logprobs.get("tokens", []))
                rows = choice.logprobs.get("top_logprobs") or []
                rows = list(rows[:n_toks]) + [{}] * max(0, n_toks - len(rows))
                lp_top.setdefault(choice.index, []).extend(rows)

    choices = [
        CompletionChoice(
            index=idx, text="".join(parts), finish_reason=finish.get(idx),
            logprobs=(
                {
                    "tokens": lp_tokens[idx],
                    "token_logprobs": lp_values[idx],
                    "top_logprobs": (
                        lp_top[idx]
                        if idx in lp_top and any(lp_top[idx])
                        else None
                    ),
                    "text_offset": lp_offsets.get(idx, []),
                }
                if idx in lp_tokens
                else None
            ),
        )
        for idx, parts in sorted(texts.items())
    ]
    return CompletionResponse(
        id=response_id, model=model, created=created, choices=choices, usage=usage
    )
