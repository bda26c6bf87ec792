"""Preprocessor: OpenAI request → PreprocessedRequest, and engine deltas →
OpenAI stream chunks.

The bidirectional frontend operator (reference: lib/llm/src/preprocessor.rs:98):
forward renders the chat template (jinja2 sandbox, as minijinja serves the
reference) and tokenizes; backward turns ``Annotated[LLMEngineOutput]`` wire
items into OpenAI SSE chunk objects.  Supported annotations (requested via
``ext.annotations``): ``formatted_prompt``, ``token_ids`` (reference:
preprocessor.rs:61-63).
"""

from __future__ import annotations

from typing import AsyncIterator

from jinja2.sandbox import ImmutableSandboxedEnvironment

from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols.common import (
    Annotated,
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.llm.protocols.openai import (
    ChatChunkChoice,
    ChatCompletionChunk,
    ChatCompletionRequest,
    ChatDelta,
    CompletionChoice,
    CompletionRequest,
    CompletionResponse,
    Usage,
    finish_reason_to_openai,
    new_request_id,
)
from dynamo_tpu_torch.llm.tokenizer import HfTokenizer
from dynamo_tpu_torch.runtime.engine import Context, Operator, ResponseStream

ANNOTATION_FORMATTED_PROMPT = "formatted_prompt"
ANNOTATION_TOKEN_IDS = "token_ids"
ANNOTATION_LLM_METRICS = "llm_metrics"

_DEFAULT_TEMPLATE = (
    "{% for message in messages %}{{ message.role }}: {{ message.content }}\n"
    "{% endfor %}assistant:"
)


class PromptFormatter:
    """Jinja chat-template renderer (reference:
    lib/llm/src/preprocessor/prompt/template/)."""

    def __init__(self, template: str | None):
        env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True)
        env.globals["raise_exception"] = _raise_exception
        self._template = env.from_string(template or _DEFAULT_TEMPLATE)

    def render(self, request: ChatCompletionRequest) -> str:
        messages = [
            {"role": m.role, "content": m.text(), "name": m.name} for m in request.messages
        ]
        return self._template.render(
            messages=messages,
            add_generation_prompt=True,
            # HF chat templates index tools as dicts ({{ tool['function'] }});
            # the typed ToolDef models dump back to the wire shape
            tools=(
                [t.model_dump(exclude_none=True) for t in request.tools]
                if request.tools else None
            ),
        )


def render_logprob_entries(
    tokenizer: HfTokenizer,
    token_ids: list[int],
    logprobs: list[float],
    top_logprobs: list[list[list]] | None = None,
) -> list[dict]:
    """OpenAI chat ``logprobs.content`` entries for one emitted burst.
    ``top_logprobs`` rows are [[token_id, logprob], ...] alternatives when
    the engine supplied them.  Callers must skip rendering when the engine
    supplied no logprobs — fabricating values would report false
    certainty."""
    entries = []
    for pos, (tid, lp) in enumerate(zip(token_ids, logprobs)):
        text = tokenizer.decode([tid], skip_special_tokens=False)
        alts = []
        if top_logprobs is not None and pos < len(top_logprobs):
            for alt_id, alt_lp in top_logprobs[pos]:
                alt_text = tokenizer.decode([int(alt_id)], skip_special_tokens=False)
                alts.append(
                    {
                        "token": alt_text,
                        "logprob": float(alt_lp),
                        "bytes": list(alt_text.encode("utf-8")),
                    }
                )
        entries.append(
            {
                "token": text,
                "logprob": lp,
                "bytes": list(text.encode("utf-8")),
                "top_logprobs": alts,
            }
        )
    return entries


def _raise_exception(message: str):
    raise ValueError(message)


class _PreprocessorCore:
    def __init__(self, mdc: ModelDeploymentCard, tokenizer: HfTokenizer):
        self.mdc = mdc
        self.tokenizer = tokenizer
        self.formatter = PromptFormatter(mdc.chat_template)

    def eos_ids(self) -> list[int]:
        return self.mdc.eos_token_ids or self.tokenizer.eos_token_ids

    def build_preprocessed(
        self, token_ids: list[int], request, annotations: list[str]
    ) -> PreprocessedRequest:
        stop = request.stop_conditions()
        if stop.max_tokens is None:
            stop.max_tokens = max(self.mdc.context_length - len(token_ids), 1)
        if len(token_ids) >= self.mdc.context_length:
            raise ValueError(
                f"prompt length {len(token_ids)} exceeds context length "
                f"{self.mdc.context_length}"
            )
        return PreprocessedRequest(
            token_ids=token_ids,
            sampling=request.sampling_options(),
            stop=stop,
            eos_token_ids=self.eos_ids(),
            model=request.model,
            annotations=annotations,
            mdc_sum=self.mdc.checksum,
        )


class ChatPreprocessor(Operator):
    """ChatCompletionRequest ⇄ PreprocessedRequest/ChatCompletionChunk."""

    def __init__(self, mdc: ModelDeploymentCard, tokenizer: HfTokenizer):
        self.core = _PreprocessorCore(mdc, tokenizer)

    async def preprocess(self, request: Context[ChatCompletionRequest]) -> Context[dict]:
        from dynamo_tpu_torch.llm.multimodal import (
            encode_image_wire,
            extract_image_url,
            resolve_image,
        )

        req = request.data
        prompt = self.core.formatter.render(req)
        token_ids = self.core.tokenizer.encode(prompt)
        annotations = list(req.ext.annotations) if req.ext else []
        pre = self.core.build_preprocessed(token_ids, req, annotations)
        ctx_data = pre.to_wire()
        # image_url content parts: fetch/decode here (host I/O belongs at
        # the frontend), ship the normalized array to the engine, which
        # encodes + splices patch embeddings (dynamo_tpu_torch/examples/
        # multimodal/pipeline.py MultimodalEngine; reference
        # processor.py:107-217)
        image_url = extract_image_url(req)
        if image_url is not None:
            image = await resolve_image(image_url)
            ctx_data["image"] = encode_image_wire(image)
        # guided decoding: json_object constrains sampling to valid-JSON
        # prefixes; the engine rejects when its mask table is not enabled
        # (llm/guided.py; engine/engine.py enable_guided_json)
        if (req.response_format or {}).get("type") == "json_object":
            ctx_data["output_format"] = "json"
        # stash state for postprocess on the context object
        request.ctx._pre_state = {  # type: ignore[attr-defined]
            "prompt": prompt,
            "prompt_tokens": len(token_ids),
            "annotations": annotations,
            "model": req.model,
            "response_id": new_request_id("chatcmpl"),
        }
        return request.transfer(ctx_data)

    async def postprocess(
        self, stream: ResponseStream[dict], request: Context[ChatCompletionRequest]
    ) -> ResponseStream[Annotated[ChatCompletionChunk]]:
        state = request.ctx._pre_state  # type: ignore[attr-defined]
        include_usage = bool(
            request.data.stream_options and request.data.stream_options.get("include_usage")
        )

        want_logprobs = bool(request.data.logprobs)
        tokenizer = self.core.tokenizer

        async def gen() -> AsyncIterator[Annotated[ChatCompletionChunk]]:
            first = True
            completion_tokens = 0
            for name in state["annotations"]:
                if name == ANNOTATION_FORMATTED_PROMPT:
                    yield Annotated.from_annotation(ANNOTATION_FORMATTED_PROMPT, state["prompt"])
                if name == ANNOTATION_TOKEN_IDS:
                    yield Annotated.from_annotation(ANNOTATION_TOKEN_IDS, state["prompt_tokens"])
            async for item in stream:
                ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
                if ann.is_annotation() or ann.data is None:
                    continue
                out: LLMEngineOutput = ann.data
                completion_tokens += len(out.token_ids)
                delta = ChatDelta(
                    role="assistant" if first else None,
                    content=out.text if out.text else ("" if first else None),
                )
                first = False
                lp_content = None
                if want_logprobs and out.token_ids and out.logprobs is not None:
                    lp_content = {
                        "content": render_logprob_entries(
                            tokenizer, out.token_ids, out.logprobs,
                            out.top_logprobs,
                        )
                    }
                yield Annotated.from_data(
                    ChatCompletionChunk(
                        id=state["response_id"],
                        model=state["model"],
                        choices=[
                            ChatChunkChoice(
                                index=0,
                                delta=delta,
                                finish_reason=finish_reason_to_openai(out.finish_reason),
                                logprobs=lp_content,
                            )
                        ],
                    )
                )
            if include_usage:
                yield Annotated.from_data(
                    ChatCompletionChunk(
                        id=state["response_id"],
                        model=state["model"],
                        choices=[],
                        usage=Usage(
                            prompt_tokens=state["prompt_tokens"],
                            completion_tokens=completion_tokens,
                            total_tokens=state["prompt_tokens"] + completion_tokens,
                        ),
                    )
                )

        return ResponseStream(gen(), request.ctx)


class CompletionPreprocessor(Operator):
    """CompletionRequest ⇄ PreprocessedRequest/CompletionResponse chunks."""

    def __init__(self, mdc: ModelDeploymentCard, tokenizer: HfTokenizer):
        self.core = _PreprocessorCore(mdc, tokenizer)

    async def preprocess(self, request: Context[CompletionRequest]) -> Context[dict]:
        req = request.data
        if isinstance(req.prompt, str):
            token_ids = self.core.tokenizer.encode(req.prompt)
        elif req.prompt and isinstance(req.prompt[0], int):
            token_ids = list(req.prompt)  # pre-tokenized
        else:
            raise ValueError("batch prompts must be dispatched one per request")
        annotations = list(req.ext.annotations) if req.ext else []
        pre = self.core.build_preprocessed(token_ids, req, annotations)
        request.ctx._pre_state = {  # type: ignore[attr-defined]
            "prompt_tokens": len(token_ids),
            "model": req.model,
            "response_id": new_request_id("cmpl"),
        }
        return request.transfer(pre.to_wire())

    async def postprocess(
        self, stream: ResponseStream[dict], request: Context[CompletionRequest]
    ) -> ResponseStream[Annotated[CompletionResponse]]:
        state = request.ctx._pre_state  # type: ignore[attr-defined]
        include_usage = bool(
            request.data.stream_options and request.data.stream_options.get("include_usage")
        )

        want_logprobs = request.data.logprobs is not None and request.data.logprobs > 0
        tokenizer = self.core.tokenizer

        async def gen() -> AsyncIterator[Annotated[CompletionResponse]]:
            completion_tokens = 0
            char_offset = 0  # running offset within the generated text
            async for item in stream:
                ann = Annotated.from_wire(item, LLMEngineOutput.from_wire)
                if ann.is_annotation() or ann.data is None:
                    continue
                out = ann.data
                completion_tokens += len(out.token_ids)
                lp_block = None
                if want_logprobs and out.token_ids and out.logprobs is not None:
                    token_texts = [
                        tokenizer.decode([t], skip_special_tokens=False)
                        for t in out.token_ids
                    ]
                    offsets = []
                    for text in token_texts:
                        offsets.append(char_offset)
                        char_offset += len(text)
                    top = None
                    if out.top_logprobs is not None:
                        top = [
                            {
                                tokenizer.decode([int(aid)], skip_special_tokens=False):
                                float(alp)
                                for aid, alp in row
                            }
                            for row in out.top_logprobs
                        ]
                    lp_block = {
                        "tokens": token_texts,
                        "token_logprobs": out.logprobs,
                        "top_logprobs": top,
                        "text_offset": offsets,
                    }
                yield Annotated.from_data(
                    CompletionResponse(
                        id=state["response_id"],
                        model=state["model"],
                        choices=[
                            CompletionChoice(
                                index=0,
                                text=out.text or "",
                                finish_reason=finish_reason_to_openai(out.finish_reason),
                                logprobs=lp_block,
                            )
                        ],
                    )
                )
            if include_usage:
                yield Annotated.from_data(
                    CompletionResponse(
                        id=state["response_id"],
                        model=state["model"],
                        choices=[],
                        usage=Usage(
                            prompt_tokens=state["prompt_tokens"],
                            completion_tokens=completion_tokens,
                            total_tokens=state["prompt_tokens"] + completion_tokens,
                        ),
                    )
                )

        return ResponseStream(gen(), request.ctx)
