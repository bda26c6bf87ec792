"""Embedding engine: the ``/v1/embeddings`` backend (counterpart of
dynamo_tpu/engine/embedding.py).

Runs the model trunk (no LM head; ``models.llama.llama_forward_trunk``)
over each input padded to ``max_length``, mean-pools the final hidden
states over the valid positions and L2-normalises (norm clamped at 1e-9).
The reference compiles that function once; here it is one CUDA graph over
persistent input buffers, captured at the first input and replayed for
every later one (eager on the CPU).  Served through the same HTTP frontend
(``HttpService``'s ``add_embedding_model``).
"""

from __future__ import annotations

import asyncio
import base64
import threading
from dataclasses import dataclass

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine.engine import _to_device
from dynamo_tpu_torch.engine.graphs import StepGraphs
from dynamo_tpu_torch.llm.protocols.openai import (
    EmbeddingData,
    EmbeddingRequest,
    EmbeddingResponse,
    Usage,
)
from dynamo_tpu_torch.llm.tokenizer import HfTokenizer
from dynamo_tpu_torch.models.llama import (
    LlamaConfig,
    init_params,
    llama_forward_trunk,
    make_rope_tables,
)


@dataclass
class EmbeddingEngineConfig:
    model: LlamaConfig
    max_length: int = 512
    seed: int = 0


class _TrunkGraph(StepGraphs):
    name = "embedding"


class TorchEmbeddingEngine:
    def __init__(self, config: EmbeddingEngineConfig, tokenizer: HfTokenizer, params=None,
                 *, device: str | torch.device | None = None):
        self.config = config
        self.tokenizer = tokenizer
        self.device = dev = resolve_device(device)
        cfg = config.model
        if params is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(config.seed)
            params = init_params(cfg, gen, dev)
        self.params = _to_device(params, dev)
        # the tables cut to the served window (the reference slices them too)
        self.cos, self.sin = make_rope_tables(cfg, dev, config.max_length)
        n = config.max_length
        self._tokens = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._len = torch.zeros((), dtype=torch.int32, device=dev)
        self._out = torch.zeros((cfg.hidden_size,), dtype=torch.float32, device=dev)
        self._pos = torch.arange(n, device=dev)
        pool = torch.cuda.MemPool() if dev.type == "cuda" else None
        self._graph = _TrunkGraph(dev, pool)
        # one input at a time through the shared buffers
        self._lock = threading.Lock()

    def _step(self) -> None:
        """The trunk, the masked mean pool and the L2 normalisation of the
        buffered input, into ``_out``.  The pool and the norm run in float32
        (the reference's run in the model dtype: in bfloat16 its norm alone
        rounds by up to 2^-9, and the vector's length with it)."""
        hidden = llama_forward_trunk(self.params, self.config.model, self._tokens,
                                     self._len, self.cos, self.sin).float()
        mask = (self._pos < self._len)[:, None]
        pooled = (hidden * mask).sum(dim=0) / self._len.clamp(min=1)
        vec = pooled / torch.linalg.vector_norm(pooled).clamp(min=1e-9)
        self._out.copy_(vec)

    def embed_ids(self, ids: list[int], *, eager: bool = False) -> np.ndarray:
        """One input's unit vector [hidden] float32: the graph's replay on a
        CUDA device (captured at the first call), the eager step on the CPU
        or with ``eager``."""
        ids = list(ids)[: self.config.max_length]
        padded = np.zeros((self.config.max_length,), np.int32)
        padded[: len(ids)] = ids
        with self._lock:
            self._tokens.copy_(torch.from_numpy(padded))
            self._len.fill_(len(ids))
            if eager or self.device.type != "cuda":
                self._step()
            else:
                self._graph._replay(None, self._step, self._step)
            # a copy: on the CPU .cpu() is the buffer the next input overwrites
            return self._out.cpu().numpy().copy()

    def _token_lists(self, request: EmbeddingRequest) -> list[list[int]]:
        """The four accepted input shapes as token-id lists."""
        inp = request.input
        if isinstance(inp, str):
            return [self.tokenizer.encode(inp)]
        if not inp:
            return []
        if isinstance(inp[0], int):
            return [list(inp)]  # one pre-tokenized sequence
        if isinstance(inp[0], list):
            return [list(ids) for ids in inp]  # a batch of pre-tokenized sequences
        return [self.tokenizer.encode(text) for text in inp]

    async def embed(self, request: EmbeddingRequest) -> EmbeddingResponse:
        if request.encoding_format not in (None, "float", "base64"):
            raise ValueError(f"unsupported encoding_format {request.encoding_format!r}")
        data = []
        total_tokens = 0
        for i, ids in enumerate(self._token_lists(request)):
            ids = ids[: self.config.max_length]
            total_tokens += len(ids)
            vec = await asyncio.to_thread(self.embed_ids, ids)
            if request.encoding_format == "base64":
                embedding: list[float] | str = base64.b64encode(
                    vec.astype(np.float32).tobytes()).decode("ascii")
            else:
                embedding = [float(x) for x in vec]
            data.append(EmbeddingData(index=i, embedding=embedding))
        return EmbeddingResponse(
            model=request.model,
            data=data,
            usage=Usage(prompt_tokens=total_tokens, total_tokens=total_tokens),
        )

    def stats(self) -> dict:
        return self._graph.stats()
