"""Shared launch helpers for the LLM example graphs (a copy of the
repository's examples/llm/common.py on the port's serving assembly;
reference: examples/llm/components/{worker,prefill_worker,processor}.py).

Each graph is a composition of:
- a frontend (OpenAI HTTP + model watcher) with a router mode,
- N workers (torch / mocker / echo engine), and — for the disagg graphs —
- a decode worker wrapping :class:`DisaggDecodeEngine` plus M prefill
  workers pumping the shared prefill queue.

The torch engines are ``serve.build_torch_engine``'s, on the card unless
``device`` is ``"cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from dynamo_tpu_torch import serve
from dynamo_tpu_torch.llm.disagg import PrefillQueue
from dynamo_tpu_torch.runtime.client import RouterMode
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.serve import serve_frontend, serve_worker
from dynamo_tpu_torch.utils.config import load_config


@dataclass
class LlmGraphConfig:
    """Per-graph config; layered defaults < YAML file < DYN_EXAMPLE_* env."""

    model_dir: str = ""
    model_name: str = "example-model"
    engine_kind: str = "torch"  # torch | mocker | echo
    num_workers: int = 1
    num_prefill_workers: int = 1
    http_host: str = "127.0.0.1"
    http_port: int = 8080
    # engine sizing
    num_blocks: int = 256
    max_batch_size: int = 8
    max_model_len: int = 1024
    # disagg decision threshold (reference: lib/llm/src/disagg_router.rs:25-34)
    max_local_prefill_length: int = 64
    max_prefill_queue_size: int = 8
    engine_overrides: dict = field(default_factory=dict)
    # where the torch engines run: "" the CUDA card, "cpu" the CPU
    device: str = ""

    @classmethod
    def load(cls, config_file: str | Path | None = None, **overrides) -> "LlmGraphConfig":
        return load_config(
            cls, env_prefix="DYN_EXAMPLE", config_file=config_file, overrides=overrides
        )

    def engine_kw(self) -> dict:
        """The torch engines' sizing, overrides and device."""
        return dict(num_blocks=self.num_blocks, max_batch_size=self.max_batch_size,
                    max_model_len=self.max_model_len, device=self.device or None,
                    **self.engine_overrides)


@dataclass
class GraphHandle:
    """Everything a graph launched; reverse-order teardown."""

    frontend: object = None
    watcher: object = None
    workers: list = field(default_factory=list)
    extras: list = field(default_factory=list)  # objects with async stop()

    async def shutdown(self) -> None:
        if self.watcher is not None:
            await self.watcher.stop()
        if self.frontend is not None:
            await self.frontend.stop()
        for extra in reversed(self.extras):
            await extra.stop()
        for worker in reversed(self.workers):
            await worker.shutdown()


async def launch_workers(
    rt: DistributedRuntime, cfg: LlmGraphConfig, *, component: str = "backend"
) -> list:
    workers = []
    for _ in range(cfg.num_workers):
        workers.append(
            await serve_worker(
                rt,
                cfg.model_dir,
                model_name=cfg.model_name,
                component=component,
                engine_kind=cfg.engine_kind,
                **(cfg.engine_kw() if cfg.engine_kind == "torch" else {}),
            )
        )
    return workers


async def launch_frontend(
    rt: DistributedRuntime, cfg: LlmGraphConfig, router_mode: RouterMode
) -> tuple:
    return await serve_frontend(
        rt, host=cfg.http_host, port=cfg.http_port, router_mode=router_mode
    )


async def launch_disagg_decode_worker(
    rt: DistributedRuntime, cfg: LlmGraphConfig, queue: PrefillQueue
) -> serve.DisaggWorkerHandle:
    """Decode worker: a torch engine behind the remote-prefill decision
    wrapper (reference: examples/llm/components/worker.py:187)."""
    return await serve.launch_disagg_decode_worker(
        rt, cfg.model_dir, queue, model_name=cfg.model_name,
        max_local_prefill_length=cfg.max_local_prefill_length,
        max_prefill_queue_size=cfg.max_prefill_queue_size, **cfg.engine_kw(),
    )


async def launch_prefill_workers(
    rt: DistributedRuntime, cfg: LlmGraphConfig, queue: PrefillQueue
) -> list[serve.PrefillHandle]:
    """Prefill-side pumps (reference: examples/llm/components/prefill_worker.py:139)."""
    return await serve.launch_prefill_workers(
        rt, cfg.model_dir, queue, num_workers=cfg.num_prefill_workers,
        model_name=cfg.model_name, **cfg.engine_kw(),
    )
