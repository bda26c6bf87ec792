"""Process supervisor — the local serving substrate (a copy of
dynamo_tpu/sdk/supervisor.py).

The circus-arbiter equivalent (reference: deploy/sdk/.../cli/serving.py
create_circus_watcher): each *watcher* is a named process spec with a target
replica count; the supervisor spawns/retires/restarts OS processes to match,
with exponential backoff on crash loops and graceful SIGTERM drain.
"""

from __future__ import annotations

import asyncio
import os
import signal
import sys
import time
from dataclasses import dataclass, field

from dynamo_tpu_torch.utils.logging import get_logger
from dynamo_tpu_torch.utils.tasks import spawn_logged

logger = get_logger("sdk.supervisor")


@dataclass
class ProcessSpec:
    name: str
    cmd: list[str]                      # argv; {replica} substituted
    env: dict[str, str] = field(default_factory=dict)
    # per-replica env overlays on top of ``env`` (index → vars) — how the
    # GPU allocator pins each replica to its disjoint card set
    # (sdk/allocator.py: a per-worker CUDA_VISIBLE_DEVICES list).  A replica
    # index past the list's end gets no overlay; a restart of replica i
    # re-applies overlay i, so the restarted process reclaims the SAME
    # cards.
    replica_env: list[dict[str, str]] = field(default_factory=list)
    replicas: int = 1                   # default target for add_watcher
    cwd: str | None = None
    restart: bool = True
    max_restarts: int = 5
    stop_timeout_s: float = 10.0


@dataclass
class _Replica:
    index: int
    process: asyncio.subprocess.Process
    started_at: float
    restarts: int = 0


class ProcessSupervisor:
    def __init__(self) -> None:
        self._specs: dict[str, ProcessSpec] = {}
        self._replicas: dict[str, dict[int, _Replica]] = {}
        self._targets: dict[str, int] = {}
        self._monitor: asyncio.Task | None = None
        self._stopping = False

    def add_watcher(self, spec: ProcessSpec, replicas: int | None = None) -> None:
        self._specs[spec.name] = spec
        self._replicas.setdefault(spec.name, {})
        self._targets[spec.name] = spec.replicas if replicas is None else replicas

    async def start(self) -> None:
        self._stopping = False
        for name in self._specs:
            await self._reconcile(name)
        if self._monitor is None:
            self._monitor = spawn_logged(self._monitor_loop())

    async def set_replicas(self, name: str, n: int) -> None:
        self._targets[name] = max(0, n)
        await self._reconcile(name)

    def replica_count(self, name: str) -> int:
        return len(self._replicas.get(name, {}))

    async def stop(self) -> None:
        self._stopping = True
        if self._monitor is not None:
            self._monitor.cancel()
            self._monitor = None
        for name in list(self._specs):
            self._targets[name] = 0
            await self._reconcile(name)

    # -- internals ---------------------------------------------------------
    async def _reconcile(self, name: str) -> None:
        spec = self._specs[name]
        replicas = self._replicas[name]
        target = self._targets[name]
        # scale up
        idx = 0
        while len(replicas) < target:
            while idx in replicas:
                idx += 1
            replicas[idx] = await self._spawn(spec, idx)
        # scale down: retire highest indices first
        while len(replicas) > target:
            highest = max(replicas)
            await self._terminate(spec, replicas.pop(highest))

    async def _spawn(self, spec: ProcessSpec, index: int) -> _Replica:
        cmd = [arg.replace("{replica}", str(index)) for arg in spec.cmd]
        env = dict(os.environ)
        env.update(spec.env)
        if spec.replica_env:
            if index >= len(spec.replica_env):
                # scaling past the planned overlays would spawn a replica
                # seeing the WHOLE card inventory — the over-subscription
                # the allocator exists to prevent.  Fail the scale-up
                # loudly; re-plan with more workers (or set
                # DYN_DISABLE_AUTO_GPU_ALLOCATION=1) to go further.
                raise RuntimeError(
                    f"{spec.name}[{index}]: no GPU-env overlay planned for "
                    f"this replica ({len(spec.replica_env)} were allocated); "
                    "re-plan the deployment with more workers"
                )
            env.update(spec.replica_env[index])
        env["DYN_REPLICA_INDEX"] = str(index)
        process = await asyncio.create_subprocess_exec(
            *cmd, env=env, cwd=spec.cwd,
            stdout=sys.stderr, stderr=sys.stderr,
        )
        logger.info("spawned %s[%d] pid=%d", spec.name, index, process.pid)
        return _Replica(index=index, process=process, started_at=time.monotonic())

    async def _terminate(self, spec: ProcessSpec, replica: _Replica) -> None:
        process = replica.process
        if process.returncode is None:
            process.send_signal(signal.SIGTERM)
            try:
                await asyncio.wait_for(process.wait(), spec.stop_timeout_s)
            except asyncio.TimeoutError:
                logger.warning("%s[%d] did not stop; killing", spec.name, replica.index)
                process.kill()
                await process.wait()
        logger.info("stopped %s[%d]", spec.name, replica.index)

    async def _monitor_loop(self) -> None:
        while True:
            await asyncio.sleep(0.5)
            for name, spec in self._specs.items():
                replicas = self._replicas[name]
                for index, replica in list(replicas.items()):
                    if replica.process.returncode is None:
                        continue
                    del replicas[index]
                    if self._stopping or not spec.restart:
                        continue
                    if len(replicas) >= self._targets[name]:
                        continue
                    if replica.restarts >= spec.max_restarts:
                        logger.error(
                            "%s[%d] crash-looped %d times; giving up",
                            name, index, replica.restarts,
                        )
                        continue
                    backoff = min(2.0 ** replica.restarts * 0.2, 10.0)
                    logger.warning(
                        "%s[%d] exited rc=%s; restarting in %.1fs",
                        name, index, replica.process.returncode, backoff,
                    )
                    await asyncio.sleep(backoff)
                    new = await self._spawn(spec, index)
                    new.restarts = replica.restarts + 1
                    replicas[index] = new
