"""GPU resource allocator — per-replica card assignment for local serving
(counterpart of dynamo_tpu/sdk/allocator.py, which hands out TPU chips).

The reference partitions host GPUs across service worker replicas and
exports ``CUDA_VISIBLE_DEVICES`` per process (reference:
deploy/sdk/src/dynamo/sdk/cli/allocator.py:53-151 — ``assign_gpus`` +
``get_resource_envs``).  This module keeps dynamo_tpu's rules, on CUDA
names: a service declares ``resources={"gpu": n}``, and each replica gets
``CUDA_VISIBLE_DEVICES`` plus the framework's own record ``DYN_GPUS``.

The rules, as the TPU allocator's:

- **Whole devices only.** A fractional request raises
  :class:`ResourceError`: two engines on one card each size their KV cache
  from the card's whole memory, so time-sharing a card is an explicit
  opt-out (below), not a scheduling strategy.
- **Contiguous runs.** Cards are assigned as contiguous index runs, so a
  tp>1 replica's cards are neighbours in the host's index order.
- **Fail fast on over-subscription.** Exhausting the inventory raises
  unless ``DYN_DISABLE_AUTO_GPU_ALLOCATION=1`` opts the deployment out of
  allocation entirely (every process then sees what the parent saw).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from dynamo_tpu_torch.utils import knobs
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("sdk.allocator")

# the opt-out switch (the reference's own name)
DISABLE_ENV = "DYN_DISABLE_AUTO_GPU_ALLOCATION"
# the env var the CUDA runtime reads to restrict a process to a card subset;
# also what GpuInventory.detect() honors when the parent was restricted
VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"


class ResourceError(RuntimeError):
    """A GPU request that cannot be satisfied (or is not a whole card)."""


@dataclass(frozen=True)
class GpuInventory:
    """The cards this host may hand out, as CUDA device indices."""

    gpus: tuple[int, ...]
    device_kind: str = "gpu"

    @classmethod
    def detect(cls, env: dict | None = None) -> "GpuInventory":
        """Inventory from the environment, cheapest signal first.

        1. ``CUDA_VISIBLE_DEVICES`` — already restricted (nested
           supervisors, operator-managed pods): inherit exactly that
           subset.
        2. ``DYN_GPU_COUNT`` — explicit operator knob.
        3. ``torch.cuda.device_count()``, but only where CUDA is already
           initialized in this process (never initializes it here: a
           planner or supervisor must not bring up a card just to plan
           processes).
        4. Otherwise: empty inventory (CPU host / no card visible).
        """
        env = os.environ if env is None else env
        visible = env.get(VISIBLE_DEVICES_ENV)
        if visible:
            return cls(gpus=tuple(int(c) for c in visible.split(",") if c.strip() != ""))
        count = knobs.get("DYN_GPU_COUNT", env=env)
        if count:
            return cls(gpus=tuple(range(count)))
        try:
            import torch

            if torch.cuda.is_initialized() and torch.cuda.device_count():
                return cls(gpus=tuple(range(torch.cuda.device_count())),
                           device_kind=torch.cuda.get_device_name(0))
        except Exception:  # noqa: BLE001 — detection must never raise
            pass
        return cls(gpus=())


@dataclass
class ResourceAllocator:
    """Hands out disjoint card sets to service replicas on one host."""

    inventory: GpuInventory
    _free: list[int] = field(init=False)
    assignments: dict[str, list[list[int]]] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self._free = sorted(self.inventory.gpus)

    @property
    def remaining(self) -> int:
        return len(self._free)

    def assign_gpus(self, count: float, service_name: str = "") -> list[int]:
        """Claim ``count`` cards as a contiguous run; they leave the pool.

        Raises :class:`ResourceError` on fractional requests (whole cards
        only) and on over-subscription (fail at plan time, not when two
        engines meet on one card)."""
        if count != int(count) or count < 1:
            raise ResourceError(
                f"{service_name or 'service'}: requested {count} GPUs — "
                "cards are assigned whole (each engine sizes its KV cache from "
                "the card's memory); use integer counts, or omit the gpu "
                "resource for CPU-only services"
            )
        count = int(count)
        if count > len(self._free):
            raise ResourceError(
                f"{service_name or 'service'}: requested {count} GPUs "
                f"but only {len(self._free)} of {len(self.inventory.gpus)} "
                f"remain unassigned; set {DISABLE_ENV}=1 to manage "
                f"{VISIBLE_DEVICES_ENV} manually"
            )
        # prefer a contiguous run; fall back to the lowest free indices
        # when fragmentation leaves no run long enough
        run = self._contiguous_run(count)
        assigned = run if run is not None else self._free[:count]
        for c in assigned:
            self._free.remove(c)
        if service_name:
            self.assignments.setdefault(service_name, []).append(list(assigned))
        logger.info(
            "assigned GPUs %s to %s (%d remain)",
            assigned, service_name or "<anon>", len(self._free),
        )
        return list(assigned)

    def _contiguous_run(self, count: int) -> list[int] | None:
        free = self._free
        for i in range(len(free) - count + 1):
            window = free[i: i + count]
            if window[-1] - window[0] == count - 1:
                return list(window)
        return None

    def replica_envs(
        self, *, gpu: float, workers: int, service_name: str = ""
    ) -> list[dict[str, str]]:
        """One env overlay per worker replica, each with a disjoint card set
        (the reference's local-deployment branch: one ``assign_gpus`` call
        per worker → per-worker ``CUDA_VISIBLE_DEVICES``)."""
        envs = []
        for _ in range(workers):
            gpus = ",".join(str(c) for c in self.assign_gpus(gpu, service_name))
            # DYN_GPUS: the framework's own record, independent of CUDA's var
            envs.append({VISIBLE_DEVICES_ENV: gpus, "DYN_GPUS": gpus})
        return envs


def plan_resource_envs(
    services: list, *, inventory: GpuInventory | None = None,
    env: dict | None = None,
) -> dict[str, list[dict[str, str]]]:
    """Per-service, per-replica env overlays for a whole dependency closure.

    ``services`` is a list of @service-decorated classes (sdk/graph.py).
    Services without a ``gpu`` resource get empty overlays.  Returns {} for
    every service when allocation is disabled or no cards are visible —
    processes then see whatever the parent saw, as the reference's do with
    DYN_DISABLE_AUTO_GPU_ALLOCATION set."""
    env = os.environ if env is None else env
    if knobs.get(DISABLE_ENV, env=env):
        return {}
    inventory = GpuInventory.detect(env) if inventory is None else inventory
    requested = {
        cls._dyn_service.name: cls._dyn_service
        for cls in services
        if (cls._dyn_service.resources or {}).get("gpu")
    }
    if not requested:
        return {}
    if not inventory.gpus:
        logger.warning(
            "services %s request GPUs but none are visible on this host; "
            "skipping GPU allocation", sorted(requested),
        )
        return {}
    allocator = ResourceAllocator(inventory)
    return {
        name: allocator.replica_envs(
            gpu=config.resources["gpu"], workers=config.workers,
            service_name=name,
        )
        for name, config in requested.items()
    }
