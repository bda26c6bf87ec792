"""Typed registry and the single read path for the port's ``DYN_*`` knobs
(counterpart of dynamo_tpu/utils/knobs.py).

The port registers only the knobs its own modules read, under the
reference's names, types and defaults, and reads them through :func:`get`.

Semantics (as the reference's):

- ``bool`` knobs parse ``1/true/yes/on`` as True and ``0/false/off/no`` (or
  empty) as False; any other token falls back to the default.
- ``int``/``float`` knobs return the default when unset, empty, or
  unparseable.
- ``get(name, env=...)`` accepts an explicit mapping (tests).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Mapping

_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("0", "false", "off", "no", "")


@dataclass(frozen=True)
class Knob:
    name: str
    type: str  # "str" | "int" | "float" | "bool"
    default: Any
    doc: str


_REGISTRY: dict[str, Knob] = {}


def register(name: str, *, type: str = "str", default: Any = None, doc: str = "") -> str:
    """Declare one knob; returns the name so modules can bind constants."""
    if name in _REGISTRY:
        raise ValueError(f"knob {name} registered twice")
    if type not in ("str", "int", "float", "bool"):
        raise ValueError(f"knob {name}: unknown type {type!r}")
    if not doc:
        raise ValueError(f"knob {name}: doc string is required")
    _REGISTRY[name] = Knob(name=name, type=type, default=default, doc=doc)
    return name


def parse_bool(raw: str | None, default: Any = False) -> Any:
    if raw is None:
        return default
    lowered = raw.strip().lower()
    if lowered in _TRUTHY:
        return True
    if lowered in _FALSY:
        return False
    return default


def get_raw(name: str, *, env: Mapping[str, str] | None = None) -> str | None:
    """The raw string value (or None when unset) of a *registered* knob."""
    if name not in _REGISTRY:
        raise KeyError(f"unregistered knob {name}; declare it in utils/knobs.py")
    source = os.environ if env is None else env
    return source.get(name)


def get(name: str, *, env: Mapping[str, str] | None = None) -> Any:
    """The typed value of a registered knob (default when unset/malformed)."""
    knob = _REGISTRY.get(name)
    if knob is None:
        raise KeyError(f"unregistered knob {name}; declare it in utils/knobs.py")
    source = os.environ if env is None else env
    raw = source.get(name)
    if knob.type == "bool":
        return parse_bool(raw, knob.default)
    if raw is None:
        return knob.default
    if knob.type == "str":
        return raw
    try:
        return int(raw) if knob.type == "int" else float(raw)
    except ValueError:
        return knob.default


def is_set(name: str, *, env: Mapping[str, str] | None = None) -> bool:
    return get_raw(name, env=env) is not None


def all_knobs() -> tuple[Knob, ...]:
    return tuple(_REGISTRY[k] for k in sorted(_REGISTRY))


# -- tracing (observability/recorder.py) -------------------------------------
K_TRACE_BUFFER = register(
    "DYN_TRACE_BUFFER", type="int", default=4096, doc="span ring-buffer size")
K_TRACE_JSONL = register(
    "DYN_TRACE_JSONL", type="str", default=None, doc="live JSONL span export path")
K_TRACE_MAX_BYTES = register(
    "DYN_TRACE_MAX_BYTES", type="int", default=0,
    doc="rotate the JSONL span export at this size (0 = unbounded)")

# -- perf flight recorder (observability/flight.py) ---------------------------
K_FLIGHT = register(
    "DYN_FLIGHT", type="bool", default=True,
    doc="always-on perf flight recorder; `0` is bookkeeping-free")
K_FLIGHT_BUFFER_BYTES = register(
    "DYN_FLIGHT_BUFFER_BYTES", type="int", default=262144,
    doc="byte budget of the flight-recorder ring")
K_FLIGHT_DIR = register(
    "DYN_FLIGHT_DIR", type="str", default=None,
    doc="directory flight dumps are written to (default "
        "`$DYN_CACHE_DIR/flight` or `~/.cache/dynamo_tpu_torch/flight`)")
K_FLIGHT_BURN = register(
    "DYN_FLIGHT_BURN", type="float", default=10.0,
    doc="worst-window SLO burn rate above which the recorder auto-dumps")

# -- robustness / routing (robustness/, runtime/) -----------------------------
K_FAULTS = register(
    "DYN_FAULTS", type="str", default="",
    doc="chaos fault-injection schedule spec")
K_CP_RECONNECT = register(
    "DYN_CP_RECONNECT", type="bool", default=True,
    doc="self-healing control-plane client; `0` restores fail-fast")
K_RETRY_MAX = register(
    "DYN_RETRY_MAX", type="int", default=1,
    doc="pre-first-token re-dispatch attempts for a failed stream")
K_CONNECT_TIMEOUT_S = register(
    "DYN_CONNECT_TIMEOUT_S", type="float", default=30.0,
    doc="data-plane rendezvous (connect-back) timeout per attempt")
K_DARK_WORKER_TTL_S = register(
    "DYN_DARK_WORKER_TTL_S", type="float", default=30.0,
    doc="quarantine TTL for an instance that failed a rendezvous")
K_DARK_PROBE_TIMEOUT_S = register(
    "DYN_DARK_PROBE_TIMEOUT_S", type="float", default=5.0,
    doc="short probe window for quarantined instances (and for waiting out "
        "an empty instance view)")
K_RENDEZVOUS_BUDGET_S = register(
    "DYN_RENDEZVOUS_BUDGET_S", type="float", default=0.0,
    doc="hard cap on total rendezvous time across failovers (0 = 3x the "
        "connect timeout)")
K_RESUME = register(
    "DYN_RESUME", type="bool", default=True,
    doc="mid-stream resume: re-dispatch a failed stream with a `resume_from` "
        "journal instead of truncating")
K_RESUME_JOURNAL_MAX_ITEMS = register(
    "DYN_RESUME_JOURNAL_MAX_ITEMS", type="int", default=4096,
    doc="max accepted tokens a GenerationJournal retains per request "
        "(0 = unbounded)")
K_MIGRATE = register(
    "DYN_MIGRATE", type="bool", default=True,
    doc="live session migration: the dispatcher may move an in-flight decode "
        "to another worker; `0` disables the coordinator entirely")
K_MIGRATE_FLIP_TIMEOUT_S = register(
    "DYN_MIGRATE_FLIP_TIMEOUT_S", type="float", default=10.0,
    doc="max seconds a migration waits for the consumer loop to commit the "
        "stream flip before aborting back to the source")
K_DRAIN_TIMEOUT_S = register(
    "DYN_DRAIN_TIMEOUT_S", type="float", default=30.0,
    doc="graceful drain budget: in-flight work gets this long to finish or "
        "hand off before cancellation")

# -- SLO tracking (observability/slo.py) --------------------------------------
K_SLO_TTFT_S = register(
    "DYN_SLO_TTFT_S", type="float", default=2.0,
    doc="TTFT objective threshold (seconds)")
K_SLO_TTFT_TARGET = register(
    "DYN_SLO_TTFT_TARGET", type="float", default=0.99,
    doc="good fraction required for TTFT")
K_SLO_ITL_S = register(
    "DYN_SLO_ITL_S", type="float", default=0.2,
    doc="inter-token-latency objective threshold (seconds)")
K_SLO_ITL_TARGET = register(
    "DYN_SLO_ITL_TARGET", type="float", default=0.99,
    doc="good fraction required for ITL")
K_SLO_ERROR_TARGET = register(
    "DYN_SLO_ERROR_TARGET", type="float", default=0.999,
    doc="request success-rate objective")
K_SLO_WINDOWS = register(
    "DYN_SLO_WINDOWS", type="str", default="",
    doc="comma-separated burn-rate windows in seconds (default `300,3600`)")
K_SLO_SHED_BURN = register(
    "DYN_SLO_SHED_BURN", type="float", default=0.0,
    doc="burn rate above which a saturated admission gate sheds (0 = off)")

# -- frontend admission control (robustness/admission.py) ---------------------
K_ADMISSION_MAX_INFLIGHT = register(
    "DYN_ADMISSION_MAX_INFLIGHT", type="int", default=0,
    doc="frontend admission gate: max in-flight requests (0 = off)")
K_ADMISSION_QUEUE = register(
    "DYN_ADMISSION_QUEUE", type="int", default=None,
    doc="admission queue depth (default: 2x max in-flight)")
K_ADMISSION_QUEUE_TIMEOUT_S = register(
    "DYN_ADMISSION_QUEUE_TIMEOUT_S", type="float", default=2.0,
    doc="max seconds a request may wait in the admission queue")
K_ADMISSION_RETRY_AFTER_S = register(
    "DYN_ADMISSION_RETRY_AFTER_S", type="float", default=1.0,
    doc="Retry-After hint attached to shed (429) responses")

# -- predictive prefetch (prefetch/, engine/offload.py) -----------------------
K_PREFETCH = register(
    "DYN_PREFETCH", type="bool", default=True,
    doc="master prefetch gate; `0` restores demand-driven paging everywhere")
K_PREFETCH_TTL = register(
    "DYN_PREFETCH_TTL", type="float", default=30.0,
    doc="seconds before an unexecuted prefetch hint goes stale")
K_PREFETCH_BLOCKS = register(
    "DYN_PREFETCH_BLOCKS", type="int", default=64,
    doc="max blocks paged per engine-loop iteration while serving")
K_PREFETCH_HEADROOM = register(
    "DYN_PREFETCH_HEADROOM", type="float", default=0.05,
    doc="fraction of device cache blocks reserved from prefetch")
K_PREFETCH_HINT_CHARS = register(
    "DYN_PREFETCH_HINT_CHARS", type="int", default=16384,
    doc="frontend arrival hints tokenize at most this much rendered text")
K_PREFETCH_PIN_HITS = register(
    "DYN_PREFETCH_PIN_HITS", type="int", default=3,
    doc="restores before a block hash becomes a pin candidate")
K_PREFETCH_PIN_MAX = register(
    "DYN_PREFETCH_PIN_MAX", type="int", default=None,
    doc="max pinned host blocks (default: host blocks / 4)")

# -- runtime plumbing (utils/config.py, llm/hub.py) ---------------------------
K_CONTROL_PLANE = register(
    "DYN_CONTROL_PLANE", type="str", default="memory",
    doc="control-plane backend (`memory` or `host:port` of a dynctl server)")
K_CACHE_DIR = register(
    "DYN_CACHE_DIR", type="str", default=None,
    doc="artifact/cache directory (default `~/.cache/dynamo_tpu_torch`)")
K_DISABLE_NATIVE = register(
    "DYN_DISABLE_NATIVE", type="bool", default=False,
    doc="skip the native (C++) data-plane codec and use pure Python")
K_ALLOW_PRIVATE_IMAGE_URLS = register(
    "DYN_ALLOW_PRIVATE_IMAGE_URLS", type="bool", default=False,
    doc="allow multimodal image fetches from private/internal addresses")

# -- disaggregated prefill/decode (llm/disagg.py, parallel/kv_transfer.py) ----
K_KV_STREAM = register(
    "DYN_KV_STREAM", type="bool", default=True,
    doc="streamed multi-part disagg KV transfer; `0` = single-shot")
K_TRANSFER_HOP = register(
    "DYN_TRANSFER_HOP", type="str", default="",
    doc="explicit override of the worker's *discovered* hop class "
        "(`local`|`ici`|`dcn`) published to the router's transfer-cost "
        "model (unset: the topology plane's classification wins)")
K_DISAGG_PREFILL_TIMEOUT_S = register(
    "DYN_DISAGG_PREFILL_TIMEOUT_S", type="float", default=300.0,
    doc="decode-side wait for the KV stream before falling back to local "
        "prefill")
K_DISAGG_CLOCK_SKEW_S = register(
    "DYN_DISAGG_CLOCK_SKEW_S", type="float", default=30.0,
    doc="tolerated cross-host clock skew when judging queued-prefill "
        "staleness")
K_KV_DIAL_TIMEOUT_S = register(
    "DYN_KV_DIAL_TIMEOUT_S", type="float", default=5.0,
    doc="KV-transfer pool dial timeout per connection attempt (a black-holed "
        "peer fails the send instead of blocking forever)")

# -- fleet topology plane (topology/) -----------------------------------------
K_TOPO = register(
    "DYN_TOPO", type="bool", default=True,
    doc="master topology-plane gate: card publication, map watching, and "
        "probing; `0` restores the env-knob-only link model")
K_TOPO_SLICE = register(
    "DYN_TOPO_SLICE", type="str", default="",
    doc="explicit slice label for this worker's TopologyCard (on a GPU host "
        "nothing else sets one; used to emulate multi-slice fleets)")
K_TOPO_PROBE_PERIOD_S = register(
    "DYN_TOPO_PROBE_PERIOD_S", type="float", default=10.0,
    doc="seconds between topology probe ticks (0 disables active probing; "
        "passive KvTransferClient EWMAs still feed the map)")
K_TOPO_PROBE_BYTES = register(
    "DYN_TOPO_PROBE_BYTES", type="int", default=65536,
    doc="payload size of one topology bandwidth probe")
K_TOPO_PROBE_MAX_PER_TICK = register(
    "DYN_TOPO_PROBE_MAX_PER_TICK", type="int", default=4,
    doc="max peers probed per tick (round-robin across the fleet)")

# -- tensor and expert parallelism (parallel/mesh.py, engine/shard_worker.py) --
K_MESH_BACKEND = register(
    "DYN_MESH_BACKEND", type="str", default="",
    doc="process-group backend of an engine mesh: `nccl` (a card a rank) or "
        "`gloo`; empty = nccl on cards, gloo on the CPU.  Ranks share a card "
        "only over gloo named here or by the caller")
K_MESH_TIMEOUT_S = register(
    "DYN_MESH_TIMEOUT_S", type="float", default=120.0,
    doc="seconds a mesh collective waits before it raises: a dead or hung "
        "rank ends the others' wait (an idle engine pings its shard workers "
        "every quarter of it)")

# -- the ragged kernel's autotuned layout (ops/autotune.py, engine/engine.py) --
K_KERNEL_PERF = register(
    "DYN_KERNEL_PERF", type="str", default=None,
    doc="explicit path to the port's kernel-perf table (default: "
        "`dynamo_tpu_torch/KERNEL_PERF_CUDA.json`, absent until a tuning run "
        "writes it; never the repo-root TPU table)")
K_AUTOTUNE = register(
    "DYN_AUTOTUNE", type="bool", default=True,
    doc="consult the kernel-perf table's autotune rows for the ragged "
        "kernel's layout at engine init; `0` keeps the heuristic defaults")
K_AUTOTUNE_TB = register(
    "DYN_AUTOTUNE_TB", type="int", default=None,
    doc="force the ragged kernel's token-block size (overrides tuned rows; "
        "must divide every serving bucket or it falls back with a warning)")
K_AUTOTUNE_PAGE_SLOTS = register(
    "DYN_AUTOTUNE_PAGE_SLOTS", type="int", default=None,
    doc="force the packed page-worklist width (overflowing windows repack "
        "at the full width and count in "
        "`stats()[\"unified_ps_overflows_total\"]`)")
K_AUTOTUNE_PAGES_PER_STEP = register(
    "DYN_AUTOTUNE_PAGES_PER_STEP", type="int", default=None,
    doc="force KV pages fetched per ragged grid step (must divide "
        "page_slots; the port's kernels accept it and ignore it)")

# -- perf regression gate (bench/perfgate.py) ---------------------------------
K_PERFGATE_BASELINE = register(
    "DYN_PERFGATE_BASELINE", type="str", default=None,
    doc="explicit baseline path for `python -m dynamo_tpu_torch.bench.perfgate` "
        "(default: `PERF_BASELINE_CUDA.json` beside the artifacts)")
K_PERFGATE_GIT_DESCRIBE = register(
    "DYN_PERFGATE_GIT_DESCRIBE", type="str", default=None,
    doc="git describe string CI stamps into artifact provenance headers")
K_PERFGATE_HOST_CLASS = register(
    "DYN_PERFGATE_HOST_CLASS", type="str", default=None,
    doc="host-class label stamped into artifact provenance (default: the "
        "card's name, `cpu` without one)")

# -- the SDK's supervisor and GPU allocator (sdk/) -----------------------------
K_GPU_COUNT = register(
    "DYN_GPU_COUNT", type="int", default=None,
    doc="explicit GPU inventory for the SDK allocator (overrides detection)")
K_GPUS = register(
    "DYN_GPUS", type="str", default=None,
    doc="comma-separated GPU indices handed to one replica (written by the "
        "allocator into child environments)")
K_REPLICA_INDEX = register(
    "DYN_REPLICA_INDEX", type="int", default=None,
    doc="replica ordinal the SDK supervisor assigns to each child process")
K_DISABLE_AUTO_GPU_ALLOCATION = register(
    "DYN_DISABLE_AUTO_GPU_ALLOCATION", type="bool", default=False,
    doc="opt a deployment out of automatic per-replica GPU partitioning")
K_SERVICE_CONFIG = register(
    "DYN_SERVICE_CONFIG", type="str", default=None,
    doc="path to the service-graph YAML the operator mounts into pods")
