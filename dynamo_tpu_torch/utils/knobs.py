"""Typed registry and the single read path for the port's ``DYN_*`` knobs
(counterpart of dynamo_tpu/utils/knobs.py).

The port registers only the knobs its own modules read, under the
reference's names, types and defaults, and reads them through :func:`get`.
Registrations are *literal* ``register(...)`` calls on purpose: the
``knob-registry`` pass of ``python -m dynamo_tpu_torch.scripts.dynlint``
parses this module's AST, flags a raw ``DYN_*`` environment read anywhere
else in the package, and a knob missing from the port's knob page
(``dynamo_tpu_torch/KNOBS.md``, which ``--knob-table`` prints).

Semantics (as the reference's):

- ``bool`` knobs parse ``1/true/yes/on`` as True and ``0/false/off/no`` (or
  empty) as False; any other token falls back to the default.  A
  ``default=None`` bool is tri-state: unset returns ``None``.
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

# the knob page's sections (the reference's four docs pages)
OBS = "observability"
PERF = "performance"
ROBUST = "robustness"
ARCH = "architecture"
SECTIONS = {
    ARCH: ("Runtime & deployment plumbing",
           "Control-plane selection, artifact caching, model resolution, the "
           "native codecs, and the SDK allocator/supervisor contract."),
    OBS: ("Observability",
          "Logging, tracing, profiling, utilization, SLO objectives, the "
          "flight recorder and the perf gate."),
    PERF: ("Engine & performance",
           "The engine's phase timing, the kernel autotuner, predictive "
           "prefetch, disaggregated KV transfer, the mesh, and the headline "
           "bench's settings."),
    ROBUST: ("Robustness & routing",
             "Fault injection, reconnect/retry policy, rendezvous budgets, "
             "resume and migration, and the admission gate."),
}


@dataclass(frozen=True)
class Knob:
    name: str
    type: str  # "str" | "int" | "float" | "bool"
    default: Any
    doc: str
    section: str  # the knob page's section that carries its table row


_REGISTRY: dict[str, Knob] = {}


def register(
    name: str, *, type: str = "str", default: Any = None, doc: str = "",
    section: str = OBS,
) -> str:
    """Declare one knob; returns the name so modules can bind constants."""
    if name in _REGISTRY:
        raise ValueError(f"knob {name} registered twice")
    if type not in ("str", "int", "float", "bool"):
        raise ValueError(f"knob {name}: unknown type {type!r}")
    if not doc:
        raise ValueError(f"knob {name}: doc string is required")
    if section not in SECTIONS:
        raise ValueError(f"knob {name}: unknown section {section!r}")
    _REGISTRY[name] = Knob(name=name, type=type, default=default, doc=doc, section=section)
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


def knob_table(section: str | None = None) -> str:
    """Markdown table rows for the knob page (``--knob-table SECTION``)."""
    rows = ["| knob | type | default | purpose |", "|---|---|---|---|"]
    for knob in all_knobs():
        if section is not None and knob.section != section:
            continue
        default = "unset" if knob.default is None else f"`{knob.default}`"
        rows.append(f"| `{knob.name}` | {knob.type} | {default} | {knob.doc} |")
    return "\n".join(rows)


def knob_page() -> str:
    """The port's knob page, ``dynamo_tpu_torch/KNOBS.md``, whole
    (``python -m dynamo_tpu_torch.scripts.dynlint --knob-table``)."""
    parts = [
        "# The port's configuration knobs (`DYN_*`)",
        "",
        "Every environment variable `dynamo_tpu_torch` reads is declared once "
        "in `dynamo_tpu_torch/utils/knobs.py` (name, type, default, purpose) "
        "and read through `knobs.get(...)`.  This page is generated: "
        "`python -m dynamo_tpu_torch.scripts.dynlint --knob-table > "
        "dynamo_tpu_torch/KNOBS.md`.  The `knob-registry` pass of `python -m "
        "dynamo_tpu_torch.scripts.dynlint --check` fails on a raw `DYN_*` "
        "read, a `knobs.get` of an undeclared name, or a knob missing here.",
        "",
        "- **bool**: `1/true/yes/on` on, `0/false/off/no`/empty off, anything "
        "else the default; a default of `unset` is tri-state.",
        "- **int/float**: unset or unparseable values give the default.",
        "- **str**: the raw value (the reader validates it).",
    ]
    for section, (title, blurb) in SECTIONS.items():
        parts += ["", f"## {title}", "", blurb, "", knob_table(section)]
    return "\n".join(parts) + "\n"


# -- logging / profiling (utils/logging.py, utils/profiling.py, engine/) -----
K_LOG = register(
    "DYN_LOG", type="str", default="info",
    doc="log filter spec, e.g. `warn,dynamo_tpu_torch.runtime=debug`", section=OBS)
K_LOGGING_JSONL = register(
    "DYN_LOGGING_JSONL", type="bool", default=False,
    doc="emit JSONL log records with structured fields merged in", section=OBS)
K_PROFILER_TRACE_DIR = register(
    "DYN_PROFILER_TRACE_DIR", type="str", default=None,
    doc="capture a torch.profiler trace of the whole engine serve window here "
        "(`trace_<pid>_<n>.json.gz`, written at the engine's stop)", section=OBS)
K_ENGINE_PHASE_TIMING = register(
    "DYN_ENGINE_PHASE_TIMING", type="bool", default=False,
    doc="host-side decode phase timing in `stats()[\"phase_ms\"]`", section=OBS)

# -- utilization (observability/perf.py) ---------------------------------------
K_UTIL_WINDOW_S = register(
    "DYN_UTIL_WINDOW_S", type="float", default=10.0,
    doc="rolling window for MFU/MBU/goodput rates", section=OBS)
K_PEAK_TFLOPS = register(
    "DYN_PEAK_TFLOPS", type="float", default=None,
    doc="hardware peak TFLOP/s for the MFU denominator (overrides the "
        "device-kind table)", section=OBS)
K_PEAK_GBPS = register(
    "DYN_PEAK_GBPS", type="float", default=None,
    doc="hardware peak GB/s for the MBU denominator (overrides the "
        "device-kind table)", section=OBS)

# -- tracing (observability/recorder.py) -------------------------------------
K_TRACE_BUFFER = register(
    "DYN_TRACE_BUFFER", type="int", default=4096, doc="span ring-buffer size", section=OBS)
K_TRACE_JSONL = register(
    "DYN_TRACE_JSONL", type="str", default=None, doc="live JSONL span export path", section=OBS)
K_TRACE_MAX_BYTES = register(
    "DYN_TRACE_MAX_BYTES", type="int", default=0,
    doc="rotate the JSONL span export at this size (0 = unbounded)", section=OBS)

# -- perf flight recorder (observability/flight.py) ---------------------------
K_FLIGHT = register(
    "DYN_FLIGHT", type="bool", default=True,
    doc="always-on perf flight recorder; `0` is bookkeeping-free", section=OBS)
K_FLIGHT_BUFFER_BYTES = register(
    "DYN_FLIGHT_BUFFER_BYTES", type="int", default=262144,
    doc="byte budget of the flight-recorder ring", section=OBS)
K_FLIGHT_DIR = register(
    "DYN_FLIGHT_DIR", type="str", default=None,
    doc="directory flight dumps are written to (default "
        "`$DYN_CACHE_DIR/flight` or `~/.cache/dynamo_tpu_torch/flight`)", section=OBS)
K_FLIGHT_BURN = register(
    "DYN_FLIGHT_BURN", type="float", default=10.0,
    doc="worst-window SLO burn rate above which the recorder auto-dumps", section=OBS)

# -- robustness / routing (robustness/, runtime/) -----------------------------
K_FAULTS = register(
    "DYN_FAULTS", type="str", default="",
    doc="chaos fault-injection schedule spec", section=ROBUST)
K_CP_RECONNECT = register(
    "DYN_CP_RECONNECT", type="bool", default=True,
    doc="self-healing control-plane client; `0` restores fail-fast", section=ROBUST)
K_CP_RECONNECT_BACKOFF_S = register(
    "DYN_CP_RECONNECT_BACKOFF_S", type="float", default=0.05,
    doc="initial control-plane reconnect backoff", section=ROBUST)
K_CP_RECONNECT_BACKOFF_MAX_S = register(
    "DYN_CP_RECONNECT_BACKOFF_MAX_S", type="float", default=2.0,
    doc="cap on the control-plane reconnect backoff", section=ROBUST)
K_RETRY_MAX = register(
    "DYN_RETRY_MAX", type="int", default=1,
    doc="pre-first-token re-dispatch attempts for a failed stream", section=ROBUST)
K_CONNECT_TIMEOUT_S = register(
    "DYN_CONNECT_TIMEOUT_S", type="float", default=30.0,
    doc="data-plane rendezvous (connect-back) timeout per attempt", section=ROBUST)
K_DARK_WORKER_TTL_S = register(
    "DYN_DARK_WORKER_TTL_S", type="float", default=30.0,
    doc="quarantine TTL for an instance that failed a rendezvous", section=ROBUST)
K_DARK_PROBE_TIMEOUT_S = register(
    "DYN_DARK_PROBE_TIMEOUT_S", type="float", default=5.0,
    doc="short probe window for quarantined instances (and for waiting out "
        "an empty instance view)", section=ROBUST)
K_RENDEZVOUS_BUDGET_S = register(
    "DYN_RENDEZVOUS_BUDGET_S", type="float", default=0.0,
    doc="hard cap on total rendezvous time across failovers (0 = 3x the "
        "connect timeout)", section=ROBUST)
K_RESUME = register(
    "DYN_RESUME", type="bool", default=True,
    doc="mid-stream resume: re-dispatch a failed stream with a `resume_from` "
        "journal instead of truncating", section=ROBUST)
K_RESUME_JOURNAL_MAX_ITEMS = register(
    "DYN_RESUME_JOURNAL_MAX_ITEMS", type="int", default=4096,
    doc="max accepted tokens a GenerationJournal retains per request "
        "(0 = unbounded)", section=ROBUST)
K_MIGRATE = register(
    "DYN_MIGRATE", type="bool", default=True,
    doc="live session migration: the dispatcher may move an in-flight decode "
        "to another worker; `0` disables the coordinator entirely", section=ROBUST)
K_MIGRATE_FLIP_TIMEOUT_S = register(
    "DYN_MIGRATE_FLIP_TIMEOUT_S", type="float", default=10.0,
    doc="max seconds a migration waits for the consumer loop to commit the "
        "stream flip before aborting back to the source", section=ROBUST)
K_DRAIN_TIMEOUT_S = register(
    "DYN_DRAIN_TIMEOUT_S", type="float", default=30.0,
    doc="graceful drain budget: in-flight work gets this long to finish or "
        "hand off before cancellation", section=ROBUST)

# -- SLO tracking (observability/slo.py) --------------------------------------
K_SLO_TTFT_S = register(
    "DYN_SLO_TTFT_S", type="float", default=2.0,
    doc="TTFT objective threshold (seconds)", section=OBS)
K_SLO_TTFT_TARGET = register(
    "DYN_SLO_TTFT_TARGET", type="float", default=0.99,
    doc="good fraction required for TTFT", section=OBS)
K_SLO_ITL_S = register(
    "DYN_SLO_ITL_S", type="float", default=0.2,
    doc="inter-token-latency objective threshold (seconds)", section=OBS)
K_SLO_ITL_TARGET = register(
    "DYN_SLO_ITL_TARGET", type="float", default=0.99,
    doc="good fraction required for ITL", section=OBS)
K_SLO_ERROR_TARGET = register(
    "DYN_SLO_ERROR_TARGET", type="float", default=0.999,
    doc="request success-rate objective", section=OBS)
K_SLO_WINDOWS = register(
    "DYN_SLO_WINDOWS", type="str", default="",
    doc="comma-separated burn-rate windows in seconds (default `300,3600`)", section=OBS)
K_SLO_SHED_BURN = register(
    "DYN_SLO_SHED_BURN", type="float", default=0.0,
    doc="burn rate above which a saturated admission gate sheds (0 = off)", section=OBS)

# -- frontend admission control (robustness/admission.py) ---------------------
K_ADMISSION_MAX_INFLIGHT = register(
    "DYN_ADMISSION_MAX_INFLIGHT", type="int", default=0,
    doc="frontend admission gate: max in-flight requests (0 = off)", section=ROBUST)
K_ADMISSION_QUEUE = register(
    "DYN_ADMISSION_QUEUE", type="int", default=None,
    doc="admission queue depth (default: 2x max in-flight)", section=ROBUST)
K_ADMISSION_QUEUE_TIMEOUT_S = register(
    "DYN_ADMISSION_QUEUE_TIMEOUT_S", type="float", default=2.0,
    doc="max seconds a request may wait in the admission queue", section=ROBUST)
K_ADMISSION_RETRY_AFTER_S = register(
    "DYN_ADMISSION_RETRY_AFTER_S", type="float", default=1.0,
    doc="Retry-After hint attached to shed (429) responses", section=ROBUST)

# -- predictive prefetch (prefetch/, engine/offload.py) -----------------------
K_PREFETCH = register(
    "DYN_PREFETCH", type="bool", default=True,
    doc="master prefetch gate; `0` restores demand-driven paging everywhere", section=PERF)
K_PREFETCH_TTL = register(
    "DYN_PREFETCH_TTL", type="float", default=30.0,
    doc="seconds before an unexecuted prefetch hint goes stale", section=PERF)
K_PREFETCH_BLOCKS = register(
    "DYN_PREFETCH_BLOCKS", type="int", default=64,
    doc="max blocks paged per engine-loop iteration while serving", section=PERF)
K_PREFETCH_HEADROOM = register(
    "DYN_PREFETCH_HEADROOM", type="float", default=0.05,
    doc="fraction of device cache blocks reserved from prefetch", section=PERF)
K_PREFETCH_HINT_CHARS = register(
    "DYN_PREFETCH_HINT_CHARS", type="int", default=16384,
    doc="frontend arrival hints tokenize at most this much rendered text", section=PERF)
K_PREFETCH_PIN_HITS = register(
    "DYN_PREFETCH_PIN_HITS", type="int", default=3,
    doc="restores before a block hash becomes a pin candidate", section=PERF)
K_PREFETCH_PIN_MAX = register(
    "DYN_PREFETCH_PIN_MAX", type="int", default=None,
    doc="max pinned host blocks (default: host blocks / 4)", section=PERF)

# -- runtime plumbing (utils/config.py, llm/hub.py) ---------------------------
K_CONTROL_PLANE = register(
    "DYN_CONTROL_PLANE", type="str", default="memory",
    doc="control-plane backend (`memory` or `host:port` of a dynctl server)", section=ARCH)
K_CACHE_DIR = register(
    "DYN_CACHE_DIR", type="str", default=None,
    doc="artifact/cache directory (default `~/.cache/dynamo_tpu_torch`)", section=ARCH)
K_OFFLINE = register(
    "DYN_OFFLINE", type="bool", default=False,
    doc="never download model artifacts; fail fast on a cache miss", section=ARCH)
K_DISABLE_NATIVE = register(
    "DYN_DISABLE_NATIVE", type="bool", default=False,
    doc="skip the native (C++) data-plane codec and use pure Python", section=ARCH)
K_ALLOW_PRIVATE_IMAGE_URLS = register(
    "DYN_ALLOW_PRIVATE_IMAGE_URLS", type="bool", default=False,
    doc="allow multimodal image fetches from private/internal addresses", section=ARCH)

# -- disaggregated prefill/decode (llm/disagg.py, parallel/kv_transfer.py) ----
K_KV_STREAM = register(
    "DYN_KV_STREAM", type="bool", default=True,
    doc="streamed multi-part disagg KV transfer; `0` = single-shot", section=PERF)
K_TRANSFER_HOP = register(
    "DYN_TRANSFER_HOP", type="str", default="",
    doc="explicit override of the worker's *discovered* hop class "
        "(`local`|`ici`|`dcn`) published to the router's transfer-cost "
        "model (unset: the topology plane's classification wins)", section=PERF)
K_DISAGG_PREFILL_TIMEOUT_S = register(
    "DYN_DISAGG_PREFILL_TIMEOUT_S", type="float", default=300.0,
    doc="decode-side wait for the KV stream before falling back to local "
        "prefill", section=PERF)
K_DISAGG_CLOCK_SKEW_S = register(
    "DYN_DISAGG_CLOCK_SKEW_S", type="float", default=30.0,
    doc="tolerated cross-host clock skew when judging queued-prefill "
        "staleness", section=PERF)
K_KV_DIAL_TIMEOUT_S = register(
    "DYN_KV_DIAL_TIMEOUT_S", type="float", default=5.0,
    doc="KV-transfer pool dial timeout per connection attempt (a black-holed "
        "peer fails the send instead of blocking forever)", section=PERF)

# -- fleet topology plane (topology/) -----------------------------------------
K_TOPO = register(
    "DYN_TOPO", type="bool", default=True,
    doc="master topology-plane gate: card publication, map watching, and "
        "probing; `0` restores the env-knob-only link model", section=PERF)
K_TOPO_SLICE = register(
    "DYN_TOPO_SLICE", type="str", default="",
    doc="explicit slice label for this worker's TopologyCard (on a GPU host "
        "nothing else sets one; used to emulate multi-slice fleets)", section=PERF)
K_TOPO_PROBE_PERIOD_S = register(
    "DYN_TOPO_PROBE_PERIOD_S", type="float", default=10.0,
    doc="seconds between topology probe ticks (0 disables active probing; "
        "passive KvTransferClient EWMAs still feed the map)", section=PERF)
K_TOPO_PROBE_BYTES = register(
    "DYN_TOPO_PROBE_BYTES", type="int", default=65536,
    doc="payload size of one topology bandwidth probe", section=PERF)
K_TOPO_PROBE_MAX_PER_TICK = register(
    "DYN_TOPO_PROBE_MAX_PER_TICK", type="int", default=4,
    doc="max peers probed per tick (round-robin across the fleet)", section=PERF)

# -- tensor and expert parallelism (parallel/mesh.py, engine/shard_worker.py) --
K_MESH_BACKEND = register(
    "DYN_MESH_BACKEND", type="str", default="",
    doc="process-group backend of an engine mesh: `nccl` (a card a rank) or "
        "`gloo`; empty = nccl on cards, gloo on the CPU.  Ranks share a card "
        "only over gloo named here or by the caller", section=PERF)
K_MESH_TIMEOUT_S = register(
    "DYN_MESH_TIMEOUT_S", type="float", default=120.0,
    doc="seconds a mesh collective waits before it raises: a dead or hung "
        "rank ends the others' wait (an idle engine pings its shard workers "
        "every quarter of it)", section=PERF)

# -- the ragged kernel's autotuned layout (ops/autotune.py, engine/engine.py) --
K_KERNEL_PERF = register(
    "DYN_KERNEL_PERF", type="str", default=None,
    doc="explicit path to the port's kernel-perf table (default: "
        "`dynamo_tpu_torch/KERNEL_PERF_CUDA.json`, absent until a tuning run "
        "writes it; never the repo-root TPU table)", section=PERF)
K_AUTOTUNE = register(
    "DYN_AUTOTUNE", type="bool", default=True,
    doc="consult the kernel-perf table's autotune rows for the ragged "
        "kernel's layout at engine init; `0` keeps the heuristic defaults", section=PERF)
K_AUTOTUNE_TB = register(
    "DYN_AUTOTUNE_TB", type="int", default=None,
    doc="force the ragged kernel's token-block size (overrides tuned rows; "
        "must divide every serving bucket or it falls back with a warning)", section=PERF)
K_AUTOTUNE_PAGE_SLOTS = register(
    "DYN_AUTOTUNE_PAGE_SLOTS", type="int", default=None,
    doc="force the packed page-worklist width (overflowing windows repack "
        "at the full width and count in "
        "`stats()[\"unified_ps_overflows_total\"]`)", section=PERF)
K_AUTOTUNE_PAGES_PER_STEP = register(
    "DYN_AUTOTUNE_PAGES_PER_STEP", type="int", default=None,
    doc="force KV pages fetched per ragged grid step (must divide "
        "page_slots; the port's kernels accept it and ignore it)", section=PERF)

# -- perf regression gate (bench/perfgate.py) ---------------------------------
K_PERFGATE_BASELINE = register(
    "DYN_PERFGATE_BASELINE", type="str", default=None,
    doc="explicit baseline path for `python -m dynamo_tpu_torch.bench.perfgate` "
        "(default: `PERF_BASELINE_CUDA.json` beside the artifacts)", section=OBS)
K_PERFGATE_GIT_DESCRIBE = register(
    "DYN_PERFGATE_GIT_DESCRIBE", type="str", default=None,
    doc="git describe string CI stamps into artifact provenance headers", section=OBS)
K_PERFGATE_HOST_CLASS = register(
    "DYN_PERFGATE_HOST_CLASS", type="str", default=None,
    doc="host-class label stamped into artifact provenance (default: the "
        "card's name, `cpu` without one)", section=OBS)

# -- the SDK's supervisor and GPU allocator (sdk/) -----------------------------
K_GPU_COUNT = register(
    "DYN_GPU_COUNT", type="int", default=None,
    doc="explicit GPU inventory for the SDK allocator (overrides detection)", section=ARCH)
K_GPUS = register(
    "DYN_GPUS", type="str", default=None,
    doc="comma-separated GPU indices handed to one replica (written by the "
        "allocator into child environments)", section=ARCH)
K_REPLICA_INDEX = register(
    "DYN_REPLICA_INDEX", type="int", default=None,
    doc="replica ordinal the SDK supervisor assigns to each child process", section=ARCH)
K_DISABLE_AUTO_GPU_ALLOCATION = register(
    "DYN_DISABLE_AUTO_GPU_ALLOCATION", type="bool", default=False,
    doc="opt a deployment out of automatic per-replica GPU partitioning", section=ARCH)
K_SERVICE_CONFIG = register(
    "DYN_SERVICE_CONFIG", type="str", default=None,
    doc="path to the service-graph YAML the operator mounts into pods", section=ARCH)

# -- the headline bench (bench/headline.py) -----------------------------------
# raw strings: the headline validates each and refuses a bad value by name
# before it builds an engine; unset, each takes the card's or the CPU's
# default (bench.py's contract)
K_BENCH_DEVICE = register(
    "DYN_BENCH_DEVICE", type="str", default=None,
    doc="headline bench device, `cuda` (unset) or `cpu`", section=PERF)
K_BENCH_MODEL = register(
    "DYN_BENCH_MODEL", type="str", default=None,
    doc="headline bench `LlamaConfig` preset (unset: `llama3_8b` on the card, "
        "`tiny` on the CPU)", section=PERF)
K_BENCH_QUANT = register(
    "DYN_BENCH_QUANT", type="str", default=None,
    doc="headline bench weights, `int8` or `none` (unset: int8 on the card)",
    section=PERF)
K_BENCH_KV_DTYPE = register(
    "DYN_BENCH_KV_DTYPE", type="str", default=None,
    doc="headline bench cache dtype; `model`/`none` = the model's (unset: "
        "fp8 on the card)", section=PERF)
K_BENCH_INIT = register(
    "DYN_BENCH_INIT", type="str", default=None,
    doc="headline bench weights, `const` (unset) or `random`", section=PERF)
K_BENCH_REQUESTS = register(
    "DYN_BENCH_REQUESTS", type="str", default=None,
    doc="headline bench requests (unset: 32 on the card, 8 on the CPU)",
    section=PERF)
K_BENCH_ISL = register(
    "DYN_BENCH_ISL", type="str", default=None,
    doc="headline bench prompt tokens (unset: 3000 / 64)", section=PERF)
K_BENCH_OSL = register(
    "DYN_BENCH_OSL", type="str", default=None,
    doc="headline bench output tokens (unset: 150 / 32)", section=PERF)
K_BENCH_BATCH = register(
    "DYN_BENCH_BATCH", type="str", default=None,
    doc="headline bench lanes (unset: 16 / 4)", section=PERF)
K_BENCH_DECODE_STEPS = register(
    "DYN_BENCH_DECODE_STEPS", type="str", default=None,
    doc="headline bench fused decode steps (unset: 8 / 4)", section=PERF)
K_BENCH_CHUNK = register(
    "DYN_BENCH_CHUNK", type="str", default=None,
    doc="headline bench prefill chunk tokens, 0 = whole prompts (unset: 512 "
        "on the card, 0 on the CPU)", section=PERF)
K_BENCH_BLOCKS = register(
    "DYN_BENCH_BLOCKS", type="str", default=None,
    doc="headline bench cache blocks (unset: a lane's blocks x lanes + 32)",
    section=PERF)
