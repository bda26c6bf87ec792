"""Structured logging for dynamo_tpu_torch.

Design mirrors the reference's tracing setup (reference: lib/runtime/src/logging.rs:62,
env filter + optional JSONL output) with Python stdlib logging:

- ``DYN_LOG``          — filter spec, e.g. ``info``, ``debug``,
  ``warn,dynamo_tpu_torch.runtime=debug`` (comma-separated ``target=level`` pairs).
- ``DYN_LOGGING_JSONL``— if set truthy, emit one JSON object per line.
"""

from __future__ import annotations

import json
import logging
import sys
import time

from dynamo_tpu_torch.utils import knobs

_LEVELS = {
    "trace": 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

_configured = False

logging.addLevelName(5, "TRACE")


class JsonlFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "time": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info and record.exc_info[0] is not None:
            entry["exception"] = self.formatException(record.exc_info)
        extra = getattr(record, "fields", None)
        if extra:
            entry.update(extra)
        return json.dumps(entry, default=str)


class TextFormatter(logging.Formatter):
    default_msec_format = "%s.%03d"

    def __init__(self) -> None:
        super().__init__(
            fmt="%(asctime)s %(levelname)5s %(name)s: %(message)s",
            datefmt="%H:%M:%S",
        )

    def format(self, record: logging.LogRecord) -> str:
        line = super().format(record)
        fields = getattr(record, "fields", None)
        if fields:
            # same structured fields the JSONL formatter emits, rendered as
            # trailing key=value pairs (request_id correlation in text logs)
            line += " " + " ".join(f"{k}={v}" for k, v in fields.items())
        return line


def _parse_filter(spec: str) -> tuple[int, dict[str, int]]:
    """Parse ``warn,dynamo_tpu_torch.runtime=debug`` into (root_level, {target: level})."""
    root = logging.INFO
    targets: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            target, _, lvl = part.partition("=")
            targets[target.strip()] = _LEVELS.get(lvl.strip().lower(), logging.INFO)
        else:
            root = _LEVELS.get(part.lower(), logging.INFO)
    return root, targets


def configure_logging(level: str | None = None, *, force: bool = False) -> None:
    """Idempotent logging init from DYN_LOG / DYN_LOGGING_JSONL env."""
    global _configured
    if _configured and not force:
        return
    _configured = True

    spec = level or knobs.get("DYN_LOG") or "info"
    root_level, targets = _parse_filter(spec)
    jsonl = knobs.get("DYN_LOGGING_JSONL")

    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(JsonlFormatter() if jsonl else TextFormatter())

    root = logging.getLogger("dynamo_tpu_torch")
    root.handlers.clear()
    root.addHandler(handler)
    root.setLevel(root_level)
    root.propagate = False
    for target, lvl in targets.items():
        logging.getLogger(target).setLevel(lvl)


def log_fields(**fields) -> dict:
    """``extra=`` payload attaching structured fields to a log record:
    ``logger.info("done", extra=log_fields(request_id=rid))`` — JSONL output
    merges them into the object, text output appends ``k=v`` pairs."""
    return {"fields": fields}


def get_logger(name: str) -> logging.Logger:
    configure_logging()
    if not name.startswith("dynamo_tpu_torch"):
        name = f"dynamo_tpu_torch.{name}"
    return logging.getLogger(name)
