"""Layered runtime configuration.

Mirrors the reference's Figment layering (reference: lib/runtime/src/config.rs:80-115):
dataclass defaults < config file (YAML) < environment (``DYN_<PREFIX>_<FIELD>``).
PyYAML is imported only where a YAML file is read.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, fields
from pathlib import Path
from typing import Any, Type, TypeVar

from dynamo_tpu_torch.utils import knobs

T = TypeVar("T")


def _coerce(value: str, typ: Any) -> Any:
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    return value


def load_config(
    cls: Type[T],
    *,
    env_prefix: str,
    config_file: str | Path | None = None,
    overrides: dict[str, Any] | None = None,
) -> T:
    """Build ``cls`` (a dataclass) from defaults, then file, then env, then overrides."""
    values: dict[str, Any] = {}
    if config_file is not None and Path(config_file).exists():
        import yaml

        with open(config_file) as f:
            data = yaml.safe_load(f) or {}
        if not isinstance(data, dict):
            raise ValueError(f"config file {config_file} must contain a mapping")
        values.update(data)

    for field in fields(cls):  # type: ignore[arg-type]
        env_key = f"{env_prefix}_{field.name.upper()}"
        if env_key in os.environ:
            typ = field.type if isinstance(field.type, type) else None
            if typ is None:
                # string annotations: resolve common scalars by default value type
                default = field.default if field.default is not dataclasses.MISSING else None
                typ = type(default) if default is not None else str
            values[field.name] = _coerce(os.environ[env_key], typ)

    if overrides:
        values.update({k: v for k, v in overrides.items() if v is not None})

    known = {f.name for f in fields(cls)}  # type: ignore[arg-type]
    values = {k: v for k, v in values.items() if k in known}
    return cls(**values)


@dataclass
class RuntimeConfig:
    """Top-level runtime knobs (reference: lib/runtime/src/config.rs:31-52)."""

    # Control-plane (discovery + messaging) endpoint, ``host:port`` of a
    # dynctl server, or "memory" for fully in-process static/dev mode.
    control_plane: str = knobs.get("DYN_CONTROL_PLANE")
    # Worker identity
    namespace: str = "dynamo"
    # Graceful shutdown drain window (seconds)
    graceful_shutdown_timeout: float = 30.0
    # TCP data-plane bind host for response streams
    data_host: str = "127.0.0.1"
    data_port: int = 0  # 0 = ephemeral

    @classmethod
    def from_env(cls, **overrides: Any) -> "RuntimeConfig":
        return load_config(cls, env_prefix="DYN_RUNTIME", overrides=overrides)
