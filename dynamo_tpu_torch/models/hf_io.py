"""Shared HF-checkpoint IO for the model families.

Reads sharded ``*.safetensors`` into one name→tensor dict on the host (the
counterpart of dynamo_tpu/models/hf_io.py, read as torch tensors so that
bf16 checkpoints load as they are)."""

from __future__ import annotations

from pathlib import Path

import torch


def read_safetensors(model_dir: str | Path) -> dict[str, torch.Tensor]:
    from safetensors import safe_open

    model_dir = Path(model_dir)
    files = sorted(model_dir.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors in {model_dir}")
    tensors: dict[str, torch.Tensor] = {}
    for file in files:
        with safe_open(str(file), framework="pt") as f:
            for name in f.keys():
                tensors[name] = f.get_tensor(name)
    return tensors
