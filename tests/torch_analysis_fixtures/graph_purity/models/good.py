"""Fixture: graph-purity-clean twin of bad.py — no rule may fire."""
import torch


def step(params, x):
    return helper(x) + 1


def helper(x):
    return torch.sum(x, dim=-1)


def prefill(params, x):
    # dynlint: disable=graph-purity -- fixture: a CPU tensor of a host constant
    scale = torch.tensor(2.0).item()
    return x * scale


def host_readback(x):
    # not reachable from any graph root: host syncing here is fine
    return x.cpu().numpy().item()
