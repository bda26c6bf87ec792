"""Fixture: the sampling tail (one root syncs, one does not, and a helper
the capture module does not import may)."""
import torch


def sample(logits):
    return torch.argmax(logits, dim=-1)


def penalize(logits):
    return logits - logits.numpy().mean()   # host-sync: .numpy(), a tail root


def debug_dump(logits):
    return logits.tolist()   # not imported by the capture module: fine
