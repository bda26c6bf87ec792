"""Fixture: the capture module; the names it imports from ops/sampling.py
are the sampling tail's roots."""
from ops.sampling import penalize, sample


def capture(logits):
    return sample(penalize(logits))
