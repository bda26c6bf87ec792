"""Tensor ops: plain PyTorch versions (norms, rope, attention, sampling) and,
under ``kernels``, the hand-written CUDA kernels that replace the
reference's Pallas kernels."""
