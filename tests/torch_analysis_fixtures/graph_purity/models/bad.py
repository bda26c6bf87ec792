"""Fixture: graph-purity host-sync findings fire here (bad twin of good.py)."""
import time

import numpy as np
import torch


def step(params, x):
    log(x)
    return x * scale_of(params)


def log(x):
    print(x.shape)                  # host-sync: print at capture, via step


def scale_of(params):
    return params["scale"].item()   # host-sync: .item(), via step


def unified(x):
    torch.cuda.synchronize()        # host-sync: explicit sync
    return np.asarray(x.cpu())      # host-sync twice: np.asarray and .cpu()


def embed(table, ids):
    t0 = time.perf_counter()        # host-sync: read once, at capture
    rows = ids.tolist()             # host-sync: .tolist()
    return table[rows], t0


def load(path):
    # not a graph root (load_weights is no forward field): host work is fine
    return torch.load(path).numpy()
