"""Pipeline parallelism over the ``pp`` mesh axis (counterpart of
dynamo_tpu/parallel/pipeline.py).

The families stack their layer weights and cache on a leading layer axis,
and the ``pp`` entry of their specs splits it: stage s holds layers
``[s*L/S, (s+1)*L/S)`` and their cache.  ``pipeline_layer_stack`` runs a
decode batch through the stages GPipe-style: the batch splits into
microbatches, each goes through stage 0's layers, then stage 1's, and so
on, the activations handed from a stage to the same tp rank of the next
one point to point (the reference's ``ppermute``), and the last stage's
outputs come back to every stage.  ``stage_layer_stack`` is the one-
microbatch case, the prefill's: the counterpart of GSPMD running the
reference's plain forward over pp-sharded layers.

The reference's stages run ``S + M - 1`` ticks in lockstep, a stage outside
its microbatches computing on stale activations and masking its cache
writes.  Here a stage runs only its ``M`` active ticks: it waits for its
microbatch's activations, runs its layers and posts them on without
waiting for them to land.  The same function, with no work in the bubble.
"""

from __future__ import annotations

from typing import Callable

import torch

from dynamo_tpu_torch.parallel.mesh import Mesh, exchange, mesh_size, post_sends, stage_peer


def _through_stages(run: Callable, x: torch.Tensor, m_count: int, mesh: Mesh | None,
                    axis: str) -> torch.Tensor:
    """``run(m, x_m)`` (this stage's layers on microbatch m) over the
    microbatches of ``x`` in order, each microbatch from the previous stage
    (stage 0: its own rows), each output to the next stage; the last
    stage's outputs, concatenated, on every stage."""
    mb = x.shape[0] // m_count
    stages = mesh_size(mesh, axis)
    if stages == 1:
        outs = [run(m, x[m * mb:(m + 1) * mb]) for m in range(m_count)]
        return outs[0] if m_count == 1 else torch.cat(outs)
    stage, last = mesh.index(axis), stages - 1
    posted, outs = [], []
    for m in range(m_count):
        if stage == 0:
            x_m = x[m * mb:(m + 1) * mb]
        else:
            x_m = exchange([], [(x[:mb], stage_peer(mesh, -1, axis))], mesh)[0]
        y = run(m, x_m)
        if stage < last:
            posted.append(post_sends([(y, stage_peer(mesh, 1, axis))], mesh))
        else:
            outs.append(y)
    if stage == last:
        out = outs[0] if m_count == 1 else torch.cat(outs)
        posted.append(post_sends([(out, stage_peer(mesh, s - last, axis))
                                  for s in range(last)], mesh))
    else:
        out = exchange([], [(x, stage_peer(mesh, last - stage, axis))], mesh)[0]
    for p in posted:
        p.wait()
    return out


def _split(t: torch.Tensor, m: int, mb: int) -> torch.Tensor:
    return t[m * mb:(m + 1) * mb]


def pipeline_layer_stack(
    body: Callable,
    x: torch.Tensor,       # [B, ...] the activations entering layer 0
    aux: tuple,            # [B, ...] per-row side inputs
    layer_params: dict,    # this stage's stacked leaves, leading axis L / S
    mesh: Mesh | None,
    *,
    axis: str = "pp",
    microbatches: int | None = None,
) -> torch.Tensor:
    """``x`` through every layer of the model, pipelined over ``axis``.

    ``body(x_mb, aux_mb, i, w) -> x_mb`` applies this stage's layer ``i``
    (its weights ``w``: one slice of ``layer_params``) to one microbatch;
    the layer's cache is the body's, written in place (the reference
    threads it through as ``layer_cache``).  The batch splits into
    ``microbatches`` (default the stage count) equal parts.  On stages past
    the first, ``x``'s values are not read, only its shape and dtype: the
    activations come from the previous stage.  Returns ``[B, ...]``, the
    last layer's output, on every stage."""
    stages = mesh_size(mesh, axis)
    batch = x.shape[0]
    m_count = microbatches or stages
    if batch % m_count:
        raise ValueError(f"batch {batch} not divisible by {m_count} microbatches")
    mb = batch // m_count
    n_local = next(iter(layer_params.values())).shape[0]

    def run(m: int, x_m: torch.Tensor) -> torch.Tensor:
        aux_m = tuple(_split(a, m, mb) for a in aux) if m_count > 1 else aux
        for i in range(n_local):
            x_m = body(x_m, aux_m, i, {name: leaf[i] for name, leaf in layer_params.items()})
        return x_m

    return _through_stages(run, x, m_count, mesh, axis)


def stage_layer_stack(run_layers: Callable, x: torch.Tensor, mesh: Mesh | None,
                      axis: str = "pp") -> torch.Tensor:
    """``x`` through every stage in order, one hand-off a stage:
    ``run_layers(x)`` runs this rank's layers.  Stage 0's ``x`` enters the
    first layer; on the other stages only its shape and dtype are read.
    Returns the last stage's output on every stage; ``run_layers(x)``
    itself off a pp mesh."""
    return _through_stages(lambda _m, x_m: run_layers(x_m), x, 1, mesh, axis)


def first_stage(mesh: Mesh | None, axis: str = "pp") -> bool:
    """This rank is on stage 0 (where the embedding and the head run), or
    there are no stages."""
    return mesh_size(mesh, axis) == 1 or mesh.index(axis) == 0


def stage_specs(specs: dict, mesh: Mesh | None) -> dict:
    """``specs`` with the layer axis of every stacked layer leaf on pp where
    the family leaves it unsharded (Mixtral's, Qwen3-MoE's): a stage holds
    its own layers.  The reference replicates those layers and its pipeline
    reshards them into stages at each call; each stage computes with the
    same layers either way.  ``specs`` itself off a pp mesh."""
    if mesh_size(mesh, "pp") == 1 or "layers" not in specs:
        return specs
    layers = {name: spec if spec[0] is not None else ("pp", *spec[1:])
              for name, spec in specs["layers"].items()}
    return {**specs, "layers": layers}
