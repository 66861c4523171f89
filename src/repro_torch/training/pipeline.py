"""GPipe-style pipeline parallelism over a mesh dimension (opt-in).

Port of ``repro/training/pipeline.py``. Per-stage parameters are stacked
on a leading dimension of P stages, one stage a rank of the mesh's
``pipe`` dimension; ``pipeline_apply`` runs the M-microbatch GPipe
schedule: M + P - 1 ticks, each stage applying its function and sending
its activation to the next stage (a ring permute, as the reference's
``ppermute``), the last stage's outputs summed over the dimension so every
rank holds them. ``bubble_fraction`` = (P - 1) / (M + P - 1) sizes M. The
collectives are not differentiated: across ranks this is a forward
(``pipeline_loss`` reports a loss).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models.params import tree_map


def bubble_fraction(num_micro: int, num_stages: int) -> float:
    return (num_stages - 1) / (num_micro + num_stages - 1)


def _ring_permute(y, group, rank: int, n: int):
    """Send ``y`` to the next stage (rank + 1 mod n) of ``group`` and return
    what the previous stage sent."""
    if n == 1:
        return y
    got = torch.empty_like(y)
    ranks = dist.get_process_group_ranks(group)
    ops = [dist.P2POp(dist.isend, y.contiguous(), ranks[(rank + 1) % n], group),
           dist.P2POp(dist.irecv, got, ranks[(rank - 1) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


def pipeline_apply(stage_fn: Callable, stage_params, mbs, *, mesh, axis: str = "pipe"):
    """Run microbatches through P pipeline stages.

    stage_fn(params_one_stage, x) -> y  (same shape as x)
    stage_params: a tree with a leading dimension of P; this rank runs the
      stage of its index along ``axis``
    mbs: (M, mb, ...) microbatches (the same on every rank)
    Returns the (M, mb, ...) outputs on every rank."""
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    stage = mesh.get_local_rank(axis)
    n_micro = mbs.shape[0]
    params_one = tree_map(stage_params, lambda a: a[stage])
    state = torch.zeros_like(mbs[0])
    outs = []
    for t in range(n_micro + n_stages - 1):
        x = mbs[min(t, n_micro - 1)] if stage == 0 else state
        y = stage_fn(params_one, x)
        if t >= n_stages - 1:
            outs.append(y if stage == n_stages - 1 else torch.zeros_like(y))
        state = _ring_permute(y, group, stage, n_stages)
    outs = torch.stack(outs)
    if n_stages > 1:
        dist.all_reduce(outs, group=group)        # only the last stage's are nonzero
    return outs


def pipeline_loss(stage_fn: Callable, loss_fn: Callable, stage_params, mbs, targets, *,
                  mesh, axis: str = "pipe"):
    """Mean of ``loss_fn(out, target)`` over the microbatches run through
    the pipeline."""
    outs = pipeline_apply(stage_fn, stage_params, mbs, mesh=mesh, axis=axis)
    return torch.stack([loss_fn(o, t) for o, t in zip(outs, targets)]).mean()
