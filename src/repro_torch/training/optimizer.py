"""AdamW with decoupled weight decay and global-norm clipping.

Port of ``repro/training/optimizer.py`` as plain functions on tensors, in
the reference's order of operations (``torch.optim.AdamW`` orders its
update differently). The optimizer state mirrors the parameter tree:
``mu`` and ``nu`` in ``adam_dtype`` (float32), and ``count``.

Where JAX builds new arrays, the port updates in place — parameters,
moments, and the gradients when it clips them — one layer at a time for
stacked leaves (``leaf[i]`` of a leaf with a leading layer axis), so each
float32 temporary is one layer's size: at OLMoE-1B-7B's widths a stacked
expert leaf of 8 layers holds 1.07B elements, and a whole-leaf float32
temporary would be 4.3 GB. Step and count are host integers, so the
schedule costs no device sync. Divisions by the bias corrections use
device tensors: on CUDA, PyTorch divides by a host scalar as a
multiplication by its reciprocal, which can miss the true quotient in the
last bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.params import tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    adam_dtype: torch.dtype = torch.float32
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_schedule(cfg: OptConfig, step) -> float:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; float32
    arithmetic on the host, as the reference's. Step 0 gives 0."""
    step = _f32(float(step))
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return (cfg.learning_rate * warm * scale).item()


def init_opt_state(params, cfg: OptConfig) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.adam_dtype, device=p.device)
    return {"mu": tree_map(params, zeros), "nu": tree_map(params, zeros), "count": 0}


def _slices(t: torch.Tensor):
    """A stacked leaf (3+ dims) one layer at a time, else the leaf."""
    return t.unbind(0) if t.dim() >= 3 else (t,)


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a device
    tensor; no sync)."""
    total = None
    for leaf in tree_leaves(tree):
        for sl in _slices(leaf):
            sq = torch.sum(torch.square(sl.float()))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale the gradients IN PLACE by min(1, max_norm / norm), each rounded
    back to its dtype as the reference's. Returns (grads, norm)."""
    norm = global_norm(grads)
    # tensor / tensor: `float / tensor` would multiply by the reciprocal
    scale = torch.clamp(torch.full_like(norm, max_norm) / torch.clamp(norm, min=1e-9),
                        max=1.0)
    for leaf in tree_leaves(grads):
        for g in _slices(leaf):
            g.copy_((g.float() * scale).to(g.dtype))
    return grads, norm


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig, step=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One AdamW step, IN PLACE on params, state["mu"], state["nu"] (and the
    gradients, which are clipped first). ``step`` (host int) sets the
    learning rate, default the new count. Returns (params, state, metrics
    {"grad_norm" (device tensor), "lr" (float)})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    count = state["count"] + 1
    lr = lr_schedule(cfg, step if step is not None else count)
    b1, b2 = cfg.beta1, cfg.beta2
    leaves = tree_leaves(params)
    dev = leaves[0].device
    bc1 = (1.0 - _f32(b1) ** _f32(float(count))).to(dev)
    bc2 = (1.0 - _f32(b2) ** _f32(float(count))).to(dev)
    for p_leaf, g_leaf, mu_leaf, nu_leaf in zip(leaves, tree_leaves(grads),
                                                tree_leaves(state["mu"]),
                                                tree_leaves(state["nu"])):
        for p, g, mu, nu in zip(_slices(p_leaf), _slices(g_leaf), _slices(mu_leaf),
                                _slices(nu_leaf)):
            g32 = g.to(cfg.adam_dtype)
            mu.mul_(b1).add_(g32 * (1 - b1))
            nu.mul_(b2).add_(torch.square(g32).mul_(1 - b2))
            delta = (mu / bc1).div_(torch.sqrt(nu / bc2).add_(cfg.eps))
            p32 = p.float()
            delta.add_(p32 * cfg.weight_decay).mul_(lr)
            p.copy_((p32 - delta).to(p.dtype))
    state = {"mu": state["mu"], "nu": state["nu"], "count": count}
    return params, state, {"grad_norm": gnorm, "lr": lr}
