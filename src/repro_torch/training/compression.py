"""int8 error-feedback gradient compression (the cross-pod reduction).

Port of ``repro/training/compression.py``. Gradients are quantized to int8
with one float32 scale a tensor before the cross-pod mean and dequantized
after; the quantization residual stays in an error-feedback buffer
(Seide et al. / EF-SGD).

* ``compress`` / ``decompress`` / ``ef_step`` and their tree forms: pure
  functions, bit-exact against the reference (abs-max over 127, a 1e-12
  scale floor, round-half-even, clip to +-127). Divisions are tensor by
  tensor: on CUDA, PyTorch divides by a host scalar as a multiplication by
  its reciprocal, which can miss the quotient in the last bit.
* ``cross_pod_mean_int8``: the mean over a mesh dimension's process group
  with an int8 payload: one scalar max-reduce for a shared scale, then an
  all-gather of the int8 values summed locally in int32 (an int32
  all-reduce would move 4 bytes an element).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.models.params import tree_leaves, tree_map


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _scale(absmax) -> torch.Tensor:
    return torch.clamp(absmax / _f32(127.0, absmax.device), min=1e-12)


def _quantize(g32, scale) -> torch.Tensor:
    return torch.clamp(torch.round(g32 / scale), -127, 127)


def compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 values, float32 scale): symmetric per-tensor quantization."""
    g32 = g.float()
    scale = _scale(g32.abs().amax())
    return _quantize(g32, scale).to(torch.int8), scale


def decompress(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def ef_step(g: torch.Tensor, err: torch.Tensor):
    """Error feedback: compress (g + err); returns (q, scale, new_err)."""
    corrected = g.float() + err
    q, scale = compress(corrected)
    return q, scale, corrected - decompress(q, scale)


def init_error_state(grads):
    return tree_map(grads, lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                 device=g.device))


def _per_leaf(fn, grads, err_state):
    """``fn(g, e)`` over the leaves -> one tree (``grads``'s nesting) per
    element of its result."""
    outs = [fn(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(err_state))]
    trees = []
    for i in range(len(outs[0])):
        it = iter([o[i] for o in outs])
        trees.append(tree_map(grads, lambda _: next(it)))
    return trees


def compress_tree(grads, err_state):
    """Tree-wise EF compression -> ((q tree, scale tree), new error tree)."""
    q, scale, err = _per_leaf(ef_step, grads, err_state)
    return (q, scale), err


def decompress_tree(qtree, scales, like):
    qs, ss = iter(tree_leaves(qtree)), iter(tree_leaves(scales))
    return tree_map(like, lambda l: decompress(next(qs), next(ss), l.dtype))


def cross_pod_mean_int8(grads, err_state, mesh, axis: str = "pod", scale_groups=()):
    """The mean of ``grads`` over the ranks of ``mesh``'s dimension ``axis``
    with an int8 payload. Each rank quantizes (grad + err) with a scale
    shared through one max-reduce, all-gathers the int8 values, sums them
    in int32 (exact: |q| n << 2^31) and scales the sum. The residual stays
    local. ``scale_groups``: further process groups the max-reduce spans
    (the other mesh dimensions a sharded gradient is split over, so the
    scale is the whole tensor's, as the reference's ``shard_map`` takes
    it). Returns (mean tree in each gradient's dtype, new error tree)."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)

    def one(g, e):
        corrected = g.float() + e
        gmax = corrected.abs().amax()
        for extra in scale_groups:
            dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=extra)
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
        scale = _scale(gmax)
        q = _quantize(corrected, scale)
        gathered = [torch.empty_like(q, dtype=torch.int8) for _ in range(n)]
        dist.all_gather(gathered, q.to(torch.int8), group=group)
        acc = torch.stack(gathered).to(torch.int32).sum(dim=0)
        mean = acc.float() * scale / _f32(float(n), g.device)
        return mean.to(g.dtype), corrected - q * scale

    return tuple(_per_leaf(one, grads, err_state))


def compressed_bytes(grads) -> int:
    """Wire bytes of the int8 payload (4x less than float32, 2x than bf16)."""
    return sum(t.numel() for t in tree_leaves(grads))
