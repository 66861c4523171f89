"""Mixture-of-Experts routing and slot dispatch (single dispatch shard).

Port of ``repro/models/moe.py``: a top-k softmax router, the cumsum slot
assignment (no sort), a token->slot gather and a slot->token combine. The
reference's dispatch is per shard (vmapped); the port serves one device, so
every function here works on the one shard's flat (T, ...) arrays.

The combine is deterministic: instead of the reference's scatter-add
(``index_add_`` on CUDA adds in no fixed order), each token gathers its
``top_k`` slots and sums them in choice order. The token->slot gather's
backward is that same combine (``_GatherSlots``), so a training step's
input gradient of the MoE layer is summed in a fixed order too.

Dispatch is hierarchical, as the reference's: ``moe_apply`` cuts the
tokens into the tiles of ``plan.dispatch_grid`` (one on one device) and
each tile dispatches into its own slot buffers. On DTensors each shard's
block of tokens is its own tile, and the tile-local work (slot
assignment, gather, combine) runs on the local shards (``on_tiles``); the
router, the expert products and the reference's sharding constraints run
as DTensor ops.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.execution import DEFAULT_PLAN, ExecutionPlan, shard_blocks
from repro_torch.models.ffn import ffn_apply
from repro_torch.sharding.rules import local_call, logical_constraint


class RouterOut(NamedTuple):
    expert_idx: torch.Tensor   # (T, top_k) int64
    gates: torch.Tensor        # (T, top_k) float32
    counts: torch.Tensor       # (E,) int64 live tokens per expert
    aux_loss: torch.Tensor     # () float32 load-balance loss (training)


def route(params, m: MoEConfig, x_flat, valid: Optional[torch.Tensor] = None) -> RouterOut:
    """``valid`` (T,) marks live tokens: padded rows neither count toward
    ``counts`` nor, later, take expert capacity.

    Ties: ``jax.lax.top_k`` prefers the lower expert index among equal
    probabilities, ``torch.topk`` promises no order among equal values. With
    float32 router logits of real activations exact ties essentially never
    occur, so the port does not emulate the tie order."""
    logits = torch.matmul(x_flat.float(), params["router"].float())   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = torch.topk(probs, m.top_k, dim=-1)
    if m.norm_topk_probs:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # counts by a one-hot sum: no data-dependent shape, so no device sync
    one_hot = torch.nn.functional.one_hot(expert_idx, m.num_experts)
    if valid is not None:
        gates = torch.where(valid[:, None], gates, torch.zeros_like(gates))
        one_hot = one_hot * valid[:, None, None]
    # Switch-style load-balance loss
    density = one_hot.float().mean(dim=(0, 1)) * m.num_experts
    density_proxy = probs.mean(dim=0) * m.num_experts
    aux = m.aux_loss_coef * torch.mean(density * density_proxy)
    return RouterOut(expert_idx, gates, one_hot.sum(dim=(0, 1)), aux)


def _capacity(T: int, m: MoEConfig, align: int = 8) -> int:
    c = int(T * m.top_k * m.capacity_factor / m.num_experts) + 1
    return max(align, -(-c // align) * align)


def group_positions(flat_expert, E: int):
    """pos[i] = #{j < i : expert[j] == expert[i]} by an exclusive cumsum of
    the one-hot mask (ids may include the out-of-range id E for invalid
    assignments). The mask is built transposed, (E + 1, N), so the cumsum
    runs along the contiguous axis: on CUDA a cumsum down the long axis of
    an (N, E + 1) mask is a slow, poorly parallel scan (``PERF.md``)."""
    ids = torch.arange(E + 1, device=flat_expert.device)
    onehot = (flat_expert[None, :] == ids[:, None]).long()
    pos = torch.cumsum(onehot, dim=1) - 1
    return torch.gather(pos, 0, flat_expert[None, :])[0]


class Dispatch(NamedTuple):
    src_token: torch.Tensor    # (n_slots,) token feeding each slot, T if empty
    slot_gate: torch.Tensor    # (n_slots,) float32 gate per slot, 0 if empty
    slot: torch.Tensor         # (T*k,) slot of each assignment, n_slots if dropped


def shard_dispatch(expert_idx, gates, T: int, E: int, caps, bases, n_slots: int,
                   valid=None) -> Dispatch:
    """Slot assignment. expert_idx/gates (T*k,) flattened assignments; caps,
    bases (E,) per-expert slot capacity and first slot; ``valid`` (T*k,)
    masks dead assignments — they get no slot AND do not advance their
    expert's fill position (remapped to the id E before the cumsum)."""
    k = expert_idx.shape[0] // T
    if valid is not None:
        expert_idx = torch.where(valid, expert_idx, torch.full_like(expert_idx, E))
    pos = group_positions(expert_idx, E)
    e_c = torch.clamp(expert_idx, max=E - 1)
    keep = pos < caps[e_c]
    if valid is not None:
        keep = keep & valid
    slot = torch.where(keep, bases[e_c] + pos, torch.full_like(pos, n_slots))
    ft = torch.arange(T, device=expert_idx.device).repeat_interleave(k)
    src = torch.full((n_slots + 1,), T, dtype=torch.long, device=expert_idx.device)
    src[slot] = torch.where(keep, ft, torch.full_like(ft, T))
    gate = torch.zeros((n_slots + 1,), dtype=torch.float32, device=expert_idx.device)
    gate[slot] = torch.where(keep, gates, torch.zeros_like(gates))
    return Dispatch(src[:-1], gate[:-1], slot)


class _GatherSlots(torch.autograd.Function):
    """Token -> slot gather whose backward is ``combine_slots``: each token
    sums its own ``top_k`` slot gradients in choice order, in float32, with
    no atomics, so the input gradient is the same from run to run on CUDA
    (``index_select``'s own backward, an ``index_add_``, adds in atomic
    order there)."""

    @staticmethod
    def forward(ctx, x_flat, src, slot):
        ctx.save_for_backward(slot)
        ctx.T = x_flat.shape[0]
        x_pad = torch.cat([x_flat, x_flat.new_zeros((1, x_flat.shape[1]))])
        return x_pad.index_select(0, src)

    @staticmethod
    def backward(ctx, grad):
        slot, = ctx.saved_tensors
        return combine_slots(grad, slot, ctx.T), None, None


def gather_slots(x_flat, src, slot):
    """Token -> slot gather: x (T, d), src (n_slots,) -> (n_slots, d); empty
    slots (src == T) read a zero row. ``slot`` (T*k,) is the dispatch's
    slot per assignment (n_slots = dropped), the inverse map the backward
    sums through (``_GatherSlots``). The forward is ``index_select``
    (advanced indexing's backward is a sort-based ``index_put_``, half of a
    training step's device time at OLMoE's widths; ``PERF.md``)."""
    return _GatherSlots.apply(x_flat, src, slot)


def combine_slots(y_slots, slot, T: int):
    """Slot -> token combine: y_slots (n_slots, d) gated slot outputs; slot
    (T*k,) each assignment's slot (n_slots = dropped). Each token sums its k
    slots in choice order in float32 (float64 for float64 slots) -> (T, d)
    in y_slots' dtype."""
    y_pad = torch.cat([y_slots, y_slots.new_zeros((1, y_slots.shape[1]))])
    picked = y_pad.index_select(0, slot).to(torch.promote_types(y_slots.dtype, torch.float32))
    picked = picked.reshape(T, -1, y_slots.shape[1])
    out = picked[:, 0]
    for j in range(1, picked.shape[1]):
        out = out + picked[:, j]
    return out.to(y_slots.dtype)


def grouped_expert_ffn(params, x_grouped, *, constrain: bool = True):
    """x (E, C, d) -> (E, C, d) with the reference's XLA rounding points; a
    tiled (E, n, C, d) slab runs as (E, n*C, d), its hidden activation
    under the reference's constraint (unless ``constrain`` is off, as the
    duplex path's)."""
    tiled = x_grouped.dim() == 4
    if tiled:
        E, n, C, d = x_grouped.shape
        x_grouped = x_grouped.reshape(E, n * C, d)
    g = torch.matmul(x_grouped, params["wi_gate"])
    u = torch.matmul(x_grouped, params["wi_up"])
    h = torch.nn.functional.silu(g.float()).to(x_grouped.dtype) * u
    if not tiled:
        return torch.matmul(h, params["wo"])
    if constrain:
        h = logical_constraint(h.reshape(E, n, C, -1), ("act_exp", "act_cap", None, "act_mlp"))
        h = h.reshape(E, n * C, -1)
    return torch.matmul(h, params["wo"]).reshape(E, n, C, d)


def _is_dtensor(x) -> bool:
    return hasattr(x, "device_mesh")


def to_tiles(x, plan: ExecutionPlan):
    """(B, S, d) -> (xb (n, Tl, d), tile placements or None, untile: y (n*Tl,
    d) -> x's (B, S, d) layout). A plain tensor is cut by ``shard_blocks``.
    A DTensor's tiles are its shards' blocks: the tile dimension is sharded
    over every mesh dimension that shards the batch or the sequence,
    outermost first, which is the reference's tile order (batch block
    major); the plan's grid must have one tile a shard there, or tile the
    replicated tensor whole."""
    if not _is_dtensor(x):
        xb, untile = shard_blocks(x, plan)
        return xb, None, untile
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    # partial sums are reduced and a sharded d_model gathered: tiles hold whole tokens
    pl = tuple(p if p in (Shard(0), Shard(1)) else Replicate() for p in x.placements)
    if pl != tuple(x.placements):
        x = x.redistribute(mesh, pl)
    ways = [1, 1]
    for i, p in enumerate(pl):
        if p.is_shard():
            ways[p.dim] *= mesh.size(i)
    B, S, d = x.shape
    grid = tuple(min(g, n) for g, n in zip(plan.dispatch_grid, (B, S)))
    local_grid = (1, 1) if ways != [1, 1] else grid
    if ways != [1, 1] and tuple(ways) != grid:
        raise NotImplementedError(f"dispatch grid {plan.dispatch_grid} against tokens "
                                  f"sharded {tuple(ways)} ways (batch, sequence)")
    tile_pl = tuple(Shard(0) if p.is_shard() and mesh.size(i) > 1 else Replicate()
                    for i, p in enumerate(pl))
    local_plan = ExecutionPlan(dispatch_grid=local_grid)
    shape = list(x.shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            shape[p.dim] //= mesh.size(i)
    xb = on_tiles(lambda xl: shard_blocks(xl, local_plan)[0], (tile_pl,), (pl,), x)

    def untile(y):
        return on_tiles(lambda yl: shard_blocks(yl.new_empty(shape), local_plan)[1](yl),
                        (pl,), (tile_pl,), y)
    return xb, tile_pl, untile


def on_tiles(fn, out_placements, in_placements, tiles, *args):
    """``fn(tiles, *args)`` on the local shards when ``tiles`` (the tiled
    tensor) is a DTensor: the DTensor arguments redistributed to
    ``in_placements`` first (a None entry for a non-tensor), the outputs
    wrapped as DTensors placed ``out_placements``; on a plain ``tiles``,
    ``fn(tiles, *args)``."""
    if not _is_dtensor(tiles):
        return fn(tiles, *args)
    outs = [list(p) for p in out_placements]
    return local_call(fn, tiles.device_mesh, outs[0] if len(outs) == 1 else tuple(outs),
                      in_placements, tiles, *args)


def tile_slots(expert_idx, gates, valid, caps, bases, Tl: int, n_slots: int):
    """Each local tile's slot assignment (``shard_dispatch``): expert_idx,
    gates (n*Tl, k); valid (n*Tl,) or None; caps, bases (E,) -> (src_token
    (n, n_slots), slot_gate (n, n_slots), slot (n, Tl*k))."""
    k = expert_idx.shape[-1]
    n = expert_idx.shape[0] // Tl
    e, g = expert_idx.reshape(n, Tl * k), gates.reshape(n, Tl * k)
    v = valid.reshape(n, Tl).repeat_interleave(k, dim=1) if valid is not None else None
    parts = [shard_dispatch(e[i], g[i], Tl, caps.shape[0], caps, bases, n_slots,
                            valid=None if v is None else v[i]) for i in range(n)]
    if n == 1:                            # a view, nothing copied on one device
        src, gate, slot = parts[0]
        return src[None], gate[None], slot[None]
    return tuple(map(torch.stack, zip(*parts)))


def tile_gather(xb, src_token, slot):
    """Each local tile's token -> slot gather: xb (n, Tl, d) -> (n, n_slots, d)."""
    if xb.shape[0] == 1:
        return gather_slots(xb[0], src_token[0], slot[0])[None]
    return torch.stack([gather_slots(xb[i], src_token[i], slot[i])
                        for i in range(xb.shape[0])])


def tile_combine(y_slots, slot, Tl: int):
    """Each local tile's slot -> token combine: (n, n_slots, d) -> (n*Tl, d)."""
    if y_slots.shape[0] == 1:
        return combine_slots(y_slots[0], slot[0], Tl)
    return torch.cat([combine_slots(y_slots[i], slot[i], Tl) for i in range(y_slots.shape[0])])


def moe_apply(params, cfg: ModelConfig, x, *, capacity: Optional[int] = None,
              token_valid=None, plan: ExecutionPlan = DEFAULT_PLAN):
    """Grouped (capacity-padded) path for x (T, d) or (B, S, d), dispatched
    per tile of ``plan.dispatch_grid`` (C = ``_capacity`` of a tile's
    tokens, or ``capacity`` spread over the tiles); shared experts
    (``params["shared"]``, a gated FFN) add their output over every row
    after the combine. Returns (y, router); training takes the
    load-balance loss from ``router.aux_loss``."""
    m = cfg.moe
    E = m.num_experts
    shape = x.shape
    x3 = x if x.dim() == 3 else x[None]
    xb, tile_pl, untile = to_tiles(x3, plan)
    n, Tl, d = xb.shape
    router = route(params, m, xb.reshape(n * Tl, d), valid=token_valid)
    C = max(1, -(-capacity // n)) if capacity is not None else _capacity(Tl, m)
    dev = x.device
    caps = torch.full((E,), C, dtype=torch.long, device=dev)
    bases = torch.arange(E, device=dev) * C
    src, slot_gate, slot = on_tiles(
        lambda *a: tile_slots(*a, Tl, E * C), (tile_pl,) * 3,
        (tile_pl, tile_pl, tile_pl if token_valid is not None else None, None, None),
        router.expert_idx, router.gates, token_valid, caps, bases)
    x_slots = on_tiles(tile_gather, (tile_pl,), (tile_pl,) * 3, xb, src, slot)
    x_slots = logical_constraint(x_slots, ("act_cap", None, "act_embed"))
    x_grouped = x_slots.reshape(n, E, C, d).transpose(0, 1)
    x_grouped = logical_constraint(x_grouped, ("act_exp", "act_cap", None, "act_embed"))
    y_grouped = grouped_expert_ffn(params, x_grouped)              # (E, n, C, d)
    y_grouped = logical_constraint(y_grouped, ("act_exp", "act_cap", None, "act_embed"))
    y_slots = y_grouped.transpose(0, 1).reshape(n, E * C, d)
    y_slots = y_slots * slot_gate[..., None].to(y_slots.dtype)
    y = untile(on_tiles(lambda ys, sl: tile_combine(ys, sl, Tl), (tile_pl,),
                        (tile_pl, tile_pl), y_slots, slot))
    if m.num_shared_experts:
        y = y + ffn_apply(params["shared"], x3)
    return y.reshape(shape), router
