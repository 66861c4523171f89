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
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig


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


def grouped_expert_ffn(params, x_grouped):
    """x (E, C, d) -> (E, C, d) with the reference's XLA rounding points."""
    g = torch.matmul(x_grouped, params["wi_gate"])
    u = torch.matmul(x_grouped, params["wi_up"])
    h = torch.nn.functional.silu(g.float()).to(x_grouped.dtype) * u
    return torch.matmul(h, params["wo"])


def moe_apply(params, cfg: ModelConfig, x, *, capacity: Optional[int] = None,
              token_valid=None):
    """Grouped (capacity-padded) path for x (T, d) or (B, S, d). Returns
    (y, router); training takes the load-balance loss from
    ``router.aux_loss``."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    shape = x.shape
    x_flat = x.reshape(-1, shape[-1])
    T, d = x_flat.shape
    router = route(params, m, x_flat, valid=token_valid)
    C = capacity if capacity is not None else _capacity(T, m)
    dev = x.device
    caps = torch.full((E,), C, dtype=torch.long, device=dev)
    bases = torch.arange(E, device=dev) * C
    fv = token_valid.repeat_interleave(k) if token_valid is not None else None
    disp = shard_dispatch(router.expert_idx.reshape(-1), router.gates.reshape(-1),
                          T, E, caps, bases, E * C, valid=fv)
    x_slots = gather_slots(x_flat, disp.src_token, disp.slot)
    y = grouped_expert_ffn(params, x_slots.reshape(E, C, d)).reshape(E * C, d)
    y = y * disp.slot_gate[:, None].to(y.dtype)
    return combine_slots(y, disp.slot, T).reshape(shape), router
