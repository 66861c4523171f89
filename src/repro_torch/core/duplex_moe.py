"""Dual-path (duplex) MoE: hot experts through the grouped GEMM, the
``k_cold`` least-loaded experts through the gather GEMV (paper §V-B), each
either ragged (per-expert live counts threaded in) or capacity-padded.

Port of ``repro/core/duplex_moe.py``. ``k_cold`` and the two capacities
are host-side choices (the planner); which experts are hot is decided on
the device from the live router counts (over every tile) by a stable
ascending sort, and each tile of ``plan.dispatch_grid`` fills its own
slot buffers, as in ``models/moe.py``. The kernels read the expert weights in place through the
rank -> expert permutation — the reference's ``_gather_weights`` copy of
every expert's weights per layer is not ported.
"""
from __future__ import annotations

from statistics import NormalDist
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.execution import DEFAULT_PLAN, ExecutionPlan
from repro_torch.kernels.moe_gemm import moe_gemm_traffic
from repro_torch.models.ffn import ffn_apply
from repro_torch.models.moe import (RouterOut, grouped_expert_ffn, on_tiles, route, tile_combine,
                                    tile_gather, tile_slots, to_tiles)
from repro_torch.sharding.rules import local_call, logical_constraint


def _align(x: int, a: int) -> int:
    return max(a, -(-x // a) * a)


def default_capacities(T: int, m: MoEConfig, k_cold: int,
                       n_shards: int = 1) -> Tuple[int, int]:
    """(C_hot, C_cold) per dispatch tile of T tokens: hot capacity covers
    routing skew (mean + 3 sigma of a multinomial); cold capacity covers
    the count at the cold/hot boundary rank (normal order statistic at
    k_cold/E) plus a fluctuation margin. Over ``n_shards`` tiles they align
    to 8/n (at least 4 hot and 2 cold), as the reference's."""
    mean = T * m.top_k / m.num_experts
    a_hot = max(8 // max(n_shards, 1), 4)
    a_cold = max(8 // max(n_shards, 1), 2)
    sigma = (mean * (1.0 - m.top_k / m.num_experts)) ** 0.5
    c_hot = _align(int(mean + 3.0 * sigma) + 1, a_hot)
    if k_cold > 0:
        q = min(max(k_cold / m.num_experts, 1e-6), 1.0 - 1e-6)
        boundary = mean + NormalDist().inv_cdf(q) * sigma + max(mean, 0.0) ** 0.5
    else:
        boundary = mean
    c_cold = _align(int(max(boundary, 0.0)) + 1, a_cold)
    return c_hot, c_cold


def duplex_capacities(Tl: int, m: MoEConfig, k_cold: int, n_shards: int = 1,
                      c_hot: Optional[int] = None, c_cold: Optional[int] = None
                      ) -> Tuple[int, int, int]:
    """(C_hot, C_cold, slots) of a dispatch tile of Tl tokens: the
    capacities given, ``default_capacities`` for those not given (a 0 counts
    as not given, as the reference's ``c_hot or ch``), no cold slots when
    k_cold is 0."""
    if c_hot is None or c_cold is None:
        ch, cc = default_capacities(Tl, m, k_cold, n_shards)
        c_hot = c_hot or ch
        c_cold = c_cold or cc
    if k_cold == 0:
        c_cold = 0
    return c_hot, c_cold, k_cold * c_cold + (m.num_experts - k_cold) * c_hot


class DuplexDispatch(NamedTuple):
    src_token: torch.Tensor     # (n, n_slots) each tile's token per slot (Tl = empty)
    slot_gate: torch.Tensor     # (n, n_slots) float32
    slot: torch.Tensor          # (n, Tl*k) slot per assignment (n_slots = dropped)
    perm: torch.Tensor          # (E,) expert id per rank (ascending count)
    counts: torch.Tensor        # (E,) tokens per expert
    k_cold: int
    c_hot: int                  # per-tile hot capacity
    c_cold: int                 # per-tile cold capacity


def duplex_dispatch(router: RouterOut, m: MoEConfig, T: int, *, k_cold: int,
                    n_shards: int = 1, c_hot: Optional[int] = None,
                    c_cold: Optional[int] = None, token_valid=None,
                    tile_pl=None) -> DuplexDispatch:
    """Rank experts by live count over every tile (stable: ties keep the
    lower id first, as ``jnp.argsort(stable=True)``); each of the
    ``n_shards`` tiles of T // n_shards tokens fills its own slot buffers,
    ranks < k_cold taking C_cold slots, the rest C_hot, in rank order. On
    DTensors ``tile_pl`` is the tiles' placements (``to_tiles``) and each
    shard assigns its own tiles' slots."""
    Tl = T // n_shards
    c_hot, c_cold, n_slots = duplex_capacities(Tl, m, k_cold, n_shards, c_hot, c_cold)
    counts = router.counts
    if hasattr(counts, "full_tensor"):   # the ranking is host-side logic on (E,) counts
        counts = counts.full_tensor()
    perm, caps, bases = rank_slots(counts, k_cold, c_hot, c_cold)
    rep = None
    if tile_pl is not None:
        from torch.distributed.tensor import Replicate
        rep = (Replicate(),) * len(tile_pl)
    src, gate, slot = on_tiles(
        lambda *a: tile_slots(*a, Tl, n_slots), (tile_pl,) * 3,
        (tile_pl, tile_pl, tile_pl if token_valid is not None else None, rep, rep),
        router.expert_idx, router.gates, token_valid, caps, bases)
    return DuplexDispatch(src, gate, slot, perm, counts, k_cold, c_hot, c_cold)


def take_experts(w, idx):
    """``w[idx]``: the experts ``idx`` (a plain index tensor) of a stacked
    expert weight; on a DTensor each shard takes them from its block, the
    expert dim gathered first where it is sharded (expert parallelism)."""
    if not hasattr(w, "device_mesh"):
        return w[idx]
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_shard(0) or p.is_partial() else p for p in w.placements]
    return local_call(lambda wl, il: wl[il], w.device_mesh, pl,
                      (pl, [Replicate()] * len(pl)), w, idx)


def rank_slots(counts, k_cold: int, c_hot: int, c_cold: int):
    """Experts ranked by live count (stable: ties keep the lower id first)
    -> (perm (E,) expert per rank, caps (E,) and bases (E,) per expert:
    ranks < k_cold take C_cold slots, the rest C_hot, in rank order)."""
    E = counts.shape[0]
    dev = counts.device
    perm = torch.sort(counts, stable=True).indices              # rank -> expert
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(E, device=dev)                    # expert -> rank
    ranks = torch.arange(E, device=dev)
    is_cold = ranks < k_cold
    base_of_rank = torch.where(is_cold, ranks * c_cold,
                               k_cold * c_cold + (ranks - k_cold) * c_hot)
    cap_of_rank = torch.where(is_cold, torch.full_like(ranks, c_cold),
                              torch.full_like(ranks, c_hot))
    return perm, cap_of_rank[rank], base_of_rank[rank]


def duplex_moe_apply(params, cfg: ModelConfig, x, *, k_cold: int,
                     c_hot: Optional[int] = None, c_cold: Optional[int] = None,
                     use_kernels: bool = False, ragged: bool = False,
                     token_valid=None, plan: ExecutionPlan = DEFAULT_PLAN):
    """Duplex MoE layer over x (T, d) or (B, S, d). With ``use_kernels`` the
    kernels run (cold: GEMV, hot: grouped GEMM): with ``ragged`` the
    count-threaded ones (one dispatch tile only, as the reference's), else
    the capacity-padded ones over every slot; without kernels, the plain
    grouped FFN over the rank-permuted weights. Tokens over capacity are
    dropped. Shared experts (``params["shared"]``) add their gated FFN over
    every row after the combine, on every route, as the reference does.
    Returns (y, router)."""
    m = cfg.moe
    E = m.num_experts
    shape = x.shape
    x3 = x if x.dim() == 3 else x[None]
    xb, tile_pl, untile = to_tiles(x3, plan)
    n, Tl, d = xb.shape
    router = route(params, m, xb.reshape(n * Tl, d), valid=token_valid)
    disp = duplex_dispatch(router, m, n * Tl, k_cold=k_cold, n_shards=n, c_hot=c_hot,
                           c_cold=c_cold, token_valid=token_valid, tile_pl=tile_pl)
    kc, ch, cc, perm = disp.k_cold, disp.c_hot, disp.c_cold, disp.perm
    n_cold = kc * cc
    x_slots = on_tiles(tile_gather, (tile_pl,), (tile_pl,) * 3, xb, disp.src_token, disp.slot)
    slot_gate, slot = disp.slot_gate, disp.slot
    w = {key: params[key] for key in ("wi_gate", "wi_up", "wo")}
    ragged = ragged and n == 1
    counts_rank = disp.counts[perm] if ragged else None
    parts = []
    if kc > 0:
        x_cold = x_slots[:, :n_cold].reshape(n, kc, cc, d).transpose(0, 1)
        if use_kernels:
            from repro_torch.kernels.ops import moe_gemv
            y_cold = moe_gemv(w, x_cold.reshape(kc, n * cc, d), None if counts_rank is None
                              else counts_rank[:kc], perm[:kc]).reshape(kc, n, cc, d)
        else:
            y_cold = grouped_expert_ffn({key: take_experts(v, perm[:kc])
                                         for key, v in w.items()}, x_cold, constrain=False)
        parts.append(y_cold.transpose(0, 1).reshape(n, n_cold, d))
    if kc < E:
        x_hot = x_slots[:, n_cold:].reshape(n, E - kc, ch, d).transpose(0, 1)
        x_hot = logical_constraint(x_hot, ("act_exp", "act_cap", None, "act_embed"))
        if use_kernels and ragged:
            from repro_torch.kernels.ops import ragged_moe_gemm
            y_hot = ragged_moe_gemm(w, x_hot.reshape(E - kc, n * ch, d), counts_rank[kc:],
                                    perm[kc:]).reshape(E - kc, n, ch, d)
        elif use_kernels:
            from repro_torch.kernels.ops import moe_gemm
            y_hot = moe_gemm(w, x_hot.reshape(E - kc, n * ch, d),
                             perm[kc:]).reshape(E - kc, n, ch, d)
        else:
            y_hot = grouped_expert_ffn({key: take_experts(v, perm[kc:])
                                        for key, v in w.items()}, x_hot, constrain=False)
        y_hot = logical_constraint(y_hot, ("act_exp", "act_cap", None, "act_embed"))
        parts.append(y_hot.transpose(0, 1).reshape(n, (E - kc) * ch, d))
    y_slots = torch.cat([p.to(x.dtype) for p in parts], dim=1)
    y_slots = y_slots * slot_gate[..., None].to(y_slots.dtype)
    y = untile(on_tiles(lambda ys, sl: tile_combine(ys, sl, Tl), (tile_pl,),
                        (tile_pl, tile_pl), y_slots, slot))
    if m.num_shared_experts:
        y = y + ffn_apply(params["shared"], x3)
    return y.reshape(shape), router


def moe_traffic_model(counts, *, k_cold: int, c_hot: int, c_cold: int,
                      d_model: int, d_ff: int, c_block: int = 256,
                      itemsize: int = 2, mats: int = 3) -> dict:
    """Modelled per-MoE-layer bytes + FLOPs under the capacity-padded vs
    ragged kernels for one stage's per-expert counts (host side). Same
    model as the reference's, so the serve counters read alike."""
    counts = np.sort(np.asarray(counts, dtype=np.int64))        # rank order
    cold, hot = counts[:k_cold], counts[k_cold:]
    out = dict.fromkeys(("padded_weight_bytes", "ragged_weight_bytes",
                         "padded_bytes", "ragged_bytes", "padded_flops",
                         "ragged_flops"), 0)
    if len(hot) and c_hot > 0:
        t = moe_gemm_traffic(hot, capacity=c_hot, d_model=d_model, d_ff=d_ff,
                             c_block=c_block, itemsize=itemsize, mats=mats)
        for key in out:
            out[key] += t[key]
    if len(cold) and c_cold > 0:
        w_once = mats * d_model * d_ff * itemsize
        a_slab = 2 * c_cold * d_model * itemsize
        flops_slab = 2 * mats * c_cold * d_model * d_ff
        occupied = int((np.minimum(cold, c_cold) > 0).sum())
        out["padded_weight_bytes"] += len(cold) * w_once
        out["ragged_weight_bytes"] += occupied * w_once
        out["padded_bytes"] += len(cold) * (w_once + a_slab)
        out["ragged_bytes"] += occupied * (w_once + a_slab)
        out["padded_flops"] += len(cold) * flops_slab
        out["ragged_flops"] += occupied * flops_slab
    return out


def padded_flops_saved(T: int, m: MoEConfig, k_cold: int, d_model: int,
                       counts=None) -> float:
    """Analytic padding-FLOP reduction of the duplex capacities (``k_cold``
    cold slots of C_cold, the rest of C_hot) against the single-capacity
    grouped path's E slots of T * top_k * capacity_factor / E. ``counts``
    is taken for the reference's signature; the estimate does not read it."""
    c_single = _align(int(T * m.top_k * m.capacity_factor / m.num_experts) + 1, 8)
    c_hot, c_cold = default_capacities(T, m, k_cold)
    base = m.num_experts * c_single
    duplex_slots = k_cold * c_cold + (m.num_experts - k_cold) * c_hot
    per_slot = 6.0 * d_model * m.d_ff_expert
    return (base - duplex_slots) * per_slot
