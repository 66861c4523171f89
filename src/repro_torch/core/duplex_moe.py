"""Dual-path (duplex) MoE: hot experts through the grouped GEMM, the
``k_cold`` least-loaded experts through the gather GEMV (paper §V-B), each
either ragged (per-expert live counts threaded in) or capacity-padded.

Port of ``repro/core/duplex_moe.py`` for one dispatch shard. ``k_cold`` and
the two capacities are host-side choices (the planner); which experts are
hot is decided on the device from the live router counts by a stable
ascending sort. The kernels read the expert weights in place through the
rank -> expert permutation — the reference's ``_gather_weights`` copy of
every expert's weights per layer is not ported.
"""
from __future__ import annotations

from statistics import NormalDist
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.moe import (RouterOut, combine_slots, gather_slots,
                                    grouped_expert_ffn, route, shard_dispatch)


def _align(x: int, a: int) -> int:
    return max(a, -(-x // a) * a)


def default_capacities(T: int, m: MoEConfig, k_cold: int) -> Tuple[int, int]:
    """(C_hot, C_cold) for a stage of T tokens: hot capacity covers routing
    skew (mean + 3 sigma of a multinomial); cold capacity covers the count
    at the cold/hot boundary rank (normal order statistic at k_cold/E) plus
    a fluctuation margin."""
    mean = T * m.top_k / m.num_experts
    sigma = (mean * (1.0 - m.top_k / m.num_experts)) ** 0.5
    c_hot = _align(int(mean + 3.0 * sigma) + 1, 8)
    if k_cold > 0:
        q = min(max(k_cold / m.num_experts, 1e-6), 1.0 - 1e-6)
        boundary = mean + NormalDist().inv_cdf(q) * sigma + max(mean, 0.0) ** 0.5
    else:
        boundary = mean
    c_cold = _align(int(max(boundary, 0.0)) + 1, 8)
    return c_hot, c_cold


class DuplexDispatch(NamedTuple):
    src_token: torch.Tensor     # (n_slots,) token per slot (T = empty)
    slot_gate: torch.Tensor     # (n_slots,) float32
    slot: torch.Tensor          # (T*k,) slot per assignment (n_slots = dropped)
    perm: torch.Tensor          # (E,) expert id per rank (ascending count)
    counts: torch.Tensor        # (E,) tokens per expert
    k_cold: int
    c_hot: int
    c_cold: int


def duplex_dispatch(router: RouterOut, m: MoEConfig, T: int, *, k_cold: int,
                    c_hot: Optional[int] = None, c_cold: Optional[int] = None,
                    token_valid=None) -> DuplexDispatch:
    """Rank experts by live count (stable: ties keep the lower id first, as
    ``jnp.argsort(stable=True)``); ranks < k_cold get C_cold slots, the rest
    C_hot, in rank order."""
    E, k = m.num_experts, m.top_k
    if c_hot is None or c_cold is None:
        ch, cc = default_capacities(T, m, k_cold)
        c_hot = c_hot or ch
        c_cold = c_cold or cc
    if k_cold == 0:
        c_cold = 0
    n_slots = k_cold * c_cold + (E - k_cold) * c_hot
    counts = router.counts
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
    fv = token_valid.repeat_interleave(k) if token_valid is not None else None
    disp = shard_dispatch(router.expert_idx.reshape(-1), router.gates.reshape(-1),
                          T, E, cap_of_rank[rank], base_of_rank[rank], n_slots,
                          valid=fv)
    return DuplexDispatch(disp.src_token, disp.slot_gate, disp.slot, perm,
                          counts, k_cold, c_hot, c_cold)


def duplex_moe_apply(params, cfg: ModelConfig, x, *, k_cold: int,
                     c_hot: Optional[int] = None, c_cold: Optional[int] = None,
                     use_kernels: bool = False, ragged: bool = False,
                     token_valid=None):
    """Duplex MoE layer over x (T, d) or (B, S, d). With ``use_kernels`` the
    kernels run (cold: GEMV, hot: grouped GEMM): with ``ragged`` the
    count-threaded ones, else the capacity-padded ones over every slot;
    without kernels, the plain grouped FFN over the rank-permuted weights.
    Tokens over capacity are dropped. Returns (y, router)."""
    m = cfg.moe
    E = m.num_experts
    shape = x.shape
    x_flat = x.reshape(-1, shape[-1])
    T, d = x_flat.shape
    router = route(params, m, x_flat, valid=token_valid)
    disp = duplex_dispatch(router, m, T, k_cold=k_cold, c_hot=c_hot,
                           c_cold=c_cold, token_valid=token_valid)
    kc, ch, cc = disp.k_cold, disp.c_hot, disp.c_cold
    n_cold = kc * cc
    x_slots = gather_slots(x_flat, disp.src_token, disp.slot)   # (n_slots, d)
    w = {key: params[key] for key in ("wi_gate", "wi_up", "wo")}
    counts_rank = disp.counts[disp.perm] if ragged else None
    parts = []
    if kc > 0:
        x_cold = x_slots[:n_cold].reshape(kc, cc, d)
        if use_kernels:
            from repro_torch.kernels.ops import moe_gemv
            parts.append(moe_gemv(w, x_cold, None if counts_rank is None
                                  else counts_rank[:kc], disp.perm[:kc]))
        else:
            idx = disp.perm[:kc]
            parts.append(grouped_expert_ffn({key: v[idx] for key, v in w.items()}, x_cold))
    if kc < E:
        x_hot = x_slots[n_cold:].reshape(E - kc, ch, d)
        if use_kernels and ragged:
            from repro_torch.kernels.ops import ragged_moe_gemm
            parts.append(ragged_moe_gemm(w, x_hot, counts_rank[kc:], disp.perm[kc:]))
        elif use_kernels:
            from repro_torch.kernels.ops import moe_gemm
            parts.append(moe_gemm(w, x_hot, disp.perm[kc:]))
        else:
            idx = disp.perm[kc:]
            parts.append(grouped_expert_ffn({key: v[idx] for key, v in w.items()}, x_hot))
    y_slots = torch.cat([p.reshape(-1, d).to(x_flat.dtype) for p in parts])
    y_slots = y_slots * disp.slot_gate[:, None].to(y_slots.dtype)
    y = combine_slots(y_slots, disp.slot, T)
    return y.reshape(shape), router


def moe_gemm_traffic(counts, *, capacity: int, d_model: int, d_ff: int,
                     c_block: int, itemsize: int = 2, mats: int = 3) -> dict:
    """Modelled per-layer HBM bytes + FLOPs of the hot grouped GEMM, padded
    (every token block) vs ragged (live blocks only)."""
    counts = np.minimum(np.asarray(counts, dtype=np.int64), capacity)
    E = len(counts)
    cb = min(c_block, capacity)
    nc = -(-capacity // cb)
    nb_live = -(-counts // cb)
    w_block = mats * d_model * d_ff * itemsize
    a_block = 2 * cb * d_model * itemsize
    flops_block = 2 * mats * cb * d_model * d_ff
    padded, ragged = E * nc, int(nb_live.sum())
    return {"padded_weight_bytes": padded * w_block,
            "ragged_weight_bytes": ragged * w_block,
            "padded_bytes": padded * (w_block + a_block),
            "ragged_bytes": ragged * (w_block + a_block),
            "padded_flops": padded * flops_block,
            "ragged_flops": ragged * flops_block}


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
