"""Model-layout wrappers around the kernels: GQA head grouping, the
heads-innermost chunk layout, and count clamping. Port of the matching
functions of ``repro/kernels/ops.py``. Each picks the CUDA kernel for CUDA
tensors and the kernel's plain version for CPU tensors (inside the kernel
modules); nothing falls back from the card to the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attn import (chunked_prefill_attention_kernel,
                                             paged_decode_attention_kernel)
from repro_torch.kernels.moe_gemm import ragged_moe_gemm_kernel
from repro_torch.kernels.moe_gemv import ragged_moe_gemv_kernel


def paged_decode_attention(q, k_pages, v_pages, lengths, block_tables, *,
                           window: int = 0, softcap: float = 0.0):
    """q (B, 1, H, hd); page pools (P, KV, page, hd); lengths (B,);
    block_tables (B, maxp). -> (B, 1, H, hd)."""
    B, _, H, hd = q.shape
    KV = k_pages.shape[1]
    qg = q.reshape(B, KV, H // KV, hd).contiguous()
    out = paged_decode_attention_kernel(
        qg, k_pages, v_pages, lengths.to(torch.int32).contiguous(),
        block_tables.to(torch.int32).contiguous(), window=window,
        softcap=softcap)
    return out.reshape(B, 1, H, hd)


def chunked_prefill_attention(q, k_pages, v_pages, totals, starts,
                              block_tables, *, softcap: float = 0.0):
    """q (B, Sc, H, hd) chunk queries (their K/V already written); pools
    (P, KV, page, hd); totals/starts (B,); block_tables (B, maxp).
    -> (B, Sc, H, hd)."""
    B, Sc, H, hd = q.shape
    KV = k_pages.shape[1]
    qpk = H // KV
    # (B, KV, Sc*qpk, hd), heads innermost so row r = chunk position r // qpk
    qg = q.reshape(B, Sc, KV, qpk, hd).permute(0, 2, 1, 3, 4)
    qg = qg.reshape(B, KV, Sc * qpk, hd).contiguous()
    out = chunked_prefill_attention_kernel(
        qg, k_pages, v_pages, totals.to(torch.int32).contiguous(),
        starts.to(torch.int32).contiguous(),
        block_tables.to(torch.int32).contiguous(), qpk=qpk, softcap=softcap)
    out = out.reshape(B, KV, Sc, qpk, hd).permute(0, 2, 1, 3, 4)
    return out.reshape(B, Sc, H, hd)


def _expert_args(w, x, perm, counts):
    counts = torch.clamp(counts, max=x.shape[1]).to(torch.int32).contiguous()
    return (x.contiguous(), w["wi_gate"], w["wi_up"], w["wo"],
            perm.to(torch.int32).contiguous(), counts)


def ragged_moe_gemm(w, x, counts, perm):
    """Count-aware hot-expert grouped GEMM. x (Eh, C, d) slot buffers (live
    tokens a contiguous prefix of C); w: the layer's full expert weights
    (wi_gate/wi_up (E, d, f), wo (E, f, d)); perm (Eh,) expert id per rank;
    counts (Eh,) live tokens. Slots at or past each count come back zeroed.
    -> (Eh, C, d)."""
    return ragged_moe_gemm_kernel(*_expert_args(w, x, perm, counts))


def moe_gemv(w, x, counts, perm):
    """Count-aware cold-expert GEMV, arguments as ``ragged_moe_gemm``
    (x (Ec, Cc, d)): empty experts stream no weights, dead rows zeroed."""
    return ragged_moe_gemv_kernel(*_expert_args(w, x, perm, counts))
