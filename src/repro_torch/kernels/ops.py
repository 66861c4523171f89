"""Model-layout wrappers around the kernels: GQA head grouping, the
heads-innermost chunk layout, and count clamping. Port of the matching
functions of ``repro/kernels/ops.py``. Each picks the CUDA kernel for CUDA
tensors and the kernel's plain version for CPU tensors (inside the kernel
modules); nothing falls back from the card to the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attn import (
    chunked_prefill_attention_int8_kernel, chunked_prefill_attention_kernel,
    decode_attention_kernel, paged_decode_attention_int8_kernel,
    paged_decode_attention_kernel)
from repro_torch.kernels.flash_attn import (flash_attention_bwd_kernel,
                                            flash_attention_kernel)
from repro_torch.kernels.moe_gemm import moe_gemm_kernel, ragged_moe_gemm_kernel
from repro_torch.kernels.moe_gemv import moe_gemv_kernel, ragged_moe_gemv_kernel
from repro_torch.kernels.ssd_decode import ssd_decode_kernel


def _i32(t):
    return t.to(torch.int32).contiguous()


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_block: int = 512, kv_block: int = 512,
                    f32_out: bool = False):
    """q (B, S, H, hd); k, v (B, S, KV, hd), read in place (no transpose or
    padding: the kernels take the model layout). -> (out (B, S, H, hd),
    lse (B, H, S) float32), and with ``f32_out`` the float32 output too.
    ``q_block``/``kv_block`` reach only the plain version (CPU tensors)."""
    return flash_attention_kernel(q, k, v, causal=causal, window=window, softcap=softcap,
                                  q_block=q_block, kv_block=kv_block, f32_out=f32_out)


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, q_block: int = 512, kv_block: int = 512):
    """Gradients of ``flash_attention`` from its inputs, float32 output, lse
    and the output's gradient ``dout`` (made contiguous here: autograd may hand a
    strided one). -> (dq, dk, dv)."""
    return flash_attention_bwd_kernel(q, k, v, out, lse, dout.contiguous(), causal=causal,
                                      window=window, softcap=softcap, q_block=q_block,
                                      kv_block=kv_block)


def decode_attention(q, k_cache, v_cache, lengths, *, window: int = 0,
                     softcap: float = 0.0):
    """q (B, 1, H, hd); dense caches (B, Smax, KV, hd) read in place (no
    transpose or padding of the cache); lengths (B,). -> (B, 1, H, hd)."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, hd).contiguous()
    out = decode_attention_kernel(qg, k_cache, v_cache, _i32(lengths), window=window,
                                  softcap=softcap)
    return out.reshape(B, 1, H, hd)


def ssd_decode(state, x, dt, a_log, b, c, d):
    """Mamba-2 decode state update: state (B, H, N, P) float32 (updated in
    place on the card); x (B, H, P); dt (B, H); a_log, d (H,); b, c (B, N).
    Returns (y (B, H, P) in x's dtype, new state)."""
    f32 = lambda t: t.float().contiguous()
    return ssd_decode_kernel(state, x.contiguous(), f32(dt), f32(a_log), f32(b),
                             f32(c), f32(d))


def paged_decode_attention(q, k_pages, v_pages, lengths, block_tables, *,
                           k_scales=None, v_scales=None, window: int = 0,
                           softcap: float = 0.0):
    """q (B, 1, H, hd); page pools (P, KV, page, hd); lengths (B,);
    block_tables (B, maxp). With ``k_scales``/``v_scales`` ((P, KV, page)
    float32) the pools are int8 and the int8 kernel runs. -> (B, 1, H, hd)."""
    B, _, H, hd = q.shape
    KV = k_pages.shape[1]
    qg = q.reshape(B, KV, H // KV, hd).contiguous()
    kw = dict(window=window, softcap=softcap)
    if k_scales is None:
        out = paged_decode_attention_kernel(qg, k_pages, v_pages, _i32(lengths),
                                            _i32(block_tables), **kw)
    else:
        out = paged_decode_attention_int8_kernel(qg, k_pages, k_scales, v_pages,
                                                 v_scales, _i32(lengths),
                                                 _i32(block_tables), **kw)
    return out.reshape(B, 1, H, hd)


def chunked_prefill_attention(q, k_pages, v_pages, totals, starts,
                              block_tables, *, k_scales=None, v_scales=None,
                              softcap: float = 0.0):
    """q (B, Sc, H, hd) chunk queries (their K/V already written); pools
    (P, KV, page, hd); totals/starts (B,); block_tables (B, maxp);
    ``k_scales``/``v_scales`` select the int8 kernel as in
    ``paged_decode_attention``. -> (B, Sc, H, hd)."""
    B, Sc, H, hd = q.shape
    KV = k_pages.shape[1]
    qpk = H // KV
    # (B, KV, Sc*qpk, hd), heads innermost so row r = chunk position r // qpk
    qg = q.reshape(B, Sc, KV, qpk, hd).permute(0, 2, 1, 3, 4)
    qg = qg.reshape(B, KV, Sc * qpk, hd).contiguous()
    ctx = (_i32(totals), _i32(starts), _i32(block_tables))
    if k_scales is None:
        out = chunked_prefill_attention_kernel(qg, k_pages, v_pages, *ctx,
                                               qpk=qpk, softcap=softcap)
    else:
        out = chunked_prefill_attention_int8_kernel(qg, k_pages, k_scales, v_pages,
                                                    v_scales, *ctx, qpk=qpk,
                                                    softcap=softcap)
    out = out.reshape(B, KV, Sc, qpk, hd).permute(0, 2, 1, 3, 4)
    return out.reshape(B, Sc, H, hd)


def _expert_args(w, x, perm, counts=None):
    args = (x.contiguous(), w["wi_gate"], w["wi_up"], w["wo"], _i32(perm))
    if counts is None:
        return args
    return args + (_i32(torch.clamp(counts, max=x.shape[1])),)


def ragged_moe_gemm(w, x, counts, perm):
    """Count-aware hot-expert grouped GEMM. x (Eh, C, d) slot buffers (live
    tokens a contiguous prefix of C); w: the layer's full expert weights
    (wi_gate/wi_up (E, d, f), wo (E, f, d)); perm (Eh,) expert id per rank;
    counts (Eh,) live tokens. Slots at or past each count come back zeroed.
    -> (Eh, C, d)."""
    return ragged_moe_gemm_kernel(*_expert_args(w, x, perm, counts))


def moe_gemm(w, x, perm):
    """Capacity-padded hot-expert grouped GEMM: every slot of the capacity
    is computed. Arguments as ``ragged_moe_gemm`` without counts."""
    return moe_gemm_kernel(*_expert_args(w, x, perm))


def moe_gemv(w, x, counts, perm):
    """Cold-expert GEMV, arguments as ``ragged_moe_gemm`` (x (Ec, Cc, d)).
    With counts, empty experts stream no weights and dead rows come back
    zeroed; with ``counts=None`` the capacity-padded kernel computes every
    slot."""
    if counts is None:
        return moe_gemv_kernel(*_expert_args(w, x, perm))
    return ragged_moe_gemv_kernel(*_expert_args(w, x, perm, counts))
