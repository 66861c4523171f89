"""Attention: the paged KV layout (decode rows and prefill-chunk rows), the
dense KV layout (decode rows, prefill cache writes, chunk rows) and the
attention over whole sequences (training, and whole-prompt prefill).

Port of ``repro/models/attention.py``. Over whole
sequences (``attention_forward``) the port runs ``full_attention`` (plain
PyTorch, differentiated by autograd) or, past ``q_block`` positions,
``blockwise_attention``: the reference's flash core with its hand-written
backward, as a ``torch.autograd.Function`` whose forward and backward are
the flash kernels (``kernels/flash_attn.py``) or their plain versions.
Packed sequences (``segment_ids``: a token attends only keys of its own
segment) take the reference's segmented blockwise route instead, plain
torch ops under autograd, as the reference runs them through XLA. Dense
caches ({"k", "v"} (B, Smax, KV, hd), "pos" (B, Smax), "len" (B,); int8
caches add float32 "k_scale"/"v_scale" (B, Smax, KV)) are updated in place
like the page pools; a dense chunk step writes whole slot rows at targets
that are distinct by construction (``dense_chunk_writes``), because the
reference drops its padded rows' writes out of bounds and CUDA orders
duplicate writes of one ``index_put_`` arbitrarily. A sliding-window
layer's dense cache is a ring of ``window + 1`` slots when max_len exceeds
the window (``is_ring``): position p lives at slot p % window, and slot
``window`` is the reference's dump slot, whose "pos" stays the empty
marker, so it is never read as live. The page pools are updated IN PLACE
(advanced-index assignment, i.e. ``index_put_``) — unlike JAX's functional
``.at[].set()``, which builds a new pool per layer, the port never copies a
pool. Write rules kept from the reference:

* padded decode rows (length 0) and dead chunk positions write into the
  reserved null page 0, which is never read as live;
* a decode write clamps to the last position the block table can hold
  (``bt.shape[1] * page - 1``);
* a chunk's K/V is written before the chunk attends.

int8 caches (``k_scale_pages`` in a page pool, ``k_scale`` in a dense
cache): K/V are quantized per (token, KV head) before the write
(``quantize_kv``), every leaf is updated in place, and attention runs on
int8 operands with the scales folded in — the int8 kernels (page pools),
or ``decode_attention_int8`` / ``chunk_attention_int8`` over the gathered
view, which requantize p * v_scale once over the whole row as the
reference's XLA path does (the kernels do it per page). No float copy of
the cache is built.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attn import (_block_pairs, _kv_blocks, _pair_mask, _q_blocks,
                                            _unblock_q, flash_attention_bwd_plain,
                                            flash_attention_plain)
from repro_torch.kernels.quant import int8_quantize
from repro_torch.models.layers import apply_rope, linear, rmsnorm
from repro_torch.sharding.rules import (heads_local, local_call, logical_constraint,
                                        split_last, take_rows, write_rows)

# the reference's constraints on q and on k, v (B, S, heads, hd)
Q_AXES = ("act_batch", "act_seq", "act_heads", None)
KV_AXES = ("act_batch", "act_seq", "act_kv_heads", None)

NEG_INF = -1e30
POS_EMPTY = 2 ** 31 - 1     # "pos" of a dense-cache slot never written


def _linear(params, x):
    y = linear(x, params["kernel"])
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y


def _project_qkv(params, cfg: ModelConfig, x, positions):
    """x (B,S,D) -> q (B,S,H,hd), k,v (B,S,KV,hd); qk-norm before rope."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = split_last(_linear(params["wq"], x), (cfg.num_heads, hd), Q_AXES)
    k = split_last(_linear(params["wk"], x), (cfg.num_kv_heads, hd), KV_AXES)
    v = split_last(_linear(params["wv"], x), (cfg.num_kv_heads, hd), KV_AXES)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def paged_gather_kv(pages, block_tables):
    """Sequence-contiguous view of the block-table pages: pool
    (P, KV, page, hd), tables (B, maxp) -> (B, maxp*page, KV, hd)."""
    B, maxp = block_tables.shape
    _, KV, page, hd = pages.shape
    g = pages[block_tables.long()]                  # (B, maxp, KV, page, hd)
    return g.permute(0, 1, 3, 2, 4).reshape(B, maxp * page, KV, hd)


def paged_gather_scale(scale_pages, block_tables):
    """Scale-pool counterpart of ``paged_gather_kv``: (P, KV, page) float32
    pool -> (B, maxp*page, KV)."""
    B, maxp = block_tables.shape
    _, KV, page = scale_pages.shape
    g = scale_pages[block_tables.long()]            # (B, maxp, KV, page)
    return g.permute(0, 1, 3, 2).reshape(B, maxp * page, KV)


def quantize_kv(x):
    """x (..., hd) -> (int8 values, float32 scale (...)) per (token, head):
    the one recipe of ``kernels/quant.py``."""
    return int8_quantize(x)


def _int_dot(a8, b8):
    """int8 x int8 product with exact integer sums, as float32: the sums are
    taken in float64 (exact far past int32 range), then rounded to float32
    as an int32 -> float32 cast rounds them."""
    return torch.matmul(a8.double(), b8.double()).float()


def decode_attention_int8(q, k_q, k_scale, v_q, v_scale, cache_len, *,
                          window: int = 0, softcap: float = 0.0, kv_positions=None):
    """Plain int8 decode path. q (B,1,H,hd); k_q/v_q (B,Smax,KV,hd) int8;
    k_scale/v_scale (B,Smax,KV) float32; cache_len (B,); ``kv_positions``
    (B,Smax) as ``decode_attention``'s. Folded-scale int8 QK^T; p * v_scale
    requantized per row over the whole context. -> (B,1,H,hd) in q's
    dtype."""
    B, _, H, hd = q.shape
    Smax, KV = k_q.shape[1], k_q.shape[2]
    scale = 1.0 / math.sqrt(hd)
    q8, q_sc = quantize_kv(q.reshape(B, KV, H // KV, hd))     # (B,KV,qpk,.)
    s = _int_dot(q8, k_q.permute(0, 2, 3, 1))                  # (B,KV,qpk,Smax)
    s = (s * q_sc[..., None] * k_scale.permute(0, 2, 1)[:, :, None, :]) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    pos = (torch.arange(Smax, device=q.device)[None] if kv_positions is None
           else kv_positions.long())
    lens = cache_len.long()[:, None]
    valid = pos < lens
    if window > 0:
        valid = valid & (pos > lens - 1 - window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    pv8, pv_sc = quantize_kv(p * v_scale.permute(0, 2, 1)[:, :, None, :])
    out = _int_dot(pv8, v_q.permute(0, 2, 1, 3)) * pv_sc[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)


def chunk_attention_int8(q, k_q, k_scale, v_q, v_scale, q_positions,
                         kv_positions, kv_len, *, softcap: float = 0.0):
    """Plain int8 chunk path, the chunk counterpart of
    ``decode_attention_int8``. q (B,Sc,H,hd); k_q/v_q (B,Skv,KV,hd) int8;
    scales (B,Skv,KV) float32; positions and masking as ``chunk_attention``.
    -> (B,Sc,H,hd) in q's dtype."""
    B, Sc, H, hd = q.shape
    KV = k_q.shape[2]
    qpk = H // KV
    scale = 1.0 / math.sqrt(hd)
    q8, q_sc = quantize_kv(q.reshape(B, Sc, KV, qpk, hd))    # (B,Sc,KV,qpk,.)
    s = _int_dot(q8.permute(0, 2, 3, 1, 4),                   # (B,KV,qpk,Sc,Skv)
                 k_q.permute(0, 2, 3, 1)[:, :, None])
    s = (s * q_sc.permute(0, 2, 3, 1)[..., None]
         * k_scale.permute(0, 2, 1)[:, :, None, None, :]) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    valid = kv_positions[:, None, :] <= q_positions[:, :, None]          # causal
    valid = valid & (kv_positions < kv_len.long()[:, None])[:, None, :]
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # fully-masked rows (chunk padding) would softmax to uniform: zero them
    p = torch.where(valid[:, None, None], p, torch.zeros_like(p))
    pv8, pv_sc = quantize_kv(p * v_scale.permute(0, 2, 1)[:, :, None, None, :])
    out = _int_dot(pv8, v_q.permute(0, 2, 1, 3)[:, :, None])  # (B,KV,qpk,Sc,hd)
    out = out * pv_sc[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sc, H, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     softcap: float = 0.0, kv_positions=None):
    """Plain decode path. q (B,1,H,hd); caches (B,Smax,KV,hd); cache_len (B,)
    valid entries including the current token; ``kv_positions`` (B,Smax)
    the absolute position each slot holds (a dense cache's "pos" leaf),
    default the slot index. -> (B,1,H,hd)."""
    if hasattr(k_cache, "device_mesh"):
        return _decode_sharded(q, k_cache, v_cache, cache_len, window=window,
                               softcap=softcap, kv_positions=kv_positions)
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bgph,bkgh->bgpk", qg.float(), k_cache.float()) / math.sqrt(hd)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    pos = (torch.arange(Smax, device=q.device)[None] if kv_positions is None
           else kv_positions.long())
    lens = cache_len.long()[:, None]
    valid = pos < lens
    if window > 0:
        valid = valid & (pos > lens - 1 - window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgpk,bkgh->bgph", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, hd)


def _decode_sharded(q, k_cache, v_cache, cache_len, *, window, softcap, kv_positions):
    """``decode_attention`` on DTensor caches, shard by shard (``local_map``):
    each shard attends its rows and KV heads; q's heads follow the cache's
    (gathered where the cache keeps its heads whole). A cache sharded along
    its sequence (context parallelism) is attended block by block, and the
    blocks' softmax statistics combined across those mesh dimensions by
    max- and sum-all-reduces (flash-decoding's merge); otherwise each shard
    runs the plain path on its local blocks."""
    from torch.distributed._functional_collectives import all_reduce
    from torch.distributed.tensor import Replicate
    mesh = k_cache.device_mesh
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    c_pl = [Replicate() if p.is_partial() else p for p in k_cache.placements]
    seq_dims = [i for i, p in enumerate(c_pl) if p.is_shard(1)]
    q_pl = [p if p.is_shard(0) or p.is_shard(2) else Replicate() for p in c_pl]
    row_pl = [p if p.is_shard(0) else Replicate() for p in c_pl]
    pos_pl = [p if p.is_shard(0) or p.is_shard(1) else Replicate() for p in c_pl]
    out_pl = q_pl

    def local(ql, kl, vl, ll, pl):
        if not seq_dims:
            return decode_attention(ql, kl, vl, ll, window=window, softcap=softcap,
                                    kv_positions=pl)
        Bl, _, Hl, _ = ql.shape
        Sl, KVl = kl.shape[1], kl.shape[2]
        qg = ql.reshape(Bl, KVl, Hl // KVl, hd)
        s = torch.einsum("bgph,bkgh->bgpk", qg.float(), kl.float()) / math.sqrt(hd)
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        if pl is None:
            coord = mesh.get_coordinate()
            start, stride = 0, Sl
            for i in reversed(seq_dims):
                start += coord[i] * stride
                stride *= mesh.size(i)
            pos = torch.arange(start, start + Sl, device=ql.device)[None]
        else:
            pos = pl.long()
        lens = ll.long()[:, None]
        valid = pos < lens
        if window > 0:
            valid = valid & (pos > lens - 1 - window)
        valid = valid[:, None, None]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1)
        p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
        l = p.sum(dim=-1)
        acc = torch.einsum("bgpk,bkgh->bgph", p.to(vl.dtype).float(), vl.float())
        for i in seq_dims:
            m_all = all_reduce(m, "max", (mesh, i))
            scale = torch.exp(m - m_all)
            l = all_reduce(l * scale, "sum", (mesh, i))
            acc = all_reduce(acc * scale[..., None], "sum", (mesh, i))
            m = m_all
        out = acc / torch.clamp(l, min=1e-37)[..., None]
        return out.reshape(Bl, 1, Hl, hd).to(vl.dtype)

    return local_call(local, mesh, out_pl,
                      (q_pl, c_pl, c_pl, row_pl, pos_pl if kv_positions is not None else None),
                      q, k_cache, v_cache, cache_len, kv_positions)


def chunk_attention(q, k_ctx, v_ctx, q_positions, kv_positions, kv_len, *,
                    softcap: float = 0.0):
    """Plain chunk path. q (B,Sc,H,hd); contexts (B,Skv,KV,hd); positions of
    queries (B,Sc) and keys (B,Skv); kv_len (B,) including the chunk.
    -> (B,Sc,H,hd)."""
    B, Sc, H, hd = q.shape
    KV = k_ctx.shape[2]
    qg = q.reshape(B, Sc, KV, H // KV, hd)
    s = torch.einsum("bqgph,bkgh->bgpqk", qg.float(), k_ctx.float()) / math.sqrt(hd)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    valid = kv_positions[:, None, :] <= q_positions[:, :, None]          # causal
    valid = valid & (kv_positions < kv_len.long()[:, None])[:, None, :]
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # fully-masked rows (chunk padding) would softmax to uniform: zero them
    p = torch.where(valid[:, None, None], p, torch.zeros_like(p))
    out = torch.einsum("bgpqk,bkgh->bqgph", p.to(v_ctx.dtype), v_ctx)
    return out.reshape(B, Sc, H, hd)


def paged_attention_decode_step(params, cfg: ModelConfig, x, cache, attn_ctx,
                                *, window: int = 0, use_kernels: bool = False):
    """One-token decode against the layer's page pools (updated in place).
    x (B,1,D); cache {"k_pages", "v_pages"} (P,KV,page,hd) (int8 pools add
    "k_scale_pages", "v_scale_pages" (P,KV,page)); attn_ctx {"lengths" (B,),
    "block_tables" (B,maxp)}. Returns (y, cache)."""
    B = x.shape[0]
    lengths = attn_ctx["lengths"].long()
    bt = attn_ctx["block_tables"]
    q, k, v = _project_qkv(params, cfg, x, lengths[:, None])
    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
    page = k_pages.shape[2]
    wpos = torch.clamp(lengths, max=bt.shape[1] * page - 1)
    page_ids = bt.long()[torch.arange(B, device=x.device), wpos // page]
    offs = wpos % page
    new_len = lengths + 1
    if "k_scale_pages" in cache:                         # int8 page pools
        ks_pages, vs_pages = cache["k_scale_pages"], cache["v_scale_pages"]
        k_pages[page_ids, :, offs], ks_pages[page_ids, :, offs] = quantize_kv(k[:, 0])
        v_pages[page_ids, :, offs], vs_pages[page_ids, :, offs] = quantize_kv(v[:, 0])
        if use_kernels:
            from repro_torch.kernels.ops import paged_decode_attention
            out = paged_decode_attention(q, k_pages, v_pages, new_len, bt,
                                         k_scales=ks_pages, v_scales=vs_pages,
                                         window=window,
                                         softcap=cfg.attn_logit_softcap)
        else:
            out = decode_attention_int8(
                q, paged_gather_kv(k_pages, bt), paged_gather_scale(ks_pages, bt),
                paged_gather_kv(v_pages, bt), paged_gather_scale(vs_pages, bt),
                new_len, window=window, softcap=cfg.attn_logit_softcap)
        y = torch.matmul(out.reshape(B, 1, -1), params["wo"]["kernel"])
        return y, cache
    k_pages[page_ids, :, offs] = k[:, 0].to(k_pages.dtype)
    v_pages[page_ids, :, offs] = v[:, 0].to(v_pages.dtype)
    if use_kernels:
        from repro_torch.kernels.ops import paged_decode_attention
        out = paged_decode_attention(q, k_pages, v_pages, new_len, bt,
                                     window=window,
                                     softcap=cfg.attn_logit_softcap)
    else:
        out = decode_attention(q, paged_gather_kv(k_pages, bt),
                               paged_gather_kv(v_pages, bt), new_len,
                               window=window, softcap=cfg.attn_logit_softcap)
    y = torch.matmul(out.reshape(B, 1, -1), params["wo"]["kernel"])
    return y, cache


def paged_attention_chunk_step(params, cfg: ModelConfig, x, cache, chunk_ctx,
                               *, use_kernels: bool = False):
    """Chunked prefill against the layer's page pools (updated in place).
    x (Bc,Sc,D); chunk_ctx {"starts", "chunk_lens", "block_tables"}. The
    chunk's K/V is written into its pages first (dead positions and padded
    rows into null page 0), then the queries attend prefix + chunk.
    Returns (y, cache)."""
    Bc, Sc, _ = x.shape
    dev = x.device
    starts = chunk_ctx["starts"].long()
    clens = chunk_ctx["chunk_lens"].long()
    bt = chunk_ctx["block_tables"]
    positions = starts[:, None] + torch.arange(Sc, device=dev)[None]
    q, k, v = _project_qkv(params, cfg, x, positions)
    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
    page = k_pages.shape[2]
    maxp = bt.shape[1]
    valid = torch.arange(Sc, device=dev)[None] < clens[:, None]
    col = torch.clamp(positions // page, max=maxp - 1)
    page_ids = torch.where(valid, bt.long()[torch.arange(Bc, device=dev)[:, None], col],
                           torch.zeros_like(col))
    offs = positions % page
    total = starts + clens
    if "k_scale_pages" in cache:                         # int8 page pools
        ks_pages, vs_pages = cache["k_scale_pages"], cache["v_scale_pages"]
        k_pages[page_ids, :, offs], ks_pages[page_ids, :, offs] = quantize_kv(k)
        v_pages[page_ids, :, offs], vs_pages[page_ids, :, offs] = quantize_kv(v)
        if use_kernels:
            from repro_torch.kernels.ops import chunked_prefill_attention
            out = chunked_prefill_attention(q, k_pages, v_pages, total, starts, bt,
                                            k_scales=ks_pages, v_scales=vs_pages,
                                            softcap=cfg.attn_logit_softcap)
        else:
            kv_pos = torch.arange(maxp * page, device=dev)[None].expand(Bc, -1)
            out = chunk_attention_int8(
                q, paged_gather_kv(k_pages, bt), paged_gather_scale(ks_pages, bt),
                paged_gather_kv(v_pages, bt), paged_gather_scale(vs_pages, bt),
                positions, kv_pos, total, softcap=cfg.attn_logit_softcap)
        y = torch.matmul(out.reshape(Bc, Sc, -1), params["wo"]["kernel"])
        return y, cache
    k_pages[page_ids, :, offs] = k.to(k_pages.dtype)
    v_pages[page_ids, :, offs] = v.to(v_pages.dtype)
    if use_kernels:
        from repro_torch.kernels.ops import chunked_prefill_attention
        out = chunked_prefill_attention(q, k_pages, v_pages, total, starts, bt,
                                        softcap=cfg.attn_logit_softcap)
    else:
        kv_pos = torch.arange(maxp * page, device=dev)[None].expand(Bc, -1)
        out = chunk_attention(q, paged_gather_kv(k_pages, bt),
                              paged_gather_kv(v_pages, bt), positions, kv_pos,
                              total, softcap=cfg.attn_logit_softcap)
    y = torch.matmul(out.reshape(Bc, Sc, -1), params["wo"]["kernel"])
    return y, cache


# ---------------------------------------------------------------------------
# Attention over whole sequences: training and whole-prompt prefill
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AttnCall:
    causal: bool = True
    window: int = 0          # > 0 for sliding-window layers
    q_block: int = 512
    kv_block: int = 512
    score_bf16: bool = False   # the flash core's bf16 score chain


def _flash_forward(q, k, v, kw, use_kernels, f32_out, score_bf16=False):
    """The flash forward through ``kernels/ops.py`` (``use_kernels``) or the
    plain version directly, either with the bf16 score chain."""
    if use_kernels:
        from repro_torch.kernels.ops import flash_attention
        return flash_attention(q, k, v, f32_out=f32_out, score_bf16=score_bf16, **kw)
    return flash_attention_plain(q, k, v, f32_out=f32_out, score_bf16=score_bf16, **kw)


class _FlashCore(torch.autograd.Function):
    """The reference's ``_flash_core`` (its ``jax.custom_vjp``): the forward
    saves (q, k, v, the float32 output before its cast, lse), as the
    reference saves ``out_b``, and the backward recomputes the scores from
    them and takes D from that float32 output. With ``use_kernels`` both
    run through ``kernels/ops.py`` (the CUDA kernels for CUDA tensors,
    their plain versions for CPU tensors); without, through the plain
    versions directly. ``score_bf16`` reaches the forward's score chain;
    the backward recomputes float32 scores whatever it says, as the
    reference's ``_flash_core_bwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_block, kv_block, use_kernels,
                score_bf16):
        kw = dict(causal=causal, window=window, softcap=softcap, q_block=q_block,
                  kv_block=kv_block)
        out, lse, out32 = _flash_forward(q, k, v, kw, use_kernels, True, score_bf16)
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.kw, ctx.use_kernels = kw, use_kernels
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out32, lse = ctx.saved_tensors
        if ctx.use_kernels:
            from repro_torch.kernels.ops import flash_attention_bwd
            dq, dk, dv = flash_attention_bwd(q, k, v, out32, lse, dout, **ctx.kw)
        else:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, out32, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None, None


def blockwise_attention(q, k, v, *, causal: bool, window: int = 0,
                        softcap: float = 0.0, q_block: int = 512,
                        kv_block: int = 512, use_kernels: bool = False,
                        score_bf16: bool = False, segment_ids=None):
    """q (B,S,H,hd); k, v (B,S,KV,hd) -> (B,S,H,hd) in q's dtype, through
    the flash core (``_FlashCore``): its forward is the reference's
    ``_flash_core`` forward (``kernels/flash_attn.py::flash_attention_plain``
    or, with ``use_kernels``, the flash kernel), and autograd takes its
    hand-written backward. Where no backward can run (grad mode off, or no
    input that requires grad, as in serving prefill) the forward runs
    alone and writes no float32 output. ``score_bf16`` runs the forward's
    bf16 score chain (the reference's, which it runs as XLA ops): in the
    plain forward, or with ``use_kernels`` in the flash kernel (its plain
    version for CPU tensors). With ``segment_ids``
    (B,S) the reference's segmented route runs instead
    (``_segmented_attention``), with no kernel and no custom backward."""
    if segment_ids is not None:
        return _segmented_attention(q, k, v, segment_ids, causal=causal, window=window,
                                    softcap=softcap, q_block=q_block, kv_block=kv_block)
    if not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)):
        kw = dict(causal=causal, window=window, softcap=softcap, q_block=q_block,
                  kv_block=kv_block)
        return _flash_forward(q, k, v, kw, use_kernels, False, score_bf16)[0]
    return _FlashCore.apply(q, k, v, causal, window, softcap, q_block, kv_block,
                            use_kernels, score_bf16)


def _segmented_attention(q, k, v, segment_ids, *, causal, window, softcap, q_block,
                         kv_block):
    """The reference's ``blockwise_attention`` with ``segment_ids``: online
    softmax over the static block schedule, blocks of min(block, S), q
    padded with segment -1 and k/v with -2 (so padding matches nothing),
    each pair masked by position and by equal segments; float32 scores and
    accumulators, p rounded to v's dtype before PV. Autograd
    differentiates it (every pair's probabilities are saved)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    q_block, kv_block = min(q_block, S), min(kv_block, S)
    nq, nkv = -(-S // q_block), -(-S // kv_block)
    scale = 1.0 / math.sqrt(hd)
    qb, kb, vb = _q_blocks(q, KV, q_block), _kv_blocks(k, kv_block), _kv_blocks(v, kv_block)
    seg = segment_ids.long()
    seg_q = torch.nn.functional.pad(seg, (0, nq * q_block - S), value=-1).reshape(B, nq, q_block)
    seg_kv = torch.nn.functional.pad(seg, (0, nkv * kv_block - S), value=-2).reshape(
        B, nkv, kv_block)
    window_blocks = (window + q_block - 1) // kv_block + 1 if window > 0 else 0
    acc = [torch.zeros(qb.shape[:3] + qb.shape[4:], dtype=torch.float32, device=q.device)
           for _ in range(nq)]
    m = [torch.full(qb.shape[:3] + qb.shape[4:5], NEG_INF, dtype=torch.float32,
                    device=q.device) for _ in range(nq)]
    l = [torch.zeros_like(mi) for mi in m]
    for qi, ki in _block_pairs(nq, nkv, causal=causal, window_blocks=window_blocks):
        qt, kt, vt = qb[:, :, :, qi], kb[:, :, ki], vb[:, :, ki]
        s = torch.einsum("bgpqh,bgkh->bgpqk", qt.float(), kt.float()) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        mask = _pair_mask(qi, ki, q_block, kv_block, S, causal, window, q.device)
        same = seg_q[:, qi, :, None] == seg_kv[:, ki, None, :]       # (B, qb, kb)
        s = torch.where(mask & same[:, None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m[qi], s.amax(dim=-1))
        alpha = torch.exp(m[qi] - m_new)
        p = torch.exp(s - m_new[..., None])
        l[qi] = l[qi] * alpha + p.sum(dim=-1)
        acc[qi] = acc[qi] * alpha[..., None] + torch.einsum(
            "bgpqk,bgkh->bgpqh", p.to(vt.dtype).float(), vt.float())
        m[qi] = m_new
    out = torch.stack(acc, dim=3) / torch.clamp(torch.stack(l, dim=3)[..., None], min=1e-37)
    return _unblock_q(out, S).to(q.dtype)


def full_attention(q, k, v, *, causal: bool, window: int = 0,
                   softcap: float = 0.0, segment_ids=None, kv_segment_ids=None):
    """Unblocked prefill attention (materializes the scores). q (B,S,H,hd);
    k, v (B,Skv,KV,hd) -> (B,S,H,hd) in v's dtype. ``segment_ids`` (B,S)
    keeps each query to the keys of its own segment, the keys' segments
    being ``kv_segment_ids`` (B,Skv) (default ``segment_ids``)."""
    B, S, H, hd = q.shape
    KV, Skv = k.shape[2], k.shape[1]
    qg = q.reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bqgph,bkgh->bgpqk", qg.float(), k.float()) / math.sqrt(hd)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(S, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    mask = mask[None, None, None]
    if segment_ids is not None:
        ks = kv_segment_ids if kv_segment_ids is not None else segment_ids
        mask = mask & (segment_ids[:, :, None] == ks[:, None, :])[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgpqk,bkgh->bqgph", p.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


def attention_forward(params, cfg: ModelConfig, x, positions, call: AttnCall,
                      return_kv: bool = False, use_kernels: bool = False,
                      segment_ids=None):
    """Train/prefill attention over whole sequences. x (B,S,D); positions
    (B,S); ``segment_ids`` (B,S) for packed sequences. The flash core for S
    > ``call.q_block`` (with ``use_kernels`` through the flash kernels),
    else the unblocked path, which autograd differentiates. Returns y
    (B,S,D), and (k, v) (B,S,KV,hd) with ``return_kv``."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)
    q = logical_constraint(q, Q_AXES)
    k = logical_constraint(k, KV_AXES)
    v = logical_constraint(v, KV_AXES)

    def core(q, k, v):
        if S > call.q_block:
            return blockwise_attention(q, k, v, causal=call.causal, window=call.window,
                                       softcap=cfg.attn_logit_softcap,
                                       q_block=call.q_block, kv_block=call.kv_block,
                                       use_kernels=use_kernels, score_bf16=call.score_bf16,
                                       segment_ids=segment_ids)
        return full_attention(q, k, v, causal=call.causal, window=call.window,
                              softcap=cfg.attn_logit_softcap, segment_ids=segment_ids)

    out = heads_local(core, q, k, v)
    y = linear(out.reshape(B, S, -1), params["wo"]["kernel"])
    y = logical_constraint(y, ("act_batch", "act_seq", "act_embed"))
    if return_kv:
        return y, (k, v)
    return y


def cross_attention_forward(params, cfg: ModelConfig, x, kv, segment_ids=None,
                            kv_segment_ids=None):
    """Decoder cross-attention: x (B,S,D) against ``kv`` = (k, v) (B,Se,KV,hd)
    from ``cross_kv``; no rope, no mask but the segments' (the keys'
    ``kv_segment_ids``, default ``segment_ids``, as in ``full_attention``).
    The unblocked plain path at any length, as the reference runs it."""
    B, S, _ = x.shape
    q = split_last(_linear(params["wq"], x), (cfg.num_heads, cfg.resolved_head_dim),
                   Q_AXES)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
    k, v = kv
    out = heads_local(lambda q, k, v: full_attention(
        q, k, v, causal=False, segment_ids=segment_ids, kv_segment_ids=kv_segment_ids),
        q, k, v)
    return linear(out.reshape(B, S, -1), params["wo"]["kernel"])


def cross_kv(params, cfg: ModelConfig, enc_out):
    """The encoder output (B,Se,D) projected to cross-attention K/V (B,Se,KV,hd)
    once a request (k-norm, no rope)."""
    B, S, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = split_last(_linear(params["wk"], enc_out), (cfg.num_kv_heads, hd), KV_AXES)
    v = split_last(_linear(params["wv"], enc_out), (cfg.num_kv_heads, hd), KV_AXES)
    if cfg.qk_norm:
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    return k, v


# ---------------------------------------------------------------------------
# Dense KV layout
# ---------------------------------------------------------------------------

def is_ring(cache, window: int) -> bool:
    """A windowed layer's dense cache is a ring when it was sized
    ``window + 1`` (max_len > window); otherwise it appends, and ``window``
    only masks."""
    return window > 0 and cache["k"].shape[1] == window + 1


def _write_kv(cache, idx, k, v) -> None:
    """Write K/V (and, into an int8 cache, their int8 values and float32
    scales per (token, KV head)) at ``cache[leaf][b, idx[b]]`` of every
    row b (``sharding/rules.py::write_rows``)."""
    if "k_scale" in cache:
        for name, x in (("k", k), ("v", v)):
            q, sc = quantize_kv(x)
            write_rows(cache[name], idx, q)
            write_rows(cache[name + "_scale"], idx, sc)
    else:
        write_rows(cache["k"], idx, k.to(cache["k"].dtype))
        write_rows(cache["v"], idx, v.to(cache["v"].dtype))


def write_prefill_cache(cache, k, v, true_len, *, window: int = 0):
    """Write prefill K/V (B,S,KV,hd) into a dense decode cache in place,
    "len" = true_len. Returns the cache.

    Full caches: token t at slot t ("pos" gets t for t < true_len, the empty
    marker past it; the padding's K/V is written too and is never read as
    live). Rings (``is_ring``): slot r takes the last valid position p <
    true_len with p % window == r, for the slots some valid position maps to
    (the others keep what they held), and the dump slot's "pos" is the
    empty marker. The reference sends every masked position to the dump
    slot, where one ``index_put_`` with duplicate targets would land an
    arbitrary value on CUDA; here each slot is written once, from a gather,
    so the live slots are deterministic and the dump slot's K/V (never read)
    is left as it was. int8 caches quantize per (token, KV head)."""
    B, S = k.shape[0], k.shape[1]
    size = cache["k"].shape[1]
    dev = k.device
    tl = true_len.long()[:, None]
    if is_ring(cache, window):
        r = torch.arange(window, device=dev)[None]
        src = tl - 1 - torch.remainder(tl - 1 - r, window)       # (B, window)
        valid = src >= 0
        src = torch.clamp(src, min=0)
        new = {"pos": src, "k": take_rows(k, src), "v": take_rows(v, src)}
        if "k_scale" in cache:
            new["k"], new["k_scale"] = quantize_kv(new["k"])
            new["v"], new["v_scale"] = quantize_kv(new["v"])
        for name, vals in new.items():
            leaf = cache[name][:, :window]
            keep = valid.reshape(valid.shape + (1,) * (vals.dim() - 2))
            leaf.copy_(torch.where(keep, vals.to(leaf.dtype), leaf))
        cache["pos"][:, window].fill_(POS_EMPTY)
    else:
        pos = torch.arange(S, device=dev)[None].expand(B, S)
        idx = torch.clamp(pos, max=size - 1)
        write_rows(cache["pos"], idx, torch.where(pos < tl, pos, torch.full_like(
            pos, POS_EMPTY)).to(cache["pos"].dtype))
        _write_kv(cache, idx, k, v)
    cache["len"].copy_(true_len)
    return cache


def attention_decode_step(params, cfg: ModelConfig, x, cache, *, window: int = 0,
                          use_kernels: bool = False):
    """One-token decode against a dense cache (updated in place). x (B,1,D);
    cache {"k", "v"} (B,Smax,KV,hd), "pos" (B,Smax), "len" (B,) — the new
    token's position (int8 caches add "k_scale"/"v_scale"). The write goes
    to slot ``len % window`` on a ring, else to ``min(len, Smax - 1)``; K/V
    are cast to the cache dtype (or quantized) before it. Attention:

    * int8 caches: ``decode_attention_int8`` masked by "pos", with no
      kernel, as the reference runs them;
    * rings: the plain ``decode_attention`` masked by "pos" even with
      ``use_kernels``. That is the reference's own route for a ring (its
      "ring-buffer caches need position-based masking and stay on the XLA
      path"): the dense decode kernel takes a slot's index for its
      position, which a ring breaks. It is not a fallback;
    * otherwise, with ``use_kernels``, the dense decode kernel over the
      positions < len + 1 (with the window mask on a local layer that
      appends), else the plain path masked by "pos".

    Returns (y, cache)."""
    B = x.shape[0]
    positions = cache["len"].long()                      # (B,)
    q, k, v = _project_qkv(params, cfg, x, positions[:, None])
    Smax = cache["k"].shape[1]
    ring = is_ring(cache, window)
    write_idx = positions % window if ring else torch.clamp(positions, max=Smax - 1)
    write_rows(cache["pos"], write_idx, positions.to(cache["pos"].dtype))
    new_len = positions + 1
    _write_kv(cache, write_idx, k[:, 0], v[:, 0])
    if "k_scale" in cache:
        out = decode_attention_int8(q, cache["k"], cache["k_scale"], cache["v"],
                                    cache["v_scale"], new_len, window=window,
                                    softcap=cfg.attn_logit_softcap,
                                    kv_positions=cache["pos"])
    elif use_kernels and not ring:
        from repro_torch.kernels.ops import decode_attention as decode_attn_kernel
        out = decode_attn_kernel(q, cache["k"], cache["v"], new_len, window=window,
                                 softcap=cfg.attn_logit_softcap)
    else:
        out = decode_attention(q, cache["k"], cache["v"], new_len, window=window,
                               softcap=cfg.attn_logit_softcap,
                               kv_positions=cache["pos"])
    cache["len"].copy_(new_len)
    y = linear(out.reshape(B, 1, -1), params["wo"]["kernel"])
    return y, cache


def dense_chunk_writes(chunk_ctx, nrows: int, Smax: int, Sc: int) -> dict:
    """Where a dense chunk step of ``Sc``-wide rows writes in a cache of
    ``nrows`` slots of ``Smax`` positions, worked out on the device without
    a host sync, once for every layer of a stage. The reference writes chunk
    position j of row b at slot ``slots[b]``, position ``min(start + j,
    Smax - 1)``, and drops (out of bounds) every write of a padded row
    (``chunk_lens`` 0) and every position past a row's ``chunk_len``; where
    the clamp sends several positions to ``Smax - 1`` the last one written
    holds it. Here a step writes whole slot rows instead: ``m = min(Bc,
    nrows)`` rows (every live row among them, live rows first), each at a
    distinct target, a live row at its slot and a padded one at a slot no
    live row takes (rewriting it unchanged). Returns {"order" (m,) the chunk
    rows written, "targets" (m,) their slots, "keep" (m, Smax) the positions
    a row writes, "src" (m, Smax) the chunk position each takes, "live"
    (m,)}."""
    slots = chunk_ctx["slots"].long()
    starts = chunk_ctx["starts"].long()
    clens = chunk_ctx["chunk_lens"].long()
    dev = slots.device
    live = clens > 0
    order = torch.argsort((~live).to(torch.int8), stable=True)[:min(len(slots), nrows)]
    live_m, slots_m = live[order], slots[order]
    rows = torch.arange(nrows, device=dev)
    taken = ((slots_m[None] == rows[:, None]) & live_m[None]).any(1)
    spare = torch.argsort(taken.to(torch.int8), stable=True)      # untaken slots first
    rank = torch.clamp(torch.cumsum((~live_m).long(), 0) - 1, min=0)
    targets = torch.where(live_m, slots_m, spare[rank])
    st, cl = starts[order][:, None], clens[order][:, None]
    s = torch.arange(Smax, device=dev)[None]
    j = s - st
    at_end = (s == Smax - 1) & (cl > 0) & (st + cl - 1 >= Smax - 1)
    keep = ((j >= 0) & (j < cl) & (s < Smax - 1)) | at_end
    src = torch.clamp(torch.where(at_end, cl - 1, j), 0, Sc - 1)
    return {"order": order, "targets": targets, "keep": keep, "src": src,
            "live": live_m}


def _write_rows(leaf, w, values):
    """Write ``values`` (m, Smax, ...) into ``leaf``'s rows ``w["targets"]``
    where ``w["keep"]`` holds, keeping the rest of each row."""
    t = w["targets"]
    keep = w["keep"].reshape(w["keep"].shape + (1,) * (values.dim() - 2))
    leaf[t] = torch.where(keep, values.to(leaf.dtype), leaf[t])


def attention_chunk_step(params, cfg: ModelConfig, x, cache, chunk_ctx):
    """Chunked prefill against a dense slot cache (updated in place). x
    (Bc,Sc,D); chunk_ctx {"slots" (Bc,) cache rows, "starts" (Bc,) first
    positions, "chunk_lens" (Bc,) live chunk tokens, optionally "writes"
    (``dense_chunk_writes``)}. Writes the chunk's K/V and positions
    (clamped to Smax - 1) and, for rows with chunk_len > 0, "len" = start +
    chunk_len; padded rows and positions past a row's chunk_len write
    nothing. Then the queries attend over the gathered slot rows through
    ``chunk_attention`` (the reference runs this in XLA, not in a kernel),
    or on an int8 cache through ``chunk_attention_int8``, whose int8 values
    and scales go through the same row writes. Returns (y, cache)."""
    Bc, Sc, _ = x.shape
    dev = x.device
    slots = chunk_ctx["slots"].long()
    starts = chunk_ctx["starts"].long()
    clens = chunk_ctx["chunk_lens"].long()
    positions = starts[:, None] + torch.arange(Sc, device=dev)[None]
    q, k, v = _project_qkv(params, cfg, x, positions)
    nrows, Smax = cache["k"].shape[:2]
    w = chunk_ctx.get("writes")
    if w is None:
        w = dense_chunk_writes(chunk_ctx, nrows, Smax, Sc)
    order, src = w["order"], w["src"]
    r = torch.arange(len(order), device=dev)[:, None]
    k, v = k[order][r, src], v[order][r, src]
    if "k_scale" in cache:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        _write_rows(cache["k_scale"], w, ks)
        _write_rows(cache["v_scale"], w, vs)
    _write_rows(cache["k"], w, k)
    _write_rows(cache["v"], w, v)
    _write_rows(cache["pos"], w, positions[order][r, src])
    total = starts + clens
    t = w["targets"]
    cache["len"][t] = torch.where(w["live"], total[order], cache["len"][t].long()
                                  ).to(cache["len"].dtype)
    kv_pos = cache["pos"][slots].long()
    if "k_scale" in cache:
        out = chunk_attention_int8(q, cache["k"][slots], cache["k_scale"][slots],
                                   cache["v"][slots], cache["v_scale"][slots], positions,
                                   kv_pos, total, softcap=cfg.attn_logit_softcap)
    else:
        out = chunk_attention(q, cache["k"][slots], cache["v"][slots], positions, kv_pos,
                              total, softcap=cfg.attn_logit_softcap)
    y = linear(out.reshape(Bc, Sc, -1), params["wo"]["kernel"])
    return y, cache
