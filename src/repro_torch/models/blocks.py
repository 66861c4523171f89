"""Decoder blocks and the segment loops: the training forward, decode
steps and unified mixed stages on the paged and dense KV layouts, and
whole-prompt prefill.

Port of ``repro/models/blocks.py`` for every block kind: full,
sliding-window and bidirectional (encoder) self-attention, decoder blocks
with self- and cross-attention, and Mamba-2 mixers, with a dense, MoE or
no FFN. A segment's
parameters and cache carry a stacked ``layers`` axis; where the reference
``jax.lax.scan``s over it, the port loops over it in Python and hands each
block the layer's slices (views, so cache writes land in the stacked
leaves). Cache leaves are laid out (layers, batch or pages, ...), as the
reference's. The training forward takes the layers from one
``torch.unbind`` per leaf, so the backward builds each stacked gradient
with one ``stack`` (indexing ``leaf[i]`` per layer would make autograd add
a full-size zero gradient per layer).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import (ATTN, ATTN_BIDIR, ATTN_CROSS, ATTN_LOCAL, MAMBA,
                                      MOE, NONE, LayerKind, ModelConfig)
from repro_torch.core.execution import ExecutionPlan, moe_execute
from repro_torch.models.attention import (POS_EMPTY, Q_AXES, AttnCall, attention_chunk_step,
                                          attention_decode_step, attention_forward,
                                          cross_attention_forward, cross_kv,
                                          decode_attention, paged_attention_chunk_step,
                                          paged_attention_decode_step,
                                          write_prefill_cache)
from repro_torch.models.ffn import ffn_apply
from repro_torch.models.layers import linear, rmsnorm
from repro_torch.models.ssm import mamba_decode_step, mamba_forward, mamba_init_cache
from repro_torch.sharding.rules import split_last


def _window(cfg: ModelConfig, kind: LayerKind) -> int:
    """The attention window of a block: the config's for a sliding-window
    mixer, 0 (none) otherwise."""
    return cfg.sliding_window if kind.mixer == ATTN_LOCAL else 0


def block_init_cache(cfg: ModelConfig, kind: LayerKind, batch: int = 0,
                     max_len: int = 0, *, dtype, device, layers: int = 1,
                     kv_quant: bool = False, page_size: int = 0,
                     num_pages: int = 0, enc_len: int = 0) -> dict:
    """The decode cache of ``layers`` stacked copies of this block.

    Dense: an attention block holds "k"/"v" (layers, batch, size, KV, hd),
    "pos" (layers, batch, size) int32 (the empty marker until written) and
    "len" (layers, batch) int32, where size is max_len, or for a
    sliding-window block ``min(max_len, window) + 1`` (a ring of window
    slots and the dump slot when max_len > window); with ``kv_quant`` "k"
    and "v" are int8 and float32 "k_scale"/"v_scale" (layers, batch, size,
    KV) ride beside them. A cross-attention block adds the encoder's K/V,
    "cross_k"/"cross_v" (layers, batch, enc_len or max_len, KV, hd) in
    ``dtype`` whatever ``kv_quant`` says, and "cross_len" (layers, batch)
    int32; the reference sizes them max_len and its prefill replaces them
    with the encoder's length, where the port's prefill writes the first
    positions in place, so ``enc_len`` sizes them for the longest encoder
    input. An encoder (bidirectional) block has no cache: ValueError.
    A Mamba block holds {"mamba": {"conv", "ssm"}}
    (``ssm.mamba_init_cache``). Paged (``page_size`` > 0, full
    self-attention blocks only): the page pools (layers, num_pages, KV,
    page, hd); page 0 is the null page. With ``kv_quant`` the value pools
    are int8 and float32 per-(token, KV head) scale pools (layers,
    num_pages, KV, page) ride beside them."""
    if kind.mixer == ATTN_BIDIR:
        raise ValueError("an encoder (bidirectional attention) block has no decode cache")
    if page_size == 0:
        if kind.mixer == MAMBA:
            return {"mamba": mamba_init_cache(cfg, batch, dtype, device, layers)}
        window = _window(cfg, kind)
        size = min(max_len, window) + 1 if window > 0 else max_len
        shape = (layers, batch, size, cfg.num_kv_heads, cfg.resolved_head_dim)
        kv_dtype = torch.int8 if kv_quant else dtype
        cache = {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
                 "v": torch.zeros(shape, dtype=kv_dtype, device=device),
                 "pos": torch.full(shape[:3], POS_EMPTY, dtype=torch.int32,
                                   device=device),
                 "len": torch.zeros(shape[:2], dtype=torch.int32, device=device)}
        if kv_quant:
            cache["k_scale"] = torch.zeros(shape[:4], dtype=torch.float32, device=device)
            cache["v_scale"] = torch.zeros(shape[:4], dtype=torch.float32, device=device)
        if kind.mixer == ATTN_CROSS:
            cross = (layers, batch, enc_len or max_len) + shape[3:]
            cache["cross_k"] = torch.zeros(cross, dtype=dtype, device=device)
            cache["cross_v"] = torch.zeros(cross, dtype=dtype, device=device)
            cache["cross_len"] = torch.zeros(shape[:2], dtype=torch.int32, device=device)
        return cache
    if kind.mixer != ATTN:
        raise ValueError(f"paged KV cache supports full self-attention decoder "
                         f"layers only, got mixer={kind.mixer}")
    shape = (layers, num_pages, cfg.num_kv_heads, page_size,
             cfg.resolved_head_dim)
    if not kv_quant:
        return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
                "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
    return {"k_pages": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_pages": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale_pages": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v_scale_pages": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}


def _attn_call(cfg: ModelConfig, kind: LayerKind, plan: ExecutionPlan) -> AttnCall:
    """The attention call of a self-attention block: causal (not for an
    encoder's bidirectional mixer), windowed for a sliding-window mixer,
    with the plan's flash-core tiles and score precision."""
    return AttnCall(causal=kind.mixer != ATTN_BIDIR, window=_window(cfg, kind),
                    q_block=plan.attn_q_block,
                    kv_block=plan.attn_kv_block, score_bf16=plan.attn_score_bf16)


def block_forward(params, cfg: ModelConfig, kind: LayerKind, x, positions,
                  plan: ExecutionPlan, segment_ids=None, enc_out=None,
                  enc_segment_ids=None):
    """Training forward of one block over whole sequences. x (B,S,d);
    ``segment_ids`` (B,S) for packed sequences (attention mixers only); a
    cross-attention block attends ``enc_out`` (B,Se,d) after its
    self-attention, the keys' segments being ``enc_segment_ids`` (default
    ``segment_ids``, the reference's behaviour, which only fits Se == S).
    Returns (x, aux) with aux the MoE layer's load-balance loss (a float32
    zero for other FFNs)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if kind.mixer == MAMBA:
        mixer_out = mamba_forward(params["mixer"], cfg, h)
    else:
        mixer_out = attention_forward(params["mixer"], cfg, h, positions,
                                      _attn_call(cfg, kind, plan),
                                      use_kernels=plan.use_kernels, segment_ids=segment_ids)
    if cfg.parallel_block and kind.ffn != NONE:
        ffn_out, aux = _ffn(params, cfg, kind, h, plan)
        return x + mixer_out + ffn_out, zero if aux is None else aux
    x = x + mixer_out
    if kind.mixer == ATTN_CROSS:
        h = rmsnorm(params["norm_cross"], x, cfg.norm_eps)
        x = x + cross_attention_forward(params["cross"], cfg, h,
                                        cross_kv(params["cross"], cfg, enc_out),
                                        segment_ids=segment_ids,
                                        kv_segment_ids=enc_segment_ids)
    if kind.ffn == NONE:
        return x, zero
    ffn_out, aux = _ffn(params, cfg, kind, rmsnorm(params["norm2"], x, cfg.norm_eps), plan)
    return x + ffn_out, zero if aux is None else aux


def _unbind_layers(tree, n: int) -> list:
    """The ``n`` per-layer trees of a stacked tree, one ``torch.unbind`` of
    the layer axis per leaf."""
    if isinstance(tree, dict):
        parts = {k: _unbind_layers(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (tuple, list)):
        parts = [_unbind_layers(v, n) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(n)]
    return list(torch.unbind(tree, 0))


# remat="dots": the outputs of matrix products with no batch dimension are
# saved, everything else is recomputed in the backward: the reference's
# jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims. A 2-D weight
# times activations is aten.mm (torch.matmul folds the leading dimensions);
# the experts' batched products (bmm) and the attention are recomputed, the
# flash kernels too: they run outside the dispatcher, so nothing caches them
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_context():
    return create_selective_checkpoint_contexts(list(DOTS_SAVED))


def segment_forward(params, cfg: ModelConfig, seg, x, positions, plan: ExecutionPlan,
                    *, remat: str = "full", segment_ids=None, enc_out=None):
    """Training forward over the segment's stacked super-blocks, a loop where
    the reference scans. ``remat="full"`` recomputes each super-block in the
    backward (``torch.utils.checkpoint``, non-reentrant), keeping only its
    input; "dots" keeps the outputs of its products with no batch dimension
    and recomputes the rest (``DOTS_SAVED``); "none" keeps every
    activation. ``segment_ids`` (B,S) reach every attention layer, the
    encoder output ``enc_out`` every cross-attention layer. Returns (x, aux
    summed over the segment's layers)."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat={remat!r}: expected 'none', 'full' or 'dots'")

    def super_block(x, blk, enc_out):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, kind in enumerate(seg.pattern):
            x, a = block_forward(blk["blocks"][i], cfg, kind, x, positions, plan,
                                 segment_ids=segment_ids, enc_out=enc_out)
            aux = aux + a
        return x, aux

    auxs = []
    for blk in _unbind_layers(params, seg.repeats):
        if remat == "full":
            x, aux = checkpoint(super_block, x, blk, enc_out, use_reentrant=False)
        elif remat == "dots":
            x, aux = checkpoint(super_block, x, blk, enc_out, use_reentrant=False,
                                context_fn=_dots_context)
        else:
            x, aux = super_block(x, blk, enc_out)
        auxs.append(aux)
    return x, torch.stack(auxs).sum()


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _ffn(params, cfg, kind, h, plan, valid=None, counts=None):
    """The block's FFN -> (out, the MoE layer's load-balance loss, or None
    for a dense FFN); an MoE layer adds its routed counts into ``counts``
    unless that is None (prefill and training collect none)."""
    if kind.ffn != MOE:
        return ffn_apply(params["ffn"], h), None
    out, router = moe_execute(params["ffn"], cfg, h, plan, token_valid=valid)
    if counts is not None:
        c = router.counts.float()
        counts += c.full_tensor() if hasattr(c, "full_tensor") else c
    return out, router.aux_loss


def block_decode_step(params, cfg: ModelConfig, kind: LayerKind, x, cache,
                      attn_ctx, plan: ExecutionPlan, counts):
    """Single-token decode. x (B,1,d). The mixer follows the cache: Mamba
    state, page pools ("k_pages") or a dense cache. Adds the layer's
    per-expert routed counts into ``counts`` ((E,) float32). Returns x."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    valid = attn_ctx.get("valid") if attn_ctx else None
    if kind.mixer == MAMBA:
        mixer_out, _ = mamba_decode_step(params["mixer"], cfg, h, cache["mamba"],
                                         use_kernels=plan.use_kernels)
    elif "k_pages" in cache:
        mixer_out, _ = paged_attention_decode_step(params["mixer"], cfg, h, cache,
                                                   attn_ctx, window=_window(cfg, kind),
                                                   use_kernels=plan.use_kernels)
    else:
        mixer_out, _ = attention_decode_step(params["mixer"], cfg, h, cache,
                                             window=_window(cfg, kind),
                                             use_kernels=plan.use_kernels)
    if cfg.parallel_block and kind.ffn != NONE:
        return x + mixer_out + _ffn(params, cfg, kind, h, plan, valid, counts)[0]
    x = x + mixer_out
    if kind.mixer == ATTN_CROSS:
        # the reference's route: the plain decode over the cross cache up
        # to "cross_len", q projected without the bias (whisper has none)
        h = rmsnorm(params["norm_cross"], x, cfg.norm_eps)
        B, hd = x.shape[0], cfg.resolved_head_dim
        q = split_last(linear(h, params["cross"]["wq"]["kernel"]), (cfg.num_heads, hd),
                       Q_AXES)
        if cfg.qk_norm:
            q = rmsnorm(params["cross"]["q_norm"], q, cfg.norm_eps)
        out = decode_attention(q, cache["cross_k"], cache["cross_v"], cache["cross_len"])
        x = x + linear(out.reshape(B, 1, -1), params["cross"]["wo"]["kernel"])
    if kind.ffn == NONE:
        return x
    h = rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + _ffn(params, cfg, kind, h, plan, valid, counts)[0]


def block_prefill(params, cfg: ModelConfig, kind: LayerKind, x, positions,
                  true_len, cache, plan: ExecutionPlan, enc_out=None):
    """Whole-prompt prefill that also fills the block's dense decode cache
    (in place). x (B,S,d); true_len (B,) valid prompt lengths. A
    cross-attention block attends ``enc_out`` (B,Se,d) and writes its K/V
    into the first Se positions of "cross_k"/"cross_v", "cross_len" = Se on
    every row (ValueError if Se exceeds the leaves). A Mamba
    mixer's cache takes the state after the last position of x, padding
    included (``ssm.mamba_forward``); the MoE routes every position,
    padding included, as the reference's prefill does. Returns x."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if kind.mixer == MAMBA:
        mixer_out, mcache = mamba_forward(params["mixer"], cfg, h, return_state=True)
        cache["mamba"]["conv"].copy_(mcache["conv"])
        cache["mamba"]["ssm"].copy_(mcache["ssm"])
    else:
        mixer_out, (k, v) = attention_forward(params["mixer"], cfg, h, positions,
                                              _attn_call(cfg, kind, plan), return_kv=True,
                                              use_kernels=plan.use_kernels)
        write_prefill_cache(cache, k, v, true_len, window=_window(cfg, kind))
    if cfg.parallel_block and kind.ffn != NONE:
        return x + mixer_out + _ffn(params, cfg, kind, h, plan)[0]
    x = x + mixer_out
    if kind.mixer == ATTN_CROSS:
        h = rmsnorm(params["norm_cross"], x, cfg.norm_eps)
        ck, cv = cross_kv(params["cross"], cfg, enc_out)
        x = x + cross_attention_forward(params["cross"], cfg, h, (ck, cv))
        Se = ck.shape[1]
        if Se > cache["cross_k"].shape[1]:
            raise ValueError(f"the encoder output has {Se} positions, the cross cache "
                             f"{cache['cross_k'].shape[1]}: size it with init_cache(enc_len=)")
        cache["cross_k"][:, :Se] = ck.to(cache["cross_k"].dtype)
        cache["cross_v"][:, :Se] = cv.to(cache["cross_v"].dtype)
        cache["cross_len"].fill_(Se)
    if kind.ffn == NONE:
        return x
    h = rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + _ffn(params, cfg, kind, h, plan)[0]


def block_mixed_step(params, cfg: ModelConfig, kind: LayerKind, xd, xc, cache,
                     attn_ctx, chunk_ctx, plan: ExecutionPlan, counts):
    """One block of a unified mixed stage: decode rows xd (Bd,1,d) write and
    attend first, then chunk rows xc (Bc,Sc,d) write their span and attend;
    norms and the FFN/MoE run over the concatenated token stream, so the
    duplex MoE covers both halves. On the dense layout the decode half runs
    over every slot, and a slot mid-prefill gets the decode half's write at
    its length, which its chunk (starting there) then overwrites: the order
    is part of the result. Full self-attention mixers only. Returns (xd,
    xc)."""
    if kind.mixer != ATTN:
        raise ValueError(f"unified mixed stages support full self-attention decoder "
                         f"layers only, got mixer={kind.mixer}")
    Bd = xd.shape[0]
    Bc, Sc, d = xc.shape
    h_d = rmsnorm(params["norm1"], xd, cfg.norm_eps)
    h_c = rmsnorm(params["norm1"], xc, cfg.norm_eps)
    if "k_pages" in cache:
        mixer_d, _ = paged_attention_decode_step(params["mixer"], cfg, h_d, cache,
                                                 attn_ctx, use_kernels=plan.use_kernels)
        mixer_c, _ = paged_attention_chunk_step(params["mixer"], cfg, h_c, cache,
                                                chunk_ctx, use_kernels=plan.use_kernels)
    else:
        mixer_d, _ = attention_decode_step(params["mixer"], cfg, h_d, cache,
                                           use_kernels=plan.use_kernels)
        mixer_c, _ = attention_chunk_step(params["mixer"], cfg, h_c, cache, chunk_ctx)
    if cfg.parallel_block and kind.ffn != NONE:
        ffn_in_d, ffn_in_c = h_d, h_c
        base_d, base_c = xd + mixer_d, xc + mixer_c
    else:
        xd = xd + mixer_d
        xc = xc + mixer_c
        if kind.ffn == NONE:
            return xd, xc
        ffn_in_d = rmsnorm(params["norm2"], xd, cfg.norm_eps)
        ffn_in_c = rmsnorm(params["norm2"], xc, cfg.norm_eps)
        base_d, base_c = xd, xc
    flat = torch.cat([ffn_in_d.reshape(Bd, d), ffn_in_c.reshape(Bc * Sc, d)])
    dec_valid = attn_ctx.get("valid")
    if dec_valid is None:
        dec_valid = torch.ones((Bd,), dtype=torch.bool, device=xd.device)
    chunk_valid = (torch.arange(Sc, device=xc.device)[None]
                   < chunk_ctx["chunk_lens"].long()[:, None])
    valid = torch.cat([dec_valid, chunk_valid.reshape(-1)])
    y, _ = _ffn(params, cfg, kind, flat, plan, valid, counts)
    return base_d + y[:Bd].reshape(Bd, 1, d), base_c + y[Bd:].reshape(Bc, Sc, d)


def segment_init_cache(cfg: ModelConfig, seg, batch: int = 0, max_len: int = 0, *,
                       dtype, device, kv_quant: bool = False, page_size: int = 0,
                       num_pages: int = 0, enc_len: int = 0) -> dict:
    return {"blocks": tuple(
        block_init_cache(cfg, kind, batch, max_len, dtype=dtype, device=device,
                         layers=seg.repeats, kv_quant=kv_quant,
                         page_size=page_size, num_pages=num_pages, enc_len=enc_len)
        for kind in seg.pattern)}


def segment_decode_step(params, cfg: ModelConfig, seg, x, cache, attn_ctx,
                        plan: ExecutionPlan, counts):
    for i in range(seg.repeats):
        for j, kind in enumerate(seg.pattern):
            x = block_decode_step(_layer(params["blocks"][j], i), cfg, kind, x,
                                  _layer(cache["blocks"][j], i), attn_ctx, plan,
                                  counts)
    return x


def segment_mixed_step(params, cfg: ModelConfig, seg, xd, xc, cache, attn_ctx,
                       chunk_ctx, plan: ExecutionPlan, counts):
    for i in range(seg.repeats):
        for j, kind in enumerate(seg.pattern):
            xd, xc = block_mixed_step(_layer(params["blocks"][j], i), cfg, kind,
                                      xd, xc, _layer(cache["blocks"][j], i),
                                      attn_ctx, chunk_ctx, plan, counts)
    return xd, xc


def segment_prefill(params, cfg: ModelConfig, seg, x, positions, true_len, cache,
                    plan: ExecutionPlan, enc_out=None):
    for i in range(seg.repeats):
        for j, kind in enumerate(seg.pattern):
            x = block_prefill(_layer(params["blocks"][j], i), cfg, kind, x, positions,
                              true_len, _layer(cache["blocks"][j], i), plan, enc_out)
    return x
