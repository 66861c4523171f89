"""Model assembly: embeddings -> segments -> final norm -> LM head.

Port of ``repro/models/model.py``: for training ``forward`` (full-sequence
logits; an encoder-decoder runs ``encode`` first, a VLM prepends its patch
embeddings) and ``loss_fn`` (next-token cross-entropy plus the MoE
load-balance loss); for serving ``init_cache`` (dense or paged),
``prefill`` (whole prompts into a dense cache), ``decode_step`` and
``mixed_step`` (either layout). The cache is a list (one entry per
segment) of ``{"blocks": (block cache, ...)}`` with stacked leaves: paged
(layers, P, KV, page, hd) pools (int8 pools add
"k_scale_pages"/"v_scale_pages" (layers, P, KV, page)); dense attention
"k"/"v" (layers, B, Smax, KV, hd), "pos" (layers, B, Smax), "len" (layers,
B), Smax being ``min(max_len, window) + 1`` for a sliding-window layer (a
ring past the window), and with ``kv_quant`` int8 "k"/"v" and float32
"k_scale"/"v_scale" (layers, B, Smax, KV); a cross-attention layer adds
"cross_k"/"cross_v" (layers, B, enc_len, KV, hd) and "cross_len" (layers,
B); Mamba {"mamba": {"conv" (layers, B, K-1, conv_dim), "ssm" (layers, B,
H, N, P)}}. Caches are updated in place; the functions still return them
so call sites read like the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.core.execution import DEFAULT_PLAN, ExecutionPlan
from repro_torch.models.attention import dense_chunk_writes
from repro_torch.models.blocks import (segment_decode_step, segment_forward,
                                       segment_init_cache, segment_mixed_step,
                                       segment_prefill)
from repro_torch.models.layers import embed_lookup, linear, rmsnorm
from repro_torch.models.params import DTYPES
from repro_torch.sharding.rules import gather_last, logical_constraint, seq_whole


def _lm_head(params, cfg: ModelConfig, x):
    """float32 logits. The reference casts the table to float32 on every
    call; the serving engine stores one float32 copy at load time under
    ``lm_head_f32`` (412 MB at OLMoE-1B-7B) and it is used when present."""
    table = params.get("lm_head_f32")
    if table is None:
        table = (params["embed"]["table"] if cfg.tie_embeddings
                 else params["lm_head"]["table"]).float()
    logits = linear(x.float(), table.t())
    return logical_constraint(logits, ("act_batch", "act_seq", "act_vocab"))


def _embed_inputs(params, cfg: ModelConfig, batch):
    """Token embedding in the activation dtype, and positions (B, S) (the
    batch's "positions", else 0..S-1). A VLM's "patch_embeds" (B, P, d),
    cast to the embedding's dtype, come first, so the stream and its
    positions run over P + S. Returns (x, positions)."""
    x = embed_lookup(params["embed"], batch["tokens"])
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    x = x.to(DTYPES[cfg.dtype])
    B, S = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x = logical_constraint(x, ("act_batch", "act_seq", "act_embed"))
    return x, positions


def encode(params, cfg: ModelConfig, batch, *, plan: ExecutionPlan = DEFAULT_PLAN,
           remat: str = "none"):
    """The encoder (whisper): frames (B, Se, d) in the activation dtype
    through the encoder's segments (bidirectional attention, positions
    0..Se-1) and its final norm -> enc_out (B, Se, d)."""
    x = batch["frames"].to(DTYPES[cfg.dtype])
    B, Se = x.shape[0], x.shape[1]
    positions = torch.arange(Se, device=x.device)[None].expand(B, Se)
    enc = params["encoder"]
    for seg, seg_params in zip(cfg.enc_segments, enc["segments"]):
        x, _ = segment_forward(seg_params, cfg, seg, x, positions, plan, remat=remat)
    return rmsnorm(enc["final_norm"], x, cfg.norm_eps)


def _decoder_inputs(params, cfg: ModelConfig, batch, plan, remat="none"):
    """(x, positions, enc_out, tokens): an encoder-decoder encodes
    "frames" and embeds "dec_tokens"; any other model embeds "tokens" (and
    a VLM's "patch_embeds") with no encoder output."""
    if cfg.is_encoder_decoder:
        enc_out = encode(params, cfg, batch, plan=plan, remat=remat)
        tokens = batch["dec_tokens"]
        x, positions = _embed_inputs(params, cfg, {"tokens": tokens})
        return x, positions, enc_out, tokens
    x, positions = _embed_inputs(params, cfg, batch)
    return x, positions, None, batch["tokens"]


def _stack(params, cfg: ModelConfig, x, positions, plan, remat, segment_ids=None,
           enc_out=None):
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg, seg_params in zip(cfg.segments, params["segments"]):
        x, aux = segment_forward(seg_params, cfg, seg, x, positions, plan, remat=remat,
                                 segment_ids=segment_ids, enc_out=enc_out)
        aux_total = aux_total + aux
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux_total


def forward(params, cfg: ModelConfig, batch, *, plan: ExecutionPlan = DEFAULT_PLAN,
            remat: str = "none", segment_ids=None):
    """Full-sequence float32 logits (B, S, V) and the summed MoE aux loss.
    batch {"tokens" (B, S)[, "positions"][, "patch_embeds" (B, P, d): a
    VLM's logits then cover P + S positions]} or, for an encoder-decoder,
    {"frames" (B, Se, d), "dec_tokens" (B, S)}; ``segment_ids`` (B, S)
    packs several documents into a row: each attention layer keeps a token
    to its own document's keys (a cross-attention layer compares them with
    the keys' own positions too, as the reference does, which only fits Se
    == S)."""
    x, positions, enc_out, _ = _decoder_inputs(params, cfg, batch, plan, remat)
    x, aux_total = _stack(params, cfg, x, positions, plan, remat, segment_ids, enc_out)
    return _lm_head(params, cfg, x), aux_total


def _chunked_ce(logits_fn, x, labels, mask, chunk: int = 1024):
    """Mean cross-entropy over the mask, in sequence chunks of ``chunk``
    positions so only one chunk's (B, chunk, V) float32 logits exists at a
    time (autograd keeps each chunk's for the backward). The gold logit is
    gathered, where the reference sums logits times a one-hot: the same
    number (one product and zeros), without the (B, chunk, V) one-hot."""
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    x, labels, mask = seq_whole(x), seq_whole(labels), seq_whole(mask)
    for s0 in range(0, x.shape[1], chunk):
        logits = logits_fn(x[:, s0:s0 + chunk])                   # (B, c, V) float32
        lse = torch.logsumexp(logits, dim=-1)
        gold = gather_last(logits, labels[:, s0:s0 + chunk])
        ms = mask[:, s0:s0 + chunk]
        total = total + ((lse - gold) * ms).sum()
        count = count + ms.sum()
    return total / torch.clamp(count, min=1.0)


def loss_fn(params, cfg: ModelConfig, batch, *, plan: ExecutionPlan = DEFAULT_PLAN,
            remat: str = "none"):
    """Next-token cross-entropy plus the MoE aux loss. batch {"tokens" (B,
    S)[, "labels" (B, S)][, "patch_embeds" (B, P, d)]} or {"frames",
    "dec_tokens"[, "labels"]} as in ``forward``; labels default to the
    (decoder) tokens shifted by one, and label -100 is ignored; a VLM's
    labels are padded in front with P -100s, so only text positions count.
    Returns (loss, {"ce", "aux"})."""
    x, positions, enc_out, tokens = _decoder_inputs(params, cfg, batch, plan, remat)
    x, aux_total = _stack(params, cfg, x, positions, plan, remat, enc_out=enc_out)
    labels = batch.get("labels")
    if labels is None:
        labels = torch.nn.functional.pad(tokens[:, 1:].long(), (0, 1), value=-100)
    labels = labels.long()
    if cfg.family == "vlm" and "patch_embeds" in batch:
        labels = torch.nn.functional.pad(labels, (batch["patch_embeds"].shape[1], 0),
                                         value=-100)
    # a padded DTensor comes back replicated: the labels and their mask are
    # placed as the tokens, or the loss's backward runs at the global batch
    labels = logical_constraint(labels, ("act_batch", "act_seq"))
    mask = logical_constraint((labels >= 0).float(), ("act_batch", "act_seq"))
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["lm_head"]["table"]).float()

    def logits_fn(xs):
        logits = linear(xs.float(), table.t())
        return logical_constraint(logits, ("act_batch", "act_seq", "act_vocab"))

    ce = _chunked_ce(logits_fn, x, torch.clamp(labels, min=0), mask)
    return ce + aux_total, {"ce": ce, "aux": aux_total}


def init_cache(cfg: ModelConfig, batch: int = 0, max_len: int = 0, *,
               page_size: int = 0, num_pages: int = 0, device="cuda",
               kv_quant: bool = False, enc_len: int = 0) -> list:
    """Decode cache. Dense (no ``page_size``): per-slot (batch, max_len)
    attention leaves (a sliding-window layer's ring sized ``min(max_len,
    window) + 1``; with ``kv_quant`` int8 values and float32 scales) and
    per-slot Mamba state. Paged (``page_size`` > 0):
    each attention layer holds a (num_pages, KV, page_size, hd) pool share in
    the model's dtype, or with ``kv_quant`` in int8 plus float32 (num_pages,
    KV, page_size) scale pools; capacity is owned by the KVManager. A
    decoder's cross-attention caches hold ``enc_len`` encoder positions
    (default ``max_len``, the reference's size)."""
    dtype = DTYPES[cfg.dtype]
    return [segment_init_cache(cfg, seg, batch, max_len, dtype=dtype, device=device,
                               kv_quant=kv_quant, page_size=page_size,
                               num_pages=num_pages, enc_len=enc_len)
            for seg in cfg.segments]


def prefill(params, cfg: ModelConfig, batch, cache, true_len, *,
            plan: ExecutionPlan = DEFAULT_PLAN):
    """Process whole prompts, fill the dense cache (in place) and return the
    logits at each sequence's last valid position. batch as in ``forward``
    ({"tokens" (B,S)[, "patch_embeds"]} or {"frames", "dec_tokens"});
    true_len (B,) indexes the decoder's stream: a VLM's counts its patches
    too (the reference's), an encoder-decoder's only the decoder tokens,
    whose cross caches take the whole encoder output. Returns (logits
    (B,1,V), cache)."""
    x, positions, enc_out, _ = _decoder_inputs(params, cfg, batch, plan)
    B = x.shape[0]
    for seg, seg_params, seg_cache in zip(cfg.segments, params["segments"], cache):
        x = segment_prefill(seg_params, cfg, seg, x, positions, true_len, seg_cache,
                            plan, enc_out)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    last = torch.clamp(true_len.long() - 1, min=0)
    x_last = x[torch.arange(B, device=x.device), last][:, None, :]
    return _lm_head(params, cfg, x_last), cache


def _counts(cfg, device):
    return (torch.zeros((cfg.moe.num_experts,), dtype=torch.float32, device=device)
            if cfg.moe else None)


def decode_step(params, cfg: ModelConfig, tokens, cache, attn_ctx, *,
                plan: ExecutionPlan = DEFAULT_PLAN):
    """tokens (B,1) -> logits (B,1,V). Paged: ``attn_ctx`` = {"lengths" (B,),
    "block_tables" (B,maxp), optional "valid" (B,)} maps the stage's rows
    onto the page pool. Dense: the rows are the cache's rows and
    ``attn_ctx`` = {"valid" (B,)} marks the live ones (dead rows are kept out
    of MoE routing). Returns (logits, cache, counts) where counts are the
    per-expert routed-token counts summed over MoE layers ((E,) float32)."""
    x = embed_lookup(params["embed"], tokens).to(DTYPES[cfg.dtype])
    x = logical_constraint(x, ("act_batch", None, "act_embed"))
    counts = _counts(cfg, x.device)
    for seg, seg_params, seg_cache in zip(cfg.segments, params["segments"], cache):
        x = segment_decode_step(seg_params, cfg, seg, x, seg_cache, attn_ctx,
                                plan, counts)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _lm_head(params, cfg, x), cache, counts


def mixed_step(params, cfg: ModelConfig, dec_tokens, chunk_tokens, cache, *,
               attn_ctx, chunk_ctx, plan: ExecutionPlan = DEFAULT_PLAN,
               spec_tokens: bool = False):
    """One unified mixed stage: decode rows (Bd,1) and prefill-chunk rows
    (Bc,Sc) through the stack as one token stream. Paged: ``attn_ctx`` as in
    ``decode_step`` and ``chunk_ctx`` = {"starts", "chunk_lens",
    "block_tables"}. Dense: the decode rows are the cache's rows (``attn_ctx``
    = {"valid"}) and ``chunk_ctx`` = {"starts", "chunk_lens", "slots"}, the
    chunk rows' cache rows; where they write is worked out here once for
    every layer. Returns (dec_logits (Bd,1,V), chunk_logits (Bc,1,V) at each
    chunk's last live position, cache, moe counts (E,) float32 or None).

    ``spec_tokens`` (a stage carrying speculative verify spans) adds a fifth
    output, ``chunk_argmax`` (Bc, Sc) int32: the argmax of the float32 LM
    head at every chunk position, the verifier's prediction for the next
    position. ``torch.argmax`` takes the first maximum, as the sampler does,
    so acceptance breaks ties as unspeculated decode would."""
    if "slots" in chunk_ctx:
        kv = next(blk for seg, seg_cache in zip(cfg.segments, cache)
                  for kind, blk in zip(seg.pattern, seg_cache["blocks"])
                  if kind.mixer == ATTN)["k"]
        chunk_ctx = dict(chunk_ctx, writes=dense_chunk_writes(
            chunk_ctx, kv.shape[1], kv.shape[2], chunk_tokens.shape[1]))
    dtype = DTYPES[cfg.dtype]
    xd = embed_lookup(params["embed"], dec_tokens).to(dtype)
    xc = embed_lookup(params["embed"], chunk_tokens).to(dtype)
    counts = _counts(cfg, xd.device)
    for seg, seg_params, seg_cache in zip(cfg.segments, params["segments"], cache):
        xd, xc = segment_mixed_step(seg_params, cfg, seg, xd, xc, seg_cache,
                                    attn_ctx, chunk_ctx, plan, counts)
    xd = rmsnorm(params["final_norm"], xd, cfg.norm_eps)
    xc = rmsnorm(params["final_norm"], xc, cfg.norm_eps)
    dec_logits = _lm_head(params, cfg, xd)
    Bc = xc.shape[0]
    last = torch.clamp(chunk_ctx["chunk_lens"].long() - 1, min=0)
    xc_last = xc[torch.arange(Bc, device=xc.device), last][:, None, :]
    chunk_logits = _lm_head(params, cfg, xc_last)
    if spec_tokens:
        chunk_argmax = torch.argmax(_lm_head(params, cfg, xc), dim=-1).to(torch.int32)
        return dec_logits, chunk_logits, cache, counts, chunk_argmax
    return dec_logits, chunk_logits, cache, counts
