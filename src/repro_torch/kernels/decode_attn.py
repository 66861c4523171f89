"""Attention kernels (CUDA, ``csrc/decode_sm90.cu``, ``csrc/decode_attn.cu``,
``csrc/chunk_attn_sm90.cu``, ``csrc/chunk_f32_sm90.cu`` and
``csrc/chunk_int8_sm90.cu``) and their plain PyTorch versions, in the kernel
layouts.

* ``decode_attention_kernel`` — GQA decode on the dense cache: one query
  token per sequence, ``qpk`` query heads per KV head, online softmax over
  the positions ``< lengths[b]`` of the sequence's (Smax, KV, hd) cache row;
  optional sliding window and tanh softcap. Port of ``repro/kernels/
  decode_attn.py::decode_attention_kernel``, in float32 and bfloat16. The
  cache stays in the model layout (B, Smax, KV, hd): the kernels of
  ``csrc/decode_sm90.cu`` read it through a TMA tensor map over its
  strides, where the reference's wrapper transposes and pads the whole
  cache per call. They split each sequence's live positions into runs of
  ``DENSE_TILES_PER_SPLIT`` tiles of ``DENSE_TILE`` keys, one block each,
  and a second launch merges the runs in order.
  ``decode_attention_split_plain`` is that arithmetic in plain PyTorch.
* ``paged_decode_attention_kernel`` — GQA decode: one query token per
  sequence, ``qpk`` query heads per KV head, online softmax over the pages
  ``block_tables[b]`` names up to ``lengths[b]``; optional sliding window and
  tanh softcap. Port of ``repro/kernels/decode_attn.py::
  paged_decode_attention_kernel`` (fp body), in float32 and bfloat16: the
  same kernels of ``csrc/decode_sm90.cu`` split each sequence's live page
  range into runs of ``PAGES_PER_SPLIT`` pages, one block each, and merge
  the runs in order. ``paged_decode_attention_split_plain`` is that
  arithmetic in plain PyTorch.
  The CPU tests hold both split versions against the Pallas kernels; the
  main path never calls them.
* ``chunked_prefill_attention_kernel`` — chunk queries (heads innermost, row
  r = position ``start + r // qpk``) against the paged prefix plus the chunk
  just written; mask ``kpos <= qpos and kpos < total``. Port of
  ``chunked_prefill_attention_kernel`` (fp body). Three routes
  (``chunk_route``): at head_dim 64 or 128 and pages of 8, 16, 32 or 64,
  bfloat16 runs the tensor-core kernel of ``csrc/chunk_attn_sm90.cu``
  (wgmma, paged K/V tiles by TMA) and float32 that of
  ``csrc/chunk_f32_sm90.cu`` (3xTF32 mma.sync, paged K/V by cp.async, an
  item's key tiles split over several blocks when a call has fewer items
  than SMs); other shapes run the scalar kernel of ``decode_attn.cu``.
* ``paged_decode_attention_int8_kernel`` / ``chunked_prefill_attention_int8_
  kernel`` — the same two functions over int8 page pools with float32
  per-(token, KV head) scale pools: int8 dots with the scales folded in and
  p * v_scale requantized per row over each page, as the TPU kernels' int8
  bodies (``_paged_decode_kernel_int8``, ``_chunked_prefill_kernel_int8``).
  Their plain versions walk the page columns with a running max exactly as
  those bodies do; they are not the model-level paths of
  ``models/attention.py``, which requantize once over the whole row. The
  decode's pages of a multiple of 4 keys run ``decode_sm90.cu``'s int8
  split (each split's pages walked from the split's own running max, then
  merged; ``paged_decode_attention_int8_split_plain`` is that arithmetic),
  other pages the scalar kernel of ``decode_attn.cu``; the chunk's
  head_dim and page in ``SM90_SHAPES`` run ``chunk_int8_sm90.cu`` (int8
  ``mma.sync``, the page walk as it is), other shapes the scalar kernel.

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.quant import int8_quantize

NEG_INF = -1e30


def _gather_pages(pages, block_tables):
    """(P, KV, page, hd) pool -> (B, KV, maxp*page, hd) per-sequence view."""
    B, maxp = block_tables.shape
    _, KV, page, hd = pages.shape
    g = pages[block_tables.long()]                  # (B, maxp, KV, page, hd)
    return g.permute(0, 2, 1, 3, 4).reshape(B, KV, maxp * page, hd)


def _attend(q, k, v, valid, softcap):
    """Masked attention in the reference kernels' arithmetic: float32
    scores, p normalised after PV and rounded to the pool dtype before it
    (the decode kernels of ``decode_sm90.cu`` keep p in float32), rows with
    nothing valid come back 0. q (..., R, hd); k, v (..., S, hd); valid
    broadcastable to (..., R, S)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / l.clamp_min(1e-37)).to(q.dtype)


def decode_attention_plain(q, k_cache, v_cache, lengths, *, window: int = 0,
                           softcap: float = 0.0):
    """q (B, KV, qpk, hd); caches (B, Smax, KV, hd); lengths (B,) valid
    positions, the current token's included. -> (B, KV, qpk, hd); a row
    with no valid position comes back 0, as the TPU kernel's does."""
    k = k_cache.permute(0, 2, 1, 3)                 # (B, KV, Smax, hd) views
    v = v_cache.permute(0, 2, 1, 3)
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    lens = lengths.long()[:, None]
    valid = kpos < lens
    if window > 0:
        valid = valid & (kpos > lens - 1 - window)
    return _attend(q, k, v, valid[:, None, None, :], softcap)


def paged_decode_attention_plain(q, k_pages, v_pages, lengths, block_tables, *,
                                 window: int = 0, softcap: float = 0.0):
    """q (B, KV, qpk, hd); pools (P, KV, page, hd); lengths (B,);
    block_tables (B, maxp). -> (B, KV, qpk, hd)."""
    k = _gather_pages(k_pages, block_tables)
    v = _gather_pages(v_pages, block_tables)
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    lens = lengths.long()[:, None]
    valid = kpos < lens
    if window > 0:
        valid = valid & (kpos > lens - 1 - window)
    return _attend(q, k, v, valid[:, None, None, :], softcap)


def _split_decode(q, tiles, lens, lim, ntiles, tile, tiles_per_split, window, softcap):
    """The split kernels' arithmetic over a row of ``ntiles`` tiles of
    ``tile`` keys: each sequence's live tiles [lo, hi) (the window's first
    position's tile up to the tile of position lim - 1) cut into splits of
    ``tiles_per_split`` tiles; each split's float32 running max m, sum l and
    accumulator taken a tile at a time (q scaled first, p kept in float32
    for PV); then the live splits merged in split order,
    out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-37). A
    sequence with no live key comes back exact zeros. ``tiles(t)`` gives the
    K and V (B, KV, tile, hd) of tile t (B,), already clamped into the row;
    lim (B,) bounds the live keys (the length, within the row)."""
    B, KV, qpk, hd = q.shape
    tps = tiles_per_split
    first = (lens - window).clamp_min(0) if window > 0 else torch.zeros_like(lens)
    lo, hi = first // tile, ((lens + tile - 1) // tile).clamp_max(ntiles)
    t = torch.arange(tile, device=q.device)
    qs = q.float() * (1.0 / math.sqrt(hd))
    parts = []
    for s in range(-(-ntiles // tps)):
        m = torch.full((B, KV, qpk, 1), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KV, qpk, hd), device=q.device)
        for j in range(tps):
            tp = lo + s * tps + j
            k, v = tiles(tp.clamp(0, max(ntiles - 1, 0)))
            kpos = tp[:, None] * tile + t[None]                       # (B, tile)
            ok = (tp < hi)[:, None] & (kpos < lim[:, None])
            if window > 0:
                ok &= kpos > lens[:, None] - 1 - window
            ok = ok[:, None, None, :]
            sc = torch.matmul(qs, k.float().transpose(-1, -2))
            if softcap > 0.0:
                sc = softcap * torch.tanh(sc / softcap)
            sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new) * ok
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, v.float())
            m = m_new
        parts.append((m, l, acc))
    return _merge_splits(q, parts, lo, hi, tps)


def _merge_splits(q, parts, lo, hi, tps):
    """The merge kernel's arithmetic: the live splits' float32 (m, l, acc)
    (B, KV, qpk, 1 | hd) of sequences whose live tiles are [lo, hi), in runs
    of ``tps`` tiles, combined in split order; a sequence with no live tile
    comes back exact zeros."""
    B, KV, qpk, hd = q.shape
    n_live = (hi - lo).clamp_min(0).add(tps - 1).div(tps, rounding_mode="floor")
    live = [(s < n_live)[:, None, None, None] for s in range(len(parts))]
    mx = torch.full((B, KV, qpk, 1), NEG_INF, device=q.device)
    for on, (m, _, _) in zip(live, parts):
        mx = torch.where(on, torch.maximum(mx, m), mx)
    acc = torch.zeros((B, KV, qpk, hd), device=q.device)
    l = torch.zeros((B, KV, qpk, 1), device=q.device)
    for on, (m, ls, a) in zip(live, parts):
        w = torch.where(on, torch.exp(m - mx), torch.zeros_like(m))
        l = l + ls * w
        acc = acc + a * w
    return (acc / l.clamp_min(1e-37)).to(q.dtype)


def paged_decode_attention_split_plain(q, k_pages, v_pages, lengths, block_tables, *,
                                       pages_per_split: int, window: int = 0,
                                       softcap: float = 0.0):
    """``paged_decode_attention_plain`` computed as ``decode_sm90.cu``
    computes it (``_split_decode``), a tile a page: the live pages [lo, hi)
    run from the window's first position's page up to the page of position
    length - 1, within the table."""
    page = k_pages.shape[2]
    maxp = block_tables.shape[1]
    lens = lengths.long()
    bt = block_tables.long()
    rows = torch.arange(bt.shape[0], device=q.device)

    def tiles(tp):
        pid = bt[rows, tp]
        return k_pages[pid], v_pages[pid]

    return _split_decode(q, tiles, lens, lens, maxp, page, pages_per_split, window, softcap)


def decode_attention_split_plain(q, k_cache, v_cache, lengths, *, tile: int,
                                 tiles_per_split: int, window: int = 0,
                                 softcap: float = 0.0):
    """``decode_attention_plain`` computed as ``decode_sm90.cu`` computes it
    (``_split_decode``) over the dense cache's ceil(Smax / tile) tiles of
    ``tile`` positions: the live keys end at min(length, Smax), so a length
    past the cache attends all Smax positions, and a last tile's positions
    past Smax are masked."""
    Smax = k_cache.shape[1]
    lens = lengths.long()
    rows = torch.arange(k_cache.shape[0], device=q.device)[:, None]
    t = torch.arange(tile, device=q.device)[None]

    def tiles(tp):
        kpos = (tp[:, None] * tile + t).clamp_max(Smax - 1)            # (B, tile)
        return (k_cache[rows, kpos].permute(0, 2, 1, 3),
                v_cache[rows, kpos].permute(0, 2, 1, 3))

    return _split_decode(q, tiles, lens, lens.clamp_max(Smax), -(-Smax // tile), tile,
                         tiles_per_split, window, softcap)


def chunked_prefill_attention_plain(q, k_pages, v_pages, totals, starts,
                                    block_tables, *, qpk: int,
                                    softcap: float = 0.0):
    """q (B, KV, R, hd), R = Sc*qpk with heads innermost; pools
    (P, KV, page, hd); totals, starts (B,); block_tables (B, maxp).
    -> (B, KV, R, hd)."""
    k = _gather_pages(k_pages, block_tables)
    v = _gather_pages(v_pages, block_tables)
    R = q.shape[2]
    qpos = starts.long()[:, None] + torch.arange(R, device=q.device)[None] // qpk
    kpos = torch.arange(k.shape[2], device=q.device)
    valid = ((kpos[None, None, :] <= qpos[:, :, None])
             & (kpos[None, None, :] < totals.long()[:, None, None]))
    return _attend(q, k, v, valid[:, None], softcap)


def _check_pools(q, k_pages, v_pages, block_tables, *ints, scales=None):
    """Refuse what the kernels do not take. ``scales`` (k, v scale pools)
    marks int8 pools: int8 values, 16-byte aligned, float32 scales
    (P, KV, page)."""
    if q.device.type != "cuda":
        raise ValueError(f"paged attention kernels run on CUDA tensors, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged attention kernels take float32/bfloat16, got {q.dtype}")
    pool_dtype = q.dtype if scales is None else torch.int8
    for t in (k_pages, v_pages):
        if t.dtype != pool_dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"page pools must be contiguous {pool_dtype} on q's device")
    if k_pages.shape != v_pages.shape or k_pages.shape[1] != q.shape[1] \
            or k_pages.shape[3] != q.shape[3]:
        raise ValueError(f"pool shape {tuple(k_pages.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if scales is not None:
        hd = q.shape[3]
        if hd % 16 or hd > 256 or 32 % (hd // 16):
            raise ValueError(f"int8 kernels take head_dim 16, 32, 64, 128 or 256, got {hd}")
        if any(t.data_ptr() % 16 for t in (k_pages, v_pages)):
            raise ValueError("int8 page pools must be 16-byte aligned")
        for t in scales:
            if t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous() \
                    or t.shape != k_pages.shape[:3]:
                raise ValueError("scale pools must be contiguous float32 (P, KV, page) "
                                 "on q's device")
    for t in (block_tables, *ints):
        if t.dtype != torch.int32 or t.device != q.device or not t.is_contiguous():
            raise ValueError("lengths/block tables must be contiguous int32 on q's device")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")


# pages a block of the paged decode covers (its split of a sequence's live
# page range); positions a stage of the dense decode brings in (one TMA box
# each of K and V) and the tiles a block covers; the stages of K and V a
# block of either keeps in flight
PAGES_PER_SPLIT = 8
DENSE_TILE = 32
DENSE_TILES_PER_SPLIT = 4
STAGES = 2


def decode_attention_kernel(q, k_cache, v_cache, lengths, *, window: int = 0,
                            softcap: float = 0.0):
    """Layout as ``decode_attention_plain``; runs the kernels of
    ``decode_sm90.cu`` (the split, then the merge) for CUDA tensors and the
    plain version for CPU tensors. The caches may be views (a layer of a
    stacked cache): each needs its last two dimensions contiguous, k and v
    the same strides, and the strides and the base in whole 16-byte words."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths, window=window,
                                      softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"the decode attention kernel runs on CUDA tensors, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode attention kernel takes float32/bfloat16, got {q.dtype}")
    B, KV, qpk, hd = q.shape
    Smax = k_cache.shape[1]
    for t in (k_cache, v_cache):
        if t.dtype != q.dtype or t.device != q.device \
                or tuple(t.shape) != (B, Smax, KV, hd):
            raise ValueError(f"caches must be {q.dtype} (B, Smax, KV, hd) = "
                             f"{(B, Smax, KV, hd)} on q's device, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if k_cache.stride() != v_cache.stride() or k_cache.stride()[2:] != (hd, 1):
        raise ValueError(f"caches need equal strides with (KV, hd) contiguous, got "
                         f"{k_cache.stride()} and {v_cache.stride()}")
    sb, ss = k_cache.stride(0), k_cache.stride(1)
    if max(sb, ss) >= 2 ** 31:
        raise ValueError(f"cache strides {sb}, {ss} do not fit the kernel's int32")
    if lengths.dtype != torch.int32 or lengths.device != q.device \
            or not lengths.is_contiguous() or not q.is_contiguous():
        raise ValueError("q must be contiguous and lengths contiguous int32 on q's device")
    item = q.element_size()
    if hd % 8 or hd > 256 or any(n * item % 16 for n in (sb, ss)) \
            or any(t.data_ptr() % 16 for t in (k_cache, v_cache)):
        raise ValueError("the kernel reads K and V by TMA: head_dim must be a multiple of 8 "
                         f"up to 256 (got {hd}), the cache strides and base whole 16-byte "
                         "words")
    if DENSE_TILE * hd * item % 128 or not 1 <= DENSE_TILE <= 256:
        raise ValueError(f"a tile of {DENSE_TILE} positions x head_dim {hd} is not whole "
                         "128-byte rows of the ring")
    if qpk * hd * item > 8 * 128 * 16:
        raise ValueError(f"qpk {qpk} x head_dim {hd} exceeds the kernel's registers "
                         "(8 x 128 16-byte words)")
    nsplit = -(-(-(-Smax // DENSE_TILE)) // DENSE_TILES_PER_SPLIT)
    _check_decode_smem(qpk, hd, DENSE_TILE, item, nsplit)
    ws = torch.empty((B, KV, nsplit, qpk, hd + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    fn = build.bind("decode_sm90.cu", "decode_attention_sm90", 6, 11, 2)
    err = fn(build.DTYPE_CODES[str(q.dtype).split(".")[1]], q.data_ptr(),
             k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(), ws.data_ptr(),
             out.data_ptr(), B, Smax, KV, qpk, hd, sb, ss, int(window), DENSE_TILE,
             DENSE_TILES_PER_SPLIT, STAGES, float(softcap), 1.0 / math.sqrt(hd),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "decode_attention")
    build.launch_counts["decode_attention"] += 1
    return out


def _check_decode_smem(qpk, hd, tile, item, nsplit):
    """Refuse what one block of ``decode_sm90.cu``'s split or merge kernel
    cannot hold in shared memory (one stage at least)."""
    smem = (128 + 2 * tile * hd * item
            + 4 * (((qpk * (hd + 2 * tile) + 3) & ~3) + 128 * (16 // item + 1)))
    if smem > 227 * 1024:
        raise ValueError("tile/head_dim too large for one block's shared memory")
    if (2 * nsplit + 1) * qpk * 4 > 227 * 1024:
        raise ValueError(f"{nsplit} splits of {qpk} heads exceed the merge's shared memory")


def paged_decode_attention_kernel(q, k_pages, v_pages, lengths, block_tables, *,
                                  window: int = 0, softcap: float = 0.0):
    """Kernel layout as ``paged_decode_attention_plain``; runs the kernels of
    ``decode_sm90.cu`` (the split, then the merge) for CUDA tensors
    and the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, lengths,
                                            block_tables, window=window,
                                            softcap=softcap)
    _check_pools(q, k_pages, v_pages, block_tables, lengths)
    B, KV, qpk, hd = q.shape
    page = k_pages.shape[2]
    maxp = block_tables.shape[1]
    item = q.element_size()
    if hd % 8 or hd > 256 or any(t.data_ptr() % 16 for t in (k_pages, v_pages)):
        raise ValueError("the kernel brings pages in by 16-byte bulk copies: head_dim "
                         f"must be a multiple of 8 up to 256 (got {hd}) and the pools "
                         "16-byte aligned")
    if qpk * hd * item > 8 * 128 * 16:
        raise ValueError(f"qpk {qpk} x head_dim {hd} exceeds the kernel's registers "
                         "(8 x 128 16-byte words)")
    nsplit = -(-maxp // PAGES_PER_SPLIT)
    _check_decode_smem(qpk, hd, page, item, nsplit)
    ws = torch.empty((B, KV, nsplit, qpk, hd + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    fn = build.bind("decode_sm90.cu", "paged_decode_attention_sm90", 7, 9, 2)
    err = fn(build.DTYPE_CODES[str(q.dtype).split(".")[1]], q.data_ptr(),
             k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
             block_tables.data_ptr(), ws.data_ptr(), out.data_ptr(), B, KV, qpk, hd,
             page, maxp, int(window), PAGES_PER_SPLIT, STAGES, float(softcap),
             1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode_attention")
    build.launch_counts["paged_decode_attention"] += 1
    return out


# (head_dim, page) the tensor-core routes of the chunk attention take, bf16,
# float32 and int8 pools alike: 64-column wgmma panels (bf16), whole 8-key
# mma.sync steps of 16-byte rows (float32) or one swizzled row of int8, and
# pages of whole 8-row tiles
SM90_SHAPES = {(hd, page) for hd in (64, 128) for page in (8, 16, 32, 64)}

# the float chunk attention's routes: launch counter (and C entry) -> source
CHUNK_ROUTES = {"chunked_prefill_attention_sm90": "chunk_attn_sm90.cu",
                "chunked_prefill_attention_f32_sm90": "chunk_f32_sm90.cu",
                "chunked_prefill_attention": "decode_attn.cu"}


def chunk_f32_splits(items: int, max_tiles: int, sms: int) -> int:
    """Blocks of ``chunk_f32_sm90.cu`` a work item (64 rows of one sequence
    and KV head) is spread over, from the call's shapes alone: a call of
    fewer items than the card has SMs shares each item's live 64-key tiles
    among up to ``sms // items`` blocks, no more than ``max_tiles`` (the
    block table's width in tiles); a second kernel merges the splits in
    order. A serving stage's chunk is 16-64 items, each walking its prefix
    tile after tile, so without the split most SMs would idle while the
    longest item sets the time."""
    return max(1, min(sms // max(items, 1), max_tiles))


def chunk_route(dtype, hd: int, page: int) -> str:
    """The route of a float chunk attention call on the card, from its
    dtype, head_dim and page size alone: bfloat16 at ``SM90_SHAPES`` runs
    ``chunk_attn_sm90.cu`` (wgmma), float32 there ``chunk_f32_sm90.cu``
    (3xTF32 mma.sync), anything else the scalar kernel of
    ``decode_attn.cu``. Returns the route's key in ``CHUNK_ROUTES``."""
    if (hd, page) in SM90_SHAPES:
        if dtype == torch.bfloat16:
            return "chunked_prefill_attention_sm90"
        if dtype == torch.float32:
            return "chunked_prefill_attention_f32_sm90"
    return "chunked_prefill_attention"


def chunked_prefill_attention_kernel(q, k_pages, v_pages, totals, starts,
                                     block_tables, *, qpk: int,
                                     softcap: float = 0.0):
    """Kernel layout as ``chunked_prefill_attention_plain``; runs a CUDA
    kernel for CUDA tensors and the plain version for CPU tensors. The
    kernel is ``chunk_route``'s, chosen before the launch; a tensor-core
    route is counted under its own name and under
    ``chunked_prefill_attention`` as well."""
    if q.device.type == "cpu":
        return chunked_prefill_attention_plain(q, k_pages, v_pages, totals,
                                               starts, block_tables, qpk=qpk,
                                               softcap=softcap)
    _check_pools(q, k_pages, v_pages, block_tables, totals, starts)
    B, KV, R, hd = q.shape
    page = k_pages.shape[2]
    if R % qpk:
        raise ValueError(f"rows {R} not a multiple of qpk {qpk}")
    route = chunk_route(q.dtype, hd, page)
    scalar = route == "chunked_prefill_attention"
    if not scalar and any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("the tensor-core chunk kernels read q and the pools 16 bytes at a "
                         "time: their bases must be 16-byte aligned")
    smem = (2 * 16 * hd + 16 * page + 48) * 4 + 2 * page * hd * q.element_size()
    if scalar and smem > 227 * 1024:
        raise ValueError("page/head_dim too large for one block's shared memory")
    out = torch.empty_like(q)
    maxp = block_tables.shape[1]
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), totals.data_ptr(),
            starts.data_ptr(), block_tables.data_ptr(), out.data_ptr())
    ints = (B, KV, R, qpk, hd, page, maxp)
    if route == "chunked_prefill_attention_sm90":
        ints += (k_pages.shape[0],)            # its tensor maps take the pool's page count
    elif route == "chunked_prefill_attention_f32_sm90":
        items = -(-R // 64) * KV * B
        nsplit = chunk_f32_splits(items, -(-maxp * page // 64),
                                  torch.cuda.get_device_properties(q.device).multi_processor_count)
        ws = (torch.empty(items * nsplit * 64 * (hd + 4), dtype=torch.float32, device=q.device)
              if nsplit > 1 else None)
        ptrs += (0 if ws is None else ws.data_ptr(),)
        ints += (nsplit,)
    fn = build.bind(CHUNK_ROUTES[route], route, len(ptrs), len(ints), 2)
    err = fn(build.DTYPE_CODES[str(q.dtype).split(".")[1]], *ptrs, *ints, float(softcap),
             1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, route)
    build.launch_counts[route] += 1
    if not scalar:
        build.launch_counts["chunked_prefill_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# int8 page pools
# ---------------------------------------------------------------------------

def _attend_int8_paged(q, k_pages, k_scales, v_pages, v_scales, block_tables,
                       valid, needed, softcap):
    """The TPU int8 bodies' page loop, vectorised over sequences, heads and
    rows. q (B, KV, R, hd); valid (B, R or 1, maxp*page) the mask; needed
    (B, maxp) the pages the TPU kernel computes (others leave the running
    state as it is). Per page: folded-scale int8 QK^T, online softmax, p
    gated by the mask, p * v_scale requantized per row over this page, an
    int8 PV. The int8 products are taken in float32, which is exact while
    every sum stays below 2^24 (hd <= 256 and page <= 1040: n * 127^2)."""
    B, KV, R, hd = q.shape
    page = k_pages.shape[2]
    q8, q_sc = int8_quantize(q, keepdims=True)            # (B,KV,R,hd), (B,KV,R,1)
    state = _int8_state(q)
    bt = block_tables.long()
    for j in range(bt.shape[1]):
        pid = bt[:, j]
        ok = valid[:, None, :, j * page:(j + 1) * page]   # (B, 1, R|1, page)
        state = _int8_page(q8, q_sc, k_pages[pid], k_scales[pid], v_pages[pid],
                           v_scales[pid], ok, needed[:, j], state, softcap)
    m, l, acc = state
    return (acc / l.clamp_min(1e-37)).to(q.dtype)


def _int8_state(q):
    """A fresh float32 running state (m, l, acc) for q's rows."""
    B, KV, R, hd = q.shape
    m = torch.full((B, KV, R, 1), NEG_INF, device=q.device)
    return m, torch.zeros_like(m), torch.zeros((B, KV, R, hd), device=q.device)


def _int8_page(q8, q_sc, k8, ks, v8, vs, ok, live, state, softcap):
    """One page of the int8 bodies: folded-scale int8 QK^T, the online
    softmax with p gated by the mask ``ok`` (B, 1, R|1, page), p * v_scale
    requantized per row over this page, an int8 PV. k8, v8 (B, KV, page, hd)
    and ks, vs (B, KV, page) are each sequence's page; rows of a sequence
    whose ``live`` (B,) is False keep their state."""
    m, l, acc = state
    scale = 1.0 / math.sqrt(q8.shape[-1])
    s = (torch.matmul(q8.float(), k8.float().transpose(-1, -2)) * q_sc
         * ks[:, :, None, :] * scale)
    if softcap > 0.0:
        # a tensor divisor, as in int8_quantize: p feeds a requantization
        s = softcap * torch.tanh(s / torch.full_like(s, softcap))
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new) * ok
    pv8, pv_sc = int8_quantize(p * vs[:, :, None, :], keepdims=True)
    pv = torch.matmul(pv8.float(), v8.float())
    live = live[:, None, None, None]
    return (torch.where(live, m_new, m),
            torch.where(live, l * alpha + p.sum(dim=-1, keepdim=True), l),
            torch.where(live, acc * alpha + pv * pv_sc, acc))


def paged_decode_attention_int8_plain(q, k_pages, k_scales, v_pages, v_scales,
                                      lengths, block_tables, *, window: int = 0,
                                      softcap: float = 0.0):
    """q (B, KV, qpk, hd); int8 pools (P, KV, page, hd); float32 scale pools
    (P, KV, page); lengths (B,); block_tables (B, maxp). -> (B, KV, qpk, hd)
    in q's dtype."""
    page = k_pages.shape[2]
    maxp = block_tables.shape[1]
    lens = lengths.long()[:, None]
    kpos = torch.arange(maxp * page, device=q.device)[None]
    valid = kpos < lens
    k_start = torch.arange(maxp, device=q.device)[None] * page
    needed = k_start < lens
    if window > 0:
        valid = valid & (kpos > lens - 1 - window)
        needed = needed & (k_start + page - 1 > lens - 1 - window)
    return _attend_int8_paged(q, k_pages, k_scales, v_pages, v_scales,
                              block_tables, valid[:, None], needed, softcap)


def paged_decode_attention_int8_split_plain(q, k_pages, k_scales, v_pages, v_scales,
                                            lengths, block_tables, *, pages_per_split: int,
                                            window: int = 0, softcap: float = 0.0):
    """``paged_decode_attention_int8_plain`` computed as ``decode_sm90.cu``'s
    int8 split computes it: the live pages [lo, hi) (the window's first
    position's page up to the page of position length - 1, within the table)
    cut into splits of ``pages_per_split`` pages, each split's float32 (m, l,
    acc) walked a page at a time from its own running max exactly as the
    page walk does (the per-page requantization of p * v_scale included),
    then the live splits merged in split order (``_merge_splits``). Above
    the recipe's 1e-8 scale floor a split's own max gives the same pv8 as
    the sequence's in exact arithmetic, and in float a value within rounding
    of a .5 step can land one int8 step away; a page whose p * v_scale under
    the sequence's max falls below 1.27e-6 is requantized on the floor's
    coarser grid by the page walk and on a finer one by a split whose own
    max is lower (``tests/test_torch_int8.py`` bounds both)."""
    page = k_pages.shape[2]
    maxp = block_tables.shape[1]
    tps = pages_per_split
    lens = lengths.long()
    lim = lens.clamp_max(maxp * page)
    bt = block_tables.long()
    rows = torch.arange(bt.shape[0], device=q.device)
    first = (lens - window).clamp_min(0) if window > 0 else torch.zeros_like(lens)
    lo, hi = first // page, ((lens + page - 1) // page).clamp_max(maxp)
    t = torch.arange(page, device=q.device)
    q8, q_sc = int8_quantize(q, keepdims=True)
    parts = []
    for s in range(-(-maxp // tps)):
        state = _int8_state(q)
        for j in range(tps):
            tp = lo + s * tps + j
            pid = bt[rows, tp.clamp(0, maxp - 1)]
            kpos = tp[:, None] * page + t[None]                        # (B, page)
            ok = kpos < lim[:, None]
            if window > 0:
                ok &= kpos > lens[:, None] - 1 - window
            state = _int8_page(q8, q_sc, k_pages[pid], k_scales[pid], v_pages[pid],
                               v_scales[pid], ok[:, None, None, :], tp < hi, state, softcap)
        parts.append(state)
    return _merge_splits(q, parts, lo, hi, tps)


def chunked_prefill_attention_int8_plain(q, k_pages, k_scales, v_pages,
                                         v_scales, totals, starts, block_tables,
                                         *, qpk: int, softcap: float = 0.0):
    """q (B, KV, R, hd), R = Sc*qpk heads innermost; int8 pools and float32
    scale pools as the decode version; totals, starts (B,); block_tables
    (B, maxp). -> (B, KV, R, hd) in q's dtype."""
    page = k_pages.shape[2]
    maxp = block_tables.shape[1]
    R = q.shape[2]
    tot = totals.long()[:, None]
    qpos = starts.long()[:, None] + torch.arange(R, device=q.device)[None] // qpk
    kpos = torch.arange(maxp * page, device=q.device)
    valid = ((kpos[None, None, :] <= qpos[:, :, None])
             & (kpos[None, None, :] < tot[:, :, None]))
    needed = torch.arange(maxp, device=q.device)[None] * page < tot
    return _attend_int8_paged(q, k_pages, k_scales, v_pages, v_scales,
                              block_tables, valid, needed, softcap)


# pages a block of the int8 paged decode's split route covers; keys a step
# of the int8 chunk kernel takes (whole pages, at least one)
INT8_PAGES_PER_SPLIT = 8
INT8_CHUNK_STEP_KEYS = 64


def paged_decode_attention_int8_kernel(q, k_pages, k_scales, v_pages, v_scales,
                                       lengths, block_tables, *, window: int = 0,
                                       softcap: float = 0.0):
    """Layout as ``paged_decode_attention_int8_plain``; runs a CUDA kernel
    for CUDA tensors and the plain version for CPU tensors. The kernel is
    chosen before the launch: pages of a multiple of 4 keys run the split
    kernels of ``decode_sm90.cu`` (runs of ``INT8_PAGES_PER_SPLIT`` pages,
    ``STAGES`` in flight, then the merge; counted under
    ``paged_decode_attention_int8_sm90`` as well;
    ``paged_decode_attention_int8_split_plain`` is its arithmetic), other
    pages the scalar kernel of ``decode_attn.cu``."""
    if q.device.type == "cpu":
        return paged_decode_attention_int8_plain(
            q, k_pages, k_scales, v_pages, v_scales, lengths, block_tables,
            window=window, softcap=softcap)
    _check_pools(q, k_pages, v_pages, block_tables, lengths,
                 scales=(k_scales, v_scales))
    B, KV, qpk, hd = q.shape
    page = k_pages.shape[2]
    maxp = block_tables.shape[1]
    ptrs = (q.data_ptr(), k_pages.data_ptr(), k_scales.data_ptr(), v_pages.data_ptr(),
            v_scales.data_ptr(), lengths.data_ptr(), block_tables.data_ptr())
    tail = (float(softcap), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    code = build.DTYPE_CODES[str(q.dtype).split(".")[1]]
    out = torch.empty_like(q)
    if page % 4 == 0:
        if any(t.data_ptr() % 16 for t in (k_scales, v_scales)):
            raise ValueError("the int8 split kernel brings scale slabs in by bulk copies: "
                             "the scale pools must be 16-byte aligned")
        if qpk * hd > 4096:
            raise ValueError(f"qpk {qpk} x head_dim {hd} exceeds the int8 split kernel's "
                             "4096 accumulators")
        nsplit = -(-maxp // INT8_PAGES_PER_SPLIT)
        smem = (128 + 2 * page * hd + 8 * page + ((qpk * (page + 5) * 4 + 15) & ~15)
                + qpk * (hd + page))
        if smem > 227 * 1024:
            raise ValueError("qpk/head_dim/page too large for one block's shared memory")
        if (2 * nsplit + 1) * qpk * 4 > 227 * 1024:
            raise ValueError(f"{nsplit} splits of {qpk} heads exceed the merge's shared memory")
        ws = torch.empty((B, KV, nsplit, qpk, hd + 2), dtype=torch.float32, device=q.device)
        name = "paged_decode_attention_int8_sm90"
        fn = build.bind("decode_sm90.cu", name, 9, 9, 2)
        err = fn(code, *ptrs, ws.data_ptr(), out.data_ptr(), B, KV, qpk, hd, page, maxp,
                 int(window), INT8_PAGES_PER_SPLIT, STAGES, *tail)
    else:
        smem = 4 * (qpk * (hd + page + 5) + 2 * page) + qpk * (hd + page) + page * hd + 32
        if smem > 227 * 1024:
            raise ValueError("qpk/head_dim/page too large for one block's shared memory")
        name = "paged_decode_attention_int8"
        fn = build.bind("decode_attn.cu", name, 8, 7, 2)
        err = fn(code, *ptrs, out.data_ptr(), B, KV, qpk, hd, page, maxp, int(window), *tail)
    build.check(err, name)
    build.launch_counts[name] += 1
    if name != "paged_decode_attention_int8":
        build.launch_counts["paged_decode_attention_int8"] += 1
    return out


def chunked_prefill_attention_int8_kernel(q, k_pages, k_scales, v_pages,
                                          v_scales, totals, starts, block_tables,
                                          *, qpk: int, softcap: float = 0.0):
    """Layout as ``chunked_prefill_attention_int8_plain``; runs a CUDA kernel
    for CUDA tensors and the plain version for CPU tensors. The kernel is
    chosen before the launch: head_dim and page in ``SM90_SHAPES`` (float32
    or bfloat16 q) run the int8 tensor-core kernel of ``chunk_int8_sm90.cu``
    (``INT8_CHUNK_STEP_KEYS`` keys of whole pages a step; counted under
    ``chunked_prefill_attention_int8_sm90`` as well), other shapes the
    scalar kernel of ``decode_attn.cu``. Both walk the pages one at a time
    as the plain version does."""
    if q.device.type == "cpu":
        return chunked_prefill_attention_int8_plain(
            q, k_pages, k_scales, v_pages, v_scales, totals, starts,
            block_tables, qpk=qpk, softcap=softcap)
    _check_pools(q, k_pages, v_pages, block_tables, totals, starts,
                 scales=(k_scales, v_scales))
    B, KV, R, hd = q.shape
    page = k_pages.shape[2]
    if R % qpk:
        raise ValueError(f"rows {R} not a multiple of qpk {qpk}")
    sm90 = (hd, page) in SM90_SHAPES
    if sm90 and any(t.data_ptr() % 16 for t in (k_scales, v_scales)):
        raise ValueError("the int8 chunk kernel brings scale slabs in by bulk copies: the "
                         "scale pools must be 16-byte aligned")
    smem = 4 * (16 * (hd + page + 5) + 2 * page) + 16 * (hd + page) + 2 * page * hd + 32
    if not sm90 and smem > 227 * 1024:
        raise ValueError("page/head_dim too large for one block's shared memory")
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k_pages.data_ptr(), k_scales.data_ptr(), v_pages.data_ptr(),
            v_scales.data_ptr(), totals.data_ptr(), starts.data_ptr(),
            block_tables.data_ptr(), out.data_ptr())
    ints = (B, KV, R, qpk, hd, page, block_tables.shape[1])
    tail = (float(softcap), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    code = build.DTYPE_CODES[str(q.dtype).split(".")[1]]
    if sm90:
        name = "chunked_prefill_attention_int8_sm90"
        fn = build.bind("chunk_int8_sm90.cu", name, 9, 9, 2)
        pps = max(1, min(8, INT8_CHUNK_STEP_KEYS // page))
        err = fn(code, *ptrs, *ints, k_pages.shape[0], pps, *tail)
    else:
        name = "chunked_prefill_attention_int8"
        fn = build.bind("decode_attn.cu", name, 9, 7, 2)
        err = fn(code, *ptrs, *ints, *tail)
    build.check(err, name)
    build.launch_counts[name] += 1
    if sm90:
        build.launch_counts["chunked_prefill_attention_int8"] += 1
    return out
