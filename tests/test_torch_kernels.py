"""PyTorch port, kernel level: each kernel's plain PyTorch version against
the JAX package's Pallas kernel (interpret mode) and its ``ref.py`` oracle,
on the same numpy inputs, at atol = rtol = 2e-5 in float32 (the reference's
kernel tolerance band). The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attn import (chunked_prefill_attention_kernel as
                                       pallas_chunk,
                                       decode_attention_kernel as pallas_dense,
                                       paged_decode_attention_kernel as
                                       pallas_decode)
from repro.kernels import ops as jops
from repro.models.attention import chunk_attention
from repro_torch.kernels import build, decode_attn, moe_gemm, moe_gemv
from repro_torch.kernels import ops as tops

torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products on a card
torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers

TOL = dict(atol=2e-5, rtol=2e-5)


def _pools(rng, lens, *, KV=2, hd=16, page=8, maxp=5):
    """Random pools plus block tables giving each sequence its own pages."""
    B = len(lens)
    P = 1 + B * maxp
    k = rng.standard_normal((P, KV, page, hd)).astype(np.float32)
    v = rng.standard_normal((P, KV, page, hd)).astype(np.float32)
    ids = list(rng.permutation(np.arange(1, P)))
    bt = np.zeros((B, maxp), np.int32)
    for b, n in enumerate(lens):
        need = -(-n // page)
        bt[b, :need] = ids[:need]
        ids = ids[need:]
    return k, v, bt


def _dense(pages, bt):
    """(P, KV, page, hd) + (B, maxp) -> (B, KV, maxp*page, hd)."""
    g = pages[bt]
    B, maxp, KV, page, hd = g.shape
    return g.transpose(0, 2, 1, 3, 4).reshape(B, KV, maxp * page, hd)


@pytest.mark.parametrize("qpk", [1, 2])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (7, 0.0), (0, 5.0), (12, 3.0)])
def test_paged_decode_plain_matches_pallas(qpk, window, softcap):
    rng = np.random.default_rng(10 + qpk)
    lens = [0, 1, 8, 9, 23, 40]          # ragged, empty, page boundaries, full
    k, v, bt = _pools(rng, lens)
    q = rng.standard_normal((len(lens), 2, qpk, 16)).astype(np.float32)
    lengths = np.asarray(lens, np.int32)
    got = decode_attn.paged_decode_attention_kernel(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(lengths),
        torch.tensor(bt), window=window, softcap=softcap).numpy()
    want = np.asarray(pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(lengths), jnp.asarray(bt),
                                    window=window, softcap=softcap, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    live = lengths > 0                   # the oracle softmaxes empty rows uniformly
    oracle = np.asarray(ref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(_dense(k, bt)), jnp.asarray(_dense(v, bt)),
        jnp.asarray(lengths), window=window, softcap=softcap))
    np.testing.assert_allclose(got[live], oracle[live], **TOL)
    assert not got[~live].any()          # empty rows come back exactly zero


@pytest.mark.parametrize("pages_per_split", [1, 2, 5])    # 5: maxp, one split
@pytest.mark.parametrize("qpk", [1, 2])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (7, 0.0), (0, 5.0), (7, 5.0)])
@pytest.mark.parametrize("q_scale", [1.0, 12.0])
def test_paged_decode_split_plain_matches_pallas(pages_per_split, qpk, window, softcap,
                                                 q_scale):
    """The CUDA kernel's split-and-merge arithmetic
    (``paged_decode_attention_split_plain``: per-split float32 (m, l, acc)
    over runs of ``pages_per_split`` live pages, merged in split order)
    against the Pallas kernel in interpret mode. Window 7 puts the first
    live page of lengths 23 and 40 past page 0; q_scale 12 spreads the
    scores over tens, so pages past a split's first move its running max;
    empty rows are exact zeros."""
    rng = np.random.default_rng(30 + qpk)
    lens = [0, 1, 8, 9, 23, 40]
    k, v, bt = _pools(rng, lens)
    q = rng.standard_normal((len(lens), 2, qpk, 16)).astype(np.float32) * q_scale
    lengths = np.asarray(lens, np.int32)
    got = decode_attn.paged_decode_attention_split_plain(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(lengths),
        torch.tensor(bt), pages_per_split=pages_per_split, window=window,
        softcap=softcap).numpy()
    want = np.asarray(pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(lengths), jnp.asarray(bt),
                                    window=window, softcap=softcap, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[lengths == 0].any()


@pytest.mark.parametrize("tile,tiles_per_split", [(1, 1), (1, 3), (4, 2)])  # 1, 3, 8 keys
@pytest.mark.parametrize("qpk", [1, 4])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (9, 0.0), (0, 5.0), (9, 5.0)])
@pytest.mark.parametrize("q_scale", [1.0, 12.0])
def test_dense_decode_split_plain_matches_pallas(tile, tiles_per_split, qpk, window, softcap,
                                                 q_scale):
    """The dense decode kernel's split-and-merge arithmetic
    (``decode_attention_split_plain``: per-split float32 (m, l, acc) over
    runs of ``tiles_per_split`` tiles of ``tile`` positions, merged in split
    order) against the Pallas ``decode_attention_kernel`` in interpret mode
    and its ``ref.py`` oracle: Smax 40 (not a multiple of a 3-key split, so
    a last split is short), lengths 0, 1, a split boundary and either side,
    Smax and past Smax; window 9 puts the first live key of the longer rows
    past the first split; q_scale 12 spreads the scores over tens, so tiles
    past a split's first move its running max; empty rows are exact zeros."""
    rng = np.random.default_rng(40 + qpk + tile)
    KV, hd, Smax = 2, 16, 40
    kps = tile * tiles_per_split
    lens = np.asarray([0, 1, 2 * kps - 1, 2 * kps, 2 * kps + 1, Smax, Smax + 5], np.int32)
    B = len(lens)
    q = rng.standard_normal((B, KV, qpk, hd)).astype(np.float32) * q_scale
    k = rng.standard_normal((B, Smax, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Smax, KV, hd)).astype(np.float32)
    got = decode_attn.decode_attention_split_plain(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(lens), tile=tile,
        tiles_per_split=tiles_per_split, window=window, softcap=softcap).numpy()
    kj, vj = (jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (k, v))   # (B, KV, Smax, hd)
    want = np.asarray(pallas_dense(jnp.asarray(q), kj, vj, jnp.asarray(lens), window=window,
                                   softcap=softcap, kv_block=8, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    oracle = np.asarray(ref.decode_attention_ref(jnp.asarray(q), kj, vj, jnp.asarray(lens),
                                                 window=window, softcap=softcap))
    kpos = np.arange(Smax)[None]
    live = ((kpos < lens[:, None]) & ((kpos > lens[:, None] - 1 - window) if window
                                      else True)).any(axis=1)
    np.testing.assert_allclose(got[live], oracle[live], **TOL)   # the oracle softmaxes
    assert not got[~live].any()                                  # empty rows uniformly


@pytest.mark.parametrize("qpk", [1, 2])
@pytest.mark.parametrize("softcap", [0.0, 4.0])
def test_chunked_prefill_plain_matches_pallas(qpk, softcap):
    rng = np.random.default_rng(20 + qpk)
    Sc, KV, hd = 6, 2, 16
    starts = np.asarray([0, 8, 13, 0], np.int32)
    clens = np.asarray([6, 6, 3, 0], np.int32)        # padded rows, totals == 0
    totals = starts + clens
    k, v, bt = _pools(rng, list(totals))
    qm = rng.standard_normal((4, Sc, KV * qpk, hd)).astype(np.float32)
    got = tops.chunked_prefill_attention(
        torch.tensor(qm), torch.tensor(k), torch.tensor(v), torch.tensor(totals),
        torch.tensor(starts), torch.tensor(bt), softcap=softcap).numpy()
    # Pallas kernel in its own layout, through the reference's adapter
    want = np.asarray(jops.chunked_prefill_attention(
        jnp.asarray(qm), jnp.asarray(k), jnp.asarray(v), jnp.asarray(totals),
        jnp.asarray(starts), jnp.asarray(bt), softcap=softcap, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    # and the XLA chunk path over the gathered context, on live positions
    kd = _dense(k, bt).transpose(0, 2, 1, 3)
    vd = _dense(v, bt).transpose(0, 2, 1, 3)
    qpos = starts[:, None] + np.arange(Sc)[None]
    kpos = np.broadcast_to(np.arange(kd.shape[1])[None], (4, kd.shape[1]))
    xla = np.asarray(chunk_attention(jnp.asarray(qm), jnp.asarray(kd), jnp.asarray(vd),
                                     jnp.asarray(qpos), jnp.asarray(kpos),
                                     jnp.asarray(totals), softcap=softcap))
    live = np.arange(Sc)[None] < clens[:, None]
    np.testing.assert_allclose(got[live], xla[live], **TOL)
    assert not got[3].any()              # totals == 0: exact zeros


def test_chunked_prefill_kernel_layout_direct():
    """The kernel-layout entry (heads innermost) against Pallas directly."""
    rng = np.random.default_rng(3)
    qpk, Sc = 2, 4
    starts = np.asarray([5, 0], np.int32)
    totals = starts + np.asarray([4, 2], np.int32)
    k, v, bt = _pools(rng, list(totals))
    q = rng.standard_normal((2, 2, Sc * qpk, 16)).astype(np.float32)
    got = decode_attn.chunked_prefill_attention_kernel(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(totals),
        torch.tensor(starts), torch.tensor(bt), qpk=qpk).numpy()
    want = np.asarray(pallas_chunk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(totals), jnp.asarray(starts),
                                   jnp.asarray(bt), qpk=qpk, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("qpk", [1, 4])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_chunked_prefill_bf16_plain_matches_pallas(qpk, softcap):
    """At the card's tensor-core route shapes (hd 128, page 16, Sc 64), the
    bf16 plain version (what ``chunk_attn_sm90.cu`` is held to on the card)
    against the Pallas kernel in bf16, interpret mode, within 2e-2 (the two
    round p to bf16 against other running maxima): a start off the page
    grid, a short chunk, and a sequence with total == 0."""
    rng = np.random.default_rng(30 + qpk)
    Sc, KV, hd, page = 64, 1, 128, 16
    starts = np.asarray([37, 0, 0], np.int32)
    totals = starts + np.asarray([Sc, 20, 0], np.int32)
    k, v, bt = _pools(rng, list(totals), KV=KV, hd=hd, page=page, maxp=7)
    q = rng.standard_normal((3, KV, Sc * qpk, hd)).astype(np.float32)
    ints = (totals, starts, bt)
    got = decode_attn.chunked_prefill_attention_plain(
        *(torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)),
        *map(torch.tensor, ints), qpk=qpk, softcap=softcap)
    want = pallas_chunk(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                        *map(jnp.asarray, ints), qpk=qpk, softcap=softcap, interpret=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)
    assert not got[2].float().any()      # totals == 0: exact zeros


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (40, 30.0)])
@pytest.mark.parametrize("q_scale", [1.0, 12.0])
def test_paged_decode_split_bf16_plain_matches_pallas(window, softcap, q_scale):
    """At the card's shapes (hd 128, page 16, the shipped
    ``PAGES_PER_SPLIT``), the bf16 split arithmetic that ``decode_sm90.cu``
    is held to on the card (p kept in float32) against the Pallas kernel in
    bf16, interpret mode (p rounded to bf16 before P.V), within 2e-2: rows
    of 0, 1, a page boundary and either side, and more than one split."""
    rng = np.random.default_rng(50 + int(q_scale))
    lens = [0, 1, 16, 17, 150, 300]
    k, v, bt = _pools(rng, lens, KV=2, hd=128, page=16, maxp=19)
    q = rng.standard_normal((len(lens), 2, 2, 128)).astype(np.float32) * q_scale
    lengths = np.asarray(lens, np.int32)
    got = decode_attn.paged_decode_attention_split_plain(
        *(torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)), torch.tensor(lengths),
        torch.tensor(bt), pages_per_split=decode_attn.PAGES_PER_SPLIT, window=window,
        softcap=softcap)
    want = pallas_decode(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                         jnp.asarray(lengths), jnp.asarray(bt), window=window,
                         softcap=softcap, interpret=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)
    assert not got[lengths == 0].float().any()


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (40, 30.0)])
@pytest.mark.parametrize("q_scale", [1.0, 12.0])
def test_dense_decode_split_bf16_plain_matches_pallas(window, softcap, q_scale):
    """The dense decode's bf16 split arithmetic (``decode_attention_split_plain``
    at the shipped ``DENSE_TILE`` and ``DENSE_TILES_PER_SPLIT``, p in float32)
    against the Pallas ``decode_attention_kernel`` in bf16, interpret mode,
    within 2e-2, at hd 128 and GQA qpk 4: Smax 300 (not a tile multiple),
    lengths 0, 1, a split boundary and either side, Smax and past it."""
    rng = np.random.default_rng(60 + int(q_scale))
    KV, qpk, hd, Smax = 2, 4, 128, 300
    kps = decode_attn.DENSE_TILE * decode_attn.DENSE_TILES_PER_SPLIT
    lens = np.asarray([0, 1, kps - 1, kps, kps + 1, Smax, Smax + 5], np.int32)
    B = len(lens)
    q = rng.standard_normal((B, KV, qpk, hd)).astype(np.float32) * q_scale
    k = rng.standard_normal((B, Smax, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Smax, KV, hd)).astype(np.float32)
    got = decode_attn.decode_attention_split_plain(
        *(torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)), torch.tensor(lens),
        tile=decode_attn.DENSE_TILE, tiles_per_split=decode_attn.DENSE_TILES_PER_SPLIT,
        window=window, softcap=softcap)
    kj, vj = (jnp.asarray(a.transpose(0, 2, 1, 3), jnp.bfloat16) for a in (k, v))
    want = pallas_dense(jnp.asarray(q, jnp.bfloat16), kj, vj, jnp.asarray(lens),
                        window=window, softcap=softcap, kv_block=100, interpret=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)
    assert not got[lens == 0].float().any()


def _experts(rng, E, d=16, f=64):
    w = {"wi_gate": rng.standard_normal((E, d, f)).astype(np.float32) * 0.1,
         "wi_up": rng.standard_normal((E, d, f)).astype(np.float32) * 0.1,
         "wo": rng.standard_normal((E, f, d)).astype(np.float32) * 0.1}
    return w


@pytest.mark.parametrize("counts", [
    [16, 0, 0, 1],             # full, empty, one token
    [0, 8, 9, 7],              # block boundary (c_block 8) and either side
    [0, 0, 0, 0],              # all empty
])
@pytest.mark.parametrize("hot", [True, False])
def test_moe_plain_matches_pallas(counts, hot):
    rng = np.random.default_rng(sum(counts) + hot)
    E, n, C, d = 6, len(counts), 16, 16
    w = _experts(rng, E)
    perm = rng.permutation(E)[:n].astype(np.int32)
    x = rng.standard_normal((n, C, d)).astype(np.float32)
    cnt = np.asarray(counts, np.int32)
    tw = {k: torch.tensor(v) for k, v in w.items()}
    op = tops.ragged_moe_gemm if hot else tops.moe_gemv
    got = op(tw, torch.tensor(x), torch.tensor(cnt), torch.tensor(perm)).numpy()
    w_perm = {k: jnp.asarray(v[perm]) for k, v in w.items()}
    if hot:
        want = jops.ragged_moe_gemm(w_perm, jnp.asarray(x), jnp.asarray(cnt),
                                    c_block=8, f_block=32, interpret=True)
    else:
        want = jops.moe_gemv(w_perm, jnp.asarray(x), jnp.asarray(cnt),
                             f_block=32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    oracle = ref.ragged_moe_ffn_ref(w_perm, jnp.asarray(x), jnp.asarray(cnt))
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("hot", [True, False])
def test_moe_bf16_plain_matches_pallas(hot, padded):
    """At widths the card's bf16 kernels take (d 128, d_ff 256), the bf16
    plain versions (what ``moe_gemm_sm90.cu`` and ``moe_gemv_sm90.cu`` are
    held to on the card: float32 products, h rounded to bf16 before Wo)
    against the Pallas kernels in bf16, interpret mode, within 2e-2: ragged
    counts full, empty, one token and either side of a c_block of 8, perm
    out of order; padded, every slot."""
    rng = np.random.default_rng(70 + 2 * hot + padded)
    E, C, d, f = 7, 16, 128, 256
    counts = np.asarray([16, 0, 1, 8, 9, 7], np.int32)
    n = len(counts)
    w = {"wi_gate": rng.standard_normal((E, d, f)).astype(np.float32) / d ** 0.5,
         "wi_up": rng.standard_normal((E, d, f)).astype(np.float32) / d ** 0.5,
         "wo": rng.standard_normal((E, f, d)).astype(np.float32) / f ** 0.5}
    perm = rng.permutation(E)[:n].astype(np.int32)
    x = rng.standard_normal((n, C, d)).astype(np.float32)
    tb = lambda a: torch.tensor(a).to(torch.bfloat16)
    args = (tb(x), tb(w["wi_gate"]), tb(w["wi_up"]), tb(w["wo"]), torch.tensor(perm))
    if hot:
        got = (moe_gemm.moe_gemm_plain(*args) if padded
               else moe_gemm.ragged_moe_gemm_plain(*args, torch.tensor(counts)))
    else:
        got = (moe_gemv.moe_gemv_plain(*args) if padded
               else moe_gemv.ragged_moe_gemv_plain(*args, torch.tensor(counts)))
    w_perm = {k: jnp.asarray(v[perm], jnp.bfloat16) for k, v in w.items()}
    xj, cj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(counts)
    if hot and padded:
        want = jops.moe_gemm(w_perm, xj, c_block=8, f_block=128, interpret=True)
    elif hot:
        want = jops.ragged_moe_gemm(w_perm, xj, cj, c_block=8, f_block=128, interpret=True)
    else:
        want = jops.moe_gemv(w_perm, xj, None if padded else cj, f_block=128,
                             interpret=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)
    if not padded:
        for e, c in enumerate(counts):
            assert not got[e, c:].float().any()


def test_moe_wrappers_clamp_counts_to_capacity():
    """Counts past the slot buffer (routed tokens over capacity) clamp."""
    rng = np.random.default_rng(7)
    w = {k: torch.tensor(v) for k, v in _experts(rng, 3).items()}
    x = torch.tensor(rng.standard_normal((2, 4, 16)).astype(np.float32))
    perm = torch.tensor([2, 0], dtype=torch.int32)
    over = tops.ragged_moe_gemm(w, x, torch.tensor([9, 2]), perm)
    exact = tops.ragged_moe_gemm(w, x, torch.tensor([4, 2]), perm)
    torch.testing.assert_close(over, exact, rtol=0, atol=0)


def test_wrappers_do_not_fall_back_off_cpu():
    """A tensor that is on neither the CPU nor a card is refused, never
    quietly run through the plain version."""
    q = torch.zeros((1, 1, 1, 16), device="meta")
    k = torch.zeros((2, 1, 8, 16), device="meta")
    one = torch.zeros((1,), dtype=torch.int32, device="meta")
    bt = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        decode_attn.paged_decode_attention_kernel(q, k, k, one, bt)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attn.chunked_prefill_attention_kernel(q, k, k, one, one, bt, qpk=1)
    cache = torch.zeros((1, 8, 1, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        decode_attn.decode_attention_kernel(q, cache, cache, one)
    x = torch.zeros((1, 2, 16), device="meta")
    w = torch.zeros((1, 16, 64), device="meta")
    wo = torch.zeros((1, 64, 16), device="meta")
    for fn in (moe_gemm.ragged_moe_gemm_kernel, moe_gemv.ragged_moe_gemv_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, w, w, wo, one, one)
    for fn in (moe_gemm.moe_gemm_kernel, moe_gemv.moe_gemv_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, w, w, wo, one)
    assert all(v == 0 for v in build.launch_counts.values())
