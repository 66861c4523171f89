"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version (``cuda`` marker; skipped without a GPU). This file imports no JAX,
so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports the JAX package.)"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, decode_attn, flash_attn, moe_gemm, moe_gemv, ssd_decode
from repro_torch.kernels.quant import int8_quantize

torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products


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


def _experts(rng, E, d, f):
    return {"wi_gate": rng.standard_normal((E, d, f)).astype(np.float32) * 0.1,
            "wi_up": rng.standard_normal((E, d, f)).astype(np.float32) * 0.1,
            "wo": rng.standard_normal((E, f, d)).astype(np.float32) * 0.1}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_cuda_kernels_match_plain(card, dtype, tol):
    """Each CUDA kernel against its plain version on the card: tiny-moe
    shapes (the MoE GEMV needs d, d_ff multiples of 64)."""
    rng = np.random.default_rng(0)
    t = lambda a: torch.tensor(a, device=card)
    lens = [0, 1, 8, 9, 23, 40]
    k, v, bt = _pools(rng, lens)
    q = rng.standard_normal((len(lens), 2, 2, 16)).astype(np.float32)
    args = (t(q).to(dtype), t(k).to(dtype), t(v).to(dtype),
            t(np.asarray(lens, np.int32)), t(bt))
    for kw in (dict(), dict(window=7, softcap=5.0)):
        got = decode_attn.paged_decode_attention_kernel(*args, **kw)
        want = decode_attn.paged_decode_attention_plain(*args, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    starts = np.asarray([0, 8, 13, 0], np.int32)
    totals = starts + np.asarray([6, 6, 3, 0], np.int32)
    k, v, bt = _pools(rng, list(totals))
    qc = rng.standard_normal((4, 2, 12, 16)).astype(np.float32)
    args = (t(qc).to(dtype), t(k).to(dtype), t(v).to(dtype), t(totals), t(starts), t(bt))
    sm90 = build.launch_counts["chunked_prefill_attention_sm90"]
    got = decode_attn.chunked_prefill_attention_kernel(*args, qpk=2)
    assert build.launch_counts["chunked_prefill_attention_sm90"] == sm90   # hd 16: scalar
    want = decode_attn.chunked_prefill_attention_plain(*args, qpk=2)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    w = {kk: t(vv).to(dtype) for kk, vv in _experts(rng, 6, d=64, f=128).items()}
    x = t(rng.standard_normal((4, 16, 64)).astype(np.float32)).to(dtype)
    perm = t(np.asarray([5, 0, 3, 1], np.int32))
    cnt = t(np.asarray([16, 0, 1, 9], np.int32))
    for kern, plain in ((moe_gemm.ragged_moe_gemm_kernel, moe_gemm.ragged_moe_gemm_plain),
                        (moe_gemv.ragged_moe_gemv_kernel, moe_gemv.ragged_moe_gemv_plain)):
        got = kern(x, w["wi_gate"], w["wi_up"], w["wo"], perm, cnt)
        want = plain(x, w["wi_gate"], w["wi_up"], w["wo"], perm, cnt)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_int8_quantize_on_the_card_is_bit_equal_to_the_cpu(card):
    """The int8 recipe gives the same scales and values on the card as on
    the CPU (true divisions), so the kernels' requantization and the plain
    versions' agree bit for bit: 4096 rows of 64 at scales 0.1-10."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4096, 64)) * rng.uniform(0.1, 10.0, (4096, 1))).astype(np.float32)
    q_cpu, s_cpu = int8_quantize(torch.tensor(x))
    q_card, s_card = int8_quantize(torch.tensor(x, device=card))
    assert torch.equal(s_card.cpu(), s_cpu)
    assert torch.equal(q_card.cpu(), q_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_cuda_int8_and_padded_kernels_match_plain(card, dtype, tol):
    """The int8 attention kernels against their per-page plain versions and
    the capacity-padded MoE kernels against theirs, on the card: hd 16, KV
    2, qpk 2, page 8; d 64, d_ff 128. Both sides requantize with the same
    recipe and the card's own exp, so the int8 values agree and the
    tolerances are the float kernels' (float32 sums in another order; bf16
    output rounding)."""
    rng = np.random.default_rng(1)
    t = lambda a: torch.tensor(a, device=card)
    lens = [0, 1, 8, 9, 23, 40]
    k, v, bt = _pools(rng, lens)
    k8, ks = int8_quantize(t(k))
    v8, vs = int8_quantize(t(v))
    q = t(rng.standard_normal((len(lens), 2, 2, 16)).astype(np.float32)).to(dtype)
    args = (q, k8, ks, v8, vs, t(np.asarray(lens, np.int32)), t(bt))
    for kw in (dict(), dict(window=7, softcap=5.0)):
        got = decode_attn.paged_decode_attention_int8_kernel(*args, **kw)
        want = decode_attn.paged_decode_attention_int8_plain(*args, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    starts = np.asarray([0, 8, 13, 0], np.int32)
    totals = starts + np.asarray([6, 6, 3, 0], np.int32)
    k, v, bt = _pools(rng, list(totals))
    k8, ks = int8_quantize(t(k))
    v8, vs = int8_quantize(t(v))
    qc = t(rng.standard_normal((4, 2, 12, 16)).astype(np.float32)).to(dtype)
    args = (qc, k8, ks, v8, vs, t(totals), t(starts), t(bt))
    for softcap in (0.0, 4.0):
        got = decode_attn.chunked_prefill_attention_int8_kernel(*args, qpk=2, softcap=softcap)
        want = decode_attn.chunked_prefill_attention_int8_plain(*args, qpk=2, softcap=softcap)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    w = {kk: t(vv).to(dtype) for kk, vv in _experts(rng, 6, d=64, f=128).items()}
    x = t(rng.standard_normal((4, 16, 64)).astype(np.float32)).to(dtype)
    perm = t(np.asarray([5, 0, 3, 1], np.int32))
    for kern, plain in ((moe_gemm.moe_gemm_kernel, moe_gemm.moe_gemm_plain),
                        (moe_gemv.moe_gemv_kernel, moe_gemv.moe_gemv_plain)):
        got = kern(x, w["wi_gate"], w["wi_up"], w["wo"], perm)
        want = plain(x, w["wi_gate"], w["wi_up"], w["wo"], perm)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_cuda_dense_decode_and_ssd_kernels_match_plain(card, monkeypatch, dtype, tol):
    """The dense-cache decode attention kernels (``decode_sm90.cu``: qpk 1
    and 4, a window and a softcap, lengths 0 to past Smax, a layer view of a
    stacked cache; then Jamba's qpk 4 at hd 128 and Smax 1024 with lengths
    on and either side of a split boundary, at the default split and at 1
    and 3 tiles a split of 8 and 32 positions with 1-3 stages) and the SSD
    decode kernel (headdim 16 and 64; its state updated in place) against
    their plain versions on the card; a second decode call gives the same
    bits, and a length-0 row exact zeros."""
    rng = np.random.default_rng(2)
    t = lambda a: torch.tensor(a, device=card)
    B, KV, hd, Smax = 6, 2, 32, 80
    lens = t(np.asarray([0, 1, 17, 64, 80, 95], np.int32))
    stacked = t(rng.standard_normal((2, 2, B, Smax, KV, hd)).astype(np.float32)).to(dtype)
    k, v = stacked[0, 1], stacked[1, 1]          # layer views, as the model passes them

    def check(q, k, v, lens, **kw):
        n = build.launch_counts["decode_attention"]
        got = decode_attn.decode_attention_kernel(q, k, v, lens, **kw)
        assert build.launch_counts["decode_attention"] == n + 1
        want = decode_attn.decode_attention_plain(q, k, v, lens, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
        assert not got[0].any()                   # length 0
        assert torch.equal(got, decode_attn.decode_attention_kernel(q, k, v, lens, **kw))

    for qpk, kw in ((1, dict()), (4, dict()), (4, dict(window=20, softcap=5.0))):
        q = t(rng.standard_normal((B, KV, qpk, hd)).astype(np.float32)).to(dtype)
        check(q, k, v, lens, **kw)
    B, KV, hd, Smax = 8, 8, 128, 1024
    split = decode_attn.DENSE_TILE * decode_attn.DENSE_TILES_PER_SPLIT
    lens = t(np.asarray([0, 1, split - 1, split, split + 1, 544, Smax, Smax + 6], np.int32))
    k, v = (t(rng.standard_normal((B, Smax, KV, hd)).astype(np.float32)).to(dtype)
            for _ in range(2))
    q = t(rng.standard_normal((B, KV, 4, hd)).astype(np.float32) * 4).to(dtype)
    for tile, tps, stages in ((decode_attn.DENSE_TILE, decode_attn.DENSE_TILES_PER_SPLIT,
                               decode_attn.STAGES), (8, 1, 1), (32, 3, 3)):
        monkeypatch.setattr(decode_attn, "DENSE_TILE", tile)
        monkeypatch.setattr(decode_attn, "DENSE_TILES_PER_SPLIT", tps)
        monkeypatch.setattr(decode_attn, "STAGES", stages)
        for kw in (dict(), dict(window=200, softcap=30.0)):
            check(q, k, v, lens, **kw)
    for (Bs, H, N, P) in ((2, 8, 16, 16), (3, 12, 16, 64)):
        state = t(rng.standard_normal((Bs, H, N, P)).astype(np.float32))
        x = t(rng.standard_normal((Bs, H, P)).astype(np.float32)).to(dtype)
        dt = t(np.log1p(np.exp(rng.standard_normal((Bs, H)))).astype(np.float32))
        a_log = t(rng.uniform(size=(H,)).astype(np.float32))
        b, c = (t(rng.standard_normal((Bs, N)).astype(np.float32)) for _ in range(2))
        d = t(rng.standard_normal((H,)).astype(np.float32))
        y_p, s_p = ssd_decode.ssd_decode_plain(state, x, dt, a_log, b, c, d)
        inplace = state.clone()
        y_k, s_k = ssd_decode.ssd_decode_kernel(inplace, x, dt, a_log, b, c, d)
        assert s_k is inplace
        torch.testing.assert_close(y_k.float(), y_p.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(s_k, s_p, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_cuda_flash_kernels_match_plain(card, dtype, tol):
    """The flash forward (out, lse) and backward (dq, dk, dv) against their
    plain versions on the card, hd 64: causal MHA, causal GQA with a window
    narrower than a tile, and non-causal GQA with a window and a softcap, at
    lengths that are not tile multiples. Gradients are held to the band
    times max(1, the plain gradient's largest entry) (dk and dv sum over
    rows and the group's heads); the backward is the same bit for bit on a
    second run (no atomics)."""
    rng = np.random.default_rng(3)
    t = lambda a: torch.tensor(a, device=card)
    for B, S, H, KV, kw in ((2, 40, 2, 2, dict(causal=True)),
                            (1, 130, 4, 2, dict(causal=True, window=10)),
                            (1, 70, 4, 1, dict(causal=False, window=20, softcap=5.0))):
        q = t(rng.standard_normal((B, S, H, 64)).astype(np.float32)).to(dtype)
        k, v = (t(rng.standard_normal((B, S, KV, 64)).astype(np.float32)).to(dtype)
                for _ in range(2))
        dout = t(rng.standard_normal((B, S, H, 64)).astype(np.float32)).to(dtype)
        out, lse = flash_attn.flash_attention_kernel(q, k, v, **kw)
        out_p, lse_p, o32 = flash_attn.flash_attention_plain(q, k, v, f32_out=True, **kw)
        torch.testing.assert_close(out.float(), out_p.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-4)
        got = flash_attn.flash_attention_bwd_kernel(q, k, v, o32, lse_p, dout, **kw)
        want = flash_attn.flash_attention_bwd_plain(q, k, v, o32, lse_p, dout, **kw)
        for g, w in zip(got, want):
            band = tol * max(1.0, w.float().abs().max().item())
            torch.testing.assert_close(g.float(), w.float(), atol=band, rtol=0)
        again = flash_attn.flash_attention_bwd_kernel(q, k, v, o32, lse_p, dout, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


# (hd, page, qpk, window, softcap, long): each head size, page and qpk of the
# paged decode in turn, a window and a softcap; `long` puts one sequence
# past 2048 keys
PAGED_DECODE_CASES = [(128, 16, 1, 0, 0.0, False), (128, 16, 4, 200, 30.0, True),
                      (128, 8, 8, 0, 30.0, False), (128, 64, 12, 0, 0.0, True),
                      (128, 32, 1, 7, 0.0, True), (64, 16, 4, 0, 0.0, False),
                      (64, 8, 12, 200, 0.0, True), (64, 64, 1, 0, 30.0, False),
                      (64, 32, 8, 7, 5.0, False), (16, 8, 1, 0, 0.0, False),
                      (16, 32, 4, 7, 5.0, True), (16, 64, 12, 0, 30.0, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd,page,qpk,window,softcap,long", PAGED_DECODE_CASES)
def test_cuda_paged_decode_matches_plain(card, monkeypatch, hd, page, qpk, window, softcap,
                                        long):
    """The paged decode (``decode_sm90.cu``: the live page range split
    over blocks, merged in a fixed order) against the plain version, bf16
    within 2e-2 and float32 within 1e-4: lengths on and off the page grid, a
    sequence with length 0 (exact zeros), block-table columns past the live
    pages on a null page 0 of large finite values; runs of 1, 3 and 32
    pages a split beside the default, with 1-3 stages, and scores spread
    wide enough to move a split's running max past its first page; a second
    call gives the same bits."""
    rng = np.random.default_rng(hd + page + qpk + window)
    KV = 2
    lens = [0, 1, page - 1, page, page + 1, 300, 2100 if long else 517, 1000]
    maxp = -(-max(lens) // page) + 2                  # columns past every live page
    k, v, bt = _pools(rng, lens, KV=KV, hd=hd, page=page, maxp=maxp)
    k[0] = v[0] = 1e4                                 # the null page: never live
    q = rng.standard_normal((len(lens), KV, qpk, hd)).astype(np.float32)
    t = lambda a: torch.tensor(a, device=card)
    ints = (t(np.asarray(lens, np.int32)), t(bt))
    kw = dict(window=window, softcap=softcap)
    default = (decode_attn.PAGES_PER_SPLIT, decode_attn.STAGES)
    # (pages a split, stages, q scale): q x 12 spreads the scores over tens, so
    # pages past a split's first move its running max too
    runs = ((*default, 1.0), (*default, 12.0), (1, 2, 1.0), (3, 1, 12.0), (32, 3, 12.0))
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for pps, stages, q_scale in runs:
            args = (t(q * q_scale).to(dtype), t(k).to(dtype), t(v).to(dtype), *ints)
            want = decode_attn.paged_decode_attention_plain(*args, **kw)
            monkeypatch.setattr(decode_attn, "PAGES_PER_SPLIT", pps)
            monkeypatch.setattr(decode_attn, "STAGES", stages)
            n = build.launch_counts["paged_decode_attention"]
            got = decode_attn.paged_decode_attention_kernel(*args, **kw)
            assert build.launch_counts["paged_decode_attention"] == n + 1
            torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
            assert not got[0].any()                   # length 0
            again = decode_attn.paged_decode_attention_kernel(*args, **kw)
            assert torch.equal(got, again)


# (hd, page, qpk, window, softcap, long) of the int8 paged decode: path b's
# hd 128 / page 16 and hd 64 / page 8 at qpk 1 and 4, then qpk 12 at page 64
# (a page past one warp's 32 lanes), the smallest page and hd 32, and a page
# of 6 keys, which takes the scalar route; `long` puts one sequence past
# 2048 keys
INT8_DECODE_CASES = [(128, 16, 1, 0, 0.0, False), (128, 16, 4, 200, 30.0, True),
                     (64, 8, 1, 7, 5.0, True), (64, 8, 4, 0, 0.0, False),
                     (128, 64, 12, 0, 30.0, True), (32, 4, 2, 7, 5.0, False),
                     (64, 6, 2, 0, 5.0, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd,page,qpk,window,softcap,long", INT8_DECODE_CASES)
def test_cuda_int8_paged_decode_matches_plain(card, monkeypatch, hd, page, qpk, window,
                                             softcap, long):
    """The int8 paged decode's split route (``decode_sm90.cu``: the live
    page range split over blocks, each split walked from its own running
    max with the per-page requantization, merged in a fixed order) against
    its plain version, ``paged_decode_attention_int8_split_plain``, bf16
    within 2e-2 and float32 within 1e-4: lengths 0 (exact zeros), 1, on and
    off the page grid and a split's edge, block-table columns past the live
    pages on a null page 0 of large values; runs of 1, 3 and 32 pages a
    split beside the default, with 1-3 stages, and q x 12 so that pages
    past a split's first move its running max; a second call gives the
    same bits. A page that is not a multiple of 4 keys takes the scalar
    route, held against the page walk."""
    rng = np.random.default_rng(hd + page + qpk + window + 7)
    KV = 2
    pps0 = decode_attn.INT8_PAGES_PER_SPLIT
    edge = pps0 * page
    lens = [0, 1, page - 1, page, page + 1, edge, edge + 1, 300, 2100 if long else 517, 1000]
    maxp = -(-max(lens) // page) + 2                  # columns past every live page
    k, v, bt = _pools(rng, lens, KV=KV, hd=hd, page=page, maxp=maxp)
    k[0] = v[0] = 1e4                                 # the null page: never live
    q = rng.standard_normal((len(lens), KV, qpk, hd)).astype(np.float32)
    t = lambda a: torch.tensor(a, device=card)
    k8, ks = int8_quantize(t(k))
    v8, vs = int8_quantize(t(v))
    ints = (t(np.asarray(lens, np.int32)), t(bt))
    kw = dict(window=window, softcap=softcap)
    split = page % 4 == 0
    runs = ((pps0, decode_attn.STAGES, 1.0), (pps0, decode_attn.STAGES, 12.0),
            (1, 2, 1.0), (3, 1, 12.0), (32, 3, 12.0)) if split else ((pps0, 2, 1.0),)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for pps, stages, q_scale in runs:
            args = (t(q * q_scale).to(dtype), k8, ks, v8, vs, *ints)
            if split:
                want = decode_attn.paged_decode_attention_int8_split_plain(
                    *args, pages_per_split=pps, **kw)
            else:
                want = decode_attn.paged_decode_attention_int8_plain(*args, **kw)
            monkeypatch.setattr(decode_attn, "INT8_PAGES_PER_SPLIT", pps)
            monkeypatch.setattr(decode_attn, "STAGES", stages)
            n = build.launch_counts["paged_decode_attention_int8"]
            n_sm90 = build.launch_counts["paged_decode_attention_int8_sm90"]
            got = decode_attn.paged_decode_attention_int8_kernel(*args, **kw)
            assert build.launch_counts["paged_decode_attention_int8"] == n + 1
            assert build.launch_counts["paged_decode_attention_int8_sm90"] == n_sm90 + split
            torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
            assert not got[0].any()                   # length 0
            again = decode_attn.paged_decode_attention_int8_kernel(*args, **kw)
            assert torch.equal(got, again)


# (hd, page, qpk, Sc, softcap, long) of the int8 chunk: path b's hd 128 /
# page 16 and hd 64 / page 8 at qpk 1 and 4, pages of 32 and 64 keys, and
# hd 16, which takes the scalar route; Sc 20 puts R off the 64-row items at
# qpk 1 and 4; `long` puts one sequence's context past 2048 keys
INT8_CHUNK_CASES = [(128, 16, 1, 64, 0.0, False), (128, 16, 4, 20, 30.0, True),
                    (64, 8, 1, 20, 30.0, True), (64, 8, 4, 64, 0.0, False),
                    (128, 32, 8, 20, 0.0, False), (64, 64, 1, 64, 30.0, True),
                    (16, 8, 2, 20, 5.0, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd,page,qpk,Sc,softcap,long", INT8_CHUNK_CASES)
def test_cuda_int8_chunked_prefill_matches_plain(card, monkeypatch, hd, page, qpk, Sc, softcap,
                                                 long):
    """The int8 chunk attention's tensor-core route (``chunk_int8_sm90.cu``:
    int8 ``mma.sync``, the reference's page walk) against its plain
    version, bf16 within 2e-2 and float32 within 1e-4, at the default keys
    a step and at one page a step, q at x1 and x12 (the scores spread over
    tens, so the running max moves from page to page):
    starts off the page grid, a chunk shorter than Sc (padded rows), a
    sequence with total == 0 (exact zeros), block-table columns past the
    live pages on a null page 0 of large values. The call must take the
    route its shape names (hd 16: the scalar kernel), and a second call
    give the same bits."""
    rng = np.random.default_rng(hd + page + qpk + Sc + 11)
    KV = 2
    starts = np.asarray([0, 37, 2100 if long else 130, 0], np.int32)
    totals = starts + np.asarray([Sc, Sc - 3, Sc, 0], np.int32)
    maxp = -(-int(totals.max()) // page) + 2          # columns past every live page
    k, v, bt = _pools(rng, list(totals), KV=KV, hd=hd, page=page, maxp=maxp)
    k[0] = v[0] = 1e4                                 # the null page: never live
    q = rng.standard_normal((len(starts), KV, Sc * qpk, hd)).astype(np.float32)
    t = lambda a: torch.tensor(a, device=card)
    k8, ks = int8_quantize(t(k))
    v8, vs = int8_quantize(t(v))
    ints = (t(totals), t(starts), t(bt))
    sm90 = (hd, page) in decode_attn.SM90_SHAPES
    kw = dict(qpk=qpk, softcap=softcap)
    runs = ((decode_attn.INT8_CHUNK_STEP_KEYS, 1.0), (decode_attn.INT8_CHUNK_STEP_KEYS, 12.0),
            (page, 12.0))
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for step_keys, q_scale in runs:
            monkeypatch.setattr(decode_attn, "INT8_CHUNK_STEP_KEYS", step_keys)
            args = (t(q * q_scale).to(dtype), k8, ks, v8, vs, *ints)
            n = build.launch_counts["chunked_prefill_attention_int8"]
            n_sm90 = build.launch_counts["chunked_prefill_attention_int8_sm90"]
            got = decode_attn.chunked_prefill_attention_int8_kernel(*args, **kw)
            assert build.launch_counts["chunked_prefill_attention_int8"] == n + 1
            assert build.launch_counts["chunked_prefill_attention_int8_sm90"] == n_sm90 + sm90
            want = decode_attn.chunked_prefill_attention_int8_plain(*args, **kw)
            torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
            assert not got[3].any()                   # total == 0
            again = decode_attn.chunked_prefill_attention_int8_kernel(*args, **kw)
            assert torch.equal(got, again)


# (hd, page, qpk, Sc, softcap, long): each head size, page, qpk, chunk width
# and softcap of the route, in turn; Sc 20 puts R off the 64-row tiles at
# qpk 1 and 4; `long` puts one sequence's context past 2048 keys
SM90_CHUNK_CASES = [(128, 16, 1, 64, 0.0, False), (128, 16, 4, 64, 30.0, False),
                    (128, 8, 8, 20, 0.0, False), (128, 64, 1, 20, 30.0, True),
                    (128, 32, 4, 20, 0.0, True), (64, 16, 1, 20, 0.0, False),
                    (64, 8, 4, 64, 30.0, True), (64, 64, 8, 64, 0.0, False),
                    (64, 32, 1, 64, 30.0, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd,page,qpk,Sc,softcap,long", SM90_CHUNK_CASES)
def test_cuda_bf16_chunked_prefill_matches_plain(card, hd, page, qpk, Sc, softcap, long):
    """The tensor-core bf16 chunk kernel (``chunk_attn_sm90.cu``) against
    the plain version within 2e-2: starts off the page grid, a chunk shorter
    than Sc (padded rows), a sequence with total == 0 (exact zeros), and
    block-table columns past the live pages on a null page 0 of large finite
    values. The call must take the tensor-core route, and a second call give
    the same bits; the same inputs in float32 take the scalar route (1e-4)."""
    rng = np.random.default_rng(hd + page + qpk + Sc)
    KV = 2
    starts = np.asarray([0, 37, 2100 if long else 130, 0], np.int32)
    totals = starts + np.asarray([Sc, Sc - 3, Sc, 0], np.int32)
    maxp = -(-int(totals.max()) // page) + 2          # columns past every live page
    k, v, bt = _pools(rng, list(totals), KV=KV, hd=hd, page=page, maxp=maxp)
    k[0] = v[0] = 1e4                                 # the null page: never live
    q = rng.standard_normal((len(starts), KV, Sc * qpk, hd)).astype(np.float32)
    t = lambda a: torch.tensor(a, device=card)
    ints = (t(totals), t(starts), t(bt))
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        args = (t(q).to(dtype), t(k).to(dtype), t(v).to(dtype), *ints)
        sm90 = build.launch_counts["chunked_prefill_attention_sm90"]
        got = decode_attn.chunked_prefill_attention_kernel(*args, qpk=qpk, softcap=softcap)
        assert build.launch_counts["chunked_prefill_attention_sm90"] == sm90 + (
            dtype == torch.bfloat16)
        want = decode_attn.chunked_prefill_attention_plain(*args, qpk=qpk, softcap=softcap)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
        assert not got[3].any()                       # total == 0
        again = decode_attn.chunked_prefill_attention_kernel(*args, qpk=qpk, softcap=softcap)
        assert torch.equal(got, again)


# (S, KV, qpk, causal, window, softcap): S 1000 and 2047 are not multiples
# of the 128-row tiles; qpk 12 does not divide them (mistral-large-123b's
# 96 heads over 8)
BF16_FWD_CASES = [(2048, 2, 1, True, 0, 0.0), (2048, 2, 4, False, 0, 0.0),
                  (1000, 1, 12, True, 0, 0.0), (2047, 1, 12, False, 0, 0.0),
                  (2047, 2, 4, True, 0, 0.0), (2048, 2, 1, True, 1000, 50.0),
                  (1000, 1, 12, False, 1000, 50.0)]


def _fused_qkv(rng, card, B, S, H, KV, hd):
    """q, k, v as strided views of one fused (B, S, (H + 2 KV) hd) bf16
    projection, as a model's fused QKV matmul hands them over."""
    qkv = torch.tensor(rng.standard_normal((B, S, (H + 2 * KV) * hd)).astype(np.float32),
                       device=card).to(torch.bfloat16)
    q = qkv[..., :H * hd].unflatten(-1, (H, hd))
    k = qkv[..., H * hd:(H + KV) * hd].unflatten(-1, (KV, hd))
    v = qkv[..., (H + KV) * hd:].unflatten(-1, (KV, hd))
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S,KV,qpk,causal,window,softcap", BF16_FWD_CASES)
def test_cuda_bf16_flash_forward_matches_plain(card, S, KV, qpk, causal, window, softcap, hd):
    """The tensor-core bf16 forward (``flash_fwd_sm90.cu``) against the
    plain version: out and its float32 copy within the bf16 band (2e-2),
    lse within 2e-2, with q, k, v read as strided views of one fused
    projection; a second call gives the same bits."""
    rng = np.random.default_rng(S + qpk + hd)
    q, k, v = _fused_qkv(rng, card, 1, S, KV * qpk, KV, hd)
    assert not q.is_contiguous() and not k.is_contiguous()
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse, o32 = flash_attn.flash_attention_kernel(q, k, v, f32_out=True, **kw)
    out_p, lse_p, o32_p = flash_attn.flash_attention_plain(q, k, v, f32_out=True, **kw)
    assert out.dtype == torch.bfloat16 and o32.dtype == torch.float32
    torch.testing.assert_close(out.float(), out_p.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(o32, o32_p, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_p, atol=2e-2, rtol=2e-2)
    assert torch.equal(o32.to(torch.bfloat16), out)
    again = flash_attn.flash_attention_kernel(q, k, v, f32_out=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip((out, lse, o32), again))


@pytest.mark.cuda
def test_cuda_bf16_flash_forward_rejects_what_it_does_not_take(card):
    """A CUDA tensor the bf16 kernel cannot read raises (no plain fallback):
    float16, head_dim 96, and rows off the 16-byte grid."""
    x = torch.zeros((1, 64, 2, 64), device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attn.flash_attention_kernel(x, x, x)
    x = torch.zeros((1, 64, 2, 96), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attn.flash_attention_kernel(x, x, x)
    base = torch.zeros((1, 64, 2 * 64 + 4), device=card, dtype=torch.bfloat16)
    x = base[..., 4:].unflatten(-1, (2, 64))     # rows start 8 bytes in
    with pytest.raises(ValueError):
        flash_attn.flash_attention_kernel(x, x, x)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S,KV,qpk,causal,window,softcap", BF16_FWD_CASES)
def test_cuda_bf16_flash_backward_matches_plain(card, S, KV, qpk, causal, window, softcap,
                                                hd):
    """The tensor-core bf16 backward (``flash_bwd_sm90.cu``) against the
    plain version, from the plain forward's float32 output and lse and a
    seeded dout, with q, k, v read as strided views of one fused
    projection: dq, dk and dv each within 2e-2 times max(1, its largest
    |plain entry|) (dk and dv sum over rows and the group's heads); a
    second call gives the same bits (no atomics)."""
    rng = np.random.default_rng(S + qpk + hd + 1)
    q, k, v = _fused_qkv(rng, card, 1, S, KV * qpk, KV, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    _, lse, o32 = flash_attn.flash_attention_plain(q, k, v, f32_out=True, **kw)
    dout = torch.tensor(rng.standard_normal(q.shape).astype(np.float32),
                        device=card).to(torch.bfloat16)
    got = flash_attn.flash_attention_bwd_kernel(q, k, v, o32, lse, dout, **kw)
    want = flash_attn.flash_attention_bwd_plain(q, k, v, o32, lse, dout, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        band = 2e-2 * max(1.0, w.float().abs().max().item())
        torch.testing.assert_close(g.float(), w.float(), atol=band, rtol=0)
    again = flash_attn.flash_attention_bwd_kernel(q, k, v, o32, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_bf16_flash_backward_rejects_what_it_does_not_take(card):
    """A CUDA tensor the bf16 backward cannot read raises (no scalar
    fallback): float16, head_dim 96, rows off the 16-byte grid, and an
    output not in float32."""
    def call(x, out_dtype=torch.float32):
        B, S, H, _ = x.shape
        out = torch.zeros(x.shape, device=card, dtype=out_dtype)
        lse = torch.zeros((B, H, S), device=card)
        dout = torch.zeros(x.shape, device=card, dtype=x.dtype)
        return flash_attn.flash_attention_bwd_kernel(x, x, x, out, lse, dout)

    with pytest.raises(TypeError):
        call(torch.zeros((1, 64, 2, 64), device=card, dtype=torch.float16))
    with pytest.raises(ValueError):
        call(torch.zeros((1, 64, 2, 96), device=card, dtype=torch.bfloat16))
    base = torch.zeros((1, 64, 2 * 64 + 4), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        call(base[..., 4:].unflatten(-1, (2, 64)))     # rows start 8 bytes in
    with pytest.raises(ValueError):
        call(torch.zeros((1, 64, 2, 64), device=card, dtype=torch.bfloat16),
             out_dtype=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d,f,Cc", [(2048, 1024, 72), (4096, 14336, 24)])
def test_cuda_moe_gemv_matches_plain(card, d, f, Cc):
    """The bf16 cold GEMVs (``moe_gemv_sm90.cu``: weights by TMA, the live
    rows on the tensor cores), ragged and capacity-padded, against their
    plain versions within 2e-2 at OLMoE's widths (Cc 72: a second pass of
    64 rows) and Jamba's: counts 0, 1, 15, 16, 17 and Cc, with empty experts
    between live ones and perm out of order. Each call must take the
    tensor-core route, dead rows come back exact zeros, and a second call
    gives the same bits; float32 at OLMoE's widths takes the scalar route
    (1e-4)."""
    gen = torch.Generator(device=card)
    gen.manual_seed(d + f)
    E = 10
    counts = [0, 1, 0, 15, 16, 0, 17, Cc]
    n = len(counts)

    def w(*shape):
        return torch.randn(shape, generator=gen, device=card) / shape[-2] ** 0.5

    wg, wu, wo = w(E, d, f), w(E, d, f), w(E, f, d)
    x = torch.randn((n, Cc, d), generator=gen, device=card)
    perm = torch.randperm(E, generator=gen, device=card)[:n].to(torch.int32)
    cnt = torch.tensor(counts, dtype=torch.int32, device=card)
    dtypes = ((torch.bfloat16, 2e-2),) + (((torch.float32, 1e-4),) if d == 2048 else ())
    for dtype, tol in dtypes:
        args = [t.to(dtype) for t in (x, wg, wu, wo)] + [perm]
        for kern, plain, extra, name in (
                (moe_gemv.ragged_moe_gemv_kernel, moe_gemv.ragged_moe_gemv_plain, [cnt],
                 "ragged_moe_gemv_sm90"),
                (moe_gemv.moe_gemv_kernel, moe_gemv.moe_gemv_plain, [], "moe_gemv_sm90")):
            n_sm90 = build.launch_counts[name]
            got = kern(*args, *extra)
            assert build.launch_counts[name] == n_sm90 + (dtype == torch.bfloat16)
            want = plain(*args, *extra)
            torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
            if extra:
                for e, c in enumerate(counts):
                    assert not got[e, c:].any()
            assert torch.equal(got, kern(*args, *extra))


@pytest.mark.cuda
@pytest.mark.parametrize("d,f,C", [(2048, 1024, 136), (4096, 14336, 72), (192, 320, 72)])
def test_cuda_moe_gemm_matches_plain(card, d, f, C):
    """The bf16 hot GEMMs (``moe_gemm_sm90.cu``: each live expert's weights
    by TMA once a pass of up to 128 rows, ``wgmma`` with the rows as N),
    ragged and capacity-padded, against their plain versions within 2e-2 at
    OLMoE's widths (C 136: a second 128-row pass), Jamba's (C 72: one pass
    of 128) and widths that end inside a block's 128 (d_ff) and 256 (d)
    columns: counts 0, 1, 15, 16, 17, 64, 65 and C, with empty experts
    between live ones and perm out of order. Each call must take the
    tensor-core route, dead rows come back exact zeros, and a second call
    gives the same bits; float32 at OLMoE's widths takes the scalar route
    (1e-4)."""
    gen = torch.Generator(device=card)
    gen.manual_seed(d + f + C)
    E = 12
    counts = [0, 1, 15, 0, 16, 17, 64, 0, 65, C]
    n = len(counts)

    def w(*shape):
        return torch.randn(shape, generator=gen, device=card) / shape[-2] ** 0.5

    wg, wu, wo = w(E, d, f), w(E, d, f), w(E, f, d)
    x = torch.randn((n, C, d), generator=gen, device=card)
    perm = torch.randperm(E, generator=gen, device=card)[:n].to(torch.int32)
    cnt = torch.tensor(counts, dtype=torch.int32, device=card)
    dtypes = ((torch.bfloat16, 2e-2),) + (((torch.float32, 1e-4),) if d == 2048 else ())
    for dtype, tol in dtypes:
        args = [t.to(dtype) for t in (x, wg, wu, wo)] + [perm]
        for kern, plain, extra, name in (
                (moe_gemm.ragged_moe_gemm_kernel, moe_gemm.ragged_moe_gemm_plain, [cnt],
                 "ragged_moe_gemm_sm90"),
                (moe_gemm.moe_gemm_kernel, moe_gemm.moe_gemm_plain, [], "moe_gemm_sm90")):
            n_sm90 = build.launch_counts[name]
            got = kern(*args, *extra)
            assert build.launch_counts[name] == n_sm90 + (dtype == torch.bfloat16)
            want = plain(*args, *extra)
            torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
            if extra:
                for e, c in enumerate(counts):
                    assert not got[e, c:].any()
            assert torch.equal(got, kern(*args, *extra))


@pytest.mark.cuda
def test_cuda_bf16_moe_gemm_rejects_what_it_does_not_take(card):
    """The bf16 hot GEMMs refuse d or d_ff not a multiple of 64, operands
    whose base is not 16-byte aligned, and float16; they never fall back to
    the scalar kernel or the plain version."""
    bf = dict(device=card, dtype=torch.bfloat16)
    perm = torch.tensor([1, 0], dtype=torch.int32, device=card)
    cnt = torch.tensor([3, 0], dtype=torch.int32, device=card)

    def operands(d, f, x_off=0, w_off=0):
        x = torch.zeros(2 * 8 * d + x_off, **bf)[x_off:].view(2, 8, d)
        wg = torch.zeros(2 * d * f + w_off, **bf)[w_off:].view(2, d, f)
        return x, wg, torch.zeros((2, d, f), **bf), torch.zeros((2, f, d), **bf)

    before = dict(build.launch_counts)
    for bad in (operands(96, 128), operands(128, 96), operands(128, 128, x_off=1),
                operands(128, 128, w_off=4)):
        with pytest.raises(ValueError):
            moe_gemm.ragged_moe_gemm_kernel(*bad, perm, cnt)
        with pytest.raises(ValueError):
            moe_gemm.moe_gemm_kernel(*bad, perm)
    half = [t.to(torch.float16) for t in operands(128, 128)]
    with pytest.raises(TypeError):
        moe_gemm.ragged_moe_gemm_kernel(*half, perm, cnt)
    assert build.launch_counts == before


@pytest.mark.cuda
def test_cuda_moe_input_gradient_is_the_same_from_run_to_run(card):
    """Two backward passes of the grouped and the duplex MoE layer on the
    same input give bit-equal input gradients on the card: the token ->
    slot gather's backward sums each token's top-k slot gradients in
    choice order (top-8 of 16 experts, as OLMoE routes, bf16)."""
    import dataclasses
    from repro_torch.configs import resolve_config
    from repro_torch.core.duplex_moe import duplex_moe_apply
    from repro_torch.models.moe import moe_apply
    base = resolve_config("tiny-moe")
    E, d, f = 16, 256, 128
    cfg = dataclasses.replace(base, d_model=d, moe=dataclasses.replace(
        base.moe, num_experts=E, top_k=8, d_ff_expert=f))
    rng = np.random.default_rng(7)
    w = lambda *shape: torch.tensor(rng.standard_normal(shape).astype(np.float32) / shape[-2]
                                    ** 0.5, device=card).to(torch.bfloat16)
    params = {"router": w(d, E), "wi_gate": w(E, d, f), "wi_up": w(E, d, f), "wo": w(E, f, d)}
    x = torch.tensor(rng.standard_normal((4096, d)).astype(np.float32),
                     device=card).to(torch.bfloat16)
    g = torch.tensor(rng.standard_normal((4096, d)).astype(np.float32),
                     device=card).to(torch.bfloat16)
    layers = (lambda xi: moe_apply(params, cfg, xi)[0],
              lambda xi: duplex_moe_apply(params, cfg, xi, k_cold=E // 2)[0])
    for layer in layers:
        grads = []
        for _ in range(2):
            xi = x.clone().requires_grad_(True)
            grads.append(torch.autograd.grad(layer(xi), xi, g)[0])
        assert torch.equal(grads[0], grads[1])
