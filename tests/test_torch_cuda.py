"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version (``cuda`` marker; skipped without a GPU). This file imports no JAX,
so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports the JAX package.)"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
    tc = [build.launch_counts[r] for r in ("chunked_prefill_attention_sm90",
                                           "chunked_prefill_attention_f32_sm90")]
    got = decode_attn.chunked_prefill_attention_kernel(*args, qpk=2)
    assert [build.launch_counts[r] for r in ("chunked_prefill_attention_sm90",
                                             "chunked_prefill_attention_f32_sm90")] == tc
    # hd 16: the scalar route
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


def _chunk_case(rng, hd, page, qpk, Sc, long, KV=2):
    """Numpy inputs of a chunk case: starts off the page grid, a chunk
    shorter than Sc (padded rows), a sequence with total == 0, and
    block-table columns past the live pages on a null page 0 of large finite
    values. Returns (q, k_pages, v_pages, totals, starts, tables)."""
    starts = np.asarray([0, 37, 2100 if long else 130, 0], np.int32)
    totals = starts + np.asarray([Sc, Sc - 3, Sc, 0], np.int32)
    maxp = -(-int(totals.max()) // page) + 2          # columns past every live page
    k, v, bt = _pools(rng, list(totals), KV=KV, hd=hd, page=page, maxp=maxp)
    k[0] = v[0] = 1e4                                 # the null page: never live
    q = rng.standard_normal((len(starts), KV, Sc * qpk, hd)).astype(np.float32)
    return q, k, v, totals, starts, bt


@pytest.mark.cuda
@pytest.mark.parametrize("hd,page,qpk,Sc,softcap,long", SM90_CHUNK_CASES)
def test_cuda_bf16_chunked_prefill_matches_plain(card, hd, page, qpk, Sc, softcap, long):
    """The tensor-core chunk kernels against the plain version: bf16
    (``chunk_attn_sm90.cu``) within 2e-2 and the same inputs in float32
    (``chunk_f32_sm90.cu``, 3xTF32) within 1e-4, each on its own route and
    counted under ``chunked_prefill_attention`` too (the scalar kernel
    never runs); a second call gives the same bits."""
    rng = np.random.default_rng(hd + page + qpk + Sc)
    q, k, v, totals, starts, bt = _chunk_case(rng, hd, page, qpk, Sc, long)
    t = lambda a: torch.tensor(a, device=card)
    ints = (t(totals), t(starts), t(bt))
    for dtype, tol, route in ((torch.bfloat16, 2e-2, "chunked_prefill_attention_sm90"),
                              (torch.float32, 1e-4, "chunked_prefill_attention_f32_sm90")):
        assert decode_attn.chunk_route(dtype, hd, page) == route
        args = (t(q).to(dtype), t(k).to(dtype), t(v).to(dtype), *ints)
        before = {r: build.launch_counts[r] for r in decode_attn.CHUNK_ROUTES}
        got = decode_attn.chunked_prefill_attention_kernel(*args, qpk=qpk, softcap=softcap)
        assert {r: build.launch_counts[r] - n for r, n in before.items()} == {
            r: int(r in (route, "chunked_prefill_attention")) for r in before}
        want = decode_attn.chunked_prefill_attention_plain(*args, qpk=qpk, softcap=softcap)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
        assert not got[3].any()                       # total == 0
        again = decode_attn.chunked_prefill_attention_kernel(*args, qpk=qpk, softcap=softcap)
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,page,qpk,Sc,softcap,long", SM90_CHUNK_CASES)
def test_cuda_f32_chunked_prefill_matches_mirror(card, monkeypatch, hd, page, qpk, Sc, softcap,
                                                 long):
    """The float32 chunk kernel (``chunk_f32_sm90.cu``) against its 3xTF32
    mirror on the CPU (``tests/torch_chunk_mirror.py``: the same TF32
    splits, 64-key tiles, softmax and splits of the key range, float32 sums
    in another order) within 1e-5, and against the plain version within the
    smoke's float32 band of 1e-4, at the wrapper's split count (these calls
    have fewer items than SMs: several) and at one; a second call gives the
    same bits."""
    from torch_chunk_mirror import chunk_attention_tf32
    rng = np.random.default_rng(7 * hd + page + qpk + Sc)
    arrays = _chunk_case(rng, hd, page, qpk, Sc, long)
    kw = dict(qpk=qpk, softcap=softcap)
    args = [torch.tensor(a, device=card) for a in arrays]
    want = decode_attn.chunked_prefill_attention_plain(*args, **kw)
    B, KV, R, _ = arrays[0].shape
    nsplit = decode_attn.chunk_f32_splits(
        -(-R // 64) * KV * B, -(-arrays[5].shape[1] * page // 64),
        torch.cuda.get_device_properties(card).multi_processor_count)
    assert nsplit > 1
    for n in (nsplit, 1):
        monkeypatch.setattr(decode_attn, "chunk_f32_splits", lambda *a: n)
        got = decode_attn.chunked_prefill_attention_kernel(*args, **kw)
        mirror = chunk_attention_tf32(*map(torch.tensor, arrays), nsplit=n, **kw)
        torch.testing.assert_close(got.cpu(), mirror, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        assert not got[3].any()                       # total == 0
        assert torch.equal(got, decode_attn.chunked_prefill_attention_kernel(*args, **kw))


# (S, KV, qpk, causal, window, softcap): S 1000 and 2047 are not multiples
# of the 128-row tiles; qpk 12 does not divide them (mistral-large-123b's
# 96 heads over 8)
BF16_FWD_CASES = [(2048, 2, 1, True, 0, 0.0), (2048, 2, 4, False, 0, 0.0),
                  (1000, 1, 12, True, 0, 0.0), (2047, 1, 12, False, 0, 0.0),
                  (2047, 2, 4, True, 0, 0.0), (2048, 2, 1, True, 1000, 50.0),
                  (1000, 1, 12, False, 1000, 50.0)]

# gemma3-4b's attention: head_dim 256, 8 heads over 4 (qpk 2), a window of
# 1024 on its local layers; S 1000 and 2047 are not multiples of the hd-256
# plan's 64-key tiles
HD256_FWD_CASES = [(2048, 4, 2, True, 0, 0.0), (2048, 4, 2, True, 1024, 0.0),
                   (1000, 4, 2, True, 300, 50.0), (2047, 2, 2, False, 0, 0.0),
                   (2047, 1, 12, True, 1024, 0.0)]


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


# the head_dim-64 models' own shapes, one sequence each: (label, S, H, KV,
# causal, backward too)
HD64_FLASH_CASES = [("whisper-small encoder", 1500, 12, 12, False, True),
                    ("internvl2-1b prefill", 1280, 14, 2, True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("label,S,H,KV,causal,bwd", HD64_FLASH_CASES,
                         ids=[c[0] for c in HD64_FLASH_CASES])
def test_cuda_hd64_flash_at_the_models_shapes(card, dtype, tol, label, S, H, KV, causal, bwd):
    """The flash forward (and for whisper's encoder the backward) at
    head_dim 64 on whisper-small's non-causal encoder (1500 frames, 12
    heads over 12) and internvl2-1b's causal prefill (14 heads over 2, qpk
    7) against the plain versions: out and lse within the band, dq, dk, dv
    within the band times max(1, the plain gradient's largest entry)."""
    rng = np.random.default_rng(S + H)
    t = lambda a: torch.tensor(a, device=card).to(dtype)
    q = t(rng.standard_normal((1, S, H, 64)).astype(np.float32))
    k, v = (t(rng.standard_normal((1, S, KV, 64)).astype(np.float32)) for _ in range(2))
    out, lse, o32 = flash_attn.flash_attention_kernel(q, k, v, causal=causal, f32_out=True)
    out_p, lse_p, o32_p = flash_attn.flash_attention_plain(q, k, v, causal=causal, f32_out=True)
    torch.testing.assert_close(out.float(), out_p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_p, atol=tol, rtol=tol)
    if not bwd:
        return
    dout = t(rng.standard_normal(q.shape).astype(np.float32))
    got = flash_attn.flash_attention_bwd_kernel(q, k, v, o32_p, lse_p, dout, causal=causal)
    want = flash_attn.flash_attention_bwd_plain(q, k, v, o32_p, lse_p, dout, causal=causal)
    for g, w in zip(got, want):
        band = tol * max(1.0, w.float().abs().max().item())
        torch.testing.assert_close(g.float(), w.float(), atol=band, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("KV,qpk,Smax", [(12, 1, 448), (2, 7, 1536)],
                         ids=["whisper-small", "internvl2-1b"])
def test_cuda_hd64_dense_decode_at_the_models_shapes(card, dtype, tol, KV, qpk, Smax):
    """The dense decode (``decode_sm90.cu``) at head_dim 64 on whisper-small's
    decoder (12 heads over 12, max_len 448) and internvl2-1b's (14 over 2,
    qpk 7, max_len 1536), 8 rows of lengths 0 to Smax, against its plain
    version; a length-0 row exact zeros."""
    rng = np.random.default_rng(Smax + qpk)
    t = lambda a: torch.tensor(a, device=card)
    lens = t(np.asarray([0, 1, 36, 127, 128, Smax // 2, Smax - 1, Smax], np.int32))
    k, v = (t(rng.standard_normal((8, Smax, KV, 64)).astype(np.float32)).to(dtype)
            for _ in range(2))
    q = t(rng.standard_normal((8, KV, qpk, 64)).astype(np.float32)).to(dtype)
    got = decode_attn.decode_attention_kernel(q, k, v, lens)
    want = decode_attn.decode_attention_plain(q, k, v, lens)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert not got[0].any()


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
@pytest.mark.parametrize("hd,S,KV,qpk,causal,window,softcap",
                         [(hd, *c) for hd in (64, 128) for c in BF16_FWD_CASES]
                         + [(256, *c) for c in HD256_FWD_CASES])
def test_cuda_bf16_flash_backward_matches_plain(card, hd, S, KV, qpk, causal, window,
                                                softcap):
    """The tensor-core bf16 backward (``flash_bwd_sm90.cu``; at hd 256
    64-key dK/dV blocks whose two warpgroups own half of hd's columns each,
    32-key dQ tiles) against the plain version, from the plain forward's
    float32 output and lse and a seeded dout, with q, k, v read as strided
    views of one fused projection: dq, dk and dv each within 2e-2 times
    max(1, its largest |plain entry|) (dk and dv sum over rows and the
    group's heads); one launch counted; a second call gives the same bits
    (no atomics)."""
    rng = np.random.default_rng(S + qpk + hd + 1)
    q, k, v = _fused_qkv(rng, card, 1, S, KV * qpk, KV, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    _, lse, o32 = flash_attn.flash_attention_plain(q, k, v, f32_out=True, **kw)
    dout = torch.tensor(rng.standard_normal(q.shape).astype(np.float32),
                        device=card).to(torch.bfloat16)
    n = build.launch_counts["flash_attention_bwd"]
    got = flash_attn.flash_attention_bwd_kernel(q, k, v, o32, lse, dout, **kw)
    assert build.launch_counts["flash_attention_bwd"] == n + 1
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
@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 128), (torch.bfloat16, 256),
                                      (torch.float32, 128)])
def test_cuda_score_bf16_chain_through_the_kernels_matches_plain(card, dtype, hd):
    """The bf16 score chain in the flash forward (kernel 9 for bf16, the
    scalar forward of ``flash_attn.cu`` for float32) against the plain
    chain (``flash_attention_plain(score_bf16=True)``): out, lse and the
    float32 output within 2e-2, causal, windowed with a softcap, at a
    length that is not a tile multiple; and the chain must show: the mean
    |difference| of the float32 output and of lse from the plain chain is
    under a third of the chain-free kernel's. Then the flash core with ``use_kernels`` and
    ``score_bf16`` on CUDA tensors launches the forward and backward
    kernels (no ValueError, no plain fallback) and its output and
    gradients match the plain core's within the band."""
    from repro_torch.models.attention import blockwise_attention
    rng = np.random.default_rng(hd + 17)
    t = lambda a: torch.tensor(a, device=card).to(dtype)
    S, H, KV = 1000, 4, 2
    q = t(rng.standard_normal((1, S, H, hd)).astype(np.float32))
    k, v = (t(rng.standard_normal((1, S, KV, hd)).astype(np.float32)) for _ in range(2))
    for kw in (dict(causal=True), dict(causal=True, window=300, softcap=50.0)):
        n = build.launch_counts["flash_attention"]
        got = flash_attn.flash_attention_kernel(q, k, v, f32_out=True, score_bf16=True, **kw)
        assert build.launch_counts["flash_attention"] == n + 1
        want = flash_attn.flash_attention_plain(q, k, v, f32_out=True, score_bf16=True, **kw)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), atol=2e-2, rtol=2e-2)
        off = flash_attn.flash_attention_kernel(q, k, v, f32_out=True, **kw)
        for i in (1, 2):                 # lse, the float32 output
            err = (got[i] - want[i]).abs().mean().item()
            effect = (off[i] - want[i]).abs().mean().item()
            assert err < effect / 3, (i, err, effect)
    kw = dict(causal=True, q_block=256, kv_block=256, score_bf16=True)
    dout = t(rng.standard_normal(q.shape).astype(np.float32))
    res = {}
    for use_kernels in (True, False):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        build.reset_launch_counts()
        out = blockwise_attention(*leaves, use_kernels=use_kernels, **kw)
        out.backward(dout)
        launched = (build.launch_counts["flash_attention"],
                    build.launch_counts["flash_attention_bwd"])
        assert launched == ((1, 1) if use_kernels else (0, 0))
        res[use_kernels] = [out.detach()] + [x.grad for x in leaves]
    for g, w in zip(res[True], res[False]):
        band = 2e-2 * max(1.0, w.float().abs().max().item())
        torch.testing.assert_close(g.float(), w.float(), atol=band, rtol=0)


MIRROR_CASES = [(512, 2, 2, True, 0, 0.0), (512, 1, 4, False, 0, 0.0),
                (1000, 2, 2, True, 300, 50.0)]
MIRROR_BAND = 1e-5     # mean |difference| from kernel 9b's dq, dk, dv


@pytest.mark.cuda
@pytest.mark.parametrize("hd,B,S,KV,qpk,causal,window,softcap",
                         [(128, 2, *c) for c in MIRROR_CASES]
                         + [(256, 1, *c) for c in HD256_FWD_CASES[:3]])
def test_cuda_bf16_backward_rounding_mirror_is_closer_to_kernel_9b(card, hd, B, S, KV, qpk,
                                                                   causal, window, softcap):
    """The bf16 mirror of kernel 9b's rounding of P and dS
    (``tests/torch_flash_mirror.py``) against kernel 9b's dq, dk, dv on
    the card, beside the unrounded plain backward, at hd 128 and at
    gemma3-4b's hd 256: for each gradient the mean |difference| from the
    kernel is under MIRROR_BAND for the mirror and over it for the plain
    version (measured on an H100 at hd 128: the mirror 1.8e-7 to 1.2e-6,
    the plain version 9.3e-5 to 1.9e-4)."""
    from torch_flash_mirror import flash_bwd_rounded
    rng = np.random.default_rng(S + qpk + 7)
    q, k, v = _fused_qkv(rng, card, B, S, KV * qpk, KV, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    _, lse, o32 = flash_attn.flash_attention_plain(q, k, v, f32_out=True, **kw)
    dout = torch.tensor(rng.standard_normal(q.shape).astype(np.float32),
                        device=card).to(torch.bfloat16)
    got = flash_attn.flash_attention_bwd_kernel(q, k, v, o32, lse, dout, **kw)
    mirror = flash_bwd_rounded(q, k, v, o32, lse, dout, **kw)
    plain = flash_attn.flash_attention_bwd_plain(q, k, v, o32, lse, dout, **kw)
    for name, g, m, p in zip(("dq", "dk", "dv"), got, mirror, plain):
        err_m = (m.float() - g.float()).abs().mean().item()
        err_p = (p.float() - g.float()).abs().mean().item()
        assert err_m < MIRROR_BAND < err_p, (name, err_m, err_p)


@pytest.mark.cuda
@pytest.mark.parametrize("d,f,Cc", [(2048, 1024, 72), (4096, 14336, 24), (2048, 1408, 40)])
def test_cuda_moe_gemv_matches_plain(card, d, f, Cc):
    """The bf16 cold GEMVs (``moe_gemv_sm90.cu``: weights by TMA, the live
    rows on the tensor cores), ragged and capacity-padded, against their
    plain versions within 2e-2 at OLMoE's widths (Cc 72: a second pass of
    64 rows), Jamba's and deepseek-moe-16b's (d_ff 1408): counts 0, 1, 15, 16, 17 and Cc, with empty experts
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
@pytest.mark.parametrize("d,f,C", [(2048, 1024, 136), (4096, 14336, 72), (192, 320, 72),
                                   (2048, 1408, 72)])
def test_cuda_moe_gemm_matches_plain(card, d, f, C):
    """The bf16 hot GEMMs (``moe_gemm_sm90.cu``: each live expert's weights
    by TMA once a pass of up to 128 rows, ``wgmma`` with the rows as N),
    ragged and capacity-padded, against their plain versions within 2e-2 at
    OLMoE's widths (C 136: a second 128-row pass), Jamba's (C 72: one pass
    of 128), deepseek-moe-16b's (d_ff 1408) and widths that end inside a block's 128 (d_ff) and 256 (d)
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


@pytest.mark.cuda
def test_cuda_dense_chunk_step_writes_without_a_host_sync(card):
    """The dense chunk step (``attention_chunk_step``) on the card runs with
    torch's sync debug mode set to raise (its dropped writes need no mask
    and no ``nonzero``), and writes and returns what it does on the CPU
    (float32: outputs within 1e-4, positions and lengths exactly). Three
    slots, four chunk rows: slot 1 from 3, slot 0 from 12 up to the
    ``Smax - 1`` clamp, two padded rows at slot 0."""
    from repro_torch.configs import resolve_config
    from repro_torch.models.attention import attention_chunk_step
    from repro_torch.models.params import init_model, tree_map
    cfg = resolve_config("tiny-moe")
    mixer = tree_map(init_model(cfg, seed=0, device="cpu")["segments"][0]["blocks"][0]["mixer"],
                     lambda t: t[0])
    gen = torch.Generator().manual_seed(0)
    cache = {"k": torch.randn((3, 16, 2, 16), generator=gen),
             "v": torch.randn((3, 16, 2, 16), generator=gen),
             "pos": torch.arange(16, dtype=torch.int32).repeat(3, 1),
             "len": torch.tensor([12, 3, 5], dtype=torch.int32)}
    x = torch.randn((4, 8, cfg.d_model), generator=gen)
    ctx = {"slots": torch.tensor([1, 0, 0, 0], dtype=torch.int32),
           "starts": torch.tensor([3, 12, 0, 0], dtype=torch.int32),
           "chunk_lens": torch.tensor([8, 7, 0, 0], dtype=torch.int32)}
    on = lambda tree: tree_map(tree, lambda t: t.to(card))
    gpu_cache, gpu_args = on(cache), (on(mixer), cfg, x.to(card))
    y_cpu, cpu_cache = attention_chunk_step(mixer, cfg, x, tree_map(cache, torch.clone), ctx)
    gpu_ctx = on(ctx)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y_gpu, _ = attention_chunk_step(*gpu_args, gpu_cache, gpu_ctx)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.testing.assert_close(y_gpu.cpu(), y_cpu, atol=1e-4, rtol=1e-4)
    for name in ("k", "v"):
        torch.testing.assert_close(gpu_cache[name].cpu(), cpu_cache[name], atol=1e-5, rtol=1e-5)
    for name in ("pos", "len"):
        assert torch.equal(gpu_cache[name].cpu(), cpu_cache[name])
    assert int(gpu_cache["pos"][0, 15]) == 18


def _tiny_engine(card, **kw):
    from repro_torch.configs import resolve_config
    from repro_torch.models.params import init_model
    from repro_torch.serving.engine import ServingEngine
    cfg = resolve_config("tiny-moe")
    params = init_model(cfg, seed=0, device=str(card))
    kw = {"max_slots": 4, "max_len": 64, "kv_page_size": 8, "prefill_chunk_tokens": 8,
          "use_duplex": False, **kw}
    return cfg, ServingEngine(cfg, params, device=str(card), **kw)


def _tiny_requests(vocab):
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(7)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(4, 20))).tolist(),
                    max_new_tokens=5) for i in range(6)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_cuda_async_dispatch_runs_without_a_host_sync(card, layout):
    """Every ``dispatch_stage`` of ``run_async`` (chained and not, mixed
    and decode-only) under torch's sync debug mode "error": staging,
    uploads, the step, the gather of chained tokens and the outputs'
    copies enqueue without waiting for the device. The async tokens are the
    sync loop's on the card."""
    out = {}
    for loop in ("run", "run_async"):
        cfg, eng = _tiny_engine(card, kv_layout=layout)
        dispatch = eng.dispatch_stage

        def strict(plan):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return dispatch(plan)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        eng.dispatch_stage = strict
        reqs = _tiny_requests(cfg.vocab_size)
        getattr(eng, loop)(reqs)
        out[loop] = [r.output for r in reqs]
        assert all(r.completed for r in reqs)
    assert out["run_async"] == out["run"]
    assert eng.stats()["chained_stages"] > 0
    assert any(r.is_mixed for r in eng.reports) and not all(r.is_mixed for r in eng.reports)


@pytest.mark.cuda
def test_cuda_materialize_waits_for_its_stage_alone(card):
    """``_materialize(N)`` returns while a 0.1 s sleep enqueued after stage
    N still runs: it waits for N's own event, not the stream. Its outputs
    are N's tokens."""
    cfg, eng = _tiny_engine(card)
    for r in _tiny_requests(cfg.vocab_size):
        eng.submit(r)
    for _ in range(3):
        eng.step()
    plan = eng.plan_stage()
    fut = eng.dispatch_stage(plan)
    torch.cuda._sleep(int(2e8))
    mat = eng._materialize(fut)
    assert not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert np.array_equal(mat["nxt"], fut.nxt.cpu().numpy())
    eng._commit_critical(fut, mat)
    eng._commit_deferred(fut, mat.get("counts"))


@pytest.mark.cuda
def test_cuda_materialize_wait_releases_the_gil(card):
    """While ``_materialize`` waits on the card, another thread runs: the
    event's wait releases the GIL (the threaded submit/cancel path of the
    async loop depends on it)."""
    import threading
    from repro_torch.serving.engine import StageFuture
    _, eng = _tiny_engine(card)
    torch.cuda.synchronize()
    ticks, stop = [0], threading.Event()

    def count():
        while not stop.is_set():
            ticks[0] += 1
    torch.cuda._sleep(int(4e8))
    fut = StageFuture(plan=None, event=torch.cuda.Event())
    fut.event.record()
    t = threading.Thread(target=count)
    t.start()
    n0 = ticks[0]
    eng._materialize(fut)
    waited = ticks[0] - n0
    stop.set()
    t.join()
    assert waited > 10_000, waited


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["pure", "nxt_only", "full"])
def test_cuda_select_tokens_matches_the_cpu(card, mode):
    from repro_torch.serving.engine import _select_tokens
    rng = np.random.default_rng(3)
    n = 16
    args = [rng.integers(0, 1000, 8), rng.integers(0, 1000, 4),
            rng.integers(0 if mode == "pure" else -1, 8, n),
            np.where(rng.random(n) < 0.3, rng.integers(0, 4, n), -1) if mode == "full"
            else np.full(n, -1), rng.integers(0, 1000, n)]
    cpu = [torch.from_numpy(a.astype(np.int32)) for a in args]
    want = _select_tokens(*cpu, mode)
    got = _select_tokens(*(t.to(card) for t in cpu), mode)
    assert torch.equal(got.cpu(), want)


def _strict(fn):
    """``fn`` under torch's sync debug mode "error"."""
    def strict(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return strict


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_cuda_spec_decoding_runs_without_a_host_sync(card, layout):
    """Speculative decoding on the card (tiny-dense, float32, a dense FFN so
    that a stage's composition moves no token): every ``dispatch_stage``
    and every critical commit (the rewinds; on the dense layout the lengths
    written from staged indices) under torch's sync debug mode "error", in
    ``run`` and ``run_async``. The tokens are spec off's, drafts were
    accepted and rejected tails rewound, the pool drains."""
    from repro_torch.configs import resolve_config
    from repro_torch.models.params import init_model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    cfg = resolve_config("tiny-dense")
    params = init_model(cfg, seed=0, device=str(card))
    rng = np.random.default_rng(7)
    prompts = [[2 + i, 3, 4] * 4 if i % 2 == 0 else rng.integers(1, cfg.vocab_size, 12).tolist()
               for i in range(4)]
    out = {}
    for spec_k, loop in ((0, "run"), (4, "run"), (4, "run_async")):
        eng = ServingEngine(cfg, params, device=str(card), max_slots=4, max_len=64,
                            kv_layout=layout, kv_page_size=8, prefill_chunk_tokens=8,
                            spec_k=spec_k, audit_stages=True)
        for name in ("dispatch_stage", "_commit_critical"):
            setattr(eng, name, _strict(getattr(eng, name)))
        reqs = [Request(rid=i, prompt=list(p), max_new_tokens=12) for i, p in enumerate(prompts)]
        getattr(eng, loop)(reqs)
        assert all(r.completed for r in reqs) and eng.stats()["audit_violations"] == 0
        assert eng.kv.free_slots == eng.kv.max_slots and eng.kv.live_pages == 0
        out[spec_k, loop] = [r.output for r in reqs]
        if spec_k:
            st = eng.stats()
            assert 0 < st["spec_accepted"] < st["spec_proposed"] and st["spec_rewinds"] > 0
    assert out[4, "run"] == out[0, "run"] == out[4, "run_async"]


@pytest.mark.cuda
def test_cuda_fleet_kill_with_a_stage_in_flight(card):
    """Two tiny-dense replicas with ``async_steps`` on the card, every
    ``dispatch_stage`` under torch's sync debug mode "error": replica 0 is
    killed while a stage of its is in flight; its requests fail over to
    replica 1, every request ends exactly once with all its tokens, equal
    to a fault-free fleet's (a dense FFN: a stage's composition moves no
    token), and the survivor drains clean."""
    from repro_torch.configs import resolve_config
    from repro_torch.models.params import init_model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.fleet import Fleet
    cfg = resolve_config("tiny-dense")
    params = init_model(cfg, seed=0, device=str(card))

    def factory(i, inj):
        eng = ServingEngine(cfg, params, device=str(card), max_slots=4, max_len=64,
                            kv_page_size=8, prefill_chunk_tokens=8, prefix_share=True, preemption="recompute", audit_stages=True)
        eng.dispatch_stage = _strict(eng.dispatch_stage)
        return eng

    out = {}
    for kill in (False, True):
        fleet = Fleet(factory, 2, router="round-robin", async_steps=True)
        reqs = _tiny_requests(cfg.vocab_size)
        for r in reqs:
            fleet.submit(r, now=0.0)
        if kill:
            for _ in range(4):
                fleet.step(now=0.0)
            assert fleet.replicas[0].engine._inflight is not None
            fleet.kill(0, now=0.0)
            assert fleet.failovers > 0
        for _ in range(500):
            if not fleet.has_work:
                break
            fleet.step(now=0.0)
        st = fleet.stats()
        assert st["terminal"] == st["submitted"] == len(reqs) and st["duplicate_submits"] == 0
        assert all(r.completed and len(r.output) == 5 for r in reqs)
        survivor = fleet.replicas[-1].engine
        assert survivor.kv.live_pages == 0 and survivor.kv.audit(pins={}) == []
        assert st["per_replica"][1]["audit_violations"] == 0
        out[kill] = [r.output for r in reqs]
    assert out[True] == out[False]


@pytest.mark.cuda
def test_cuda_sampling_runs_without_a_host_sync(card):
    """``sample`` at a temperature with top-k and top-p on the card under
    sync debug "error": its draw is reproducible from the generator's seed,
    every token is in the vocabulary and among the top-k; and a sampled
    engine's stages dispatch without a host sync and repeat from its
    seed."""
    from repro_torch.configs import resolve_config
    from repro_torch.models.params import init_model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.sampling import SamplingParams, sample
    params_s = SamplingParams(temperature=0.8, top_k=5, top_p=0.95)
    logits = torch.randn(64, 1, 1000, device=card)
    draws = []
    for _ in range(2):
        gen = torch.Generator(device=card).manual_seed(0)
        draws.append(_strict(lambda x: sample(x, params_s, gen))(logits))
    assert torch.equal(draws[0], draws[1]) and draws[0].dtype == torch.int32
    top5 = logits[:, 0].topk(5).indices
    assert bool((top5 == draws[0][:, None].long()).any(-1).all())
    cfg = resolve_config("tiny-moe")
    params = init_model(cfg, seed=0, device=str(card))
    out = []
    for _ in range(2):
        eng = ServingEngine(cfg, params, device=str(card), max_slots=4, max_len=64,
                            kv_page_size=8, prefill_chunk_tokens=8, seed=0,
                            sampling=SamplingParams(temperature=0.8, top_k=50, top_p=0.95))
        eng.dispatch_stage = _strict(eng.dispatch_stage)
        reqs = _tiny_requests(cfg.vocab_size)
        eng.run(reqs)
        assert all(r.completed and all(0 <= t < cfg.vocab_size for t in r.output)
                   for r in reqs)
        out.append([r.output for r in reqs])
    assert out[0] == out[1]


def _blank(tree):
    """A tree like ``tree``: zero tensors (same dtype, device and
    ``requires_grad``) and zero ints, for a restore to write into."""
    if isinstance(tree, dict):
        return {k: _blank(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_blank(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree).requires_grad_(tree.requires_grad)
    return 0


@pytest.mark.cuda
def test_cuda_checkpoint_restores_bf16_on_the_card_and_the_cpu(card, tmp_path):
    """A train state with bf16 and float32 leaves saved from the card
    restores on the card and on the CPU with equal bits, and its ints as
    ints. An ``AsyncCheckpointer.save`` followed at once by an in-place
    AdamW step still writes the values from before the step."""
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.training.checkpoint import (AsyncCheckpointer, restore_checkpoint,
                                                 save_checkpoint)
    from repro_torch.training.optimizer import OptConfig, adamw_update
    from repro_torch.training.train_state import make_train_state
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    params = {"w": torch.randn((64, 32), generator=gen, device=card).to(torch.bfloat16),
              "b": (torch.randn((7,), generator=gen, device=card),)}
    opt = OptConfig(learning_rate=0.1, warmup_steps=1)
    state = make_train_state(params, opt)
    state["step"] = 5
    bits = lambda t: t.detach().view(torch.int16) if t.dtype == torch.bfloat16 else t.detach()
    save_checkpoint(str(tmp_path / "sync"), 5, state)
    for device in (None, "cpu"):
        back, step = restore_checkpoint(str(tmp_path / "sync"), _blank(state), device=device)
        assert step == 5 and back["step"] == 5 and back["opt"]["count"] == 0
        for got, want in zip(tree_leaves(back["params"]), tree_leaves(state["params"])):
            assert got.device.type == (device or "cuda") and got.dtype == want.dtype
            assert got.requires_grad and torch.equal(bits(got).cpu(), bits(want).cpu())
    before = [t.detach().clone() for t in tree_leaves(state["params"])]
    ck = AsyncCheckpointer(str(tmp_path / "async"), keep=1)
    ck.save(6, state)
    adamw_update(state["params"], tree_map(state["params"], torch.ones_like), state["opt"],
                 opt, step=1)
    ck.wait()
    back, _ = restore_checkpoint(str(tmp_path / "async"), _blank(state))
    for got, old, now in zip(tree_leaves(back["params"]), before,
                             tree_leaves(state["params"])):
        assert torch.equal(bits(got), bits(old)) and not torch.equal(bits(old), bits(now))


@pytest.mark.cuda
def test_cuda_checkpoint_restore_takes_no_second_copy(card, tmp_path):
    """A restore on the card copies into the state's own tensors: on a
    768 MiB state (bf16 and float32 leaves of 64 MiB) it raises the
    allocator's peak by less than one leaf, and the leaves hold the saved
    bits again after being zeroed."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
    gen = torch.Generator(device=card)
    gen.manual_seed(2)
    state = {"params": {f"w{i}": torch.randn((4096, 8192), generator=gen, device=card)
                        .to(torch.bfloat16).requires_grad_(True) for i in range(4)},
             "mu": [torch.randn((4096, 4096), generator=gen, device=card) for _ in range(8)],
             "step": 3}
    leaves = tree_leaves(state)[:-1]
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    saved = [t.detach().cpu() for t in leaves]
    save_checkpoint(str(tmp_path / "ck"), 3, state)
    with torch.no_grad():
        for t in leaves:
            t.zero_()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    back, step = restore_checkpoint(str(tmp_path / "ck"), state)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    assert step == 3 and back["step"] == 3 and nbytes == 768 * 2**20
    assert rise < 64 * 2**20, f"the restore raised the peak by {rise} bytes"
    for got, want, tmpl in zip(tree_leaves(back)[:-1], saved, leaves):
        assert got is tmpl and torch.equal(got.detach().cpu(), want)


def _narrow_olmoe():
    """OLMoE's structure at a width the flash kernels take: 2 layers,
    d_model 256, 2 heads of 128, 8 experts top-2, bf16."""
    import dataclasses
    from repro_torch.configs import resolve_config
    full = resolve_config("olmoe-1b-7b")
    return dataclasses.replace(full, num_layers=2, d_model=256, num_heads=2, num_kv_heads=2,
                               head_dim=128, vocab_size=512, segments=(
                                   dataclasses.replace(full.segments[0], repeats=2),),
                               moe=dataclasses.replace(full.moe, num_experts=8, top_k=2,
                                                       d_ff_expert=64)).validate()


class _MmCount(TorchDispatchMode):
    """Counts the 2-D products (aten mm, addmm) dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func.overloadpacket.__name__ in ("mm", "addmm")
        return func(*args, **(kwargs or {}))


@pytest.mark.cuda
def test_cuda_remat_dots_equals_none_with_the_kernels(card):
    """On the card with the flash kernels (seq 256 over 64-row tiles):
    ``remat="dots"`` and "full" give "none"'s loss and every gradient bit
    for bit, and launch the flash forward again in each layer's backward
    (the recompute runs it: nothing caches an extension call). The
    backward under "dots" runs "none"'s 2-D products (their outputs were
    kept), under "full" more (it recomputes them)."""
    from repro_torch.core.execution import ExecutionPlan
    from repro_torch.models import model as tmodel
    from repro_torch.models.params import init_model, tree_leaves
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_state import make_train_state
    cfg = _narrow_olmoe()
    params = make_train_state(init_model(cfg, seed=0, device=card), OptConfig())["params"]
    gen = torch.Generator(device=card)
    gen.manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen, device=card)
    plan = ExecutionPlan(use_kernels=True, attn_q_block=64, attn_kv_block=64)
    out = {}
    for remat in ("none", "dots", "full"):
        build.reset_launch_counts()
        loss, _ = tmodel.loss_fn(params, cfg, {"tokens": toks}, plan=plan, remat=remat)
        with _MmCount() as mm:
            grads = torch.autograd.grad(loss, tree_leaves(params))
        torch.cuda.synchronize()
        out[remat] = (loss.detach(), grads, build.launch_counts["flash_attention"],
                      build.launch_counts["flash_attention_bwd"], mm.n)
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1], out["none"][1]))
    assert [out[r][2:4] for r in ("none", "dots", "full")] == [(2, 2), (4, 2), (4, 2)]
    assert out["dots"][4] == out["none"][4] < out["full"][4]


@pytest.mark.cuda
def test_cuda_segments_all_equal_match_the_flash_kernels(card):
    """One segment a row (all-equal ids) through the segmented route (plain
    torch ops on the card, no kernel) against ``segment_ids=None`` through
    kernels 9 and 9b, bf16 GQA at seq 256 over 64-row blocks: the output
    and dq, dk, dv each within 2e-2 times max(1, its largest entry)."""
    from repro_torch.models.attention import blockwise_attention
    rng = np.random.default_rng(8)
    t = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32),
                                device=card).to(torch.bfloat16)
    q, k, v, dout = t(2, 256, 4, 128), t(2, 256, 2, 128), t(2, 256, 2, 128), t(2, 256, 4, 128)
    seg = torch.zeros((2, 256), dtype=torch.int32, device=card)
    kw = dict(causal=True, q_block=64, kv_block=64, use_kernels=True)
    res = {}
    for ids in (None, seg):
        build.reset_launch_counts()
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = blockwise_attention(*xs, segment_ids=ids, **kw)
        out.backward(dout)
        torch.cuda.synchronize()
        launches = (build.launch_counts["flash_attention"],
                    build.launch_counts["flash_attention_bwd"])
        res[ids is None] = ([out.detach()] + [x.grad for x in xs], launches)
    assert res[True][1] == (1, 1) and res[False][1] == (0, 0)
    for got, want in zip(res[False][0], res[True][0]):
        band = 2e-2 * max(1.0, want.float().abs().max().item())
        torch.testing.assert_close(got.float(), want.float(), atol=band, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("S,KV,qpk,causal,window,softcap", HD256_FWD_CASES)
def test_cuda_bf16_flash_forward_matches_plain_at_head_dim_256(card, S, KV, qpk, causal,
                                                               window, softcap):
    """The hd-256 plan of ``flash_fwd_sm90.cu`` (one Q slot, 64-key tiles,
    two PV products a step) against the plain version, as the hd 64 and 128
    cases: out, its float32 copy and lse within 2e-2, strided q, k, v from
    one fused projection, the same bits from a second call."""
    rng = np.random.default_rng(S + qpk + window)
    q, k, v = _fused_qkv(rng, card, 1, S, KV * qpk, KV, 256)
    kw = dict(causal=causal, window=window, softcap=softcap)
    n = build.launch_counts["flash_attention"]
    out, lse, o32 = flash_attn.flash_attention_kernel(q, k, v, f32_out=True, **kw)
    assert build.launch_counts["flash_attention"] == n + 1
    out_p, lse_p, o32_p = flash_attn.flash_attention_plain(q, k, v, f32_out=True, **kw)
    torch.testing.assert_close(out.float(), out_p.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(o32, o32_p, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_p, atol=2e-2, rtol=2e-2)
    assert torch.equal(o32.to(torch.bfloat16), out)
    again = flash_attn.flash_attention_kernel(q, k, v, f32_out=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip((out, lse, o32), again))


@pytest.mark.cuda
def test_cuda_head_dim_256_routes_refuse_what_they_do_not_compute(card):
    """At head_dim 256 the float32 forward and backward (``flash_attn.cu``)
    raise ValueError before any launch (no plain fallback)."""
    n = dict(build.launch_counts)
    x = torch.zeros((1, 64, 2, 256), device=card)
    lse = torch.zeros((1, 2, 64), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attn.flash_attention_bwd_kernel(x, x, x, x, lse, x)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attn.flash_attention_kernel(x, x, x)
    assert dict(build.launch_counts) == n


@pytest.mark.cuda
def test_cuda_dense_decode_at_head_dim_256_matches_the_split_plain(card):
    """The dense decode kernel at gemma3-4b's global layers: head_dim 256,
    4 KV heads, qpk 2, bf16, Smax 4096, lengths 0 to past Smax (either side
    of a split boundary and of path l's prompts), with and without a
    window: within 2e-2 of ``decode_attention_split_plain`` (the kernel's
    arithmetic) and of ``decode_attention_plain``; exact zeros at length 0;
    the same bits from a second call."""
    rng = np.random.default_rng(256)
    t = lambda a: torch.tensor(a, device=card)
    KV, qpk, hd, Smax = 4, 2, 256, 4096
    split = decode_attn.DENSE_TILE * decode_attn.DENSE_TILES_PER_SPLIT
    lens = t(np.asarray([0, 1, split - 1, split, split + 1, 973, 1092, 2048, Smax, Smax + 3],
                        np.int32))
    B = lens.shape[0]
    k, v = (t(rng.standard_normal((B, Smax, KV, hd)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    q = t(rng.standard_normal((B, KV, qpk, hd)).astype(np.float32)).to(torch.bfloat16)
    for kw in (dict(), dict(window=1024)):
        got = decode_attn.decode_attention_kernel(q, k, v, lens, **kw)
        split_plain = decode_attn.decode_attention_split_plain(
            q, k, v, lens, tile=decode_attn.DENSE_TILE,
            tiles_per_split=decode_attn.DENSE_TILES_PER_SPLIT, **kw)
        for want in (split_plain, decode_attn.decode_attention_plain(q, k, v, lens, **kw)):
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
        assert not got[0].any()
        assert torch.equal(got, decode_attn.decode_attention_kernel(q, k, v, lens, **kw))


@pytest.mark.cuda
def test_cuda_gemma_ring_decode_matches_forward(card):
    """gemma3-4b at full width cut to 2 layers (one local, one global),
    bf16, random weights: prompts of 1000 and 990 tokens prefilled through
    the kernels into a 1100-position cache (the local layer's ring of 1025
    slots), then 40 greedy decode steps (the ring wraps at 1024) with the
    kernels; every 8th step's logits against ``forward`` over the grown
    sequences through the plain versions: within 5% of the logit scale,
    the argmax equal wherever the top-2 gap is clear of the difference."""
    import dataclasses
    from repro_torch.configs import resolve_config
    from repro_torch.configs.base import Segment
    from repro_torch.core.execution import ExecutionPlan
    from repro_torch.models import model as tmodel
    from repro_torch.models.params import init_model
    full = resolve_config("gemma3-4b")
    cfg = dataclasses.replace(full, num_layers=2,
                              segments=(Segment(full.segments[0].pattern[-2:], 1),)).validate()
    params = init_model(cfg, seed=0, device=card)
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 1000), generator=gen, device=card)
    true_len = torch.tensor([1000, 990], dtype=torch.int32, device=card)
    cache = tmodel.init_cache(cfg, 2, 1100, device=card)
    assert cache[0]["blocks"][0]["k"].shape[2] == cfg.sliding_window + 1
    kern, plain = ExecutionPlan(use_kernels=True), ExecutionPlan(use_kernels=False)
    seqs = [toks[0].tolist(), toks[1, :990].tolist()]
    with torch.no_grad():
        lg, _ = tmodel.prefill(params, cfg, {"tokens": toks}, cache, true_len, plan=kern)
        nxt = lg.argmax(-1).to(torch.int32)
        for step in range(40):
            for b in range(2):
                seqs[b].append(int(nxt[b, 0]))
            lg, _, _ = tmodel.decode_step(params, cfg, nxt, cache, {}, plan=kern)
            if step % 8 == 7:
                for b in range(2):
                    ref, _ = tmodel.forward(params, cfg, {"tokens": torch.tensor(
                        [seqs[b]], device=card)}, plan=plain)
                    a, w = lg[b, 0].float(), ref[0, -1].float()
                    diff, scale = (a - w).abs().max().item(), w.abs().max().item()
                    assert diff <= 0.05 * scale, (step, b, diff, scale)
                    top2 = w.topk(2).values
                    if top2[0] - top2[1] > 2 * diff:
                        assert a.argmax() == w.argmax()
            nxt = lg.argmax(-1).to(torch.int32)
    assert int(cache[0]["blocks"][0]["len"][0, 0]) == 1040
