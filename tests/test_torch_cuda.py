"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version (``cuda`` marker; skipped without a GPU). This file imports no JAX,
so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports the JAX package.)"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attn, moe_gemm, moe_gemv, ssd_decode
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
    got = decode_attn.chunked_prefill_attention_kernel(*args, qpk=2)
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
def test_cuda_dense_decode_and_ssd_kernels_match_plain(card, dtype, tol):
    """The dense-cache decode attention kernel (qpk 1 and 4, a window and a
    softcap, lengths 0 to past Smax, a layer view of a stacked cache) and the
    SSD decode kernel (headdim 16 and 64; its state updated in place)
    against their plain versions on the card."""
    rng = np.random.default_rng(2)
    t = lambda a: torch.tensor(a, device=card)
    B, KV, hd, Smax = 6, 2, 32, 80
    lens = t(np.asarray([0, 1, 17, 64, 80, 95], np.int32))
    stacked = t(rng.standard_normal((2, 2, B, Smax, KV, hd)).astype(np.float32)).to(dtype)
    k, v = stacked[0, 1], stacked[1, 1]          # layer views, as the model passes them
    for qpk, kw in ((1, dict()), (4, dict()), (4, dict(window=20, softcap=5.0))):
        q = t(rng.standard_normal((B, KV, qpk, hd)).astype(np.float32)).to(dtype)
        got = decode_attn.decode_attention_kernel(q, k, v, lens, **kw)
        want = decode_attn.decode_attention_plain(q, k, v, lens, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
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
