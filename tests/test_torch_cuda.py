"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version (``cuda`` marker; skipped without a GPU). This file imports no JAX,
so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports the JAX package.)"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attn, moe_gemm, moe_gemv
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
