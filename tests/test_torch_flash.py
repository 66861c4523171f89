"""PyTorch port, flash attention of the training path: the plain forward
against the JAX Pallas kernel (interpret mode) and ``ref.flash_attention_ref``,
and the port's flash core (forward, lse and its hand-written backward)
against the reference's ``_flash_core`` custom VJP, on the same numpy
inputs. On the CPU the kernel wrappers run these plain versions; the CUDA
kernels are held to them on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.models import attention as jattn
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attn import flash_attention_plain
from repro_torch.models import attention as tattn

torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers

# (S, KV, qpk, causal, window, softcap): S 40 is not a multiple of the
# 16-row blocks; window 12 is narrower than a block, so a row's first block
# can be wholly masked
CASES = [(40, 2, 1, True, 0, 0.0), (40, 1, 4, False, 0, 0.0), (64, 2, 2, True, 12, 0.0),
         (40, 2, 2, True, 0, 10.0), (48, 1, 4, False, 20, 5.0)]
BLK = 16
HD = 16


def _inputs(S, KV, qpk, seed=0, B=2):
    rng = np.random.default_rng(seed)
    H = KV * qpk
    q = rng.standard_normal((B, S, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, HD)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, HD)).astype(np.float32)
    return q, k, v


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,KV,qpk,causal,window,softcap", CASES)
def test_flash_plain_matches_pallas_and_ref(S, KV, qpk, causal, window, softcap, dtype):
    """The plain forward against the Pallas kernel run in interpret mode
    (through the reference's model-layout wrapper, as its own kernel tests
    run it) and the unblocked ``flash_attention_ref``."""
    q, k, v = _inputs(S, KV, qpk)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in (q, k, v))
    pallas = jops.flash_attention(jq, jk, jv, q_block=BLK, kv_block=BLK, interpret=True, **kw)
    B, H = q.shape[0], q.shape[2]
    qg = jq.reshape(B, S, KV, qpk, HD).transpose(0, 2, 3, 1, 4)
    want = ref.flash_attention_ref(qg, jk.transpose(0, 2, 1, 3), jv.transpose(0, 2, 1, 3), **kw)
    want = want.transpose(0, 3, 1, 2, 4).reshape(B, S, H, HD)
    td = getattr(torch, dtype)
    got, lse = flash_attention_plain(*(torch.tensor(a).to(td) for a in (q, k, v)),
                                     q_block=BLK, kv_block=BLK, **kw)
    assert got.dtype == td and lse.dtype == torch.float32 and lse.shape == (B, H, S)
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32), **_tol(dtype))
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **_tol(dtype))


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(map(str, c)))
def reference_vjp(request):
    """Inputs, a seeded dO, and the reference's ``_flash_core`` output,
    (dq, dk, dv) by ``jax.vjp`` and lse, at 16-row blocks, once per case."""
    S, KV, qpk, causal, window, softcap = request.param
    q, k, v = _inputs(S, KV, qpk, seed=1)
    dout = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    args = (causal, window, softcap, BLK, BLK, False)
    out_j, vjp = jax.vjp(lambda a, b, c: jattn._flash_core(a, b, c, *args),
                         *map(jnp.asarray, (q, k, v)))
    _, res = jattn._flash_core_fwd(*map(jnp.asarray, (q, k, v)), *args)
    B, H = q.shape[0], q.shape[2]
    lse_j = np.asarray(res[4]).reshape(B, H, -1)[:, :, :S]
    kw = dict(causal=causal, window=window, softcap=softcap, q_block=BLK, kv_block=BLK)
    return (q, k, v, dout), kw, (out_j, vjp(jnp.asarray(dout)), lse_j)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_flash_core_and_vjp_match_reference(reference_vjp, use_kernels):
    """Forward, lse and (dq, dk, dv) for a seeded dO against ``jax.vjp`` of
    the reference's ``_flash_core`` at the same block sizes (float32).
    ``use_kernels`` routes through ``kernels/ops.py``, which runs the plain
    versions for CPU tensors."""
    (q, k, v, dout), kw, (out_j, grads_j, lse_j) = reference_vjp
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out_t = tattn.blockwise_attention(tq, tk, tv, use_kernels=use_kernels, **kw)
    out_t.backward(torch.tensor(dout))
    tol = dict(atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **tol)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    _, lse_t = tops.flash_attention(tq.detach(), tk.detach(), tv.detach(), **kw)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, **tol)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(map(str, c)))
def reference_vjp_bf16(request):
    """As ``reference_vjp`` in bfloat16: the same numpy inputs and dO cast
    to bf16 on both sides; the reference keeps its float32 output ``out_b``
    as the residual and takes D from it."""
    S, KV, qpk, causal, window, softcap = request.param
    q, k, v = _inputs(S, KV, qpk, seed=4)
    dout = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    args = (causal, window, softcap, BLK, BLK, False)
    out_j, vjp = jax.vjp(lambda a, b, c: jattn._flash_core(a, b, c, *args),
                         *map(bf, (q, k, v)))
    grads_j = vjp(bf(dout))
    kw = dict(causal=causal, window=window, softcap=softcap, q_block=BLK, kv_block=BLK)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    return (q, k, v, dout), kw, (f32(out_j), [f32(g) for g in grads_j])


@pytest.mark.parametrize("use_kernels", [False, True])
def test_flash_core_and_vjp_match_reference_bf16(reference_vjp_bf16, use_kernels):
    """bf16 forward and (dq, dk, dv) against ``jax.vjp`` of the reference's
    ``_flash_core`` at the bf16 band (2e-2): the port saves the float32
    output for its backward and takes D = rowsum(dO * O) from it, as the
    reference does from ``out_b``."""
    (q, k, v, dout), kw, (out_j, grads_j) = reference_vjp_bf16
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16).requires_grad_(True) for a in (q, k, v))
    out_t = tattn.blockwise_attention(tq, tk, tv, use_kernels=use_kernels, **kw)
    out_t.backward(torch.tensor(dout).to(torch.bfloat16))
    assert out_t.dtype == torch.bfloat16 and tq.grad.dtype == torch.bfloat16
    tol = _tol("bfloat16")
    np.testing.assert_allclose(out_t.detach().float().numpy(), out_j, **tol)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads_j):
        np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_flash_backward_refuses_an_output_not_in_float32(use_kernels):
    """The backward takes D = rowsum(dO * O) from the forward's float32
    output, as the reference takes it from ``out_b``: a bf16 output is
    refused, here as on the card, and the flash core saves the float32
    one."""
    q, k, v = (torch.tensor(a).to(torch.bfloat16) for a in _inputs(40, 2, 2, seed=6))
    kw = dict(causal=True, q_block=BLK, kv_block=BLK)
    out, lse, out32 = flash_attention_plain(q, k, v, f32_out=True, **kw)
    assert out32.dtype == torch.float32 and torch.equal(out32.to(torch.bfloat16), out)
    bwd = tops.flash_attention_bwd if use_kernels else tattn.flash_attention_bwd_plain
    with pytest.raises(TypeError, match="float32 output"):
        bwd(q, k, v, out, lse, torch.ones_like(q), **kw)
    tq = q.clone().requires_grad_(True)
    got = tattn.blockwise_attention(tq, k, v, use_kernels=use_kernels, **kw)
    saved = got.grad_fn.saved_tensors
    assert saved[3].dtype == torch.float32 and torch.equal(saved[3], out32)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_flash_forward_without_grad_writes_no_float32_output(use_kernels, monkeypatch):
    """Where no backward can run (grad mode off, or no input that requires
    grad) the forward runs alone, without the float32 output, and gives
    the flash core's values."""
    q, k, v = (torch.tensor(a).to(torch.bfloat16) for a in _inputs(40, 1, 4, seed=7))
    kw = dict(causal=False, window=12, softcap=5.0, q_block=BLK, kv_block=BLK)
    want = tattn.blockwise_attention(q.clone().requires_grad_(True), k, v,
                                     use_kernels=use_kernels, **kw).detach()
    import repro_torch.kernels.flash_attn as fa
    asked = []
    real = fa.flash_attention_plain

    def spy(*a, f32_out=False, **kw_):
        asked.append(f32_out)
        return real(*a, f32_out=f32_out, **kw_)

    monkeypatch.setattr(fa, "flash_attention_plain", spy)
    monkeypatch.setattr(tattn, "flash_attention_plain", spy)
    plain = tattn.blockwise_attention(q, k, v, use_kernels=use_kernels, **kw)
    with torch.no_grad():
        quiet = tattn.blockwise_attention(q.clone().requires_grad_(True), k, v,
                                          use_kernels=use_kernels, **kw)
    assert asked == [False, False]
    assert plain.grad_fn is None and quiet.grad_fn is None
    assert torch.equal(plain, want) and torch.equal(quiet, want)
