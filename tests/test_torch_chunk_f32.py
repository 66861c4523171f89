"""PyTorch port, the float32 chunk attention's tensor-core route
(``chunk_f32_sm90.cu``, 3xTF32 on mma.sync): its arithmetic, mirrored in
plain torch (``tests/torch_chunk_mirror.py``), against the JAX package's
Pallas ``chunked_prefill_attention_kernel`` in interpret mode at the
reference's float32 band (atol = rtol = 2e-5), and the route function that
sends a call to it. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn import chunked_prefill_attention_kernel as pallas_chunk
from repro_torch.kernels import decode_attn
from torch_chunk_mirror import chunk_attention_tf32, tf32_split

torch.set_num_threads(1)   # small shapes; leave the cores to the other test workers

TOL = dict(atol=2e-5, rtol=2e-5)

# (hd, page, qpk, softcap): each head size, page and qpk of the kernel's
# shapes, with and without a softcap
CASES = [(128, 16, 1, 0.0), (128, 8, 4, 30.0), (64, 8, 1, 30.0), (64, 16, 4, 0.0)]


def case_inputs(hd, page, qpk):
    """Four sequences of a 20-position chunk: a start of 0, one off the page
    grid with a short chunk (padded rows), one whose prefix spans three
    64-key tiles, and one with total == 0; R = 20 qpk, so qpk 4 takes two
    64-row tiles. Block-table columns past the live pages hold the null
    page 0. Returns numpy (q, k_pages, v_pages, totals, starts, tables)."""
    rng = np.random.default_rng(hd + page + qpk)
    Sc, KV = 20, 2
    starts = np.asarray([0, 37, 130, 0], np.int32)
    totals = starts + np.asarray([Sc, Sc - 3, Sc, 0], np.int32)
    maxp = -(-int(totals.max()) // page) + 1
    P = 1 + len(starts) * maxp
    k = rng.standard_normal((P, KV, page, hd)).astype(np.float32)
    v = rng.standard_normal((P, KV, page, hd)).astype(np.float32)
    ids = list(rng.permutation(np.arange(1, P)))
    bt = np.zeros((len(starts), maxp), np.int32)
    for b, n in enumerate(totals):
        need = -(-int(n) // page)
        bt[b, :need] = ids[:need]
        ids = ids[need:]
    q = rng.standard_normal((len(starts), KV, Sc * qpk, hd)).astype(np.float32)
    return q, k, v, totals, starts, bt


@pytest.mark.parametrize("nsplit", [1, 2])
@pytest.mark.parametrize("hd,page,qpk,softcap", CASES)
def test_tf32_mirror_matches_pallas(hd, page, qpk, softcap, nsplit):
    """Three TF32 products a float32 product, over 64-key tiles of the live
    pages with the online softmax between them, within the reference's
    float32 band of the Pallas kernel (page-sized steps, float32 dots), in
    one split and in two (the three-tile prefix in runs of two tiles and
    one, merged); total == 0 gives exact zeros."""
    arrays = case_inputs(hd, page, qpk)
    got = chunk_attention_tf32(*map(torch.tensor, arrays), qpk=qpk, softcap=softcap,
                               nsplit=nsplit).numpy()
    want = np.asarray(pallas_chunk(*map(jnp.asarray, arrays), qpk=qpk, softcap=softcap,
                                   interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[3].any()              # totals == 0


def test_tf32_split_rounds_to_nearest_ties_away():
    """``tf32_split`` rounds as ``cvt.rna.tf32.f32``: 10 mantissa bits kept,
    to nearest, ties away from zero, and hi + lo keeps x to 2^-22."""
    one = 1.0 + 2.0 ** -10                   # a TF32 value
    half = 2.0 ** -11                        # half its unit
    x = torch.tensor([one, one + half, -(one + half), 1.0 + half, 1.0 + half * 0.99,
                      3.14159265], dtype=torch.float32)
    hi, lo = tf32_split(x)
    want = torch.tensor([one, one + 2 * half, -(one + 2 * half), 1.0 + 2 * half, 1.0,
                         3.140625], dtype=torch.float32)
    assert torch.equal(hi, want)
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    r = torch.tensor(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = tf32_split(r)
    assert ((hi + lo - r).abs() <= r.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("items,max_tiles,sms,want", [
    (16, 16, 132, 8), (64, 16, 132, 2), (256, 16, 132, 1), (14, 16, 132, 9),
    (4, 2, 132, 2), (0, 16, 132, 16), (133, 16, 132, 1)])
def test_chunk_f32_splits(items, max_tiles, sms, want):
    """A call of fewer 64-row items than SMs spreads each item over up to
    SMs / items blocks, never more than the table's tiles nor fewer than
    one (path a's chunk: 16 items; the kernel phase's first case: 64)."""
    assert decode_attn.chunk_f32_splits(items, max_tiles, sms) == want


@pytest.mark.parametrize("hd,page", sorted(decode_attn.SM90_SHAPES)
                         + [(16, 8), (16, 16), (256, 16), (256, 64), (128, 12)])
def test_chunk_route_by_dtype_and_shape(hd, page):
    """Float32 at the tensor-core shapes runs the 3xTF32 kernel, bf16 there
    the wgmma kernel; any other head size or page (tiny-moe's hd 16, hd 256)
    the scalar kernel, whatever the dtype."""
    sm90 = (hd, page) in decode_attn.SM90_SHAPES
    f32 = decode_attn.chunk_route(torch.float32, hd, page)
    bf16 = decode_attn.chunk_route(torch.bfloat16, hd, page)
    assert f32 == ("chunked_prefill_attention_f32_sm90" if sm90
                   else "chunked_prefill_attention")
    assert bf16 == ("chunked_prefill_attention_sm90" if sm90
                    else "chunked_prefill_attention")
    assert decode_attn.CHUNK_ROUTES[f32] == ("chunk_f32_sm90.cu" if sm90 else "decode_attn.cu")
