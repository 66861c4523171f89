"""PyTorch port, int8 KV page pools: the int8 recipe bit for bit, the int8
kernels' per-page plain versions against the Pallas int8 bodies (interpret
mode), the model-level int8 paths against the reference's, ``mixed_step``
with int8 pools, the byte accounting, and the engine's greedy tokens with
``kv_quant=True``.

Tolerances: every int8 value is produced by the one recipe on the same
float inputs, so products and sums are exact integers; what is left is
float32 arithmetic in another order (2e-5, the float kernels' band), except
where a requantized p * v_scale lands within an ulp of a rounding tie and
``exp`` in two libraries (XLA's and PyTorch's) rounds it to neighbouring
int8 steps. Where that can happen the test says so and states the bound of
one step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig, small_test_config
from repro.core.execution import ExecutionPlan as JPlan
from repro.core.execution import execution_plan
from repro.kernels import int8_quantize as j_int8_quantize
from repro.kernels.decode_attn import (chunked_prefill_attention_kernel as
                                       pallas_chunk,
                                       paged_decode_attention_kernel as
                                       pallas_decode)
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.serving import kvmanager as jkv
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.request import Request as RefRequest
from repro_torch.configs import resolve_config
from repro_torch.core.execution import ExecutionPlan
from repro_torch.kernels import build, decode_attn
from repro_torch.kernels.quant import int8_quantize
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.params import from_numpy_tree
from repro_torch.serving import kvmanager as tkv
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request

torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products on a card
torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers

TOL = dict(atol=2e-5, rtol=2e-5)
KV, HD, PAGE, MAXP = 2, 16, 8, 5


# ---------------------------------------------------------------------------
# the recipe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_quantize_is_bit_equal(dtype, keepdims):
    """Rows with amax 127 (scale exactly 1) hold exact .5 ties, which both
    round half to even; an all-zero row takes the 1e-8 scale floor."""
    rng = np.random.default_rng(0)
    ties = np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5], np.float32)
    x = np.stack([ties, -ties, np.zeros(8, np.float32),
                  *rng.standard_normal((5, 8)).astype(np.float32) * 3.0,
                  np.full(8, 1e-12, np.float32)])
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    want_q, want_s = j_int8_quantize(jx, keepdims=keepdims)
    got_q, got_s = int8_quantize(tx, keepdims=keepdims)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  np.asarray(want_s).view(np.int32))
    assert got_q[0, 1:4].tolist() == [0, 2, 2]          # half to even
    assert got_s.reshape(-1)[2].item() == np.float32(1e-8)


# ---------------------------------------------------------------------------
# the int8 kernels' plain versions against the Pallas int8 bodies
# ---------------------------------------------------------------------------

def _int8_pools(rng, lens):
    """int8 pools quantized from random K/V by the reference's recipe, with
    block tables giving each sequence its own shuffled pages."""
    B = len(lens)
    P = 1 + B * MAXP
    k8, ks = j_int8_quantize(jnp.asarray(rng.standard_normal((P, KV, PAGE, HD)),
                                         jnp.float32))
    v8, vs = j_int8_quantize(jnp.asarray(rng.standard_normal((P, KV, PAGE, HD)),
                                         jnp.float32))
    ids = list(rng.permutation(np.arange(1, P)))
    bt = np.zeros((B, MAXP), np.int32)
    for b, n in enumerate(lens):
        need = -(-n // PAGE)
        bt[b, :need] = ids[:need]
        ids = ids[need:]
    return [np.asarray(a) for a in (k8, ks, v8, vs)], bt


@pytest.mark.parametrize("qpk", [1, 2])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (7, 0.0), (0, 5.0), (12, 3.0)])
def test_paged_decode_int8_plain_matches_pallas(qpk, window, softcap):
    rng = np.random.default_rng(30 + qpk)
    lens = [0, 1, 8, 9, 23, 40]          # empty, page boundaries, full table
    pools, bt = _int8_pools(rng, lens)
    q = rng.standard_normal((len(lens), KV, qpk, HD)).astype(np.float32)
    lengths = np.asarray(lens, np.int32)
    k8, ks, v8, vs = (torch.tensor(a) for a in pools)
    got = decode_attn.paged_decode_attention_int8_kernel(
        torch.tensor(q), k8, ks, v8, vs, torch.tensor(lengths), torch.tensor(bt),
        window=window, softcap=softcap).numpy()
    jk8, jks, jv8, jvs = (jnp.asarray(a) for a in pools)
    want = np.asarray(pallas_decode(jnp.asarray(q), jk8, jv8, jnp.asarray(lengths),
                                    jnp.asarray(bt), k_scale_pages=jks,
                                    v_scale_pages=jvs, window=window,
                                    softcap=softcap, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[0].any()              # length 0: exact zeros


def _pv8_flips(q, k8, ks, v8, vs, lens, bt, pps, window, softcap):
    """Recomputes each live page's pv8 under the sequence's running max (the
    page walk's) and under its split's own (runs of ``pps`` live pages), in
    float32 as both plain versions do, and returns what the pv8s that
    differ move in the page walk's output, (B, KV, qpk, hd): the sum over
    pages of |pv8 * pv_scale - pv8' * pv_scale' * e^(m' - m)| @ |v8| over
    the differing keys, times e^(m_page - m_final) / l_final. Asserts that
    each difference is one of two kinds: a value within rounding of a .5
    step landing one int8 step away, or a page whose requantization scale
    in the page walk sits at the recipe's 1e-8 floor (p * v_scale below
    1.27e-6 under the sequence's max), where the split's larger p is
    requantized on a finer grid: requantization is scale-invariant only
    above the floor."""
    B, KV, qpk, hd = q.shape
    page = k8.shape[2]
    scale = 1.0 / np.sqrt(hd)
    q8, q_sc = int8_quantize(q, keepdims=True)
    ninf = decode_attn.NEG_INF
    m_g = m_s = torch.full((B, KV, qpk, 1), ninf)
    l_g = torch.zeros_like(m_g)
    moved = []                                    # (m after the page, what it moved)
    ln = lens.long()[:, None]
    first = (ln - window).clamp_min(0) if window else torch.zeros_like(ln)
    for j in range(bt.shape[1]):
        pid = bt[:, j].long()
        kpos = j * page + torch.arange(page)[None]
        ok = kpos < ln
        if window:
            ok &= kpos > ln - 1 - window
        live = ((j * page < ln) & (j * page + page > first))[:, :, None, None]
        restart = ((j - first // page) % pps == 0)[:, :, None, None]
        ok = ok[:, None, None, :]
        sc = torch.matmul(q8.float(), k8[pid].float().transpose(-1, -2)) * q_sc \
            * ks[pid][:, :, None, :] * scale
        if softcap:
            sc = softcap * torch.tanh(sc / torch.full_like(sc, softcap))
        sc = torch.where(ok, sc, torch.full_like(sc, ninf))
        mx = sc.amax(dim=-1, keepdim=True)
        m_s = torch.where(restart, torch.full_like(m_s, ninf), m_s)
        new_g, new_s = torch.maximum(m_g, mx), torch.maximum(m_s, mx)
        a8, a_sc = int8_quantize(torch.exp(sc - new_g) * ok * vs[pid][:, :, None, :],
                                 keepdims=True)
        b8, b_sc = int8_quantize(torch.exp(sc - new_s) * ok * vs[pid][:, :, None, :],
                                 keepdims=True)
        differ = (a8 != b8) & live
        one_step = (a8.int() - b8.int()).abs() <= 1
        assert (one_step | (a_sc == np.float32(1e-8)))[differ].all(), \
            "a pv8 differs by more than one int8 step on a page above the scale floor"
        gap = (a8.float() * a_sc - b8.float() * b_sc * torch.exp(new_s - new_g)).abs()
        moved.append((new_g, torch.matmul(gap * differ, v8[pid].float().abs())))
        l_g = torch.where(live, l_g * torch.exp(m_g - new_g)
                          + (torch.exp(sc - new_g) * ok).sum(-1, keepdim=True), l_g)
        m_g = torch.where(live, new_g, m_g)
        m_s = torch.where(live, new_s, m_s)
    bound = sum(torch.exp(m - m_g) * mv for m, mv in moved)
    return bound / l_g.clamp_min(1e-37)


@pytest.mark.parametrize("q_scale", [1.0, 12.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (7, 5.0)])
@pytest.mark.parametrize("qpk", [1, 2])
@pytest.mark.parametrize("pages_per_split", [1, 2, 3])
def test_paged_decode_int8_split_plain_matches_pallas(pages_per_split, qpk, window,
                                                      softcap, dtype, q_scale):
    """The int8 split kernel's arithmetic (``paged_decode_attention_int8_
    split_plain``: each split of ``pages_per_split`` live pages walked from
    its own running max, the per-page requantization kept, the splits
    merged in order) against the Pallas int8 body in interpret mode, within
    2e-5: lengths 0, 1, a page edge and past it, split edges (16 and 24) and
    past them, and the full table; q x 12 spreads the scores over tens, so
    pages past a split's first move its running max. Where a split's own max
    moves a requantized p * v_scale by one int8 step (``_pv8_flips`` shows
    each is one step), the elements it touches are held to that step's
    bound instead; every other element to 2e-5."""
    rng = np.random.default_rng(70 + 10 * pages_per_split + qpk)
    lens = [0, 1, 8, 9, 16, 17, 24, 25, 40]
    pools, bt = _int8_pools(rng, lens)
    jq = jnp.asarray(rng.standard_normal((len(lens), KV, qpk, HD)) * q_scale,
                     getattr(jnp, dtype))
    q = torch.tensor(np.asarray(jq.astype(jnp.float32))).to(getattr(torch, dtype))
    lengths = np.asarray(lens, np.int32)
    k8, ks, v8, vs = (torch.tensor(a) for a in pools)
    kw = dict(window=window, softcap=softcap)
    split = lambda x: decode_attn.paged_decode_attention_int8_split_plain(
        x, k8, ks, v8, vs, torch.tensor(lengths), torch.tensor(bt),
        pages_per_split=pages_per_split, **kw)
    got = split(q)
    assert got.dtype == q.dtype
    jk8, jks, jv8, jvs = (jnp.asarray(a) for a in pools)
    want = np.asarray(pallas_decode(jq, jk8, jv8, jnp.asarray(lengths), jnp.asarray(bt),
                                    k_scale_pages=jks, v_scale_pages=jvs, interpret=True,
                                    **kw).astype(jnp.float32))
    band = 2e-5 + 2e-5 * np.abs(want)
    if dtype == "bfloat16":
        # both sides quantize the same bf16 values of q and cast a float32
        # result to bf16 at the end: compare that float32 result, allowing
        # the bf16 output its own rounding, half a step
        exact = split(q.float())
        assert torch.equal(got, exact.to(torch.bfloat16))
        got = exact
        band += np.abs(want) * 2.0 ** -8
    got = got.float().numpy()
    bound = _pv8_flips(q, k8, ks, v8, vs, torch.tensor(lengths), torch.tensor(bt),
                       pages_per_split, window, softcap).numpy()
    err = np.abs(got - want)
    assert (err <= band + bound).all(), (err - band - bound).max()
    assert (err[bound == 0] <= band[bound == 0]).all()
    assert not got[0].any()              # length 0: exact zeros


@pytest.mark.parametrize("qpk", [1, 2])
@pytest.mark.parametrize("softcap", [0.0, 4.0])
def test_chunked_prefill_int8_plain_matches_pallas(qpk, softcap):
    rng = np.random.default_rng(40 + qpk)
    Sc = 6
    starts = np.asarray([0, 8, 13, 0], np.int32)
    clens = np.asarray([6, 6, 3, 0], np.int32)        # padded rows, totals == 0
    totals = starts + clens
    pools, bt = _int8_pools(rng, list(totals))
    q = rng.standard_normal((4, KV, Sc * qpk, HD)).astype(np.float32)
    k8, ks, v8, vs = (torch.tensor(a) for a in pools)
    got = decode_attn.chunked_prefill_attention_int8_kernel(
        torch.tensor(q), k8, ks, v8, vs, torch.tensor(totals), torch.tensor(starts),
        torch.tensor(bt), qpk=qpk, softcap=softcap).numpy()
    jk8, jks, jv8, jvs = (jnp.asarray(a) for a in pools)
    want = np.asarray(pallas_chunk(jnp.asarray(q), jk8, jv8, jnp.asarray(totals),
                                   jnp.asarray(starts), jnp.asarray(bt),
                                   k_scale_pages=jks, v_scale_pages=jvs, qpk=qpk,
                                   softcap=softcap, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[3].any()              # totals == 0: exact zeros


def test_per_page_requantization_is_not_the_global_one():
    """The kernels requantize p * v_scale per page, the model-level path once
    over the whole row: on a multi-page context they differ by more than
    float rounding, which is why each is held to its own reference."""
    rng = np.random.default_rng(5)
    lens = [40, 33]
    pools, bt = _int8_pools(rng, lens)
    q = rng.standard_normal((2, KV, 1, HD)).astype(np.float32)
    k8, ks, v8, vs = (torch.tensor(a) for a in pools)
    lengths, btt = torch.tensor(np.asarray(lens, np.int32)), torch.tensor(bt)
    per_page = decode_attn.paged_decode_attention_int8_plain(
        torch.tensor(q), k8, ks, v8, vs, lengths, btt)
    whole_row = tattn.decode_attention_int8(
        torch.tensor(q).reshape(2, 1, KV, HD), tattn.paged_gather_kv(k8, btt),
        tattn.paged_gather_scale(ks, btt), tattn.paged_gather_kv(v8, btt),
        tattn.paged_gather_scale(vs, btt), lengths).reshape(2, KV, 1, HD)
    diff = (per_page - whole_row).abs().max().item()
    assert 1e-4 < diff
    rel = diff / whole_row.abs().max().item()
    assert rel < 0.03                    # the reference's int8 noise band


# ---------------------------------------------------------------------------
# model-level int8 paths against the reference's
# ---------------------------------------------------------------------------

def _dense_int8(rng, B, S):
    k8, ks = j_int8_quantize(jnp.asarray(rng.standard_normal((B, S, KV, HD)), jnp.float32))
    v8, vs = j_int8_quantize(jnp.asarray(rng.standard_normal((B, S, KV, HD)), jnp.float32))
    return [np.asarray(a) for a in (k8, ks, v8, vs)]


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (9, 4.0)])
def test_decode_attention_int8_matches_reference(window, softcap):
    rng = np.random.default_rng(50 + window)
    B, S, H = 3, 24, 4
    arrs = _dense_int8(rng, B, S)
    q = rng.standard_normal((B, 1, H, HD)).astype(np.float32)
    lens = np.asarray([24, 1, 13], np.int32)
    got = tattn.decode_attention_int8(torch.tensor(q), *map(torch.tensor, arrs),
                                      torch.tensor(lens), window=window,
                                      softcap=softcap).numpy()
    want = np.asarray(jattn.decode_attention_int8(jnp.asarray(q), *map(jnp.asarray, arrs),
                                                  jnp.asarray(lens), window=window,
                                                  softcap=softcap))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("softcap", [0.0, 4.0])
def test_chunk_attention_int8_matches_reference(softcap):
    rng = np.random.default_rng(60)
    B, Sc, S, H = 2, 5, 16, 4
    arrs = _dense_int8(rng, B, S)
    q = rng.standard_normal((B, Sc, H, HD)).astype(np.float32)
    starts = np.asarray([6, 0], np.int32)
    clens = np.asarray([5, 3], np.int32)               # one padded chunk tail
    qpos = starts[:, None] + np.arange(Sc)[None]
    kpos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    total = starts + clens
    got = tattn.chunk_attention_int8(
        torch.tensor(q), *map(torch.tensor, arrs), torch.tensor(qpos),
        torch.tensor(kpos), torch.tensor(total), softcap=softcap).numpy()
    want = np.asarray(jattn.chunk_attention_int8(
        jnp.asarray(q), *map(jnp.asarray, arrs), jnp.asarray(qpos), jnp.asarray(kpos),
        jnp.asarray(total), softcap=softcap))
    np.testing.assert_allclose(got, want, **TOL)


def test_paged_gather_scale_matches_reference():
    rng = np.random.default_rng(2)
    pool = rng.standard_normal((7, KV, PAGE)).astype(np.float32)
    bt = np.asarray([[3, 1, 0], [6, 0, 0]], np.int32)
    np.testing.assert_array_equal(
        tattn.paged_gather_scale(torch.tensor(pool), torch.tensor(bt)).numpy(),
        np.asarray(jattn.paged_gather_scale(jnp.asarray(pool), jnp.asarray(bt))))


@pytest.mark.parametrize("kv_quant", [False, True])
def test_kv_byte_accounting_matches_reference(kv_quant):
    """kv_token_bytes is 2*KV*hd*itemsize in bf16 and 2*KV*(hd + 4) in int8;
    pages_for_budget follows it (OLMoE: 256/132 = 1.94x the pages)."""
    from repro.configs.registry import get_config
    cfg_j, cfg_t = get_config("olmoe-1b-7b"), resolve_config("olmoe-1b-7b")
    assert tkv.kv_token_bytes(cfg_t, kv_quant=kv_quant) == \
        jkv.kv_token_bytes(cfg_j, kv_quant=kv_quant)
    for budget in (1 << 30, 80 << 30):
        assert tkv.pages_for_budget(cfg_t, 16, budget, kv_quant=kv_quant) == \
            jkv.pages_for_budget(cfg_j, 16, budget, kv_quant=kv_quant)
    assert tkv.kv_token_bytes(cfg_t, kv_quant=kv_quant) == (
        2 * 16 * (128 + 4) if kv_quant else 2 * 16 * 128 * 2)


# (head_dim, page): the scalar int8 chunk and the decode's split route; the
# scalar decode (a page not a multiple of 4 keys); path b's shape, where the
# decode takes the split route and the chunk the tensor-core one
@pytest.mark.parametrize("hd,page", [(16, 8), (16, 6), (128, 16)])
def test_int8_wrappers_do_not_fall_back_off_cpu(hd, page):
    """Off the CPU a wrapper launches a kernel or raises, on every route."""
    q = torch.zeros((1, 1, 1, hd), device="meta")
    k = torch.zeros((2, 1, page, hd), dtype=torch.int8, device="meta")
    s = torch.zeros((2, 1, page), device="meta")
    one = torch.zeros((1,), dtype=torch.int32, device="meta")
    bt = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    before = dict(build.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attn.paged_decode_attention_int8_kernel(q, k, s, k, s, one, bt)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attn.chunked_prefill_attention_int8_kernel(q, k, s, k, s, one, one, bt,
                                                          qpk=1)
    assert build.launch_counts == before


# ---------------------------------------------------------------------------
# mixed_step with int8 pools
# ---------------------------------------------------------------------------

P = 16


def _stages(rng, V):
    """Two mixed stages (chunks with padded rows, decode rows) and one
    decode-only stage on pages of 8, as numpy inputs."""
    bt = lambda rows: np.asarray(rows, np.int32)
    tok = lambda *s: rng.integers(0, V, s).astype(np.int32)
    return [
        ("mixed",
         dict(tokens=tok(1, 1), lengths=np.asarray([0], np.int32), bt=bt([[0, 0, 0, 0]])),
         dict(tokens=tok(2, 16), starts=np.asarray([0, 0], np.int32),
              clens=np.asarray([16, 11], np.int32), bt=bt([[1, 2, 0, 0], [3, 4, 0, 0]]))),
        ("mixed",
         dict(tokens=tok(2, 1), lengths=np.asarray([16, 11], np.int32),
              bt=bt([[1, 2, 5, 0], [3, 4, 0, 0]])),
         dict(tokens=tok(2, 16), starts=np.asarray([0, 0], np.int32),
              clens=np.asarray([9, 0], np.int32), bt=bt([[6, 7, 0, 0], [0, 0, 0, 0]]))),
        ("decode",
         dict(tokens=tok(4, 1), lengths=np.asarray([17, 12, 9, 0], np.int32),
              bt=bt([[1, 2, 5, 0], [3, 4, 0, 0], [6, 7, 0, 0], [0, 0, 0, 0]])),
         None),
    ]


@pytest.mark.parametrize("use_kernels", [True, False])
def test_mixed_and_decode_steps_match_with_int8_pools(use_kernels):
    """Logits within 1e-4 (float32 sums in another order through two layers
    of int8 attention and MoE), MoE counts exactly, the written int8 pools
    exactly and their scales bit for bit: the writes quantize the same
    float K/V by the same recipe."""
    cfg_j = dataclasses.replace(small_test_config(
        "tiny-moe", family="moe", moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=128)),
        qk_norm=True)
    cfg_t = dataclasses.replace(resolve_config("tiny-moe"), qk_norm=True)
    pj = jmodel.init_model(jax.random.PRNGKey(3), cfg_j)
    pt = from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    cache_j = jmodel.init_cache(cfg_j, 1, 4 * PAGE, paged=True, page_size=PAGE,
                                num_pages=P, kv_quant=True)
    cache_t = tmodel.init_cache(cfg_t, page_size=PAGE, num_pages=P, device="cpu",
                                kv_quant=True)
    assert cache_t[0]["blocks"][0]["k_pages"].dtype == torch.int8
    plan_kw = dict(moe_impl="duplex", k_cold=4, c_hot=16, c_cold=8,
                   moe_ragged=use_kernels, use_kernels=use_kernels)
    plan_t, plan_j = ExecutionPlan(**plan_kw), JPlan(**plan_kw)
    J, T = jnp.asarray, torch.tensor
    for kind, dec, chunk in _stages(np.random.default_rng(0), cfg_j.vocab_size):
        actx_j = {"lengths": J(dec["lengths"]), "block_tables": J(dec["bt"]),
                  "valid": J(dec["lengths"] > 0)}
        actx_t = {"lengths": T(dec["lengths"]), "block_tables": T(dec["bt"]),
                  "valid": T(dec["lengths"] > 0)}
        if kind == "mixed":
            cctx_j = {"starts": J(chunk["starts"]), "chunk_lens": J(chunk["clens"]),
                      "block_tables": J(chunk["bt"])}
            cctx_t = {k: T(np.asarray(v)) for k, v in cctx_j.items()}
            with execution_plan(plan_j):
                dl_j, cl_j, cache_j, cnt_j = jax.jit(
                    lambda p, d, c, cache, a, cc: jmodel.mixed_step(
                        p, cfg_j, d, c, cache, attn_ctx=a, chunk_ctx=cc))(
                    pj, J(dec["tokens"]), J(chunk["tokens"]), cache_j, actx_j, cctx_j)
            dl_t, cl_t, cache_t, cnt_t = tmodel.mixed_step(
                pt, cfg_t, T(dec["tokens"]), T(chunk["tokens"]), cache_t,
                attn_ctx=actx_t, chunk_ctx=cctx_t, plan=plan_t)
            live = chunk["clens"] > 0
            np.testing.assert_allclose(cl_t.numpy()[live], np.asarray(cl_j)[live],
                                       atol=1e-4)
        else:
            with execution_plan(plan_j):
                dl_j, cache_j, cnt_j = jax.jit(
                    lambda p, d, cache, a: jmodel.decode_step(
                        p, cfg_j, d, cache, attn_ctx=a, return_moe_counts=True))(
                    pj, J(dec["tokens"]), cache_j, actx_j)
            dl_t, cache_t, cnt_t = tmodel.decode_step(
                pt, cfg_t, T(dec["tokens"]), cache_t, actx_t, plan=plan_t)
        live = dec["lengths"] > 0
        np.testing.assert_allclose(dl_t.numpy()[live], np.asarray(dl_j)[live], atol=1e-4)
        np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    for name in ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages"):
        got = cache_t[0]["blocks"][0][name].numpy()[:, 1:8]     # live pages 1..7
        want = np.asarray(cache_j[0]["blocks"][0][name])[:, 1:8]
        assert (np.abs(got.astype(np.float64) - want).max() == 0
                if name in ("k_pages", "v_pages") else
                np.abs(got - want).max() <= 1e-6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the engine with int8 pools
# ---------------------------------------------------------------------------

KW = dict(max_slots=3, max_len=64, kv_page_size=8, prefill_chunk_tokens=16)


@pytest.mark.parametrize("flags", [dict(kv_quant=True),
                                   dict(kv_quant=True, moe_ragged=False)])
def test_engine_int8_emits_the_reference_greedy_tokens(flags):
    """kv_quant=True (with the ragged and with the capacity-padded MoE
    kernels): greedy tokens, per-stage k_cold and stage mix, and the
    streamed KV bytes (int8 values plus float32 scales) equal the
    reference engine's."""
    cfg_j = small_test_config("tiny-moe", family="moe",
                              moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=128))
    params_j = jmodel.init_model(jax.random.PRNGKey(0), cfg_j)
    params_t = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params_j), "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg_j.vocab_size, n).tolist() for n in (19, 5, 27, 9)]
    ref = RefEngine(cfg_j, params_j, kv_layout="paged", use_kernels=True, **flags, **KW)
    ref_reqs = [RefRequest(rid=i, prompt=list(p), max_new_tokens=3)
                for i, p in enumerate(prompts)]
    ref.run(ref_reqs)
    eng = ServingEngine(resolve_config("tiny-moe"), params_t, device="cpu",
                        use_kernels=True, **flags, **KW)
    reqs = [Request(rid=i, prompt=list(p), max_new_tokens=3) for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert [r.k_cold for r in eng.reports] == [r.k_cold for r in ref.reports]
    assert any(0 < r.k_cold < 8 for r in eng.reports)
    assert [(r.is_mixed, r.num_decode, r.num_prefill, r.stage_tokens)
            for r in eng.reports] == [(r.is_mixed, r.num_decode, r.num_prefill,
                                       r.stage_tokens) for r in ref.reports]
    assert [r.kv_bytes_streamed for r in eng.reports] == \
        [r.kv_bytes_streamed for r in ref.reports]
    assert [r.moe_bytes_streamed for r in eng.reports] == \
        [r.moe_bytes_streamed for r in ref.reports]
    assert eng.kv.cache[0]["blocks"][0]["k_pages"].dtype == torch.int8
