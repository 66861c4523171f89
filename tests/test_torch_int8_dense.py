"""PyTorch port, int8 dense caches (``kv_quant`` on the dense layout: int8
K/V with float32 per-(token, KV head) scales), against the JAX package on
the same numpy inputs and weights (float32, TF32 off):

* the writes: a prefill into a full-length cache and into a ring, decode
  steps (across a ring's wrap), and a chunk step whose rows reach the
  ``Smax - 1`` clamp; int8 values and scales bit for bit (the chunk's K
  scales within 1e-6 relative: the reference's rope rounds otherwise in
  the last float32 bit at a position, as ``test_torch_dense_chunk.py``
  finds for float K); attention outputs within 2e-5;
* the engine's greedy tokens and stage reports against the reference
  engine's with ``kv_quant`` on the dense attention layout (chunked), on a
  windowed stack (rings, with migrate) and on the hybrid (Mamba, attention
  and MoE layers);
* the dense KV manager on int8 rings: its bytes a slot as the
  reference's, a migrated row back bit for bit, ``rewind_dense``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jb
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.request import Request as RefRequest
from repro_torch.configs import base as tb
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.params import from_numpy_tree
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request

from test_torch_ring import WINDOW, assert_engines_agree, assert_ring_equal, windowed
from test_torch_ring import _serve as ring_serve
from test_torch_ring import params as ring_params

torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products on a card
torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers
T = torch.tensor
TOL = dict(atol=2e-5, rtol=2e-5)


def _layer_caches(cfg_j, cfg_t, layer, batch, max_len):
    """One layer's int8 dense cache in both packages, its layer axis dropped."""
    cj = jax.tree_util.tree_map(lambda a: a[0], jmodel.init_cache(
        cfg_j, batch, max_len, kv_quant=True)[0]["blocks"][layer])
    ct = {k: v[0] for k, v in tmodel.init_cache(cfg_t, batch, max_len, device="cpu",
                                                kv_quant=True)[0]["blocks"][layer].items()}
    return cj, ct


def _mixer(pj, pt, layer):
    mj = jax.tree_util.tree_map(lambda a: a[0], pj["segments"][0]["blocks"][layer]["mixer"])
    mt = {k: {kk: vv[0] for kk, vv in v.items()}
          for k, v in pt["segments"][0]["blocks"][layer]["mixer"].items()}
    return mj, mt


def assert_int8_equal(got, want, live=None, k_scale_rtol=0.0):
    """Every leaf bit for bit (``live``: a ring's live slots, "pos" and "len"
    whole), K's scale within ``k_scale_rtol`` relative when given."""
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = got[key].numpy(), np.asarray(want[key])
        if live is not None and key not in ("pos", "len"):
            g, w = g[:, :live], w[:, :live]
        if key == "k_scale" and k_scale_rtol:
            np.testing.assert_allclose(g, w, rtol=k_scale_rtol, atol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("layer,max_len", [(1, 32), (0, 32), (0, 6)])
def test_prefill_write_is_bit_equal(layer, max_len):
    """int8 K/V and their scales written from a padded prefill (true
    lengths 20, 13, 5 of 20): a full-length buffer (the global layer), a
    ring (the local layer at max_len 32), and a local layer that appends
    (max_len 6, prompts cut to 6): every leaf bit for bit (a ring's dump
    slot aside)."""
    cfg_j, cfg_t = windowed(jb), windowed(tb)
    S = min(20, max_len)
    rng = np.random.default_rng(layer + max_len)
    k = rng.standard_normal((3, S, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, S, 2, 16)).astype(np.float32)
    tl = np.minimum(np.asarray([20, 13, 5], np.int32), S)
    window = WINDOW if layer == 0 else 0
    cache_j, cache_t = _layer_caches(cfg_j, cfg_t, layer, 3, max_len)
    want = jattn.write_prefill_cache(cache_j, jnp.asarray(k), jnp.asarray(v), jnp.asarray(tl),
                                     window=window)
    got = tattn.write_prefill_cache(cache_t, T(k), T(v), T(tl), window=window)
    assert got["k"].dtype == torch.int8 and got["k_scale"].dtype == torch.float32
    if tattn.is_ring(got, window):
        assert_ring_equal(got, want, WINDOW)
    else:
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("layer", [0, 1])
def test_decode_steps_write_and_attend_like_the_reference(layer):
    """Three decode steps of one layer on an int8 cache prefilled with 11
    and 4 positions (a ring of 9 slots for the local layer, so the first
    row wraps it; 32 positions for the global one): outputs within 2e-5,
    int8 values, scales and positions bit for bit."""
    cfg_j, cfg_t, pj, pt = ring_params()
    mj, mt = _mixer(pj, pt, layer)
    window = WINDOW if layer == 0 else 0
    rng = np.random.default_rng(10 + layer)
    k = rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
    tl = np.asarray([11, 4], np.int32)
    cache_j, cache_t = _layer_caches(cfg_j, cfg_t, layer, 2, 32)
    cache_j = jattn.write_prefill_cache(cache_j, jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(tl), window=window)
    tattn.write_prefill_cache(cache_t, T(k), T(v), T(tl), window=window)
    for step in range(3):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        y_j, cache_j = jattn.attention_decode_step(mj, cfg_j, jnp.asarray(x), cache_j,
                                                   window=window)
        y_t, _ = tattn.attention_decode_step(mt, cfg_t, T(x), cache_t, window=window,
                                             use_kernels=True)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    assert_int8_equal(cache_t, cache_j, live=WINDOW if layer == 0 else None)


def test_chunk_step_writes_and_attends_like_the_reference():
    """The dense chunk step on an int8 cache of three slots of 16 positions
    holding earlier rows: a chunk row at slot 1 from 3 (8 live), one at
    slot 0 from 12 (7 live, positions 15-18 clamp to 15), two padded rows;
    outputs within 2e-5; the scales go through the same row writes as K/V:
    every leaf bit for bit, K's scales within 1e-6 relative."""
    cfg_j, cfg_t, pj, pt = ring_params()
    mj, mt = _mixer(pj, pt, 1)
    rng = np.random.default_rng(7)
    cache_j, cache_t = _layer_caches(cfg_j, cfg_t, 1, 3, 16)
    k = rng.standard_normal((3, 16, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 16, 2, 16)).astype(np.float32)
    tl = np.asarray([12, 3, 16], np.int32)
    cache_j = jattn.write_prefill_cache(cache_j, jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(tl))
    tattn.write_prefill_cache(cache_t, T(k), T(v), T(tl))
    ctx = {"slots": np.asarray([1, 0, 0, 2], np.int32),
           "starts": np.asarray([3, 12, 0, 0], np.int32),
           "chunk_lens": np.asarray([8, 7, 0, 0], np.int32)}
    x = rng.standard_normal((4, 8, 64)).astype(np.float32)
    y_j, cache_j = jattn.attention_chunk_step(mj, cfg_j, jnp.asarray(x), cache_j,
                                              {n: jnp.asarray(a) for n, a in ctx.items()})
    y_t, _ = tattn.attention_chunk_step(mt, cfg_t, T(x), cache_t,
                                        {n: T(a) for n, a in ctx.items()})
    live = ctx["chunk_lens"] > 0
    np.testing.assert_allclose(y_t.numpy()[live], np.asarray(y_j)[live], **TOL)
    assert_int8_equal(cache_t, cache_j, k_scale_rtol=1e-6)


def _tiny_moe(m):
    return m.small_test_config("tiny-moe", family="moe",
                               moe=m.MoEConfig(num_experts=8, top_k=2, d_ff_expert=128))


def test_engine_on_the_dense_attention_layout_emits_the_reference_tokens():
    """tiny-moe on the dense layout with chunks of 16 and int8 rows, kernels
    on: greedy tokens, stage composition and streamed KV bytes (int8 values
    plus their scales) exactly as the reference engine's."""
    cfg_j, cfg_t = _tiny_moe(jb), _tiny_moe(tb)
    pj = jmodel.init_model(jax.random.PRNGKey(0), cfg_j)
    pt = from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).tolist() for n in (19, 5, 27, 9)]

    def serve(make, request):
        eng = make(max_slots=3, max_len=64, kv_layout="dense", use_kernels=True,
                   kv_quant=True, prefill_chunk_tokens=16)
        reqs = [request(rid=i, prompt=list(p), max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, (3, 2, 4, 3)))]
        eng.run(reqs)
        return eng, reqs
    ref, ref_reqs = serve(lambda **k: RefEngine(cfg_j, pj, **k), RefRequest)
    eng, reqs = serve(lambda **k: ServingEngine(cfg_t, pt, device="cpu", **k), Request)
    assert eng.kv.cache[0]["blocks"][0]["k"].dtype == torch.int8
    assert_engines_agree(eng, reqs, ref, ref_reqs)
    assert [r.k_cold for r in eng.reports] == [r.k_cold for r in ref.reports]
    assert any(r.is_mixed and r.num_decode for r in eng.reports)


def test_engine_on_a_windowed_stack_with_migrate_emits_the_reference_tokens():
    """The windowed stack of ``test_torch_ring.py`` with int8 rings and
    migrate: greedy tokens, stage composition, streamed KV bytes and
    preemptions exactly as the reference engine's (a migrated row carries
    its scales)."""
    cfg_j, cfg_t, pj, pt = ring_params()
    kw = dict(kv_quant=True, preemption="migrate")
    ref, ref_reqs = ring_serve(lambda **k: RefEngine(cfg_j, pj, **k), RefRequest, **kw)
    eng, reqs = ring_serve(lambda **k: ServingEngine(cfg_t, pt, device="cpu", **k), Request,
                           **kw)
    assert_engines_agree(eng, reqs, ref, ref_reqs)
    assert eng.preemptions > 0
    # 2 slots x 2 x 2 heads x (16 + 4) bytes (int8 K/V and a float32 scale)
    # x (32 positions + the ring's 9 slots)
    assert eng._dense_kv_bytes_per_stage == 2 * 80 * (32 + WINDOW + 1)


def test_engine_on_the_hybrid_emits_the_reference_tokens():
    """Jamba's pattern (``test_torch_hybrid.py``'s tiny hybrid, one period)
    with int8 rows in its attention layer, kernels off: greedy tokens,
    per-stage k_cold, stage composition and streamed KV bytes exactly as
    the reference engine's."""
    from test_torch_hybrid import _engine_run, _params
    cfg_j, cfg_t, pj, pt = _params(1)
    kw = dict(max_slots=3, max_len=64, kv_quant=True)
    ref, ref_reqs = _engine_run(
        lambda c, p, **k: RefEngine(c, p, kv_layout="dense", **kw, **k), RefRequest,
        cfg_j, pj, False)
    eng, reqs = _engine_run(lambda c, p, **k: ServingEngine(c, p, device="cpu", **kw, **k),
                            Request, cfg_t, pt, False)
    assert_engines_agree(eng, reqs, ref, ref_reqs)
    assert [r.k_cold for r in eng.reports] == [r.k_cold for r in ref.reports]


def test_kv_manager_on_int8_rings_matches_the_reference():
    """The dense KV manager of the windowed stack with int8 rows (a ring of
    9 slots and a 32-position row a slot): ``bytes_per_slot`` equal to the
    reference's; a migrated row (every leaf, scales included) comes back
    bit for bit; ``rewind_dense`` moves every attention layer's length and
    no other leaf."""
    from repro.serving.kvmanager import KVManager as RefKV
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving import preemption
    from repro_torch.serving.kvmanager import KVManager
    cfg_j, cfg_t = windowed(jb), windowed(tb)
    ref = RefKV(cfg_j, 3, 32, layout="dense", kv_quant=True)
    kv = KVManager(cfg_t, 3, 32, layout="dense", kv_quant=True, device="cpu")
    assert kv.bytes_per_slot() == ref.bytes_per_slot() > 0
    gen = torch.Generator().manual_seed(0)
    for leaf in tree_leaves(kv.cache):
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen))
        elif leaf.is_floating_point():
            leaf.copy_(torch.rand(leaf.shape, generator=gen))
        else:
            leaf.copy_(torch.randint(0, 30, leaf.shape, generator=gen))
    saved = preemption.gather_slot(kv, 1)
    before = [t.clone() for t in tree_leaves(kv.cache)]
    for leaf in tree_leaves(kv.cache):
        leaf[:, 1] = 0
    preemption.restore_slot(kv, 1, saved)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(kv.cache), before))
    old = [{n: t.clone() for n, t in blk.items()} for blk in kv.cache[0]["blocks"]]
    kv.rewind_dense([0, 2], [5, 7])
    for blk, was in zip(kv.cache[0]["blocks"], old):
        assert blk["len"][:, [0, 2]].tolist() == [[5, 7]]
        assert torch.equal(blk["len"][:, 1], was["len"][:, 1])
        for name in ("k", "v", "k_scale", "v_scale", "pos"):
            assert torch.equal(blk[name], was[name])
