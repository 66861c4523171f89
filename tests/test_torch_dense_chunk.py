"""PyTorch port, the dense KV layout for full self-attention stacks, against
the JAX package on the same numpy inputs and weights (tiny-moe, float32,
TF32 off):

* ``attention_chunk_step`` on a dense slot cache: a padded row whose slot 0
  is also a live row's, a chunk that reaches the ``Smax - 1`` clamp, and a
  softcap; outputs within 2e-5, the written "pos" and "len" and the V rows
  exactly, K where the reference writes it within 1e-6 (its rope rounds
  otherwise in the last bit) and bit for bit everywhere else;
* ``mixed_step`` on the dense layout: two stages, logits within 1e-4 and
  the MoE counts exactly;
* the engine with ``kv_layout="dense"``, chunked and whole-prompt spans,
  kernels on (the port's plain kernel versions here, Pallas in interpret
  mode in the reference): greedy tokens, per-stage k_cold, stage
  composition and streamed KV bytes exactly as the reference engine's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig, small_test_config
from repro.core.execution import ExecutionPlan as JPlan
from repro.core.execution import execution_plan
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.request import Request as RefRequest
from repro_torch.configs import resolve_config
from repro_torch.core.execution import ExecutionPlan
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.params import from_numpy_tree
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request

torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products on a card
torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers
T = torch.tensor


def _configs(**kw):
    j = small_test_config("tiny-moe", family="moe",
                          moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=128))
    return dataclasses.replace(j, **kw), dataclasses.replace(resolve_config("tiny-moe"), **kw)


def _params(cfg_j, seed):
    pj = jmodel.init_model(jax.random.PRNGKey(seed), cfg_j)
    return pj, from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")


@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_attention_chunk_step_matches(softcap):
    """Three slots of 16 positions holding earlier rows; four chunk rows of
    8: slot 1 from 3 (8 live), slot 0 from 12 (7 live: positions 15-18 all
    clamp to 15, the last one written holds it), and two padded rows at slot
    0 (more rows than slots: only the live rows and one padded row are
    written back)."""
    cfg_j, cfg_t = _configs(attn_logit_softcap=softcap)
    pj, pt = _params(cfg_j, 1)
    mj = jax.tree_util.tree_map(lambda a: a[0], pj["segments"][0]["blocks"][0]["mixer"])
    mt = {k: {n: t[0] for n, t in v.items()} if isinstance(v, dict) else v[0]
          for k, v in pt["segments"][0]["blocks"][0]["mixer"].items()}
    rng = np.random.default_rng(0)
    nrows, Smax, Sc = 3, 16, 8
    k = rng.standard_normal((nrows, Smax, 2, 16)).astype(np.float32)
    v = rng.standard_normal((nrows, Smax, 2, 16)).astype(np.float32)
    pos = np.tile(np.arange(Smax, dtype=np.int32), (nrows, 1))
    pos[2, 5:] = 2 ** 31 - 1
    cache = dict(k=k, v=v, pos=pos, len=np.asarray([12, 3, 5], np.int32))
    x = rng.standard_normal((4, Sc, cfg_j.d_model)).astype(np.float32)
    ctx = dict(slots=np.asarray([1, 0, 0, 0], np.int32),
               starts=np.asarray([3, 12, 0, 0], np.int32),
               chunk_lens=np.asarray([8, 7, 0, 0], np.int32))
    yj, cj = jattn.attention_chunk_step(mj, cfg_j, jnp.asarray(x),
                                        {n: jnp.asarray(a) for n, a in cache.items()},
                                        {n: jnp.asarray(a) for n, a in ctx.items()})
    yt, ct = tattn.attention_chunk_step(mt, cfg_t, T(x), {n: T(a) for n, a in cache.items()},
                                        {n: T(a) for n, a in ctx.items()})
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-5)
    for name in ("v", "pos", "len"):
        np.testing.assert_array_equal(ct[name].numpy(), np.asarray(cj[name]))
    assert np.asarray(cj["pos"])[0, Smax - 1] == 18
    kj = np.asarray(cj["k"])
    written = kj != k
    np.testing.assert_array_equal(ct["k"].numpy()[~written], k[~written])
    np.testing.assert_allclose(ct["k"].numpy()[written], kj[written], atol=1e-6)


def test_mixed_step_dense_matches():
    """Two dense mixed stages over three slots (rows of 32): first two chunk
    rows (slot 2 and slot 0) with one padded row and no live decode row, then
    one decode row (slot 2), slot 0's second chunk and a fresh chunk at slot
    1. Logits within 1e-4 (float32 sums in another order through two MoE
    layers), MoE counts exactly, the caches after each stage within 1e-4."""
    cfg_j, cfg_t = _configs(qk_norm=True)
    pj, pt = _params(cfg_j, 3)
    rng = np.random.default_rng(4)
    stages = [
        (np.asarray([False, False, False]),
         dict(slots=[2, 0, 0], starts=[0, 0, 0], chunk_lens=[9, 16, 0])),
        (np.asarray([False, False, True]),
         dict(slots=[0, 1, 0], starts=[16, 0, 0], chunk_lens=[5, 12, 0])),
    ]
    kw = dict(moe_impl="duplex", k_cold=3, c_hot=32, c_cold=16, moe_ragged=False,
              use_kernels=False)
    cache_j = jmodel.init_cache(cfg_j, 3, 32)
    cache_t = tmodel.init_cache(cfg_t, 3, 32, device="cpu")
    step_j = jax.jit(lambda p, d, c, cache, a, x: jmodel.mixed_step(
        p, cfg_j, d, c, cache, attn_ctx=a, chunk_ctx=x))
    for valid, ctx in stages:
        dtok = rng.integers(0, 256, (3, 1)).astype(np.int32)
        ctok = rng.integers(0, 256, (3, 16)).astype(np.int32)
        ctx = {n: np.asarray(a, np.int32) for n, a in ctx.items()}
        with execution_plan(JPlan(**kw)):
            dl_j, cl_j, cache_j, cnt_j = step_j(
                pj, jnp.asarray(dtok), jnp.asarray(ctok), cache_j,
                {"valid": jnp.asarray(valid)}, {n: jnp.asarray(a) for n, a in ctx.items()})
        dl_t, cl_t, cache_t, cnt_t = tmodel.mixed_step(
            pt, cfg_t, T(dtok), T(ctok), cache_t, attn_ctx={"valid": T(valid)},
            chunk_ctx={n: T(a) for n, a in ctx.items()}, plan=ExecutionPlan(**kw))
        np.testing.assert_allclose(dl_t.numpy()[valid], np.asarray(dl_j)[valid], atol=1e-4)
        live = ctx["chunk_lens"] > 0
        np.testing.assert_allclose(cl_t.numpy()[live], np.asarray(cl_j)[live], atol=1e-4)
        np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
        blk_j, blk_t = cache_j[0]["blocks"][0], cache_t[0]["blocks"][0]
        for name in ("k", "v", "pos", "len"):
            np.testing.assert_allclose(blk_t[name].numpy(), np.asarray(blk_j[name]),
                                       atol=1e-4)


def _serve(make, request, chunk):
    rng = np.random.default_rng(0)
    # four prompts over three slots (one waits for request 1's slot),
    # spanning 1-2 chunks
    prompts = [rng.integers(0, 256, n).tolist() for n in (19, 5, 27, 9)]
    eng = make(max_slots=3, max_len=64, kv_layout="dense", use_kernels=True,
               prefill_chunk_tokens=chunk)
    reqs = [request(rid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, (3, 2, 4, 3)))]
    eng.run(reqs)
    return eng, reqs


@pytest.mark.parametrize("chunk", [16, None])
def test_engine_dense_emits_the_reference_greedy_tokens(chunk):
    """The dense layout with chunked (16) and whole-prompt spans, kernels
    on: greedy tokens, per-stage k_cold, stage composition and streamed KV
    bytes exactly as the reference engine's."""
    cfg_j, cfg_t = _configs()
    pj, pt = _params(cfg_j, 0)
    ref, ref_reqs = _serve(lambda **k: RefEngine(cfg_j, pj, **k), RefRequest, chunk)
    eng, reqs = _serve(lambda **k: ServingEngine(cfg_t, pt, device="cpu", **k), Request,
                       chunk)
    assert not eng.paged
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert all(r.done for r in reqs)
    assert [r.k_cold for r in eng.reports] == [r.k_cold for r in ref.reports]
    assert [(r.is_mixed, r.num_decode, r.num_prefill, r.stage_tokens, r.chunk_tokens)
            for r in eng.reports] == [(r.is_mixed, r.num_decode, r.num_prefill,
                                       r.stage_tokens, r.chunk_tokens) for r in ref.reports]
    assert [r.kv_bytes_streamed for r in eng.reports] == \
        [r.kv_bytes_streamed for r in ref.reports]
    assert any(r.is_mixed and r.num_decode for r in eng.reports)
    assert eng.kv.free_slots == 3
