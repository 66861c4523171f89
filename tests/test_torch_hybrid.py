"""PyTorch port, the hybrid family on the dense KV layout (Jamba's pattern:
Mamba-2 and GQA attention mixers, dense and MoE FFNs under one stacked
period), against the JAX package on the same numpy inputs and weights
(float32, TF32 off):

* the dense decode-attention kernel's plain version against the Pallas
  kernel (interpret mode), 2e-5;
* the prefill attention (unblocked and blockwise branches) and the dense
  prefill-cache write;
* ``model.prefill`` plus two dense ``decode_step``s on a tiny hybrid,
  logits within 1e-4 and MoE counts exactly;
* the port's engine against the JAX engine: dense layout, legacy prefill,
  greedy tokens and per-stage k_cold exactly, kernels on and off;
* ``KVManager.bytes_per_slot`` on both layouts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jb
from repro.core.execution import ExecutionPlan as JPlan
from repro.core.execution import execution_plan
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.request import Request as RefRequest
from repro_torch.configs import base as tb
from repro_torch.configs import resolve_config
from repro_torch.core.execution import ExecutionPlan
from repro_torch.kernels import ops as tops
from repro_torch.kernels.decode_attn import decode_attention_kernel, decode_attention_plain
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.params import from_numpy_tree
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request

torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products on a card
torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers

T = torch.tensor
E = 4


def _hybrid(m, repeats):
    """Jamba's 8-layer period (attention at i % 8 == 4, MoE on odd layers) at
    d_model 64: 4 heads over 2 KV heads, 4 experts top-2, SSM headdim 16,
    chunk 8; float32."""
    pattern = tuple(m.LayerKind(m.ATTN if i % 8 == 4 else m.MAMBA,
                                m.MOE if i % 2 == 1 else m.DENSE) for i in range(8))
    return m.ModelConfig(
        name="tiny-hybrid", family="hybrid", num_layers=8 * repeats, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
        segments=(m.Segment(pattern, repeats),),
        moe=m.MoEConfig(num_experts=E, top_k=2, d_ff_expert=128),
        ssm=m.SSMConfig(d_state=16, d_conv=4, expand=2, headdim=16, chunk_size=8),
        dtype="float32", param_dtype="float32").validate()


def _params(repeats, seed=0):
    cfg_j, cfg_t = _hybrid(jb, repeats), _hybrid(tb, repeats)
    pj = jmodel.init_model(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, cfg_t, pj, from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")


@pytest.mark.parametrize("qpk,window,softcap", [(1, 0, 0.0), (4, 0, 0.0), (4, 9, 0.0),
                                                (1, 0, 5.0), (4, 12, 3.0)])
def test_dense_decode_attention_plain_matches_pallas(qpk, window, softcap):
    """Lengths 0 (no live key: 0 out), 1, ragged, Smax and past Smax (a dead
    dense row keeps counting): the kernel-layout plain version, the wrapper
    on CPU tensors and the model-layout op against the Pallas kernel, 2e-5.
    The Pallas kv block divides Smax, as the engine's (min(512, Smax) for
    the caches it serves) does: the reference's wrapper pads the cache to a
    whole block, and a row past Smax would then also attend the zero pad."""
    rng = np.random.default_rng(qpk * 100 + window)
    B, KV, hd, Smax = 6, 2, 16, 40
    lens = np.asarray([0, 1, 17, 23, 40, 45], np.int32)
    q = rng.standard_normal((B, 1, KV * qpk, hd)).astype(np.float32)
    k = rng.standard_normal((B, Smax, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Smax, KV, hd)).astype(np.float32)
    want = np.asarray(jops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            jnp.asarray(lens), window=window,
                                            softcap=softcap, kv_block=8))
    qg = T(q).reshape(B, KV, qpk, hd)
    kw = dict(window=window, softcap=softcap)
    for got in (decode_attention_plain(qg, T(k), T(v), T(lens), **kw),
                decode_attention_kernel(qg, T(k), T(v), T(lens), **kw)):
        np.testing.assert_allclose(got.reshape(B, 1, -1, hd).numpy(), want,
                                   atol=2e-5, rtol=2e-5)
    got = tops.decode_attention(T(q), T(k), T(v), T(lens), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S,q_block", [(21, 512), (21, 8), (37, 16)])
def test_attention_forward_matches(S, q_block):
    """Prefill attention at GQA 4/2: the unblocked branch (S <= q_block) and
    the blockwise one (S > q_block, padded tail), y and (k, v) within 1e-5
    (float32)."""
    cfg_j, cfg_t, pj, pt = _params(1, seed=1)
    mj = jax.tree_util.tree_map(lambda a: a[0], pj["segments"][0]["blocks"][4]["mixer"])
    mt = {k: {kk: vv[0] for kk, vv in v.items()}
          for k, v in pt["segments"][0]["blocks"][4]["mixer"].items()}
    x = np.random.default_rng(S).standard_normal((2, S, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (2, S))
    call_j = jattn.AttnCall(causal=True, q_block=q_block, kv_block=q_block)
    call_t = tattn.AttnCall(causal=True, q_block=q_block, kv_block=q_block)
    y_j, (k_j, v_j) = jattn.attention_forward(mj, cfg_j, jnp.asarray(x), jnp.asarray(pos),
                                              call_j, return_kv=True)
    y_t, (k_t, v_t) = tattn.attention_forward(mt, cfg_t, T(x), T(pos.copy()), call_t,
                                              return_kv=True)
    for a, b in ((y_t, y_j), (k_t, k_j), (v_t, v_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (11, 0.0), (0, 4.0)])
def test_blockwise_attention_matches(window, softcap):
    """The blockwise (flash forward) schedule with a window and a softcap
    against the reference's, blocks of 8 over 29 positions, within 1e-5."""
    rng = np.random.default_rng(window + 7)
    q = rng.standard_normal((2, 29, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 29, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 29, 2, 16)).astype(np.float32)
    kw = dict(causal=True, window=window, softcap=softcap, q_block=8, kv_block=8)
    want = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = tattn.blockwise_attention(*map(T, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_write_prefill_cache_matches():
    """A dense cache row written from a padded prefill: K/V, "pos" (the
    empty marker past true_len) and "len" exactly as the reference's."""
    rng = np.random.default_rng(3)
    k = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    true_len = np.asarray([10, 6], np.int32)
    cache_j = jax.tree_util.tree_map(
        lambda a: a[0], jmodel.init_cache(_hybrid(jb, 1), 2, 16)[0]["blocks"][4])
    cache_t = {key: val[0] for key, val in
               tmodel.init_cache(_hybrid(tb, 1), 2, 16, device="cpu")[0]["blocks"][4].items()}
    want = jattn.write_prefill_cache(cache_j, jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(true_len))
    got = tattn.write_prefill_cache(cache_t, T(k), T(v), T(true_len))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("use_kernels,repeats", [(True, 1), (False, 2)])
def test_prefill_and_decode_steps_match(use_kernels, repeats):
    """One or two stacked periods (8 or 16 layers; the reference's Pallas
    kernels in interpret mode make the kernel case slow), three prompts padded to 16 (true
    lengths 16, 11, 5), then two dense decode steps over four rows with one
    dead row: prefill under the grouped MoE plan, decode under the duplex
    plan (ragged kernels on: their plain versions here, Pallas in interpret
    mode there; off: the plain grouped paths). Logits within 1e-4 (float32
    sums in another order through 8 MoE and 14 Mamba layers), MoE counts
    exactly, and the caches after the steps within 1e-4."""
    cfg_j, cfg_t, pj, pt = _params(repeats)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (4, 16)).astype(np.int32)
    true_len = np.asarray([16, 11, 5, 1], np.int32)
    pre_j = JPlan(moe_impl="grouped", use_kernels=use_kernels)
    pre_t = ExecutionPlan(moe_impl="grouped", use_kernels=use_kernels)
    dec_kw = dict(moe_impl="duplex", k_cold=2, c_hot=8, c_cold=8,
                  moe_ragged=use_kernels, use_kernels=use_kernels)
    cache_j = jmodel.init_cache(cfg_j, 4, 32)
    with execution_plan(pre_j):
        lg_j, cache_j = jmodel.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)}, cache_j,
                                       jnp.asarray(true_len))
    cache_t = tmodel.init_cache(cfg_t, 4, 32, device="cpu")
    lg_t, cache_t = tmodel.prefill(pt, cfg_t, {"tokens": T(toks)}, cache_t, T(true_len),
                                   plan=pre_t)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=1e-4)
    valid = np.asarray([True, True, False, True])
    step_j = jax.jit(lambda p, t, c, a: jmodel.decode_step(p, cfg_j, t, c, attn_ctx=a,
                                                           return_moe_counts=True))
    for step in range(2):
        nxt = rng.integers(0, 256, (4, 1)).astype(np.int32)
        with execution_plan(JPlan(**dec_kw)):       # read while jit traces
            dl_j, cache_j, cnt_j = step_j(pj, jnp.asarray(nxt), cache_j,
                                          {"valid": jnp.asarray(valid)})
        dl_t, cache_t, cnt_t = tmodel.decode_step(pt, cfg_t, T(nxt), cache_t,
                                                  {"valid": T(valid)},
                                                  plan=ExecutionPlan(**dec_kw))
        np.testing.assert_allclose(dl_t.numpy()[valid], np.asarray(dl_j)[valid], atol=1e-4)
        np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    flat_j = jax.tree_util.tree_leaves(cache_j)
    flat_t = [cache_t[0]["blocks"][j][k] for j in range(8)
              for k in sorted(cache_t[0]["blocks"][j])]
    flat_t = [leaf for x in flat_t for leaf in
              ([x[k] for k in sorted(x)] if isinstance(x, dict) else [x])]
    assert len(flat_t) == len(flat_j)
    for a, b in zip(flat_t, flat_j):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def _engine_run(make, request, cfg, params, use_kernels):
    rng = np.random.default_rng(0)
    # five prompts over three slots; none fills its 64-token bucket, and
    # staggered lengths make stages that decode and prefill together
    prompts = [rng.integers(0, 256, n).tolist() for n in (12, 5, 27, 9, 40)]
    new_tokens = (3, 5, 2, 3, 4)
    eng = make(cfg, params, use_kernels=use_kernels)
    reqs = [request(rid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, new_tokens))]
    eng.run(reqs)
    return eng, reqs


@pytest.mark.parametrize("use_kernels", [True, False])
def test_engine_emits_the_reference_greedy_tokens(use_kernels):
    """Dense layout, legacy whole-prompt prefill, duplex MoE (ragged kernels
    with ``use_kernels``): greedy tokens, per-stage k_cold, stage composition
    and streamed KV bytes exactly as the JAX engine's."""
    kw = dict(max_slots=3, max_len=64)
    cfg_j, cfg_t, pj, pt = _params(1)
    ref, ref_reqs = _engine_run(
        lambda c, p, **k: RefEngine(c, p, kv_layout="dense", **kw, **k), RefRequest,
        cfg_j, pj, use_kernels)
    # the port's default layout for a hybrid stack is the dense one
    eng, reqs = _engine_run(lambda c, p, **k: ServingEngine(c, p, device="cpu", **kw, **k),
                            Request, cfg_t, pt, use_kernels)
    assert not eng.paged
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert all(r.done for r in reqs)
    assert [r.k_cold for r in eng.reports] == [r.k_cold for r in ref.reports]
    assert [(r.num_decode, r.num_prefill, r.stage_tokens, r.kv_bytes_streamed)
            for r in eng.reports] == [(r.num_decode, r.num_prefill, r.stage_tokens,
                                       r.kv_bytes_streamed) for r in ref.reports]
    assert any(r.num_decode and r.num_prefill for r in eng.reports)
    assert eng.kv.free_slots == kw["max_slots"]


def test_engine_routes_a_hybrid_stack_like_the_reference():
    """Chunked prefill and paged caches are refused for a Mamba stack; a
    full-attention stack takes either layout; the default layout is paged
    for a full-attention stack and dense for a hybrid one."""
    cfg_t = _hybrid(tb, 1)
    params = {"embed": {"table": torch.zeros(1)}, "lm_head": {"table": torch.zeros(1)}}
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        ServingEngine(cfg_t, params, max_slots=2, max_len=32, kv_layout="dense",
                      prefill_chunk_tokens=16, device="cpu")
    with pytest.raises(ValueError, match="paged KV cache"):
        ServingEngine(cfg_t, params, max_slots=2, max_len=32, kv_layout="paged",
                      device="cpu")
    for layout, paged in (("dense", False), (None, True)):
        eng = ServingEngine(resolve_config("tiny-moe"), params, max_slots=2, max_len=32,
                            kv_layout=layout, device="cpu")
        assert eng.paged == paged
    assert not ServingEngine(cfg_t, params, max_slots=2, max_len=32, device="cpu").paged
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        ServingEngine(cfg_t, params, max_slots=2, max_len=32, prefill_chunk_tokens=16,
                      device="cpu")


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_kv_bytes_per_slot_matches_the_reference(layout):
    """``KVManager.bytes_per_slot`` as the reference computes it: dense, the
    configured footprint over the slots (the tiny hybrid); paged, one
    full-length slot when idle, then the live pages over the active slots
    (tiny-moe, page 8)."""
    from repro.serving.kvmanager import KVManager as RefKV
    from repro_torch.serving.kvmanager import KVManager
    if layout == "dense":
        cfg_j, cfg_t, kw = _hybrid(jb, 1), _hybrid(tb, 1), {}
    else:
        cfg_j = jb.small_test_config("tiny-moe", family="moe",
                                     moe=jb.MoEConfig(num_experts=8, top_k=2,
                                                      d_ff_expert=128))
        cfg_t, kw = resolve_config("tiny-moe"), dict(page_size=8)
    ref = RefKV(cfg_j, 3, 64, layout=layout, **kw)
    kv = KVManager(cfg_t, 3, 64, layout=layout, device="cpu", **kw)
    assert kv.bytes_per_slot() == ref.bytes_per_slot() > 0
    for m in (ref, kv):
        slots = [m.allocate(), m.allocate()]
        if layout == "paged":
            m.ensure_len(slots[0], 20)
            m.ensure_len(slots[1], 3)
    assert kv.bytes_per_slot() == ref.bytes_per_slot() > 0
