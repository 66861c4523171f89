"""PyTorch port, ring caches for sliding-window layers, against the JAX
package on the same numpy inputs and weights (float32, TF32 off):

* ``write_prefill_cache`` into a ring of window + 1 slots: the live slots'
  K/V and every slot's "pos" bit for bit, for prompts shorter and longer
  than the window;
* a windowed stack (a local layer then a global one, 4 heads over 2, window
  8) through prefill and decode steps across the ring's wrap, on a ring
  (max_len past the window) and on an appending buffer (max_len within the
  window), logits within 2e-5 and against the port's own forward; the
  prefill also through the blockwise route (``attn_q_block`` 16);
* the engine's greedy tokens and stage reports against the reference
  engine's on that stack (dense layout, legacy prefill, kernels on), with
  and without migrate;
* the engine's refusals (chunked prefill, the paged layout, speculative
  decoding), as the reference's;
* path l's launch counts in ``chip_smoke.py`` (``L_EXPECT``): the port's
  engine on the CPU, at gemma3-4b's depth and a narrow width, forms the
  schedule the card runs.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jb
from repro.core.execution import ExecutionPlan as JPlan
from repro.core.execution import execution_plan
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.request import Request as RefRequest
from repro_torch.configs import base as tb
from repro_torch.core.execution import ExecutionPlan
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.params import from_numpy_tree
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request

torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products on a card
torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers
T = torch.tensor
WINDOW = 8
TOL = dict(atol=2e-5, rtol=2e-5)


def windowed(m, window=WINDOW, **kw):
    """A local (sliding-window) layer then a global one, d_model 64, 4 heads
    over 2 KV heads of 16, a dense FFN; float32."""
    pattern = (m.LayerKind(m.ATTN_LOCAL, m.DENSE), m.LayerKind(m.ATTN, m.DENSE))
    cfg = m.small_test_config("tiny-swa", num_layers=2, **kw)
    return dataclasses.replace(cfg, segments=(m.Segment(pattern, 1),),
                               sliding_window=window).validate()


def params(seed=0, **kw):
    cfg_j, cfg_t = windowed(jb, **kw), windowed(tb, **kw)
    pj = jmodel.init_model(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, cfg_t, pj, from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")


def _local_caches(cfg_j, cfg_t, batch, max_len, kv_quant=False):
    """Layer 0's (the local layer's) cache in both packages, its layer axis
    dropped."""
    cj = jax.tree_util.tree_map(lambda a: a[0], jmodel.init_cache(
        cfg_j, batch, max_len, kv_quant=kv_quant)[0]["blocks"][0])
    ct = {k: v[0] for k, v in tmodel.init_cache(cfg_t, batch, max_len, device="cpu",
                                                kv_quant=kv_quant)[0]["blocks"][0].items()}
    return cj, ct


def assert_ring_equal(got, want, window):
    """A ring's "pos" and "len" bit for bit, and every other leaf bit for bit
    on the window's live slots (the dump slot's K/V is never read)."""
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = got[key].numpy(), np.asarray(want[key])
        if key not in ("pos", "len"):
            g, w = g[:, :window], w[:, :window]
        np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("true_len", [(5, 8, 0), (9, 20, 3), (17, 13, 20)])
def test_ring_prefill_write_is_bit_equal(true_len):
    """Prompts padded to 20 positions, written into a ring of 9 slots: the
    last 8 valid positions of each row at pos % 8, the rest kept (prompts
    of 5, 3 and 0 leave slots as they were), "pos" the empty marker
    elsewhere; the reference's writes within the live slots exactly."""
    cfg_j, cfg_t = windowed(jb), windowed(tb)
    rng = np.random.default_rng(sum(true_len))
    k = rng.standard_normal((3, 20, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 20, 2, 16)).astype(np.float32)
    tl = np.asarray(true_len, np.int32)
    cache_j, cache_t = _local_caches(cfg_j, cfg_t, 3, 32)
    assert cache_t["k"].shape[1] == WINDOW + 1
    want = jattn.write_prefill_cache(cache_j, jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(tl), window=WINDOW)
    got = tattn.write_prefill_cache(cache_t, T(k), T(v), T(tl), window=WINDOW)
    assert_ring_equal(got, want, WINDOW)
    assert (got["pos"][:, WINDOW] == tattn.POS_EMPTY).all()


@pytest.mark.parametrize("max_len,q_block", [(32, 512), (32, 16), (6, 512)])
def test_windowed_prefill_and_decode_match(max_len, q_block):
    """Prompts of 20 positions (true lengths 20, 13, 5), then 4 decode
    steps: on a ring (max_len 32; decode wraps it), through the blockwise
    prefill (q_block 16 < 20 positions, with the window), and on an
    appending buffer (max_len 6 within the window: the local layer appends
    into 7 slots; prompts cut to 5 positions and 1 decode step so they
    fit). Logits within 2e-5 of the reference's, the local layer's
    live slots within 1e-5, and the decode logits within 1e-4 of the port's
    own forward over the grown sequence."""
    cfg_j, cfg_t, pj, pt = params()
    S, steps = (20, 4) if max_len > 6 else (5, 1)
    rng = np.random.default_rng(max_len + q_block)
    toks = rng.integers(0, 256, (3, S)).astype(np.int32)
    true_len = np.asarray([S, min(13, S), 5], np.int32)
    jplan = JPlan(moe_impl="grouped", attn_q_block=q_block, attn_kv_block=q_block)
    tplan = ExecutionPlan(moe_impl="grouped", attn_q_block=q_block, attn_kv_block=q_block)
    cache_j = jmodel.init_cache(cfg_j, 3, max_len)
    cache_t = tmodel.init_cache(cfg_t, 3, max_len, device="cpu")
    size = cache_t[0]["blocks"][0]["k"].shape[2]
    assert size == min(max_len, WINDOW) + 1
    with execution_plan(jplan):
        lg_j, cache_j = jmodel.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)}, cache_j,
                                       jnp.asarray(true_len))
    lg_t, cache_t = tmodel.prefill(pt, cfg_t, {"tokens": T(toks)}, cache_t, T(true_len),
                                   plan=tplan)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), **TOL)
    seqs = [list(toks[b, :n]) for b, n in enumerate(true_len)]
    nxt = np.asarray(lg_t.argmax(-1), np.int32)
    for _ in range(steps):
        for b in range(3):
            seqs[b].append(int(nxt[b, 0]))
        with execution_plan(jplan):
            dl_j, cache_j = jmodel.decode_step(pj, cfg_j, jnp.asarray(nxt), cache_j)
        dl_t, cache_t, _ = tmodel.decode_step(pt, cfg_t, T(nxt), cache_t, {}, plan=tplan)
        np.testing.assert_allclose(dl_t.numpy(), np.asarray(dl_j), **TOL)
        for b in range(3):
            full, _ = tmodel.forward(pt, cfg_t, {"tokens": T([seqs[b]])}, plan=tplan)
            np.testing.assert_allclose(dl_t[b, 0].numpy(), full[0, -1].numpy(), atol=1e-4)
        nxt = np.asarray(dl_t.argmax(-1), np.int32)
    blk_j = jax.tree_util.tree_map(lambda a: a[0], cache_j[0]["blocks"][0])
    blk_t = {k: v[0] for k, v in cache_t[0]["blocks"][0].items()}
    live = min(size, WINDOW)
    for key in ("pos", "len"):
        np.testing.assert_array_equal(blk_t[key].numpy(), np.asarray(blk_j[key]))
    for key in ("k", "v"):
        np.testing.assert_allclose(blk_t[key].numpy()[:, :live],
                                   np.asarray(blk_j[key])[:, :live], atol=1e-5)


def test_ring_decode_runs_the_plain_path_under_kernels(monkeypatch):
    """On a ring the dense decode kernel is not called even with
    ``use_kernels`` (the reference's route); the global layer's buffer takes
    it, and so does a local layer that appends."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.decode_attention
    monkeypatch.setattr(ops, "decode_attention",
                        lambda q, k, *a, **kw: calls.append((k.shape[1], kw["window"]))
                        or real(q, k, *a, **kw))
    _, cfg_t, _, pt = params()
    plan = ExecutionPlan(moe_impl="grouped", use_kernels=True)
    for max_len, want in ((32, [(32, 0)]), (6, [(7, WINDOW), (6, 0)])):
        calls.clear()
        cache = tmodel.init_cache(cfg_t, 2, max_len, device="cpu")
        tmodel.prefill(pt, cfg_t, {"tokens": T([[1, 2, 3], [4, 5, 6]])}, cache,
                       T([3, 2]), plan=plan)
        tmodel.decode_step(pt, cfg_t, T([[7], [8]]), cache, {}, plan=plan)
        assert calls == want


def _serve(make, request, **kw):
    rng = np.random.default_rng(0)
    # five prompts over two slots: 3 and 5 stay within the window, 12, 19
    # and 9 cross it in prefill, and decode wraps every ring
    prompts = [rng.integers(0, 256, n).tolist() for n in (12, 3, 19, 9, 5)]
    eng = make(max_slots=2, max_len=32, kv_layout="dense", use_kernels=True, **kw)
    reqs = [request(rid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, (6, 9, 4, 7, 5)))]
    eng.run(reqs)
    return eng, reqs


def assert_engines_agree(eng, reqs, ref, ref_reqs):
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert all(r.done for r in reqs)
    assert [(r.num_decode, r.num_prefill, r.stage_tokens, r.kv_bytes_streamed)
            for r in eng.reports] == [(r.num_decode, r.num_prefill, r.stage_tokens,
                                       r.kv_bytes_streamed) for r in ref.reports]
    assert eng.preemptions == ref.preemptions
    assert eng.kv.free_slots == ref.kv.free_slots


@pytest.mark.parametrize("preemption", ["none", "migrate"])
def test_engine_on_a_windowed_stack_emits_the_reference_tokens(preemption):
    """Legacy whole-prompt prefill into rings (max_len 32 > window 8), the
    decode over both slots with the kernels on (the global layer through
    the dense decode kernel's plain version here, Pallas in interpret mode
    there; the ring through the plain path in both): greedy tokens, stage
    composition, streamed KV bytes (the ring counted at 9 slots) and
    preemptions exactly as the reference engine's."""
    cfg_j, cfg_t, pj, pt = params()
    kw = dict(preemption=preemption)
    ref, ref_reqs = _serve(lambda **k: RefEngine(cfg_j, pj, **k), RefRequest, **kw)
    eng, reqs = _serve(lambda **k: ServingEngine(cfg_t, pt, device="cpu", **k), Request,
                       **kw)
    assert_engines_agree(eng, reqs, ref, ref_reqs)
    # 2 slots x 64 bytes a token and layer (K+V of 2 heads x 16, float32) x
    # (32 positions + the ring's 9 slots)
    assert eng._dense_kv_bytes_per_stage == 2 * 256 * (32 + WINDOW + 1)
    if preemption == "migrate":
        assert eng.preemptions > 0


def test_engine_refuses_what_the_reference_refuses():
    """A windowed stack: chunked prefill and speculative decoding raise
    NotImplementedError, the paged layout ValueError, in both packages."""
    cfg_j, cfg_t, pj, pt = params()
    base = dict(max_slots=2, max_len=32)
    for make in (lambda **k: RefEngine(cfg_j, pj, **k),
                 lambda **k: ServingEngine(cfg_t, pt, device="cpu", **k)):
        with pytest.raises(NotImplementedError, match="chunked prefill"):
            make(kv_layout="dense", prefill_chunk_tokens=16, **base)
        with pytest.raises(NotImplementedError, match="speculative decoding"):
            make(kv_layout="dense", spec_k=4, **base)
        with pytest.raises(ValueError, match="paged KV cache"):
            make(kv_layout="paged", kv_page_size=8, **base)
    assert not ServingEngine(cfg_t, pt, device="cpu", **base).paged


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_ring", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_path_l_launch_counts_match_the_smoke_gates(monkeypatch):
    """Path l's schedule on the CPU: its engine flags and requests on
    gemma3-4b's first period (5 local layers, 1 global; the schedule does
    not depend on the depth or the weights) at d_model 64 (2 heads of 32
    over 1 KV head: qpk 2, as gemma's), a 512-token vocabulary, float32.
    The schedule equals ``L_EXPECT``, and the dense decode kernel's wrapper
    runs once a decode stage in each global layer, the flash forward's once
    a layer in each legacy prefill whose bucket passes the 512-position q
    block: the card's gates (``L_EXPECT`` times gemma3-4b's 5 global and 34
    layers)."""
    from repro_torch.configs import resolve_config
    from repro_torch.configs.base import Segment
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_model
    smoke = _smoke()
    counts = {"decode_attention": 0, "flash_attention": 0}
    for name in counts:
        real = getattr(ops, name)

        def counting(*a, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, counting)
    full = resolve_config("gemma3-4b")
    period = full.segments[0].pattern
    cfg = dataclasses.replace(full, num_layers=len(period), segments=(Segment(period, 1),),
                              d_model=64, num_heads=2, num_kv_heads=1, head_dim=32, d_ff=64,
                              vocab_size=512, dtype="float32", param_dtype="float32")
    reqs = smoke.ring_requests(cfg)
    eng = smoke.ring_engine(cfg, init_model(cfg, seed=0, device="cpu"), device="cpu")
    eng.run(reqs)
    assert all(r.completed and len(r.output) == smoke.RING_NEW for r in reqs)
    got = smoke.ring_counters(eng)
    assert got == smoke.L_EXPECT
    assert counts == {"decode_attention": got["decode_stages"],
                      "flash_attention": got["long_prefill_stages"] * len(period)}
    assert sum(k.mixer == "attn" for k in full.layer_kinds()) == smoke.L_GLOBAL_LAYERS
    # the prompts over the window wrap their rings in prefill, 973 in decode
    lens = smoke.RING_LENS
    assert sum(n > full.sliding_window for n in lens) == 9
    assert [n for n in lens if n <= full.sliding_window < n + smoke.RING_NEW] == [973]
