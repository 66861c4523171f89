"""PyTorch port, speculative decoding's parts against the JAX package's:

* ``NgramDrafter``: the reference's four scripted cases
  (``tests/test_spec_decode.py``), seeded streams of few symbols, and a
  hypothesis property over drawn streams (where hypothesis is installed);
* the scheduler's ``plan_stage(drafts=)`` and ``next_stage(drafts=)`` on one
  state: spans, their order, the prefill budgets they stay outside of, the
  stage mix, and ``commit_stage`` passing verify spans by;
* ``KVManager.rewind`` under one op sequence with prefix sharing (a shared
  page survives its rewind under its other owner, a private partial
  boundary page leaves the index), scripted and seeded: block tables,
  lengths, refcounts, the index, ``live_pages`` and ``audit()`` equal after
  every op; ``rewind_dense`` sets every attention block's length leaf;
* ``mixed_step(spec_tokens=True)`` on the paged and the dense layout with
  the duplex MoE (tiny-moe, float32, Pallas in interpret mode in the
  reference): ``chunk_argmax`` equal at every live position, the logits
  within 2e-5, and the 4-tuple unchanged without ``spec_tokens``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import MoEConfig, small_test_config
from repro.core.execution import ExecutionPlan as JPlan
from repro.core.execution import execution_plan
from repro.models import model as jmodel
from repro.serving.drafter import NgramDrafter as RefDrafter
from repro.serving.kvmanager import KVManager as RefKV
from repro.serving.request import Request as RefRequest
from repro.serving.scheduler import ContinuousBatchingScheduler as RefScheduler
from repro_torch.configs import resolve_config
from repro_torch.configs import small_test_config as t_small_test_config
from repro_torch.core.execution import ExecutionPlan
from repro_torch.models import model as tmodel
from repro_torch.models.params import from_numpy_tree
from repro_torch.serving.drafter import NgramDrafter
from repro_torch.serving.kvmanager import KVManager
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import ContinuousBatchingScheduler

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers


# ---- the drafter ------------------------------------------------------------------------
@pytest.mark.parametrize("k,ngram,stream,want", [
    (4, 3, [1], []),
    (4, 3, [1, 2, 3, 4], []),                              # all distinct: no earlier tail
    (2, 3, [8, 1, 7, 8, 9, 2, 7, 8], [9, 2]),               # the longer match wins
    (1, 1, [5, 1, 5, 2, 5], [2]),                           # the most recent match wins
    (5, 3, [9, 7, 7, 7, 7], [7] * 5),                       # period 1 fills k
    (5, 2, [1, 2, 1, 2, 1, 2], [1, 2, 1, 2, 1]),            # period 2
], ids=["short", "distinct", "longest", "recent", "period1", "period2"])
def test_drafter_scripted_cases(k, ngram, stream, want):
    assert NgramDrafter(k, ngram).draft(stream) == RefDrafter(k, ngram).draft(stream) == want


def _drafts_agree(stream, k, ngram):
    got = NgramDrafter(k, ngram).draft(stream)
    assert got == RefDrafter(k, ngram).draft(stream)
    assert len(got) in (0, k)
    return got


@pytest.mark.parametrize("seed", range(4))
def test_drafter_matches_the_reference_on_seeded_streams(seed):
    rng = np.random.default_rng(seed)
    proposed = 0
    for _ in range(200):
        stream = rng.integers(0, 4, int(rng.integers(0, 24))).tolist()
        proposed += bool(_drafts_agree(stream, int(rng.integers(1, 7)),
                                       int(rng.integers(1, 5))))
    assert proposed > 100


@settings(max_examples=200, deadline=None)
@given(stream=st.lists(st.integers(0, 5), max_size=30), k=st.integers(1, 8),
       ngram=st.integers(1, 5))
def test_drafter_matches_the_reference_property(stream, k, ngram):
    _drafts_agree(stream, k, ngram)


# ---- the scheduler ----------------------------------------------------------------------
def _sched_state(R, S):
    """Three decoding requests (rid 0-2), one prefilling (rid 3, at 6 of
    20), three queued; chunks of 16, two spans a stage."""
    s = S(max_prefill_seqs=2, prefill_chunk_tokens=16, max_prefill_target=64)
    reqs = [R(rid=i, prompt=list(range(1, 13 + i)), max_new_tokens=8) for i in range(7)]
    for r in reqs:
        s.submit(r)
    for r in reqs[:4]:
        s.queue.remove(r)
        r.prefill_target = r.prefill_pos = len(r.prompt)
    for r in reqs[:3]:
        r.state = type(r.state).DECODE
        r.output = [5, 6]
        s.running.append(r)
    reqs[3].state = type(reqs[3].state).PREFILL
    reqs[3].prefill_pos, reqs[3].prefill_target = 6, 20
    s.prefilling.append(reqs[3])
    return s, reqs


def _decision(d):
    return (None if d is None else
            ([(c.req.rid, c.start, c.end, c.first, c.target, c.draft, c.is_first, c.is_last,
               c.tokens) for c in d.chunks],
             [r.rid for r in d.decoding], [r.rid for r in d.restored],
             (d.mix().decode_ctx, d.mix().chunk_spans, d.mix().spec_spans,
              d.mix().num_tokens, d.mix().is_mixed)))


DRAFTS = [None, {0: (13, [7, 8, 9]), 2: (15, [4])}, {1: (14, [1, 2, 3, 4])}]


@pytest.mark.parametrize("drafts", DRAFTS, ids=["none", "two_rows", "one_row"])
@pytest.mark.parametrize("free", [0, 1, 3])
def test_plan_stage_with_drafts_matches_the_reference(free, drafts):
    """Verify spans ride after the prefill chunks, in decode order, each
    [start, start + len(draft) + 1), outside the two-span and 16-token
    budgets (the prefill spans are those of the undrafted plan); projected
    overrides too."""
    s, reqs = _sched_state(Request, ContinuousBatchingScheduler)
    rs, rreqs = _sched_state(RefRequest, RefScheduler)
    got, want = s.plan_stage(free, drafts=drafts), rs.plan_stage(free, drafts=drafts)
    assert _decision(got) == _decision(want)
    n_spec = len(drafts or {})
    assert sum(c.draft is not None for c in got.chunks) == n_spec
    plain = _decision(s.plan_stage(free))[0]
    assert [c for c in _decision(got)[0] if c[5] is None] == plain    # the prefill as without
    assert all(c[5] is not None for c in _decision(got)[0][len(plain):])
    kw = dict(prefilling=[reqs[3]], running=[reqs[0], reqs[2]], queue=list(s.queue),
              pos={3: 14})
    rkw = dict(prefilling=[rreqs[3]], running=[rreqs[0], rreqs[2]], queue=list(rs.queue),
               pos={3: 14})
    assert _decision(s.plan_stage(free, drafts=drafts, **kw)) == \
        _decision(rs.plan_stage(free, drafts=drafts, **rkw))


def test_next_stage_and_commit_skip_verify_spans():
    """``next_stage(drafts=)`` activates like the reference's; the commit
    advances the prefill and passes a verify span by (its request keeps its
    state, position and place in the decode set)."""
    out = []
    for R, S in ((Request, ContinuousBatchingScheduler), (RefRequest, RefScheduler)):
        s, reqs = _sched_state(R, S)
        d = s.next_stage(1, drafts=DRAFTS[1])
        s.commit_stage(d)
        out.append((_decision(d), [r.rid for r in s.running], [r.rid for r in s.prefilling],
                    [r.rid for r in s.queue], [(r.state.value, r.prefill_pos) for r in reqs],
                    dict(s.stage_counts)))
    assert out[0] == out[1]
    assert out[0][1][:3] == [0, 1, 2]
    assert out[0][4][0] == (RequestState.DECODE.value, 12)


# ---- the KV manager's rewinds -----------------------------------------------------------
def _pair(num_pages=16, max_len=32, page=4, slots=4):
    ref = RefKV(small_test_config("tiny-dense"), slots, max_len, layout="paged",
                page_size=page, num_pages=num_pages)
    port = KVManager(t_small_test_config("tiny-dense"), slots, max_len, layout="paged",
                     page_size=page, num_pages=num_pages, device="cpu")
    return ref, port


def _state(kv):
    return dict(bt=kv.block_tables.tolist(), lens=kv.lens.tolist(),
                refs=dict(kv._page_refs), pages={s: list(p) for s, p in kv._slot_pages.items()},
                free=sorted(kv._page_free), index=dict(kv._hash_page),
                keys=dict(kv._page_key), version=kv.index_version,
                shared=kv.shared_pages, live=kv.live_pages, stats=kv.stats())


def _apply(kv, op, args, streams):
    if op == "alloc":
        s = kv.allocate()
        streams[s] = list(args)
        return s
    if op == "grow":                   # a stage's write: pages, then the length
        s, n = args
        kv.ensure_len(s, n)
        kv.lens[s] = max(int(kv.lens[s]), n)
        return None
    if op == "register":
        return kv.register_prefix(args, streams[args][:int(kv.lens[args])])
    if op == "share":                  # pin a slot's stream and adopt it anew
        s = args
        t = kv.allocate()
        covered = kv.adopt_prefix(t, kv.pin_prefix(streams[s]))
        streams[t] = list(streams[s])
        kv.lens[t] = covered
        return t, covered
    if op == "cow":
        s, start, end = args
        return kv.ensure_writable(s, start, end)
    if op == "rewind":
        return kv.rewind(*args)
    if op == "free":
        del streams[args]
        return kv.free(args)
    raise AssertionError(op)


def _check_same(ops, num_pages=16):
    ref, port = _pair(num_pages)
    sr, sp = {}, {}
    for op, args in ops:
        assert _apply(port, op, args, sp) == _apply(ref, op, args, sr), (op, args)
        assert _state(port) == _state(ref), (op, args)
        assert port.audit(pins={}) == ref.audit(pins={}) == [], (op, args)
    return port


TOKS = list(range(100, 132))           # eight pages of 4


def test_rewind_scripted_sequence_with_sharing_matches():
    """Slot 0 writes 20 positions and indexes them; slot 1 adopts them.
    Slot 1 verifies a span into a fresh page and rewinds into the shared
    region (the shared pages survive under slot 0, indexed); slot 0 then
    rewinds to a partial boundary page it still shares (left alone), and,
    once slot 1 is gone, to a private partial one (de-indexed); then a
    rewind to 0 and frees drain the pool."""
    ops = [("alloc", TOKS), ("grow", (0, 20)), ("register", 0), ("share", 0),
           ("grow", (1, 25)), ("cow", (1, 20, 25)), ("rewind", (1, 18)),
           ("rewind", (0, 14)), ("free", 1), ("rewind", (0, 10)), ("grow", (0, 13)),
           ("rewind", (0, 0)), ("free", 0)]
    port = _check_same(ops)
    assert port.live_pages == 0 and port.free_pages == port.num_pages - 1


def test_rewind_keeps_a_shared_page_for_its_other_owner():
    ref, port = _pair()
    for kv in (ref, port):
        streams = {}
        for op, args in [("alloc", TOKS), ("grow", (0, 16)), ("register", 0), ("share", 0)]:
            _apply(kv, op, args, streams)
        shared = list(kv._slot_pages[1])
        assert kv.rewind(1, 5) == 2
        assert all(kv.page_ref(p) == 1 for p in shared[2:])         # slot 0's alone now
        assert kv.page_ref(shared[1]) == 2 and kv.match_prefix(TOKS[:16]) == shared
    assert _state(port) == _state(ref)


def _random_rewind_ops(rng, n_ops):
    """A seeded op sequence, each op drawn against the reference manager's
    state as it goes (lengths, free slots), so every op is valid; the pool
    holds every slot's full length, so none is exhausted."""
    ref, _ = _pair(num_pages=33)
    streams, ops = {}, []
    for _ in range(n_ops):
        op = ["alloc", "grow", "register", "share", "rewind", "rewind", "free"][
            rng.integers(0, 7)]
        slots = sorted(ref._active)
        if op in ("alloc", "share") and ref.free_slots == 0 or op != "alloc" and not slots:
            continue
        s = int(rng.choice(slots)) if slots else 0
        cur = int(ref.lens[s]) if slots else 0
        if op == "alloc":
            args = rng.integers(0, 3, 32).tolist()           # few symbols: many matches
        elif op == "grow":
            args = (s, min(cur + int(rng.integers(1, 9)), 32))
        elif op in ("register", "share", "free"):
            args = s
        else:
            args = (s, int(rng.integers(0, cur + 1)))
        _apply(ref, op, args, streams)
        ops.append((op, args))
        if op == "grow":                     # the write never lands in a shared page
            ops.append(("cow", (s, cur, args[1])))
            _apply(ref, *ops[-1], streams)
    return ops


@pytest.mark.parametrize("seed", range(6))
def test_rewind_random_op_sequences_match(seed):
    """Seeded sequences of allocations, writes (copy-on-write first, as the
    engine's), registrations, shares, rewinds and frees."""
    ops = _random_rewind_ops(np.random.default_rng(seed), 60)
    assert sum(op == "rewind" for op, _ in ops) > 5
    port = _check_same(ops, num_pages=33)
    for s in list(port._active):
        port.free(s)
    assert port.audit(pins={}) == [] and port.free_pages == port.num_pages - 1


def test_rewind_dense_sets_every_attention_length():
    cfg_j = small_test_config("tiny-dense")
    ref = RefKV(cfg_j, 4, 32, layout="dense")
    port = KVManager(t_small_test_config("tiny-dense"), 4, 32, layout="dense", device="cpu")
    lens = np.asarray([[9, 7, 12, 3]] * cfg_j.num_layers, np.int32)
    ref.cache = [dict(seg, blocks=tuple(dict(b, len=jnp.asarray(lens)) for b in seg["blocks"]))
                 for seg in ref.cache]
    for seg in port.cache:
        for b in seg["blocks"]:
            b["len"].copy_(torch.from_numpy(lens))
    ref.rewind_dense([2, 0], [5, 8])
    port.rewind_dense([2, 0], [5, 8])
    port.rewind_dense(torch.tensor([3], dtype=torch.int32), torch.tensor([1], dtype=torch.int32))
    ref.rewind_dense([3], [1])
    got = [b["len"].numpy() for seg in port.cache for b in seg["blocks"]]
    want = [np.asarray(b["len"]) for seg in ref.cache for b in seg["blocks"]]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, [[8, 7, 5, 1]] * cfg_j.num_layers)


# ---- mixed_step(spec_tokens=True) -------------------------------------------------------
def _configs():
    j = small_test_config("tiny-moe", family="moe",
                          moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=128))
    return dataclasses.replace(j, qk_norm=True), dataclasses.replace(
        resolve_config("tiny-moe"), qk_norm=True)


PLAN = dict(moe_impl="duplex", k_cold=4, c_hot=32, c_cold=16, moe_ragged=True,
            use_kernels=True)


def _random_caches(cfg_j, cfg_t, layout, rng, lens):
    """Both packages' caches holding the same random K/V (the dense layout:
    positions below each slot's length live, the rest empty)."""
    if layout == "paged":
        cache_j = jmodel.init_cache(cfg_j, 1, 32, paged=True, page_size=8, num_pages=16)
        cache_t = tmodel.init_cache(cfg_t, page_size=8, num_pages=16, device="cpu")
    else:
        cache_j = jmodel.init_cache(cfg_j, len(lens), 32)
        cache_t = tmodel.init_cache(cfg_t, len(lens), 32, device="cpu")
    out_j = []
    for seg_j, seg_t in zip(cache_j, cache_t):
        blocks = []
        for blk_j, blk_t in zip(seg_j["blocks"], seg_t["blocks"]):
            new = {}
            for name, t in blk_t.items():
                if name == "len":
                    a = np.broadcast_to(np.asarray(lens, np.int32), t.shape)
                elif name == "pos":
                    s = np.arange(t.shape[-1])
                    a = np.broadcast_to(np.where(s[None] < np.asarray(lens)[:, None], s[None],
                                                 2 ** 31 - 1).astype(np.int32), t.shape)
                else:
                    a = rng.standard_normal(t.shape).astype(np.float32)
                t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
                new[name] = jnp.asarray(a)
            blocks.append(new)
        out_j.append(dict(seg_j, blocks=tuple(blocks)))
    return out_j, cache_t


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_mixed_step_spec_tokens_matches_the_reference(layout):
    """One stage over a written cache (the same random K/V in both): a
    decode row at 16, two verify spans of 2 and 5 positions at unaligned
    starts (13 and 11), a fresh prefill chunk of 8 and a padded row.
    Kernels on (the port's plain versions here, Pallas in interpret mode
    there) with the ragged duplex MoE; without ``spec_tokens`` the 4-tuple
    is unchanged."""
    cfg_j, cfg_t = _configs()
    pj = jmodel.init_model(jax.random.PRNGKey(5), cfg_j)
    pt = from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    rng = np.random.default_rng(6)
    V, Sc = cfg_j.vocab_size, 8
    J, T = jnp.asarray, torch.tensor
    i32 = lambda a: np.asarray(a, np.int32)
    dtok = rng.integers(0, V, (4 if layout == "dense" else 1, 1)).astype(np.int32)
    ctok = rng.integers(0, V, (4, Sc)).astype(np.int32)
    if layout == "paged":
        cache_j, cache_t = _random_caches(cfg_j, cfg_t, layout, rng, None)
        bt = i32([[1, 2, 3, 0], [4, 5, 6, 0], [7, 8, 9, 0], [10, 11, 0, 0], [0, 0, 0, 0]])
        lens = i32([16])
        actx = {"lengths": lens, "block_tables": bt[2:3], "valid": lens > 0}
        cctx = dict(starts=i32([13, 11, 0, 0]), chunk_lens=i32([2, 5, 8, 0]),
                    block_tables=bt[[0, 1, 3, 4]])
        live_d = lens > 0
    else:
        cache_j, cache_t = _random_caches(cfg_j, cfg_t, layout, rng, [13, 11, 16, 0])
        live_d = np.asarray([False, False, True, False])
        actx = {"valid": live_d}
        cctx = dict(slots=i32([0, 1, 3, 0]), starts=i32([13, 11, 0, 0]),
                    chunk_lens=i32([2, 5, 8, 0]))
    with execution_plan(JPlan(**PLAN)):
        out_j = jax.jit(lambda p, d, c, cache, a, cc: jmodel.mixed_step(
            p, cfg_j, d, c, cache, attn_ctx=a, chunk_ctx=cc, spec_tokens=True))(
            pj, J(dtok), J(ctok), cache_j, {n: J(a) for n, a in actx.items()},
            {n: J(a) for n, a in cctx.items()})
    fresh = lambda c: [dict(seg, blocks=tuple({n: t.clone() for n, t in b.items()}
                                              for b in seg["blocks"])) for seg in c]
    plain = tmodel.mixed_step(pt, cfg_t, T(dtok), T(ctok), fresh(cache_t),
                              attn_ctx={n: T(a) for n, a in actx.items()},
                              chunk_ctx={n: T(a) for n, a in cctx.items()},
                              plan=ExecutionPlan(**PLAN))
    out_t = tmodel.mixed_step(pt, cfg_t, T(dtok), T(ctok), cache_t,
                              attn_ctx={n: T(a) for n, a in actx.items()},
                              chunk_ctx={n: T(a) for n, a in cctx.items()},
                              plan=ExecutionPlan(**PLAN), spec_tokens=True)
    assert len(out_t) == len(out_j) == 5 and len(plain) == 4
    for a, b in zip(plain, out_t):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    live_c = cctx["chunk_lens"] > 0
    np.testing.assert_allclose(out_t[0].numpy()[live_d], np.asarray(out_j[0])[live_d],
                               atol=2e-5)
    np.testing.assert_allclose(out_t[1].numpy()[live_c], np.asarray(out_j[1])[live_c],
                               atol=2e-5)
    np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
    am_t, am_j = out_t[4], np.asarray(out_j[4])
    assert am_t.dtype == torch.int32 and am_t.shape == (4, Sc)
    pos = np.arange(Sc)[None] < cctx["chunk_lens"][:, None]
    np.testing.assert_array_equal(am_t.numpy()[pos], am_j[pos])
