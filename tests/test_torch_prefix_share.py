"""PyTorch port, refcounted copy-on-write prefix sharing against the JAX
package:

* one op sequence (allocate, grow, register with its dedupe merge, match,
  pin, unpin, adopt, copy-on-write, free) applied to both packages'
  ``KVManager``s leaves equal block tables, lengths, refcounts, page lists,
  free heaps, prefix indexes, ``index_version``, ``dedup_merges``,
  ``cow_copies``, ``stats()``, ``page_need`` and ``audit()`` results
  after every op: a scripted
  sequence, seeded random ones, and a hypothesis property over random ones
  (the reference's ``test_refcount_invariants_property``; it runs where
  hypothesis is installed);
* ``_copy_page`` copies every pool leaf (int8 values and scales too);
* the engine with ``prefix_share=True`` against the reference engine, on
  the reference's scenarios (a shared 3-page prefix, a prompt shared whole
  whose last page is copied on write, whole-prompt spans): greedy tokens,
  ``shared_tokens_skipped``, ``cow_copies`` and per-stage streamed KV bytes
  and chunk tokens equal; host logic, so both run without kernels.
"""
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import MoEConfig, small_test_config
from repro.models.model import init_model
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.kvmanager import KVManager as RefKV
from repro.serving.request import Request as RefRequest
from repro_torch.configs import MoEConfig as TMoEConfig
from repro_torch.configs import small_test_config as t_small_test_config
from repro_torch.models.params import from_numpy_tree
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kvmanager import KVManager
from repro_torch.serving.request import Request

torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers


def _pair(num_pages, max_len=32, page=4, slots=4):
    ref = RefKV(small_test_config("tiny-dense"), slots, max_len, layout="paged",
                page_size=page, num_pages=num_pages)
    port = KVManager(t_small_test_config("tiny-dense"), slots, max_len, layout="paged",
                     page_size=page, num_pages=num_pages, device="cpu")
    return ref, port


def _state(kv):
    return dict(bt=kv.block_tables.tolist(), lens=kv.lens.tolist(),
                refs=dict(kv._page_refs), pages=dict(kv._slot_pages),
                free=sorted(kv._page_free), free_slots=sorted(kv._free),
                index=dict(kv._hash_page), keys=dict(kv._page_key),
                version=kv.index_version, merges=kv.dedup_merges, cow=kv.cow_copies,
                shared=kv.shared_pages, live=kv.live_pages, stats=kv.stats(),
                need={s: kv.page_need(s, 30) for s in sorted(kv._active)})


def _apply(kv, op, args, streams, pins):
    """One op on one manager; returns what it returned, or "exhausted"."""
    try:
        if op == "alloc":
            s = kv.allocate()
            streams[s] = list(args)
            return s
        if op == "grow":
            s, n = args
            return kv.ensure_len(s, n)
        if op == "register":
            s = args
            return kv.register_prefix(s, streams[s][:kv.slot_page_count(s) * kv.page_size])
        if op == "match":
            return kv.match_prefix(args)
        if op == "pin":
            pins.append(kv.pin_prefix(args))
            return pins[-1]
        if op == "unpin":
            return kv.unpin(pins.pop(args))
        if op == "share":                       # pin a slot's stream, adopt it anew
            s, tail = args
            t = kv.allocate()
            covered = kv.adopt_prefix(t, kv.pin_prefix(streams[s]))
            streams[t] = streams[s][:covered] + list(tail)[:len(streams[s]) - covered]
            return t, covered
        if op == "cow":
            s, start, end = args
            return kv.ensure_writable(s, start, end)
        if op == "setlen":
            s, n = args
            kv.lens[s] = n
            return None
        if op == "evict":
            del streams[args]
            return kv.free(args)
    except RuntimeError as e:
        assert "exhausted" in str(e)
        return "exhausted"
    raise AssertionError(op)


def _check_same(ops, num_pages):
    ref, port = _pair(num_pages)
    sr, sp, pr, pp = {}, {}, [], []
    for op, args in ops:
        got = _apply(port, op, args, sp, pp)
        want = _apply(ref, op, args, sr, pr)
        if isinstance(want, list):
            want = [int(x) for x in want]
        assert got == want, (op, args)
        assert _state(port) == _state(ref), (op, args)
        assert port.audit(pins=_pins(pp)) == ref.audit(pins=_pins(pr)), (op, args)
        assert pp == pr
    return ref, port, pr


def _pins(pins):
    out = {}
    for p in pins:
        for pid in p:
            out[pid] = out.get(pid, 0) + 1
    return out


def test_scripted_op_sequence_matches():
    """Register a slot's full pages, share them (pin + adopt), copy the
    last shared page on write, deindex the private copy by writing it again,
    merge a slot that computed three of the pages onto the indexed ones,
    copy a page shared three ways on write, pin a queued prefix, outlive its
    owners with the pin, then free everything."""
    toks = list(range(100, 120))                 # five pages of 4
    ops = [("alloc", toks), ("grow", (0, 20)), ("setlen", (0, 20)), ("register", 0),
           ("match", toks), ("match", toks[:9] + [999] + toks[10:]),
           ("share", (0, [7] * 20)), ("grow", (1, 20)), ("cow", (1, 19, 20)),
           ("cow", (1, 19, 20)), ("alloc", toks), ("grow", (2, 12)), ("register", 2),
           ("cow", (0, 0, 1)), ("match", toks), ("pin", toks[:12]), ("evict", 0),
           ("evict", 1), ("match", toks), ("evict", 2), ("unpin", 0), ("match", toks)]
    _, port, _ = _check_same(ops, num_pages=16)
    assert port.dedup_merges == 3 and port.cow_copies == 2
    assert port.live_pages == 0 and port.free_pages == 15


def _random_ops(rng, n_ops):
    ops, slots, n_pins = [], [], 0
    free = list(range(4))
    for _ in range(n_ops):
        op = ["alloc", "grow", "register", "share", "cow", "evict", "pin", "unpin",
              "match"][rng.integers(0, 9)]
        stream = rng.integers(0, 3, 32).tolist()        # few symbols: many matches
        if op == "alloc" and free:
            slots.append(free.pop(0))
            free.sort()
            ops.append(("alloc", stream))
        elif op == "grow" and slots:
            ops.append(("grow", (int(rng.choice(slots)), int(rng.integers(1, 33)))))
        elif op == "register" and slots:
            ops.append(("register", int(rng.choice(slots))))
        elif op == "share" and slots and free:
            ops.append(("share", (int(rng.choice(slots)), stream)))
            slots.append(free.pop(0))
            free.sort()
        elif op == "cow" and slots:
            end = int(rng.integers(1, 33))
            ops.append(("cow", (int(rng.choice(slots)), max(end - 3, 0), end)))
        elif op == "evict" and slots:
            s = int(rng.choice(slots))
            slots.remove(s)
            free.append(s)
            free.sort()
            ops.append(("evict", s))
        elif op == "pin":
            ops.append(("pin", stream))
            n_pins += 1
        elif op == "unpin" and n_pins:
            ops.append(("unpin", int(rng.integers(0, n_pins))))
            n_pins -= 1
        elif op == "match":
            ops.append(("match", stream))
    return ops


def _guard_cow(ops):
    """Drop copy-on-write ops past a slot's mapped pages (both managers would
    assert); the managers' own page counts decide, so replay on one."""
    kept = []
    ref, _ = _pair(12)
    streams, pins = {}, []
    for op, args in ops:
        if op == "cow" and args[2] > ref.slot_page_count(args[0]) * ref.page_size:
            continue
        _apply(ref, op, args, streams, pins)
        kept.append((op, args))
    return kept


@pytest.mark.parametrize("seed", range(6))
def test_random_op_sequences_match(seed):
    ops = _guard_cow(_random_ops(np.random.default_rng(seed), 60))
    _check_same(ops, num_pages=12)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 31), n_ops=st.integers(5, 60))
def test_random_op_sequences_match_property(seed, n_ops):
    ops = _guard_cow(_random_ops(np.random.default_rng(seed), n_ops))
    _, port, pins = _check_same(ops, num_pages=12)
    for s in list(port._active):
        port.free(s)
    for p in pins:
        port.unpin(p)
    assert port.audit(pins={}) == [] and port.free_pages == port.num_pages - 1


def test_copy_page_copies_every_leaf():
    cfg = t_small_test_config("tiny-dense")
    for kv_quant in (False, True):
        kv = KVManager(cfg, 2, 16, layout="paged", page_size=4, kv_quant=kv_quant,
                       device="cpu")
        leaves = [t for seg in kv.cache for blk in seg["blocks"] for t in blk.values()]
        for t in leaves:
            t.copy_(torch.randint(-100, 100, t.shape).to(t.dtype))
        kv._copy_page(3, 5)
        for t in leaves:
            assert torch.equal(t[:, 5], t[:, 3])
        assert len(leaves) == (4 if kv_quant else 2)


@pytest.fixture(scope="module")
def moe_setup():
    cfg_j = small_test_config("share-moe", family="moe", num_layers=2, d_model=64,
                              moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64))
    cfg_t = t_small_test_config("share-moe", family="moe", num_layers=2, d_model=64,
                                moe=TMoEConfig(num_experts=4, top_k=2, d_ff_expert=64))
    pj = init_model(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg_t, pj, from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")


def _serve(make, request, prompts, chunk, first_alone=False):
    eng = make(max_slots=4, max_len=64, kv_layout="paged", kv_page_size=8,
               prefix_share=True, prefill_chunk_tokens=chunk, use_kernels=False)
    reqs = [request(rid=i, prompt=list(p), max_new_tokens=6) for i, p in enumerate(prompts)]
    if first_alone:
        # whole-prompt spans share only once the donor is resident: the first
        # request prefills alone, then the others arrive
        eng.submit(reqs[0])
        eng.step()
    eng.run(reqs[1:] if first_alone else reqs)
    return eng, reqs


SYS = list(range(1, 25))                        # three full pages of 8


@pytest.mark.parametrize("prompts,chunk,first_alone", [
    ([SYS + [100 + i, 101 + i] for i in range(4)], 16, False),   # a shared prefix
    ([SYS] * 3, 16, False),                     # shared whole: the last page copies
    ([SYS[:16] + [100 + i] for i in range(3)], None, True),      # whole-prompt spans
], ids=["shared_prefix", "shared_whole_cow", "whole_prompt_spans"])
def test_engine_prefix_share_matches_the_reference(moe_setup, prompts, chunk, first_alone):
    cfg_j, cfg_t, pj, pt = moe_setup
    ref, ref_reqs = _serve(lambda **k: RefEngine(cfg_j, pj, **k), RefRequest, prompts,
                           chunk, first_alone)
    eng, reqs = _serve(lambda **k: ServingEngine(cfg_t, pt, device="cpu", **k), Request,
                       prompts, chunk, first_alone)
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert all(r.done for r in reqs)
    assert eng.shared_tokens_skipped > 0
    assert eng.shared_tokens_skipped == ref.shared_tokens_skipped
    assert eng.kv.cow_copies == ref.kv.cow_copies
    assert eng.kv.dedup_merges == ref.kv.dedup_merges
    assert [(r.kv_bytes_streamed, r.chunk_tokens, r.shared_kv_pages) for r in eng.reports] \
        == [(r.kv_bytes_streamed, r.chunk_tokens, r.shared_kv_pages) for r in ref.reports]
    assert eng.kv.live_pages == 0 and eng.kv.audit(pins={}) == []
