"""PyTorch port, chaos invariants under the seeded fault injector, mirroring
``tests/test_chaos.py``:

* the port's ``FaultInjector`` (its own copy, numpy only) draws the
  reference's sequence and counts for seeds 0-4, forks and backoffs too;
* an injected page fault leaves the ``KVManager`` as it was
  (``audit(pins={})`` empty), and the audit detects five planted
  violations;
* the soak (paged, prefix sharing, recompute preemption over an
  oversubscribed pool, chunks of 8) under page-allocation failures, forced
  evictions, latency spikes and step errors, seeds 0-2 on the port: every
  request completes with the greedy tokens of the port's fault-free run, no
  audit violation, the pool drains. For seed 0 the port's tokens, counters,
  stage reports and fault counts also equal the reference engine's on the
  same run (the same weights; both without kernels);
* the random submit/step/cancel/fault schedule with an audit after every
  stage, on the port alone, once for each of the six layout x sharing x
  preemption combinations and as a hypothesis property.

* speculative verify spans under chaos (the reference's
  ``test_chaos_spec_spans_parity_and_seed_reproducibility``, on the port
  alone): a span rides its stage's single fault draw, so injected faults
  change no committed token of the fault-free speculative run and a fixed
  seed replays fault for fault.
"""
import heapq

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.base import small_test_config
from repro.models.model import init_model
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.faults import FaultInjector as RefInjector
from repro.serving.request import Request as RefRequest
from repro_torch.configs import small_test_config as t_small_test_config
from repro_torch.models.params import from_numpy_tree
from repro_torch.models.params import init_model as t_init_model
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import FaultInjector, InjectedPageFault
from repro_torch.serving.kvmanager import KVManager
from repro_torch.serving.request import Request

torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers

SOAK_FAULTS = dict(p_page_alloc_fail=0.05, p_forced_evict=0.08, p_step_error=0.05,
                   p_latency_spike=0.05, max_retries=4)


@pytest.fixture(scope="module")
def setup():
    cfg_j = small_test_config("chaos-test")
    cfg_t = t_small_test_config("chaos-test")
    pj = init_model(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg_t, pj, from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")


# ---- the injector ---------------------------------------------------------------
@pytest.mark.parametrize("seed", range(5))
def test_injector_draws_the_reference_sequence(seed):
    probs = dict(p_page_alloc_fail=0.3, p_step_error=0.3, p_forced_evict=0.3,
                 p_latency_spike=0.3, p_replica_kill=0.1, p_replica_spike=0.2,
                 backoff_s=0.01)
    a, b = RefInjector(seed, **probs), FaultInjector(seed, **probs)
    order = np.random.default_rng(100 + seed).integers(0, 6, 400)

    def draws(inj):
        calls = (inj.page_alloc_fails, inj.step_error, inj.forced_eviction,
                 inj.latency_spike, inj.replica_kill, inj.replica_spike)
        return [calls[i]() for i in order]
    assert draws(b) == draws(a)
    assert b.counts == a.counts and b.total_faults == a.total_faults > 0
    assert [b.backoff(n) for n in range(4)] == [a.backoff(n) for n in range(4)]
    fa, fb = a.fork(3), b.fork(3)
    assert fb.seed == fa.seed
    assert [fb.step_error() for _ in range(50)] == [fa.step_error() for _ in range(50)]


def test_injected_page_fault_leaves_the_manager_clean(setup):
    _, cfg, _, _ = setup
    inj = FaultInjector(0, p_page_alloc_fail=1.0, p_step_error=0.0, p_forced_evict=0.0,
                        p_latency_spike=0.0)
    kv = KVManager(cfg, 2, 32, layout="paged", page_size=8, injector=inj, device="cpu")
    slot = kv.allocate()
    with pytest.raises(InjectedPageFault):
        kv.ensure_len(slot, 8)
    assert inj.counts["page_alloc_fail"] == 1
    assert kv.audit(pins={}) == [] and kv.live_pages == 0


def test_audit_detects_planted_violations(setup):
    _, cfg, _, _ = setup

    def fresh():
        kv = KVManager(cfg, 2, 32, layout="paged", page_size=8, device="cpu")
        slot = kv.allocate()
        kv.ensure_len(slot, 16)
        assert kv.audit(pins={}) == []
        return kv, slot

    kv, slot = fresh()               # a leaked pin: a phantom reference
    kv._page_refs[kv._slot_pages[slot][0]] += 1
    assert any("leaked pin" in e for e in kv.audit(pins={}))
    kv, slot = fresh()               # a block table out of step with the page list
    kv.block_tables[slot, 0] = 0
    assert any("desynced" in e for e in kv.audit(pins={}))
    kv, slot = fresh()               # a page both free and allocated
    heapq.heappush(kv._page_free, kv._slot_pages[slot][1])
    assert any("both free and allocated" in e for e in kv.audit(pins={}))
    kv, slot = fresh()               # a length beyond the mapped pages
    kv.lens[slot] = 99
    assert any("exceeds" in e for e in kv.audit(pins={}))
    kv, slot = fresh()               # the index pointing at a free page
    kv._hash_page[1234] = kv.num_pages - 1
    assert any("free page" in e or "asymmetry" in e for e in kv.audit(pins={}))


# ---- the soak ---------------------------------------------------------------------
def _soak_requests(R, vocab, page_size=8, n=8, l_out=5):
    rng = np.random.default_rng(42)
    sys_prefix = rng.integers(0, vocab, 2 * page_size).tolist()
    reqs = []
    for i in range(n):
        tail = rng.integers(0, vocab, page_size // 2 + i).tolist()
        prompt = (sys_prefix + tail if i % 4 != 3
                  else rng.integers(0, vocab, 2 * page_size + 3).tolist())
        reqs.append(R(rid=i, prompt=prompt, max_new_tokens=l_out))
    return reqs


SOAK_KW = dict(max_slots=4, max_len=64, use_duplex=False, kv_layout="paged",
               kv_page_size=8, kv_num_pages=1 + 20, prefix_share=True,
               preemption="recompute", prefill_chunk_tokens=8)


def _soak(make, R, vocab, injector):
    eng = make(injector=injector, **SOAK_KW)
    reqs = _soak_requests(R, vocab)
    eng.run(reqs, max_stages=2000, stall_stages=1000)
    return eng, reqs


@pytest.fixture(scope="module")
def fault_free(setup):
    _, cfg, _, pt = setup
    eng, reqs = _soak(lambda **k: ServingEngine(cfg, pt, use_kernels=False, device="cpu",
                                                **k), Request, cfg.vocab_size, None)
    assert all(r.completed for r in reqs)
    return {r.rid: list(r.output) for r in reqs}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_soak_parity_and_clean_drain(setup, fault_free, seed):
    cfg_j, cfg, pj, pt = setup
    inj = FaultInjector(seed, **SOAK_FAULTS)
    eng, reqs = _soak(lambda **k: ServingEngine(cfg, pt, use_kernels=False, device="cpu",
                                                **k), Request, cfg.vocab_size, inj)
    assert all(r.completed for r in reqs)
    # faults reorder and replay work; they never change a greedy token
    assert {r.rid: list(r.output) for r in reqs} == fault_free
    st_ = eng.stats()
    assert st_["audit_violations"] == 0, eng.audit_log[:5]
    assert eng.kv.audit(pins={}) == [] and eng.kv.live_pages == 0
    assert eng.kv.free_slots == eng.kv.max_slots
    assert inj.total_faults > 0, "the chaos run drew no faults"
    if seed:
        return
    assert st_["stage_aborts"] > 0        # the abort path ran
    # seed 0: the reference engine on the same run draws the same schedule
    ref_inj = RefInjector(seed, **SOAK_FAULTS)
    ref, ref_reqs = _soak(lambda **k: RefEngine(cfg_j, pj, **k), RefRequest,
                          cfg_j.vocab_size, ref_inj)
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    ref_st = ref.stats()
    assert {k: st_[k] for k in ServingEngine.STATS_DELTA_KEYS} == \
        {k: ref_st[k] for k in ServingEngine.STATS_DELTA_KEYS}
    assert st_["fault_counts"] == ref_st["fault_counts"] == ref_inj.counts
    rep = lambda e: [(p.num_decode, p.num_prefill, p.aborted, p.retries,
                      p.kv_bytes_streamed) for p in e.reports]
    assert rep(eng) == rep(ref)


# ---- random submit/step/cancel/fault schedules ------------------------------------
_COMBOS = [
    ("dense", False, "none"),
    ("dense", False, "migrate"),
    ("paged", False, "none"),
    ("paged", False, "recompute"),
    ("paged", True, "none"),
    ("paged", True, "recompute"),
]


def _random_ops(cfg, params, seed, combo):
    """A random submit/step/cancel/fault schedule with an audit after every
    stage (the reference's, on the port); returns the engine."""
    rng = np.random.default_rng(seed)
    layout, share, preemption = _COMBOS[combo]
    inj = (FaultInjector(seed, p_page_alloc_fail=0.04, p_forced_evict=0.05,
                         p_step_error=0.04, p_latency_spike=0.05)
           if rng.random() < 0.7 else None)
    eng = ServingEngine(
        cfg, params, max_slots=3, max_len=32, use_duplex=False, use_kernels=False,
        device="cpu", kv_layout=layout, kv_page_size=8,
        kv_num_pages=(1 + 10 if (layout == "paged" and preemption == "recompute")
                      else None),
        prefix_share=share, preemption=preemption,
        prefill_chunk_tokens=8 if layout == "paged" else None,
        queue_cap=4, overload_policy="shed-oldest", injector=inj, audit_stages=True)
    prefix = rng.integers(0, cfg.vocab_size, 8).tolist()
    t = 0.0
    rid = 0
    for _ in range(int(rng.integers(15, 30))):
        op = rng.random()
        if op < 0.45:
            tail = rng.integers(0, cfg.vocab_size, int(rng.integers(2, 12))).tolist()
            prompt = (prefix + tail) if rng.random() < 0.5 else tail
            req = Request(rid=rid, prompt=prompt, max_new_tokens=int(rng.integers(1, 5)),
                          arrival_time=t,
                          deadline=(t + float(rng.integers(3, 30))
                                    if rng.random() < 0.3 else None))
            rid += 1
            eng.submit(req, now=t)       # queue_cap=4 sheds, never raises
        elif op < 0.6 and rid:
            eng.cancel(int(rng.integers(rid)), now=t)
        else:
            eng.step(now=t)
            t += 1.0
    for _ in range(300):
        if eng.step(now=t) is None and not eng.scheduler.has_work:
            break
        t += 1.0
    assert not eng.scheduler.has_work
    assert eng.stats()["audit_violations"] == 0, eng.audit_log[:5]
    if eng.paged:
        assert eng.kv.live_pages == 0 and eng.kv.audit(pins={}) == []
    assert eng.kv.free_slots == eng.kv.max_slots
    assert all(r.done for r in eng._requests.values())
    return eng


@pytest.mark.parametrize("combo", range(len(_COMBOS)))
def test_random_ops_deterministic_twin(setup, combo):
    _, cfg, _, pt = setup
    _random_ops(cfg, pt, combo, combo)


@settings(max_examples=15, deadline=None)
@given(st.integers(min_value=0, max_value=10_000),
       st.integers(min_value=0, max_value=len(_COMBOS) - 1))
def test_random_ops_property(seed, combo):
    cfg = t_small_test_config("chaos-prop")
    _random_ops(cfg, t_init_model(cfg, seed=0, device="cpu"), seed, combo)


# ---- speculative verify spans under chaos ---------------------------------------
def test_chaos_spec_spans_parity_and_seed_reproducibility(setup):
    """Repetitive prompts so the drafter proposes; paged, sharing, recompute,
    chunks of 8, spec_k 4, the reference's ``FaultInjector(1, ...)``: every
    request completes with the fault-free speculative run's tokens, the
    audit is empty after every stage and the pool drains, and a second run
    of the same seed draws the same faults over the same stages."""
    _, cfg, _, pt = setup
    prompts = [[3 + i % 2, 4, 5] * 5 for i in range(4)]

    def run(injector):
        eng = ServingEngine(cfg, pt, max_slots=4, max_len=64, use_duplex=False,
                            use_kernels=False, kv_layout="paged", kv_page_size=8,
                            prefix_share=True, preemption="recompute", prefill_chunk_tokens=8,
                            spec_k=4, injector=injector, audit_stages=True, device="cpu")
        reqs = [Request(rid=i, prompt=list(p), max_new_tokens=8) for i, p in enumerate(prompts)]
        eng.run(reqs, max_stages=2000, stall_stages=1000)
        assert all(r.completed for r in reqs)
        assert eng.stats()["audit_violations"] == 0, eng.audit_log[:5]
        assert eng.kv.audit(pins={}) == [] and eng.kv.live_pages == 0
        return eng, {r.rid: list(r.output) for r in reqs}

    base, expect = run(None)
    assert base.stats()["spec_accepted"] > 0                 # spans flew

    def inj():
        return FaultInjector(1, p_page_alloc_fail=0.04, p_forced_evict=0.05,
                             p_step_error=0.06, p_latency_spike=0.06, max_retries=4)

    ia = inj()
    ea, outs_a = run(ia)
    assert outs_a == expect                                  # greedy parity under faults
    assert ia.total_faults > 0 and ea.stats()["spec_proposed"] > 0
    ib = inj()
    eb, outs_b = run(ib)
    assert outs_b == outs_a and ib.counts == ia.counts
    assert eb.stats()["stages"] == ea.stats()["stages"]
    assert [(p.num_decode, p.num_prefill, p.aborted, p.spec_proposed, p.spec_accepted)
            for p in eb.reports] == [(p.num_decode, p.num_prefill, p.aborted, p.spec_proposed,
                                      p.spec_accepted) for p in ea.reports]
