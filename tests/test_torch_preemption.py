"""PyTorch port, preemption (``serving/preemption.py`` and the engine's
eviction paths) against the JAX package, on the reference's own scenario
(a 2-layer MoE, five 5-token prompts over two slots, 8 new tokens each)
and the same weights; host logic, so both engines run without kernels:

* migrate on the dense layout, recompute on the dense and the paged
  layouts: the reference engine's greedy tokens and ``preemptions`` count;
* a migrated slot's cache row comes back bit for bit (attention and Mamba
  leaves);
* ``pick_victim`` and ``pick_victim_paged`` choose as the reference's,
  and the scheduler's queue (priority bands, ``remove``,
  ``resubmit_preempted``) orders as the reference's;
* the no-thrash bound: preemptions stay at most the request count;
* the oversubscribed paged pool (9 pages for ~18 pages of demand), held to
  what the reference emits on that input. The reference's own tight-pool
  run departs from its full-pool run (``tests/test_preemption.py::
  test_paged_oversubscribed_pool_parity`` fails on it), so the port is held
  to the reference's tight run, not to the full pool; where the two runs
  part, request 3's token is a near-tie between 159 and 155 in both
  (logits under 2.5e-2 apart), once sampled from a decode row and once from
  a replayed prefill's last position.
"""
import jax
import numpy as np
import repro_torch.serving.engine as tengine
import pytest
import torch

from repro.configs.base import MoEConfig, small_test_config
from repro.models.model import init_model
from repro.serving import preemption as jpre
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.request import Request as RefRequest
from repro.serving.request import RequestState as RefState
from repro.serving.scheduler import ContinuousBatchingScheduler as RefScheduler
from repro_torch.configs import MoEConfig as TMoEConfig
from repro_torch.configs import SSMConfig as TSSMConfig
from repro_torch.configs import small_test_config as t_small_test_config
from repro_torch.serving import preemption as tpre
from repro_torch.models.params import from_numpy_tree
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kvmanager import KVManager
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import ContinuousBatchingScheduler

torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers


@pytest.fixture(scope="module")
def setup():
    cfg_j = small_test_config("pre-moe", family="moe", num_layers=2, d_model=64,
                              moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64))
    cfg_t = t_small_test_config("pre-moe", family="moe", num_layers=2, d_model=64,
                                moe=TMoEConfig(num_experts=4, top_k=2, d_ff_expert=64))
    pj = init_model(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg_t, pj, from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")


def _run(make, request, policy, n=5, slots=2, **kw):
    eng = make(max_slots=slots, max_len=64, preemption=policy, use_kernels=False, **kw)
    reqs = [request(rid=i, prompt=list(range(1, 6)), max_new_tokens=8) for i in range(n)]
    eng.run(reqs)
    return eng, reqs


@pytest.mark.parametrize("policy,kw", [
    ("migrate", dict(kv_layout="dense")),
    ("recompute", dict(kv_layout="dense")),
    ("recompute", dict(kv_layout="paged", kv_page_size=8)),
])
def test_preemption_matches_the_reference(setup, policy, kw):
    cfg_j, cfg_t, pj, pt = setup
    ref, ref_reqs = _run(lambda **k: RefEngine(cfg_j, pj, **k), RefRequest, policy, **kw)
    eng, reqs = _run(lambda **k: ServingEngine(cfg_t, pt, device="cpu", **k), Request,
                     policy, **kw)
    assert eng.preemptions > 0
    assert eng.preemptions == ref.preemptions
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert all(r.done and len(r.output) == 8 for r in reqs)
    assert [(r.num_decode, r.num_prefill) for r in eng.reports] == \
        [(r.num_decode, r.num_prefill) for r in ref.reports]
    assert eng.peak_active == ref.peak_active
    assert eng.kv.free_slots == 2 and eng.kv.live_pages == 0


def test_migrated_row_comes_back_bit_for_bit(setup):
    """gather_slot then restore_slot into another slot: every leaf's row
    equal bit for bit, for an attention stack and a Mamba stack."""
    _, cfg_t, _, _ = setup
    ssm = t_small_test_config("ssm", family="ssm", num_layers=2,
                              ssm=TSSMConfig(d_state=16, d_conv=4, expand=2, headdim=16,
                                             chunk_size=8))
    gen = torch.Generator().manual_seed(0)
    for cfg in (cfg_t, ssm):
        kv = KVManager(cfg, 3, 16, layout="dense", device="cpu")
        for leaf in [t for seg in kv.cache for blk in seg["blocks"]
                     for t in (blk["mamba"].values() if "mamba" in blk else blk.values())]:
            if leaf.is_floating_point():
                leaf.copy_(torch.randn(leaf.shape, generator=gen))
            else:
                leaf.copy_(torch.randint(0, 100, leaf.shape, generator=gen))
        req = Request(rid=0, prompt=[1], max_new_tokens=2, slot=kv.allocate(),
                      state=RequestState.DECODE)
        before = [t[:, req.slot].clone() for t in _leaves(kv.cache)]
        tpre.migrate_out(kv, req)
        for t in _leaves(kv.cache):              # the freed row is reused meanwhile
            t[:, 0].zero_()
        kv.allocate()
        slot = kv.allocate()
        tpre.restore_slot(kv, slot, req.saved_cache)
        for b, t in zip(before, _leaves(kv.cache)):
            assert torch.equal(b, t[:, slot])


def _leaves(cache):
    from repro_torch.models.params import tree_leaves
    return tree_leaves(cache)


def _victims(make, state, n_out, prio, arrival):
    rs = []
    for i, (n, p, a) in enumerate(zip(n_out, prio, arrival)):
        r = make(rid=i, prompt=[1], max_new_tokens=99, priority=p, arrival_time=a)
        r.state = state("decode" if i % 3 else "prefill")
        r.slot = i if i != 4 else -1
        r.output = list(range(n))
        rs.append(r)
    return rs


@pytest.mark.parametrize("seed", range(4))
def test_victim_choice_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = 7
    cols = (rng.integers(0, 4, n).tolist(), rng.integers(0, 2, n).tolist(),
            rng.integers(0, 3, n).astype(float).tolist())
    ref = _victims(RefRequest, lambda s: RefState(s), *cols)
    port = _victims(Request, lambda s: RequestState(s), *cols)
    for pick_j, pick_t in ((jpre.pick_victim, tpre.pick_victim),
                           (jpre.pick_victim_paged, tpre.pick_victim_paged)):
        for now in (None, 1.0):
            assert pick_t(port, now).rid == pick_j(ref, now).rid


def test_scheduler_queue_matches_the_reference():
    """Submits in three priority bands, a removal, and a preempted running
    request resubmitted behind the head: the same queue order, sequence
    numbers and prefill cursors in both packages."""
    kw = dict(max_prefill_seqs=2, prefill_chunk_tokens=4, max_prefill_target=64)
    out = []
    for sched, make in ((RefScheduler(**kw), RefRequest),
                        (ContinuousBatchingScheduler(max_prefill_tokens=64, **kw),
                         Request)):
        reqs = [make(rid=i, prompt=[1] * 5, max_new_tokens=4, priority=p)
                for i, p in enumerate((0, 1, 0, 2, 1, 0))]
        for r in reqs[:5]:
            sched.submit(r)
        sched.remove(reqs[2])
        sched.remove(reqs[2])                    # idempotent
        running = reqs[5]
        running.prefill_pos, running.prefill_target = 5, 5
        sched.running.append(running)
        sched.resubmit_preempted(running)
        out.append([(r.rid, r.queue_seq, r.prefill_pos, r.prefill_target, r.was_preempted)
                    for r in sched.queue] + [len(sched.running)])
    assert out[0] == out[1]


def test_no_thrash_between_preempted(setup):
    """A preempted queue head evicts no one: six requests over two slots all
    finish with at most one preemption each."""
    _, cfg_t, _, pt = setup
    eng, reqs = _run(lambda **k: ServingEngine(cfg_t, pt, device="cpu", **k), Request,
                     "recompute", n=6)
    assert all(r.done for r in reqs)
    assert 0 < eng.preemptions <= len(reqs)


def test_oversubscribed_pool_matches_the_reference_tight_run(setup):
    """Six 13-token prompts, 10 new tokens, chunk 16, page 8, four slots over
    9 pages (8 usable, demand ~18): page-granular recompute preemption
    completes everything, with the reference's outputs and preemptions on
    that pool."""
    cfg_j, cfg_t, pj, pt = setup

    def run(make, request):
        eng = make(max_slots=4, max_len=64, kv_layout="paged", kv_page_size=8,
                   kv_num_pages=9, preemption="recompute", prefill_chunk_tokens=16,
                   use_kernels=False)
        reqs = [request(rid=i, prompt=list(range(1, 14)), max_new_tokens=10)
                for i in range(6)]
        eng.run(reqs)
        return eng, reqs

    ref, ref_reqs = run(lambda **k: RefEngine(cfg_j, pj, **k), RefRequest)
    eng, reqs = run(lambda **k: ServingEngine(cfg_t, pt, device="cpu", **k), Request)
    assert eng.preemptions > 0 and eng.preemptions == ref.preemptions
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert all(r.done for r in reqs)
    assert eng.kv.live_pages == 0 and eng.kv.audit() == []


def test_oversubscribed_pool_departs_at_a_near_tie(setup, monkeypatch):
    """The full pool and the 9-page pool part at request 3's fifth token:
    on the full pool a decode row picks 159, whose logit leads 155's by
    under 2.5e-2; on the tight pool the last position of its replayed
    prefill picks 155, leading 159 by under 2.5e-2. Both margins are
    printed (``-s``)."""
    _, cfg_t, _, pt = setup
    seen = []
    sample = tengine.sample
    monkeypatch.setattr(tengine, "sample", lambda l, *a: seen.append(l) or sample(l, *a))
    picks = {}
    for pages, policy in ((None, "none"), (9, "recompute")):
        eng = ServingEngine(cfg_t, pt, device="cpu", max_slots=4, max_len=64,
                            kv_layout="paged", kv_page_size=8, kv_num_pages=pages,
                            preemption=policy, prefill_chunk_tokens=16, use_kernels=False)
        reqs = [Request(rid=i, prompt=list(range(1, 14)), max_new_tokens=10)
                for i in range(6)]
        for r in reqs:
            eng.submit(r)
        commit = eng._commit_critical

        def watch(fut, mat):
            decision = fut.plan.decision
            r3 = reqs[3]
            if len(r3.output) == 4:
                rows = [(seen[-2 if decision.chunks else -1], i)
                        for i, r in enumerate(decision.decoding) if r is r3]
                rows += [(seen[-1], i) for i, c in enumerate(decision.chunks)
                         if c.req is r3 and c.is_last]
                for logits, i in rows:
                    row = logits[i, 0]
                    picks[policy] = (row.argmax().item(), (row[159] - row[155]).item())
            return commit(fut, mat)

        eng._commit_critical = watch
        while eng.scheduler.has_work:
            eng.step()
    print(picks)
    assert picks["none"][0] == 159 and picks["recompute"][0] == 155
    assert 0 < picks["none"][1] < 2.5e-2 and -2.5e-2 < picks["recompute"][1] < 0


def test_engine_refuses_what_the_reference_refuses(setup):
    _, cfg_t, _, pt = setup
    with pytest.raises(NotImplementedError, match="recompute"):
        ServingEngine(cfg_t, pt, max_slots=2, max_len=64, kv_layout="paged",
                      preemption="migrate", device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(cfg_t, pt, max_slots=2, max_len=32, kv_layout="dense",
                      prefix_share=True, device="cpu")
