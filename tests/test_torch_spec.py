"""PyTorch port, speculative decoding in the engine, mirroring
``tests/test_spec_decode.py``:

* the port alone (``small_test_config("spec-test")``, a dense FFN, as the
  reference's parity tests): spec on against spec off on the dense, paged,
  paged int8 and paged prefix-sharing layouts, in ``run`` and (dense,
  sharing) ``run_async``: equal greedy tokens, drafts accepted and rejected
  tails rewound, no more stages, the pool drained with an empty audit;
  ``spec_k=6`` stops exactly at ``max_new_tokens``; the ``StageReport``
  counters sum to ``stats()``; ``on_token`` streams exactly the outputs in
  both loops; the greedy and hybrid refusals; EOS under ``run_async`` while
  the next stage is chained, and EOS inside a verify span;
* against the reference engine (same weights, both without kernels):
  greedy tokens, per-stage (decode rows, chunk rows, k_cold) and the
  ``spec_*`` counters equal on (a) the reference's stage-collapse traffic,
  paged, whose stage count the port must equal (the reference's own
  assertion that it falls fails: see ROADMAP queue 3 item 2), (b) its
  mixed traffic on the dense layout, (c) paged with sharing through
  ``run_async``, ``spec_miss_reasons`` too, and (d) the duplex MoE in
  float32, paged and chunked;
* path i of ``chip_smoke.py``: its engine flags and its requests on a
  narrow OLMoE (vocabulary cut to 1024) through the smoke's speculative
  runs, held to the smoke's own gates (``spec_gates``).
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig, small_test_config
from repro.models.model import init_model
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.request import Request as RefRequest
from repro_torch.configs import resolve_config
from repro_torch.configs import small_test_config as t_small_test_config
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.configs.base import SSMConfig
from repro_torch.models.params import from_numpy_tree
from repro_torch.models.params import init_model as t_init_model
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request
from repro_torch.serving.sampling import SamplingParams

torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers
ROOT = Path(__file__).resolve().parents[1]

FLAVORS = {
    "dense": dict(kv_layout="dense"),
    "paged": dict(kv_layout="paged", kv_page_size=8),
    "paged_int8": dict(kv_layout="paged", kv_page_size=8, kv_quant=True),
    "paged_prefix": dict(kv_layout="paged", kv_page_size=8, prefix_share=True),
}


@pytest.fixture(scope="module")
def port_model():
    cfg = t_small_test_config("spec-test")
    return cfg, t_init_model(cfg, seed=0, device="cpu")


@pytest.fixture(scope="module")
def both_models():
    cfg_j = small_test_config("spec-test")
    pj = init_model(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, t_small_test_config("spec-test"), pj, from_numpy_tree(
        jax.tree_util.tree_map(np.asarray, pj), "cpu")


def _mk_reqs(R, vocab, n=4, l_out=12, **kw):
    """The reference's traffic: cyclic prompts (drafts mostly accepted) and
    random ones (drafts rejected once the output repeats by chance)."""
    rng = np.random.default_rng(7)
    return [R(rid=i, prompt=([2 + i, 3, 4] * 4 if i % 2 == 0 else
                             rng.integers(1, vocab, 12).tolist()), max_new_tokens=l_out, **kw)
            for i in range(n)]


def _port(cfg, params, spec_k, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("use_duplex", False)
    return ServingEngine(cfg, params, use_kernels=False, spec_k=spec_k, audit_stages=True,
                         device="cpu", **kw)


def _run(eng, reqs, loop="run"):
    getattr(eng, loop)(reqs, max_stages=2000)
    assert all(r.done for r in reqs)
    assert eng.stats()["audit_violations"] == 0, eng.audit_log[:5]
    return {r.rid: list(r.output) for r in reqs}


def _drained(eng):
    return (eng.kv.free_slots == eng.kv.max_slots and eng.kv.live_pages == 0
            and eng.kv.audit(pins={}) == [])


# ---- the port alone ------------------------------------------------------------------
@pytest.mark.parametrize("loop,flavor", [("run", f) for f in sorted(FLAVORS)]
                         + [("run_async", "dense"), ("run_async", "paged_prefix")])
def test_spec_on_equals_spec_off(port_model, loop, flavor):
    cfg, pt = port_model
    out, engs = {}, {}
    for k in (0, 4):
        engs[k] = _port(cfg, pt, k, **FLAVORS[flavor])
        out[k] = _run(engs[k], _mk_reqs(Request, cfg.vocab_size), loop)
        assert _drained(engs[k])
    assert out[4] == out[0]
    st, st0 = engs[4].stats(), engs[0].stats()
    assert 0 < st["spec_accepted"] < st["spec_proposed"]
    assert st["spec_rewinds"] > 0                    # the reject path ran
    assert st["stages"] <= st0["stages"]
    assert st0["spec_proposed"] == st0["spec_rewinds"] == 0
    if loop == "run_async":
        reasons = st["spec_miss_reasons"]
        assert reasons.get("draft", 0) + reasons.get("rewind", 0) > 0


def test_exact_output_lengths_and_report_counters(port_model):
    cfg, pt = port_model
    eng = _port(cfg, pt, 6, **FLAVORS["paged"])
    reqs = _mk_reqs(Request, cfg.vocab_size)
    _run(eng, reqs)
    assert all(len(r.output) == r.max_new_tokens for r in reqs)
    st = eng.stats()
    assert sum(p.spec_proposed for p in eng.reports) == st["spec_proposed"] > 0
    assert sum(p.spec_accepted for p in eng.reports) == st["spec_accepted"] > 0
    assert st["spec_acceptance"] == pytest.approx(st["spec_accepted"] / st["spec_proposed"])
    assert st["delta"]["spec_proposed"] == st["spec_proposed"]
    eng.stats(reset=True)
    assert eng.stats()["delta"]["spec_accepted"] == 0


@pytest.mark.parametrize("loop", ["run", "run_async"])
def test_on_token_streams_exactly_the_outputs(port_model, loop):
    cfg, pt = port_model
    got = {}
    eng = _port(cfg, pt, 4, **FLAVORS["paged"],
                on_token=lambda rid, tok: got.setdefault(rid, []).append(tok))
    assert _run(eng, _mk_reqs(Request, cfg.vocab_size), loop) == got


def test_refusals(port_model):
    cfg, pt = port_model
    with pytest.raises(ValueError, match="greedy"):
        _port(cfg, pt, 4, sampling=SamplingParams(temperature=1.0))
    hybrid = t_small_test_config("spec-ssm", family="ssm", ssm=SSMConfig(
        d_state=16, d_conv=4, expand=2, headdim=16, chunk_size=8))
    with pytest.raises(NotImplementedError, match="full self-attention"):
        ServingEngine(hybrid, t_init_model(hybrid, seed=0, device="cpu"), max_slots=2,
                      max_len=32, spec_k=4, device="cpu")
    # without speculation a sampled engine builds and serves
    eng = _port(cfg, pt, 0, sampling=SamplingParams(temperature=1.0))
    reqs = _mk_reqs(Request, cfg.vocab_size, n=1)
    out = _run(eng, reqs)
    assert reqs[0].completed and all(0 <= t < cfg.vocab_size for t in out[0])


def test_eos_while_the_next_stage_is_chained(port_model):
    """Two slots, three requests, ``run_async``: request 0 stops at its
    EOS while the stage after it, already chained, carries its row, and the
    stage after that admits request 2 into the freed slot before the chained
    stage commits. Nobody else loses a slot: the others' tokens are the
    EOS-free run's, the audit stays empty after every stage, the pool
    drains."""
    cfg, pt = port_model
    kw = dict(max_slots=2, kv_layout="paged", kv_page_size=8)
    base = _run(_port(cfg, pt, 0, **kw), _mk_reqs(Request, cfg.vocab_size, n=3), "run_async")
    out = base[0]
    stop = next(i for i in range(3, len(out)) if out[i] not in out[:i])
    reqs = _mk_reqs(Request, cfg.vocab_size, n=3)
    reqs[0].eos_id = out[stop]
    eng = _port(cfg, pt, 0, **kw)
    seen = []
    dispatch, commit = eng.dispatch_stage, eng._commit_critical

    def dispatching(plan):
        fut = dispatch(plan)
        seen.append(("dispatch", plan.chain is not None, [r.rid for r in plan.decision.decoding],
                     [c.req.rid for c in plan.decision.chunks if c.first], fut))
        return fut

    def committing(fut, mat):
        commit(fut, mat)
        seen.append(("commit", fut, reqs[0].done))

    eng.dispatch_stage, eng._commit_critical = dispatching, committing
    got = _run(eng, reqs, "run_async")
    assert got[0] == out[:stop + 1] and reqs[0].finish_reason == "stop"
    assert got[1] == base[1] and got[2] == base[2]
    assert _drained(eng) and eng.stats()["chained_stages"] > 0
    # the commit that stopped request 0 came after a chained dispatch that
    # carried its row; request 2 was admitted before that stage committed
    i_stop = next(i for i, e in enumerate(seen) if e[0] == "commit" and e[2])
    chained = [e for e in seen[:i_stop] if e[0] == "dispatch"][-1]
    assert chained[1] and 0 in chained[2]
    later = [e for e in seen[i_stop:] if e[0] == "dispatch" and 2 in e[3]]
    commit_chained = next(i for i, e in enumerate(seen) if e[0] == "commit" and e[1] is chained[4])
    assert later and seen.index(later[0]) < commit_chained


@pytest.mark.parametrize("flavor", ["paged", "dense"])
def test_eos_inside_a_verify_span(port_model, flavor):
    """A verify span that commits several tokens, and EOS its first: the
    request stops there, the span's trailing accepts are dropped and the
    request retires with its slot (and pages) at that commit; the others
    keep the EOS-free run's tokens. This model's accepted drafts repeat
    tokens it has already emitted, so the EOS id is set just before that
    stage's commit (a request stops at the first EOS it commits)."""
    cfg, pt = port_model
    groups = []
    eng = _port(cfg, pt, 4, **FLAVORS[flavor],
                on_token=lambda rid, tok: groups.append((eng._stage_idx, rid, tok)))
    base = _run(eng, _mk_reqs(Request, cfg.vocab_size))
    by_stage, n_out = {}, {}
    for stage, rid, tok in groups:             # each token's position in its output
        by_stage.setdefault((stage, rid), []).append(n_out.get(rid, 0))
        n_out[rid] = n_out.get(rid, 0) + 1
    (stage, rid), pos = next((k, p) for k, p in by_stage.items() if len(p) >= 2)
    stop = pos[0]
    reqs = _mk_reqs(Request, cfg.vocab_size)
    eng2 = _port(cfg, pt, 4, **FLAVORS[flavor])
    commit, seen = eng2._commit_critical, []

    def committing(fut, mat):
        if eng2._stage_idx == stage:
            reqs[rid].eos_id = base[rid][stop]
        commit(fut, mat)
        if eng2._stage_idx == stage:
            r = reqs[rid]
            seen.append((r.done, len(r.output), eng2._slot_req.get(r.slot) is r,
                         eng2.kv.slot_page_count(r.slot) if eng2.paged else 0))

    eng2._commit_critical = committing
    got = _run(eng2, reqs)
    assert seen == [(True, stop + 1, False, 0)]
    assert got[rid] == base[rid][:stop + 1] and reqs[rid].finish_reason == "stop"
    assert all(got[r] == base[r] for r in got if r != rid)
    assert _drained(eng2)


# ---- against the reference engine ------------------------------------------------------
def _summary(eng, reqs):
    st = eng.stats()
    return dict(tokens=[list(r.output) for r in reqs],
                stages=[(p.num_decode, p.num_prefill, p.k_cold, p.spec_proposed, p.spec_accepted)
                        for p in eng.reports],
                counters={k: st[k] for k in ("stages", "spec_proposed", "spec_accepted",
                                             "spec_rewinds", "spec_hits", "spec_misses",
                                             "spec_miss_reasons", "chained_stages")})


def _both(cfg_j, cfg_t, pj, pt, reqs_fn, loop="run", **kw):
    ref = RefEngine(cfg_j, pj, max_slots=4, max_len=64, spec_k=4, audit_stages=True, **kw)
    ref_reqs = reqs_fn(RefRequest, cfg_j.vocab_size)
    getattr(ref, loop)(ref_reqs, max_stages=2000)
    eng = _port(cfg_t, pt, 4, **kw)
    reqs = reqs_fn(Request, cfg_t.vocab_size)
    _run(eng, reqs, loop)
    got = _summary(eng, reqs)
    assert got == _summary(ref, ref_reqs)
    assert got["counters"]["spec_proposed"] > 0 and _drained(eng)
    return got


COLLAPSE = [[2 + i, 3, 4] * 4 for i in range(4)]
# what the reference emits on its collapse scenario: spec on and off both in
# 12 stages (its assertion that the count falls fails; ROADMAP queue 3 item 2)
COLLAPSE_STAGES = 12


def test_collapse_traffic_matches_the_reference(both_models):
    cfg_j, cfg_t, pj, pt = both_models
    got = _both(cfg_j, cfg_t, pj, pt, lambda R, v: [
        R(rid=i, prompt=list(p), max_new_tokens=12) for i, p in enumerate(COLLAPSE)],
        use_duplex=False, kv_layout="paged", kv_page_size=8)
    assert got["counters"]["stages"] == COLLAPSE_STAGES
    off = _port(cfg_t, pt, 0, kv_layout="paged", kv_page_size=8)
    reqs = [Request(rid=i, prompt=list(p), max_new_tokens=12) for i, p in enumerate(COLLAPSE)]
    assert list(_run(off, reqs).values()) == got["tokens"]
    assert off.stats()["stages"] == COLLAPSE_STAGES


def test_mixed_traffic_dense_matches_the_reference(both_models):
    cfg_j, cfg_t, pj, pt = both_models
    got = _both(cfg_j, cfg_t, pj, pt, _mk_reqs, use_duplex=False, kv_layout="dense")
    assert got["counters"]["spec_rewinds"] > 0


def test_prefix_share_run_async_matches_the_reference(both_models):
    cfg_j, cfg_t, pj, pt = both_models
    got = _both(cfg_j, cfg_t, pj, pt, _mk_reqs, loop="run_async", use_duplex=False,
                **FLAVORS["paged_prefix"])
    reasons = got["counters"]["spec_miss_reasons"]
    assert reasons.get("draft", 0) > 0 and reasons.get("rewind", 0) > 0


def test_duplex_moe_chunked_matches_the_reference():
    moe = dict(num_experts=4, top_k=2, d_ff_expert=64)
    cfg_j = small_test_config("spec-moe", family="moe", num_layers=2, d_model=64,
                              moe=MoEConfig(**moe))
    cfg_t = t_small_test_config("spec-moe", family="moe", num_layers=2, d_model=64,
                                moe=TMoEConfig(**moe))
    pj = init_model(jax.random.PRNGKey(0), cfg_j)
    pt = from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    got = _both(cfg_j, cfg_t, pj, pt, lambda R, v: _mk_reqs(R, v, l_out=6), use_duplex=True,
                kv_layout="paged", kv_page_size=8, prefill_chunk_tokens=16)
    assert any(s[2] > 0 for s in got["stages"])              # the duplex split ran


# ---- path i's gates ---------------------------------------------------------------------
def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_i", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_path_i_runs_pass_the_smoke_gates():
    """Path i's engine flags (``SPEC_KW``), requests (``spec_requests``) and
    its two speculative runs (``SPEC_RUNS``: spec_k 4 through ``run`` and
    ``run_async``) on a narrow OLMoE (2 layers, d_model 64, 64 experts
    top-8, vocabulary 1024), each held to ``spec_gates``; stages with a
    prefill chunk carry verify spans too."""
    from repro_torch.configs.base import ATTN, MOE, LayerKind, Segment
    sm = _smoke()
    full = resolve_config("olmoe-1b-7b")
    cfg = dataclasses.replace(
        full, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=32,
        vocab_size=1024, segments=(Segment((LayerKind(ATTN, MOE),), 2),),
        moe=dataclasses.replace(full.moe, d_ff_expert=32), dtype="float32",
        param_dtype="float32").validate()
    params = t_init_model(cfg, seed=0, device="cpu")
    assert [(k, loop) for k, loop in sm.SPEC_RUNS] == [(0, "sync"), (4, "sync"), (4, "async")]
    for spec_k, loop in sm.SPEC_RUNS[1:]:
        reqs = sm.spec_requests(cfg)
        assert len(reqs) == 16 and all(len(set(r.prompt)) <= 8 for r in reqs[8:])
        streamed = {}
        eng = ServingEngine(cfg, params, device="cpu", **dict(sm.SPEC_KW, spec_k=spec_k),
                            on_token=lambda rid, tok: streamed.setdefault(rid, []).append(tok))
        (eng.run_async if loop == "async" else eng.run)(reqs)
        assert sm.spec_gates(eng, reqs, loop, streamed) == []
        assert sum(p.spec_proposed for p in eng.reports if p.num_prefill) > 0
