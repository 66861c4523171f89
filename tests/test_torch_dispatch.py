"""PyTorch port, the Op/B dispatch model and sampling at a temperature:

* ``core/opb.py``'s cost functions and ``core/dispatch.py``'s
  ``plan_stage`` against the reference's, on tiny-moe, tiny-dense, a
  windowed tiny stack, OLMoE-1B-7B, Jamba-v0.1, gemma3-4b, qwen3-8b,
  command-r-35b, mistral-large-123b and mamba2-2.7b (each package's own
  config), over decode-only, whole-prompt, chunk-span and verify-span
  mixes and contexts past gemma3-4b's window, with ``kv_quant`` off and on and with per-expert ``counts`` given
  and not: every component's name, FLOPs, bytes, Op/B and path, the
  bandwidth fraction and ``describe_plan``'s text;
* one paged, chunked engine run on tiny-moe through both engines (the
  reference without kernels): every stage's ``bandwidth_flop_fraction``
  and ``k_cold``;
* ``sample`` at a temperature, with top-k and top-p, against the
  reference's: the tokens it can draw and, by a chi-square test, the
  frequencies of the masked softmax; the engine's draws reproducible from
  its seed, greedy unchanged.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.configs import base as ref_base
from repro.configs.registry import get_config
from repro.core import dispatch as ref_dispatch
from repro.core import opb as ref_opb
from repro.core.costmodel import DUPLEX as REF_DUPLEX
from repro.models.model import init_model
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.request import Request as RefRequest
from repro.serving.sampling import SamplingParams as RefSampling
from repro.serving.sampling import sample as ref_sample
from repro_torch.configs import base as t_base
from repro_torch.configs import resolve_config
from repro_torch.core import dispatch
from repro_torch.core import opb
from repro_torch.core.costmodel import DUPLEX
from repro_torch.models.params import from_numpy_tree
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request
from repro_torch.serving.sampling import SamplingParams, sample

torch.set_num_threads(1)   # tiny shapes; leave the cores to the other test workers
REL = 1e-12


def _windowed(base):
    """A tiny stack of a sliding-window layer then a global one (the
    windowed cost branches), built in either package."""
    kinds = (base.LayerKind(base.ATTN_LOCAL, base.DENSE), base.LayerKind(base.ATTN, base.DENSE))
    return base.ModelConfig(
        name="tiny-window", family="dense", num_layers=4, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=256, segments=(base.Segment(kinds, 2),),
        sliding_window=8, dtype="float32", param_dtype="float32").validate()


def _configs():
    """(name, reference config, port config)."""
    from repro.launch.train import resolve_config as ref_resolve
    out = [(n, ref_resolve(n, False), resolve_config(n)) for n in ("tiny-moe", "tiny-dense")]
    out.append(("tiny-window", _windowed(ref_base), _windowed(t_base)))
    out += [(n, get_config(n), resolve_config(n))
            for n in ("olmoe-1b-7b", "jamba-v0.1-52b", "gemma3-4b", "qwen3-8b", "command-r-35b",
                      "mistral-large-123b", "mamba2-2.7b")]
    return out


CONFIGS = _configs()


def _mixes():
    """(label, keyword arguments of StageMix)."""
    return [
        ("decode", dict(decode_ctx=(17, 130, 511, 1024))),
        ("prefill", dict(decode_ctx=(40, 9), prefill_len=(64, 300))),
        ("chunks", dict(decode_ctx=(33,), chunk_spans=((0, 64), (448, 512), (5, 6)))),
        ("verify", dict(decode_ctx=(200, 77), spec_spans=((145, 150), (300, 302)))),
        ("all", dict(decode_ctx=(3,), prefill_len=(12,), chunk_spans=((16, 80),),
                     spec_spans=((90, 94),))),
        ("decode1", dict(decode_ctx=(1,))),
        # contexts past gemma3-4b's 1024-position window
        ("long", dict(decode_ctx=(1023, 1025, 2080, 4096), prefill_len=(2048,))),
    ]


def _close(a, b):
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


def _same_cost(a, b):
    assert a.name == b.name
    for f in ("flops", "weight_bytes", "act_bytes", "bytes", "opb"):
        assert _close(getattr(a, f), getattr(b, f)), (a.name, f, getattr(a, f), getattr(b, f))


def _counts(cfg, seed):
    if cfg.moe is None:
        return None
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 40, cfg.moe.num_experts)
    c[::5] = 0                                  # unselected experts are skipped
    return [int(x) for x in c]


@pytest.mark.parametrize("name,ref_cfg,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_costs_and_plans_match_the_reference(name, ref_cfg, cfg):
    for label, kw in _mixes():
        mix, ref_mix = opb.StageMix(**kw), ref_opb.StageMix(**kw)
        assert (mix.is_mixed, mix.num_tokens, mix.batch_size) == \
            (ref_mix.is_mixed, ref_mix.num_tokens, ref_mix.batch_size)
        for kv_quant in (False, True):
            for counts in (None, _counts(cfg, len(label))):
                ctx = (name, label, kv_quant, counts is not None)
                seen = set()
                for kind, ref_kind in zip(cfg.layer_kinds(), ref_cfg.layer_kinds()):
                    assert (kind.mixer, kind.ffn) == (ref_kind.mixer, ref_kind.ffn)
                    if kind in seen:
                        continue
                    seen.add(kind)
                    got = opb.layer_stage_cost(cfg, kind, mix, counts, kv_quant=kv_quant)
                    want = ref_opb.layer_stage_cost(ref_cfg, ref_kind, ref_mix, counts,
                                                    kv_quant=kv_quant)
                    assert len(got.components) == len(want.components), ctx
                    for a, b in zip(got.components, want.components):
                        _same_cost(a, b)
                    _same_cost(got.total(), want.total())
                got = opb.stage_cost_breakdown(cfg, mix, counts, kv_quant=kv_quant)
                want = ref_opb.stage_cost_breakdown(ref_cfg, ref_mix, counts, kv_quant=kv_quant)
                assert list(got) == list(want), ctx
                for k in got:
                    _same_cost(got[k], want[k])
                plan = dispatch.plan_stage(cfg, mix, counts=counts, kv_quant=kv_quant)
                ref_plan = ref_dispatch.plan_stage(ref_cfg, ref_mix, counts=counts,
                                                   kv_quant=kv_quant)
                assert len(plan.routes) == len(ref_plan.routes), ctx
                for (kind, comps), (ref_kind, ref_comps) in zip(plan.routes, ref_plan.routes):
                    assert (kind.mixer, kind.ffn) == (ref_kind.mixer, ref_kind.ffn)
                    assert [(c.component, c.path) for c in comps] == \
                        [(c.component, c.path) for c in ref_comps], ctx
                    for c, r in zip(comps, ref_comps):
                        assert _close(c.opb, r.opb) and _close(c.flops, r.flops)
                        assert _close(c.bytes, r.bytes)
                        assert plan.path_of(kind, c.component) == c.path
                assert _close(plan.bandwidth_fraction(), ref_plan.bandwidth_fraction()), ctx
                assert dispatch.describe_plan(plan) == ref_dispatch.describe_plan(ref_plan)
                # the modelled-time rule, and a threshold of 0 (all compute
                # but the pinned components)
                for tkw in (dict(duplex=DUPLEX), dict(threshold=0.0)):
                    rkw = dict(duplex=REF_DUPLEX) if "duplex" in tkw else tkw
                    got = dispatch.plan_stage(cfg, mix, counts=counts, kv_quant=kv_quant, **tkw)
                    want = ref_dispatch.plan_stage(ref_cfg, ref_mix, counts=counts,
                                                   kv_quant=kv_quant, **rkw)
                    assert [[c.path for c in cs] for _, cs in got.routes] == \
                        [[c.path for c in cs] for _, cs in want.routes], (ctx, tkw)


def test_unit_costs_and_helpers_match_the_reference():
    """The per-component functions at the widths the stage sums do not
    reach alone: prefill windowed and bidirectional, decode windowed, the
    Mamba pair at several batch sizes, the helper mixes and the roofline
    time of both modelled paths."""
    cfgs = {n: (r, c) for n, r, c in CONFIGS}
    ref_cfg, cfg = cfgs["tiny-window"]
    for s in (1, 7, 8, 33):
        for kw in (dict(window=8), dict(causal=False), dict(kv_quant=True)):
            _same_cost(opb.attention_prefill_cost(cfg, s, **kw),
                       ref_opb.attention_prefill_cost(ref_cfg, s, **kw))
        _same_cost(opb.attention_decode_cost(cfg, s, window=8),
                   ref_opb.attention_decode_cost(ref_cfg, s, window=8))
        _same_cost(opb.attention_chunk_cost(cfg, s, s + 9, window=8, kv_quant=True),
                   ref_opb.attention_chunk_cost(ref_cfg, s, s + 9, window=8, kv_quant=True))
    ref_cfg, cfg = cfgs["jamba-v0.1-52b"]
    for b in (1, 3, 16):
        _same_cost(opb.mamba_decode_cost(cfg, b), ref_opb.mamba_decode_cost(ref_cfg, b))
        _same_cost(opb.mamba_prefill_cost(cfg, b * 100),
                   ref_opb.mamba_prefill_cost(ref_cfg, b * 100))
        _same_cost(opb.ffn_cost(cfg, b), ref_opb.ffn_cost(ref_cfg, b))
        _same_cost(opb.expert_cost(cfg, b), ref_opb.expert_cost(ref_cfg, b))
        _same_cost(opb.qkv_proj_cost(cfg, b), ref_opb.qkv_proj_cost(ref_cfg, b))
        assert opb.expected_tokens_per_expert(cfg, b) == \
            ref_opb.expected_tokens_per_expert(ref_cfg, b)
    assert opb.decoding_only(4, 100) == opb.StageMix(decode_ctx=(100,) * 4)
    assert dataclasses.astuple(opb.mixed(2, 50, 3, 24)) == \
        dataclasses.astuple(ref_opb.mixed(2, 50, 3, 24))
    for flops, nbytes in ((0.0, 0.0), (1e9, 0.0), (0.0, 1e6), (3e12, 2e9)):
        for a, b in ((DUPLEX.xpu, REF_DUPLEX.xpu), (DUPLEX.pim, REF_DUPLEX.pim)):
            assert a.time(flops, nbytes) == b.time(flops, nbytes)
    assert dispatch.OPB_THRESHOLD == ref_dispatch.OPB_THRESHOLD
    assert dispatch._ALWAYS_COMPUTE == ref_dispatch._ALWAYS_COMPUTE
    assert dispatch._DECODE_BOUND == ref_dispatch._DECODE_BOUND


def test_engine_stage_fractions_match_the_reference():
    """Paged and chunked with the duplex MoE (no kernels in either
    engine): every stage's bandwidth-path FLOP fraction, k_cold and
    composition, and the greedy tokens, equal the reference engine's; a
    greedy engine's tokens do not depend on its seed."""
    from repro.launch.train import resolve_config as ref_resolve
    cfg_j, cfg = ref_resolve("tiny-moe", False), resolve_config("tiny-moe")
    pj = init_model(jax.random.PRNGKey(0), cfg_j)
    pt = from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    kw = dict(max_slots=3, max_len=64, kv_layout="paged", kv_page_size=8,
              prefill_chunk_tokens=16, use_kernels=False)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (21, 6, 30, 11)]
    ref = RefEngine(cfg_j, pj, **kw)
    ref_reqs = [RefRequest(rid=i, prompt=list(p), max_new_tokens=4)
                for i, p in enumerate(prompts)]
    ref.run(ref_reqs)
    outs = []
    for seed in (0, 5):
        eng = ServingEngine(cfg, pt, device="cpu", seed=seed, **kw)
        reqs = [Request(rid=i, prompt=list(p), max_new_tokens=4) for i, p in enumerate(prompts)]
        eng.run(reqs)
        outs.append([r.output for r in reqs])
        assert [(r.is_mixed, r.num_decode, r.num_prefill, r.k_cold) for r in eng.reports] == \
            [(r.is_mixed, r.num_decode, r.num_prefill, r.k_cold) for r in ref.reports]
        got = [r.bandwidth_flop_fraction for r in eng.reports]
        want = [r.bandwidth_flop_fraction for r in ref.reports]
        assert all(_close(a, float(b)) for a, b in zip(got, want)), (got, want)
        assert 0.0 < min(got) and max(got) < 1.0
    assert outs[0] == outs[1] == [r.output for r in ref_reqs]


# (label, params, the logit step between neighbouring tokens over the
# temperature): every kept token has probability >= 1% under these logits,
# and the steps make the kept probabilities differ
SETTINGS = [
    ("T0.7", dict(temperature=0.7), 0.045),
    ("T1-k5", dict(temperature=1.0, top_k=5), 0.35),
    ("T1-p0.8", dict(temperature=1.0, top_p=0.8), 0.25),
    ("T0.5-k8-p0.9", dict(temperature=0.5, top_k=8, top_p=0.9), 0.2),
]
ROWS, VOCAB = 20_000, 32


def _logits(temperature, step, seed):
    """One row of 32 logits stepping down by ``step`` x the temperature
    (with a little seeded noise against ties), in a seeded order."""
    rng = np.random.default_rng(seed)
    x = -step * temperature * (np.arange(VOCAB) + rng.uniform(-0.1, 0.1, VOCAB))
    return x[rng.permutation(VOCAB)].astype(np.float32)


def _masked_softmax(row, p):
    """The reference's steps in float64: temperature, top-k, top-p (the
    argmax always kept); returns the probabilities and the smallest
    distance of a top-p cut from its threshold."""
    x = row.astype(np.float64) / p.temperature
    if p.top_k > 0:
        x = np.where(x < np.sort(x)[-p.top_k], -np.inf, x)
    margin = np.inf
    if p.top_p < 1.0:
        order = np.argsort(-x, kind="stable")
        e = np.exp(x[order] - x[order][0])
        probs = e / e.sum()
        excl = np.cumsum(probs) - probs
        margin = np.min(np.abs(excl - p.top_p))
        keep = np.zeros(VOCAB, bool)
        keep[order] = excl < p.top_p
        x = np.where(keep, x, -np.inf)
    e = np.exp(x - x.max())
    return e / e.sum(), margin


@pytest.mark.parametrize("label,kw,step", SETTINGS, ids=[s[0] for s in SETTINGS])
def test_sampling_support_and_distribution(label, kw, step):
    row = _logits(kw["temperature"], step, len(label))
    probs, margin = _masked_softmax(row, SamplingParams(**kw))
    kept = set(np.flatnonzero(probs > 0).tolist())
    assert probs[probs > 0].min() >= 0.01 and margin > 1e-4     # the design holds
    logits = np.broadcast_to(row, (ROWS, 1, VOCAB))
    ref_tok = np.asarray(ref_sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                                    RefSampling(**kw)))
    gen = torch.Generator().manual_seed(0)
    tok = sample(torch.from_numpy(np.ascontiguousarray(logits)), SamplingParams(**kw),
                 gen).numpy()
    assert tok.dtype == np.int32 and tok.shape == (ROWS,)
    assert set(tok.tolist()) == set(ref_tok.tolist()) == kept
    idx = sorted(kept)
    freq = np.bincount(tok, minlength=VOCAB)[idx]
    res = stats.chisquare(freq, ROWS * probs[idx])
    assert res.pvalue > 1e-3, (label, res)


def test_sampled_engine_is_reproducible_from_its_seed():
    """At temperature 0.8 with top-k and top-p: the same seed gives the
    same tokens, another seed others; greedy is the argmax."""
    cfg = resolve_config("tiny-moe")
    from repro_torch.models.params import init_model as t_init
    params = t_init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (9, 14, 5)]

    def run(sampling, seed):
        eng = ServingEngine(cfg, params, max_slots=2, max_len=48, kv_page_size=8,
                            prefill_chunk_tokens=8, sampling=sampling, seed=seed,
                            device="cpu")
        reqs = [Request(rid=i, prompt=list(p), max_new_tokens=8) for i, p in enumerate(prompts)]
        eng.run(reqs)
        assert all(r.completed and len(r.output) == 8 for r in reqs)
        return [r.output for r in reqs]

    hot = SamplingParams(temperature=0.8, top_k=50, top_p=0.95)
    a, b, c = run(hot, 0), run(hot, 0), run(hot, 1)
    assert a == b and a != c
    assert all(0 <= t < cfg.vocab_size for out in a + c for t in out)
    assert run(SamplingParams(), 0) == run(SamplingParams(), 1) != a
    # the same seed through the async loop draws the same stream
    eng = ServingEngine(cfg, params, max_slots=2, max_len=48, kv_page_size=8,
                        prefill_chunk_tokens=8, sampling=hot, seed=0, device="cpu")
    reqs = [Request(rid=i, prompt=list(p), max_new_tokens=8) for i, p in enumerate(prompts)]
    eng.run_async(reqs)
    assert [r.output for r in reqs] == a
    with pytest.raises(ValueError, match="greedy"):
        ServingEngine(cfg, params, max_slots=2, max_len=48, sampling=hot, spec_k=4,
                      device="cpu")
