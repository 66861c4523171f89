"""PyTorch port, the paper's analytic simulator (``repro_torch/sim/``) and
the rest of the cost model, against the reference's on the same inputs:

* ``core/costmodel.py``: every ``DeviceSpec`` field, ``time``, ``energy``,
  ``knee_opb``, ``gemm_time`` and ``edap`` over a grid of FLOPs and bytes
  for each device, the Duplex devices, the constants; the port's
  ``DEVICES`` is the reference's without the TPU v5e;
* ``optimal_partition_bruteforce``, ``moe_gemm_traffic`` and
  ``padded_flops_saved``;
* ``sim/``: the Table I configs, the cluster's bytes and batch capacity for
  each paper model on each default system, ``stage_exec`` for all seven
  policies on Mixtral, GLaM, Jamba-v0.1 (the Mamba branch) and
  whisper-small (cross-attention) over decode-only, mixed and
  prefill-only mixes, with counts given and drawn; ``simulate`` for every
  policy and ``simulate_split`` on a seeded Poisson workload; Fig. 10's
  and Fig. 11's quick rows through the reference's own benchmark code
  with its imports swapped for the port's;
* ``chip_smoke.py``'s path r: its pinned Fig. 11 and Table I numbers, and
  its stage recording and predictions on a narrow OLMoE on the CPU.

Both packages do the same float64 numpy operations in the same order, so
every number is held with ``==``.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import benchmarks.fig10_flows as ref_fig10
import benchmarks.fig11_throughput as ref_fig11
from repro.configs.registry import get_config as ref_get_config
from repro.core import costmodel as ref_cm
from repro.core import opb as ref_opb
from repro.core.partition import build_luts as ref_build_luts
from repro.core.partition import optimal_partition_bruteforce as ref_bruteforce
from repro.core.duplex_moe import padded_flops_saved as ref_padded_flops_saved
from repro.kernels.moe_gemm import moe_gemm_traffic as ref_moe_gemm_traffic
from repro.sim import cluster as ref_cluster
from repro.sim import engine_sim as ref_engine_sim
from repro.sim import layermodel as ref_layermodel
from repro.sim import metrics as ref_metrics
from repro.sim import paper_models as ref_paper
from repro.sim import specs as ref_specs
from repro.sim import workload as ref_workload
from repro_torch.configs.registry import get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import opb
from repro_torch.core.duplex_moe import padded_flops_saved
from repro_torch.core.partition import (build_luts, optimal_partition_bruteforce,
                                        partition_experts)
from repro_torch.kernels.moe_gemm import moe_gemm_traffic
from repro_torch.sim import cluster, engine_sim, layermodel, metrics, paper_models, specs, workload

ROOT = Path(__file__).resolve().parents[1]
DEVICE_FIELDS = [f.name for f in dataclasses.fields(cm.DeviceSpec)]
GRID = [(f, b) for f in (0.0, 1.0, 3.3e9, 2.0e12, 7.7e14) for b in (0.0, 2.0, 5.1e8, 3.0e11)]


# ---- the cost model -------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(cm.DEVICES))
def test_device_fields_and_costs_equal_the_reference(name):
    """Every field, ``knee_opb``, and ``time``, ``energy``, ``edap`` and
    ``gemm_time`` (with and without a byte override) over a grid of FLOPs
    and bytes, zero included."""
    dev, ref = cm.DEVICES[name], ref_cm.DEVICES[name]
    assert [getattr(dev, f) for f in DEVICE_FIELDS] == [getattr(ref, f) for f in DEVICE_FIELDS]
    assert DEVICE_FIELDS == [f.name for f in dataclasses.fields(ref_cm.DeviceSpec)]
    assert dev.knee_opb == ref.knee_opb
    for f, b in GRID:
        assert dev.time(f, b) == ref.time(f, b)
        assert dev.energy(f, b) == ref.energy(f, b)
        assert cm.edap(dev, f, b) == ref_cm.edap(ref, f, b)
    for m, k, n in ((1, 4096, 14336), (64, 2048, 1024), (4096, 4096, 4096)):
        assert cm.gemm_time(dev, m, k, n) == ref_cm.gemm_time(ref, m, k, n)
        assert cm.gemm_time(dev, m, k, n, 1.5e9) == ref_cm.gemm_time(ref, m, k, n, 1.5e9)


def test_devices_are_the_references_without_the_tpu():
    """The port's ``DEVICES`` is the reference's minus ``tpu_v5e``; the TPU
    device and its ICI rate are left out on purpose; every other constant
    and both Duplex devices equal the reference's."""
    assert set(ref_cm.DEVICES) - set(cm.DEVICES) == {"tpu_v5e"}
    assert set(cm.DEVICES) <= set(ref_cm.DEVICES)
    assert list(cm.DEVICES) == [n for n in ref_cm.DEVICES if n != "tpu_v5e"]
    assert not hasattr(cm, "TPU_V5E") and not hasattr(cm, "ICI_BW")
    for c in ("E_ACT", "E_RD", "E_IO_EXT", "E_TSV", "E_FLOP_XPU", "E_FLOP_PIM", "HBM3_BW",
              "HBM3_CAP", "H100_FLOPS", "N_STACKS", "NVLINK_BW", "IB_BW"):
        assert getattr(cm, c) == getattr(ref_cm, c), c
    for name in ("DUPLEX", "DUPLEX_BANKPIM"):
        d, r = getattr(cm, name), getattr(ref_cm, name)
        assert (d.name, d.mem_capacity) == (r.name, r.mem_capacity)
        for which in ("xpu", "pim"):
            assert d.path(which) == getattr(d, which)
            assert dataclasses.astuple(d.path(which)) == dataclasses.astuple(r.path(which))
    # the reference's import-time check of the Logic-PIM's compute sizing
    assert abs(cm.LOGIC_PIM.peak_flops - cm.N_STACKS * 21.3e12) / cm.LOGIC_PIM.peak_flops < 0.3


@pytest.mark.parametrize("seed", range(6))
def test_bruteforce_oracle_equals_the_reference(seed):
    """Seeded counts over 2-10 experts on Mixtral's and OLMoE's expert LUTs:
    the exhaustive makespan equals the reference's, and the greedy split
    never beats it beyond rounding."""
    rng = np.random.default_rng(seed)
    E = 2 + seed + (seed > 3) * 2
    counts = rng.integers(0, 48, E)
    for d, f in ((4096, 14336), (2048, 1024)):
        luts = build_luts(cm.DUPLEX, d, f, 512)
        ref_luts = ref_build_luts(ref_cm.DUPLEX, d, f, 512)
        best = optimal_partition_bruteforce(counts, *luts)
        assert best == ref_bruteforce(counts, *ref_luts)
        # the greedy sums its paths incrementally, the oracle afresh
        assert partition_experts(counts, *luts).makespan >= best * (1 - 1e-12)
    with pytest.raises(ValueError):
        optimal_partition_bruteforce(np.ones(17, np.int64), *luts)


MOE_SHAPES = {"olmoe": (get_config("olmoe-1b-7b"), 3), "mixtral": (paper_models.MIXTRAL, 3)}


@pytest.mark.parametrize("model", sorted(MOE_SHAPES))
def test_moe_traffic_and_padded_flops_equal_the_reference(model):
    """``moe_gemm_traffic`` over seeded counts, capacities and token blocks,
    and ``padded_flops_saved`` over stage sizes and cold counts, on OLMoE's
    (64 experts, d 2048, f 1024) and Mixtral's (8, 4096, 14336) MoE."""
    cfg, mats = MOE_SHAPES[model]
    m = cfg.moe
    rng = np.random.default_rng(7)
    for tokens, capacity, c_block in ((16, 8, 8), (256, 64, 16), (2048, 320, 256), (4, 16, 64)):
        counts = rng.multinomial(tokens * m.top_k, np.full(m.num_experts, 1 / m.num_experts))
        kw = dict(capacity=capacity, d_model=cfg.d_model, d_ff=m.d_ff_expert, c_block=c_block,
                  mats=mats)
        assert moe_gemm_traffic(counts, **kw) == ref_moe_gemm_traffic(counts, **kw)
        assert (moe_gemm_traffic(counts, itemsize=4, **kw)
                == ref_moe_gemm_traffic(counts, itemsize=4, **kw))
    ref_m = (ref_get_config(cfg.name) if model == "olmoe" else ref_paper.MIXTRAL).moe
    for T in (1, 16, 80, 1024):
        for k_cold in sorted({0, 1, m.num_experts // 4, m.num_experts // 2, m.num_experts}):
            assert (padded_flops_saved(T, m, k_cold, cfg.d_model)
                    == ref_padded_flops_saved(T, ref_m, k_cold, cfg.d_model))


# ---- Table I, the cluster -------------------------------------------------------------------
def _kinds(cfg):
    return [(k.mixer, k.ffn) for k in cfg.layer_kinds()]


@pytest.mark.parametrize("name", sorted(ref_paper.PAPER_MODELS))
def test_table_one_configs_equal_the_reference(name):
    """Each Table I model's counts, layer kinds, head dim and FFN form, and
    the default system sizes."""
    cfg, ref = paper_models.PAPER_MODELS[name], ref_paper.PAPER_MODELS[name]
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert _kinds(cfg) == _kinds(ref)
    assert cfg.resolved_head_dim == ref.resolved_head_dim
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size",
              "gated_ffn", "family"):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert (cfg.moe is None) == (ref.moe is None)
    if cfg.moe is not None:
        assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(ref.moe)
    assert paper_models.PAPER_SYSTEMS == ref_paper.PAPER_SYSTEMS
    assert list(paper_models.PAPER_MODELS) == list(ref_paper.PAPER_MODELS)


KINDS = ("gpu", "gpu2x", "duplex", "duplex_et", "bankpim")


@pytest.mark.parametrize("name", sorted(ref_paper.PAPER_MODELS))
def test_cluster_bytes_and_batch_capacity_equal_the_reference(name):
    """``weight_bytes``, ``kv_bytes_per_token`` and ``max_batch_size`` for
    each default system kind; a Duplex system holds memory (its batch is
    not one at a time) exactly as the reference's."""
    cfg, ref = paper_models.PAPER_MODELS[name], ref_paper.PAPER_MODELS[name]
    assert cluster.weight_bytes(cfg) == ref_cluster.weight_bytes(ref)
    assert cluster.kv_bytes_per_token(cfg) == ref_cluster.kv_bytes_per_token(ref)
    for kind in KINDS:
        sys_, ref_sys = specs.default_system(cfg, kind), ref_specs.default_system(ref, kind)
        assert (sys_.name, sys_.nodes, sys_.devs_per_node, sys_.moe_dist, sys_.n_dev,
                sys_.is_duplex, sys_.mem_capacity, sys_.nvlink_bw, sys_.ib_bw) == (
            ref_sys.name, ref_sys.nodes, ref_sys.devs_per_node, ref_sys.moe_dist,
            ref_sys.n_dev, ref_sys.is_duplex, ref_sys.mem_capacity, ref_sys.nvlink_bw,
            ref_sys.ib_bw)
        assert sys_.mem_capacity == sys_.n_dev * cm.HBM3_CAP
        for ctx in (512, 2048, 8192):
            for copies in (1, 2):
                assert (cluster.max_batch_size(sys_, cfg, ctx, weight_copies=copies)
                        == ref_cluster.max_batch_size(ref_sys, ref, ctx, weight_copies=copies))
    assert cluster.max_batch_size(specs.default_system(cfg, "duplex"), cfg, 512) > 1
    with pytest.raises(ValueError):
        specs.default_system(cfg, "tpu")


# ---- stage_exec -----------------------------------------------------------------------------
STAGE_MODELS = {
    "mixtral": (lambda: paper_models.MIXTRAL, lambda: ref_paper.MIXTRAL),
    "glam": (lambda: paper_models.GLAM, lambda: ref_paper.GLAM),
    "jamba": (lambda: get_config("jamba-v0.1-52b"), lambda: ref_get_config("jamba-v0.1-52b")),
    "whisper": (lambda: get_config("whisper-small"), lambda: ref_get_config("whisper-small")),
}
MIXES = {"decode": dict(decode_ctx=(144, 171, 300, 544, 2048, 1030)),
         "mixed": dict(decode_ctx=(144, 171, 300, 544, 2048), prefill_len=(64, 1024)),
         "prefill": dict(prefill_len=(300, 17))}
SYSTEM_OF = {"gpu": "gpu", "bankpim": "bankpim", "duplex_pe_et": "duplex_et"}


def _stage(sim_mod, opb_mod, specs_mod, cfg, policy, mix_kw, counts, seed):
    system = specs_mod.default_system(cfg, SYSTEM_OF.get(policy, "duplex"))
    ex = sim_mod.stage_exec(system, cfg, opb_mod.StageMix(**mix_kw), policy,
                            rng=np.random.default_rng(seed), counts=counts)
    return ex.time, ex.energy, ex.breakdown


@pytest.mark.parametrize("policy", layermodel.POLICIES)
@pytest.mark.parametrize("model", sorted(STAGE_MODELS))
def test_stage_exec_equals_the_reference(model, policy):
    """Time, energy and every breakdown entry of one stage, per policy, on
    each mix, with the MoE counts given and drawn from the simulator's
    generator; the Mamba branch (Jamba) and cross-attention (whisper)
    included."""
    cfg, ref = (f() for f in STAGE_MODELS[model])
    assert layermodel.POLICIES == ref_layermodel.POLICIES
    seen = set()
    for name, mix_kw in MIXES.items():
        tokens = opb.StageMix(**mix_kw).num_tokens
        counts = [None]
        if cfg.moe is not None:
            counts.append(np.random.default_rng(5).multinomial(
                tokens * cfg.moe.top_k, np.full(cfg.moe.num_experts, 1 / cfg.moe.num_experts)))
        for c in counts:
            for seed in (0, 9):
                got = _stage(layermodel, opb, specs, cfg, policy, mix_kw, c, seed)
                want = _stage(ref_layermodel, ref_opb, ref_specs, ref, policy, mix_kw, c, seed)
                assert got == want, (name, seed, c is None)
                assert got[0] > 0 and np.isfinite(got[1])
                seen |= set(got[2])
    if model == "jamba" and policy != "minibatch_split":
        assert "mamba" in seen and "moe" in seen
    if model == "whisper":
        assert "ffn" in seen and "moe" not in seen
    with pytest.raises(ValueError):
        layermodel.stage_exec(specs.default_system(cfg, "gpu"), cfg,
                              opb.StageMix(**MIXES["decode"]), "tpu")


def test_sample_counts_draw_the_references_stream():
    """``sample_counts`` from one generator threaded through many draws."""
    cfg = paper_models.GLAM
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for tokens in (1, 7, 64, 4096):
        assert np.array_equal(layermodel.sample_counts(a, cfg, tokens),
                              ref_layermodel.sample_counts(b, ref_paper.GLAM, tokens))


# ---- simulate -------------------------------------------------------------------------------
def _workload(wl, n=14, qps=40.0):
    reqs = wl.gaussian_requests(n, 96, 24, seed=3, std_frac=0.3)
    return wl.poisson_arrivals(reqs, qps, seed=4)


def _result(res, metrics_mod):
    return (res.total_time, res.total_energy, res.stages, res.mixed_stages, res.tokens_out,
            res.throughput, res.energy_per_token,
            [(r.rid, r.l_in, r.l_out, r.arrival, r.first_token_time, r.finish_time,
              r.token_times, r.t2ft, r.e2e, r.tbts()) for r in res.requests],
            metrics_mod.latency_summary(res.requests))


@pytest.mark.parametrize("policy", layermodel.POLICIES)
def test_simulate_equals_the_reference(policy):
    """A seeded Poisson workload on Mixtral's default system for the
    policy (a Duplex one for every PIM policy), batches of 4 with two
    prompts a stage and uncapped: the ``SimResult``, every request's times
    and the latency summary."""
    kind = SYSTEM_OF.get(policy, "duplex")
    for kw in (dict(max_batch=4, max_prefill_per_stage=2, seed=1), dict()):
        got = engine_sim.simulate(specs.default_system(paper_models.MIXTRAL, kind),
                                  paper_models.MIXTRAL, policy, _workload(workload), **kw)
        want = ref_engine_sim.simulate(ref_specs.default_system(ref_paper.MIXTRAL, kind),
                                       ref_paper.MIXTRAL, policy, _workload(ref_workload), **kw)
        assert _result(got, metrics) == _result(want, ref_metrics)
        assert got.tokens_out == sum(r.l_out for r in got.requests)
        assert got.mixed_stages > 0


def test_simulate_split_equals_the_reference():
    """The phase-split system (Fig. 16): a GPU prefill pool and a Duplex
    decode pool."""
    got = engine_sim.simulate_split(specs.gpu_system(1, 2), specs.duplex_system(1, 2),
                                    paper_models.MIXTRAL, "duplex", _workload(workload), seed=2)
    want = ref_engine_sim.simulate_split(ref_specs.gpu_system(1, 2),
                                         ref_specs.duplex_system(1, 2), ref_paper.MIXTRAL,
                                         "duplex", _workload(ref_workload), seed=2)
    assert _result(got, metrics) == _result(want, ref_metrics)
    assert got.mixed_stages == 0 and got.stages > 0


def test_workload_and_metrics_equal_the_reference():
    """Lengths, arrivals, and percentiles of an empty list (NaN)."""
    a, b = _workload(workload, n=40), _workload(ref_workload, n=40)
    assert [dataclasses.astuple(r) for r in a] == [dataclasses.astuple(r) for r in b]
    assert np.isnan(metrics.percentile([], 50)) and np.isnan(ref_metrics.percentile([], 50))
    assert metrics.percentile([3.0, 1.0, 2.0], 90) == ref_metrics.percentile([3.0, 1.0, 2.0], 90)


# ---- the paper's figures through the reference's benchmark code -----------------------------
def _swap(monkeypatch, mod, names):
    for name, value in names.items():
        assert hasattr(mod, name), name
        monkeypatch.setattr(mod, name, value)


def test_fig10_quick_rows_equal_the_reference(monkeypatch):
    """``benchmarks/fig10_flows.py``'s quick rows, then the same function
    with its imports pointed at the port."""
    want = ref_fig10.run(quick=True)
    _swap(monkeypatch, ref_fig10, dict(decoding_only=opb.decoding_only, mixed=opb.mixed,
                                       GLAM=paper_models.GLAM, MIXTRAL=paper_models.MIXTRAL,
                                       default_system=specs.default_system,
                                       stage_exec=layermodel.stage_exec))
    got = ref_fig10.run(quick=True)
    assert got == want and len(got) == 6


@pytest.fixture(scope="module")
def fig11_rows():
    """The reference's Fig. 11 quick rows (~3 s), computed once."""
    return ref_fig11.run(quick=True)


def test_fig11_quick_rows_equal_the_reference(monkeypatch, fig11_rows):
    """``benchmarks/fig11_throughput.py``'s quick grid (Mixtral, (256, 256,
    32) and (1024, 1024 -> 256, 64), five systems), then the same function
    with its imports pointed at the port; the paper's directions hold."""
    want = fig11_rows
    _swap(monkeypatch, ref_fig11, dict(simulate=engine_sim.simulate,
                                       GLAM=paper_models.GLAM, GROK1=paper_models.GROK1,
                                       MIXTRAL=paper_models.MIXTRAL,
                                       default_system=specs.default_system,
                                       gaussian_requests=workload.gaussian_requests))
    got = ref_fig11.run(quick=True)
    assert got == want and len(got) == 10
    by = {(r["system"], r["policy"], r["l_in"]): r["speedup_vs_gpu"] for r in got}
    assert by[("duplex", "duplex", 256)] > 1.3
    assert by[("duplex_et", "duplex_pe_et", 256)] >= by[("duplex", "duplex", 256)] * 0.95


# ---- chip_smoke.py's path r -----------------------------------------------------------------
def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_r", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_path_r_pins_equal_the_reference(fig11_rows):
    """The Fig. 11 quick grid and the Table I parameter counts that path r
    computes with the port on the card's host, against the reference's
    benchmark and configs and against the constants the smoke pins."""
    sm = _smoke()
    got = sm.sim_paper_numbers()
    want = {f"fig11/{r['l_in']}/{r['system']}/{r['policy']}": r["tok_per_s"]
            for r in fig11_rows}
    want.update({f"params/{n}": float(m.param_count())
                 for n, m in ref_paper.PAPER_MODELS.items()})
    assert got == want
    assert sm.R_EXPECT == want
    sm.check_paper_numbers(got)
    with pytest.raises(AssertionError):
        sm.check_paper_numbers(dict(got, **{"fig11/256/duplex/duplex": 1.0}))


def test_path_r_stages_and_predictions_on_a_narrow_olmoe():
    """Path r's stage-by-stage run on the port's engine on the CPU, narrow
    (2 layers, d_model 64, OLMoE's 64 experts top-8 and vocabulary), built
    by the smoke's own functions, on path r's four requests and on path
    a's 16: the same tokens as ``run``, every stage's mix recorded, and
    each predicted at OLMoE's full width under the three policies, finite
    and positive, the decode-only stages' MoE the largest part under
    "gpu", equal to the reference's ``stage_exec`` on the same mixes."""
    import torch
    from repro_torch.configs import resolve_config
    from repro_torch.configs.base import ATTN, MOE, LayerKind, Segment
    from repro_torch.models.params import init_model
    from repro_torch.serving.engine import ServingEngine
    torch.set_num_threads(1)
    sm = _smoke()
    full = resolve_config("olmoe-1b-7b")
    cfg = dataclasses.replace(
        full, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=32,
        segments=(Segment((LayerKind(ATTN, MOE),), 2),),
        moe=dataclasses.replace(full.moe, d_ff_expert=32), dtype="float32",
        param_dtype="float32").validate()
    params = init_model(cfg, seed=0, device="cpu")
    kw = {**sm.ENGINE_KW, **sm.PATHS[0][1]}
    for make in (sm.short_requests, sm.path_a_requests):
        base = make(cfg)
        ServingEngine(cfg, params, device="cpu", **kw).run(base)
        reqs = make(cfg)
        mixes = sm.drive_stages(ServingEngine(cfg, params, device="cpu", **kw), reqs)
        assert [r.output for r in reqs] == [r.output for r in base]
        assert all(len(r.output) == r.max_new_tokens for r in reqs)
        assert sum(not m.is_mixed for m in mixes) > 0 and sum(m.is_mixed for m in mixes) > 0
        _check_predictions(sm, full, mixes)


def _check_predictions(sm, full, mixes):
    pred = sm.predict_stages(full, mixes)
    assert set(pred) == set(sm.R_POLICIES)
    for policy, stages in pred.items():
        assert len(stages) == len(mixes)
        assert all(np.isfinite(ex.time) and ex.time > 0 for ex in stages), policy
    dec = [ex for ex, m in zip(pred["gpu"], mixes) if not m.is_mixed]
    assert all(max(ex.breakdown, key=ex.breakdown.get) == "moe" for ex in dec)
    # the predictions are the reference's on the same mixes and seeds
    ref_sys = ref_specs.gpu_system(1, 1)
    rng = np.random.default_rng(sm.R_SEED)
    for ex, m in zip(pred["gpu"], mixes):
        want = ref_layermodel.stage_exec(ref_sys, ref_get_config("olmoe-1b-7b"),
                                         ref_opb.StageMix(*dataclasses.astuple(m)), "gpu",
                                         rng=rng)
        assert (ex.time, ex.energy, ex.breakdown) == (want.time, want.energy, want.breakdown)
