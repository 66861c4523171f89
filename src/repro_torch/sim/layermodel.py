"""Analytic stage-execution model (paper §VI simulator, roofline + overhead).
Port of ``repro/sim/layermodel.py``: the same sums in the same order, so
every float equals the reference's.

``stage_exec`` computes the latency and energy of ONE continuous-batching
stage for a (system, model, policy). Per-layer component costs come from
``core/opb.py`` (the analysis behind the runtime dispatch); per-device
times from ``core/costmodel.DeviceSpec.time``; the expert co-processing
split from ``core/partition.partition_experts``, the algorithm the
runtime's planner runs.

Policies (evaluation §VII):
  gpu            everything on the xPU (H100 baseline)
  duplex         C1 only: decode-stage MoE + decode attention on Logic-PIM,
                 everything else on the xPU; units used serially (Fig. 10(a,b))
  duplex_pe      + C2/C3 co-processing: experts split between units by the
                 greedy partitioner; prefill attention || decode attention
  duplex_pe_et   + C4: tensor-parallel experts (all experts visible on every
                 device, co-processing has full freedom)
  bankpim        Logic-PIM replaced by Bank-PIM (16x BW, 1 Op/B)
  hetero         half GPUs, half Logic-PIM-only devices (§III-B, Fig. 5)
  minibatch_split  two half-batches alternating the units (Fig. 10(c))

A stage's chunk and verify spans count in its MoE tokens, its all-to-all,
its LM-head rows and ``is_mixed``; the per-layer costs (FC, attention,
dense FFN, Mamba) see only its decode rows and whole prompts, as in the
reference, which predates those spans.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.base import DENSE, MOE, ModelConfig
from repro_torch.core import opb as opb_mod
from repro_torch.core.costmodel import E_IO_EXT, DeviceSpec
from repro_torch.core.opb import BYTES, StageMix
from repro_torch.core.partition import build_lut, partition_experts
from repro_torch.sim.cluster import SystemSpec

POLICIES = ("gpu", "duplex", "duplex_pe", "duplex_pe_et", "bankpim",
            "hetero", "minibatch_split")
# minibatch_split (Fig. 10(c)): split the stage into two half-batches and
# alternate xPU/Logic-PIM between them. Both units stay busy, but the FC and
# MoE layers run at HALF the batch => half the weight reuse: when those
# layers are memory-bound their time does not shrink, and the model weights
# are read twice, the paper's argument for co-processing (Fig. 10(d)).
# hetero (§III-B / Fig. 5): half the devices are GPUs (FC + prefill attn),
# half are Logic-PIM-only devices that ALWAYS process MoE + decode attention
# (no weight duplication), so mixed-stage MoE is stuck on the weak unit:
# the tail-latency pathology the paper identifies.


@dataclass
class StageExec:
    time: float
    energy: float
    breakdown: Dict[str, float] = field(default_factory=dict)

    def add(self, name: str, t: float, e: float) -> None:
        self.time += t
        self.energy += e
        self.breakdown[name] = self.breakdown.get(name, 0.0) + t


def _comm_time(bytes_, bw: float) -> float:
    return bytes_ / bw + 2e-6


def sample_counts(rng: np.random.Generator, cfg: ModelConfig,
                  tokens: int) -> np.ndarray:
    """Uniform expert selection (paper §VI workload model)."""
    m = cfg.moe
    return rng.multinomial(tokens * m.top_k,
                           np.full(m.num_experts, 1.0 / m.num_experts))


def _moe_time_ep(system: SystemSpec, cfg: ModelConfig, counts: np.ndarray,
                 dev: DeviceSpec, n_dev: Optional[int] = None) -> float:
    """Expert parallelism (paper §III): experts spread over devices; layer
    time = the slowest device (the sum of its experts), one unit."""
    m = cfg.moe
    n_dev = n_dev or system.n_dev
    mats = 3 if cfg.gated_ffn else 2
    lut = build_lut(dev, cfg.d_model, m.d_ff_expert,
                    max_tokens=int(counts.sum()) + 1, mats=mats)
    if m.num_experts >= n_dev:
        per_dev = np.array_split(counts, n_dev)
        return max(float(lut(c).sum()) for c in per_dev)
    # more devices than experts: each expert TP over n_dev/E devices
    ways = n_dev // m.num_experts
    return float(max(lut(counts) / ways))


def _moe_time_coproc(system: SystemSpec, cfg: ModelConfig,
                     counts: np.ndarray, xpu: DeviceSpec, pim: DeviceSpec,
                     *, et: bool) -> Tuple[float, float, float]:
    """Expert co-processing (C2 / C2+C4): returns (makespan, t_xpu, t_pim).

    EP mode: each device sees E/n_dev experts and partitions only those.
    ET mode (C4): every device in a node sees all experts at 1/devs_per_node
    per-expert time; nodes split the token batch (EP across nodes)."""
    m = cfg.moe
    total = int(counts.sum()) + 1
    mats = 3 if cfg.gated_ffn else 2
    if et:
        node_counts = counts  # uniform routing => same distribution per node
        scale = system.devs_per_node
        lut_x = build_lut(xpu, cfg.d_model, m.d_ff_expert // scale, total,
                          mats)
        lut_p = build_lut(pim, cfg.d_model, m.d_ff_expert // scale, total,
                          mats)
        part = partition_experts(node_counts, lut_x, lut_p)
        return part.makespan, part.t_xpu, part.t_pim
    # EP: experts per device; the worst device bounds the layer
    n_dev = system.n_dev
    lut_x = build_lut(xpu, cfg.d_model, m.d_ff_expert, total, mats)
    lut_p = build_lut(pim, cfg.d_model, m.d_ff_expert, total, mats)
    worst = (0.0, 0.0, 0.0)
    if m.num_experts >= n_dev:
        for chunk in np.array_split(counts, n_dev):
            part = partition_experts(chunk, lut_x, lut_p)
            if part.makespan > worst[0]:
                worst = (part.makespan, part.t_xpu, part.t_pim)
        return worst
    ways = n_dev // m.num_experts
    lut_x = build_lut(xpu, cfg.d_model, m.d_ff_expert // ways, total, mats)
    lut_p = build_lut(pim, cfg.d_model, m.d_ff_expert // ways, total, mats)
    for c in counts:
        part = partition_experts([c], lut_x, lut_p)
        if part.makespan > worst[0]:
            worst = (part.makespan, part.t_xpu, part.t_pim)
    return worst


def stage_exec(system: SystemSpec, cfg: ModelConfig, mix: StageMix,
               policy: str, *, rng: Optional[np.random.Generator] = None,
               counts: Optional[np.ndarray] = None) -> StageExec:
    """Latency + energy of one stage under ``policy``. ``counts`` are every
    MoE layer's per-expert token counts; without them each MoE layer kind
    draws its own from ``rng`` (uniform routing)."""
    if policy not in POLICIES:
        raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
    rng = rng or np.random.default_rng(0)
    if policy == "minibatch_split":
        # two half-stages execute concurrently, one per unit; each half runs
        # serially on its unit (Fig. 10(c)). Time = max(half on xPU-only
        # system, half on PIM-heavy duplex), energy = both halves.
        half_a = StageMix(mix.decode_ctx[::2], mix.prefill_len[::2])
        half_b = StageMix(mix.decode_ctx[1::2], mix.prefill_len[1::2])
        ex_a = stage_exec(system, cfg, half_a, "gpu", rng=rng)
        ex_b = stage_exec(system, cfg, half_b, "duplex", rng=rng)
        out = StageExec(max(ex_a.time, ex_b.time), ex_a.energy + ex_b.energy)
        for k in set(ex_a.breakdown) | set(ex_b.breakdown):
            out.breakdown[k] = max(ex_a.breakdown.get(k, 0.0),
                                   ex_b.breakdown.get(k, 0.0))
        return out
    xpu = system.xpu()
    pim = system.pim() if policy != "gpu" else None
    use_pim = pim is not None
    hetero = policy == "hetero"

    n_dev = system.n_dev
    tp = system.devs_per_node            # TP ways for FC layers (in node)
    nodes = system.nodes
    if hetero:                            # half GPUs, half PIM devices
        n_dev = system.n_dev // 2
        tp = max(tp // 2, 1)
    T = mix.num_tokens
    T_node = max(T // nodes, 1)          # DP across nodes for FC layers
    out = StageExec(0.0, 0.0)
    d = cfg.d_model

    kind_mult: Dict = {}
    for k in cfg.layer_kinds():
        kind_mult[k] = kind_mult.get(k, 0) + 1

    for kind, mult in kind_mult.items():
        lc = opb_mod.layer_stage_cost(cfg, kind,
                                      StageMix(mix.decode_ctx,
                                               mix.prefill_len))
        comps = {c.name: c for c in lc.components}

        # --- FC (qkv+proj): always the xPU, TP in node, DP across nodes ----
        if "qkv+proj" in comps:
            c = comps["qkv+proj"]
            frac = T_node / max(T, 1)
            t = xpu.time(c.flops * frac / tp, c.bytes * frac / tp)
            # 1 all-reduce of the proj output across TP
            ar = _comm_time(BYTES * T_node * d * 2 * (tp - 1) / tp,
                            system.nvlink_bw)
            e = xpu.energy(c.flops / nodes / tp, c.bytes / nodes / tp) * n_dev
            out.add("fc", (t + ar) * mult, e * mult)

        # --- attention ------------------------------------------------------
        t_dec = t_pre = 0.0
        if "attn_decode" in comps or "cross_attn" in comps:
            c = comps.get("attn_decode", comps.get("cross_attn"))
            dev = pim if use_pim else xpu
            t_dec = dev.time(c.flops / n_dev, c.bytes / n_dev)
            out.energy += dev.energy(c.flops, c.bytes) * mult
        if "attn_prefill" in comps:
            c = comps["attn_prefill"]
            t_pre = xpu.time(c.flops / n_dev, c.bytes / n_dev)
            out.energy += xpu.energy(c.flops, c.bytes) * mult
        if policy in ("duplex_pe", "duplex_pe_et", "bankpim") and use_pim:
            # C3: prefill attention on the xPU concurrent with decode on PIM
            t_attn = max(t_dec, t_pre)
        else:
            t_attn = t_dec + t_pre
        if t_attn:
            out.add("attn", t_attn * mult, 0.0)

        # --- mamba mixer (C1: decode -> bandwidth path) ----------------------
        if "mamba_decode" in comps:
            c = comps["mamba_decode"]
            dev = pim if use_pim else xpu
            t = dev.time(c.flops / n_dev, c.bytes / n_dev)
            out.add("mamba", t * mult, dev.energy(c.flops, c.bytes) * mult)
        if "mamba_prefill" in comps:
            c = comps["mamba_prefill"]
            t = xpu.time(c.flops / n_dev, c.bytes / n_dev)
            out.add("mamba", t * mult, xpu.energy(c.flops, c.bytes) * mult)

        # --- FFN / MoE --------------------------------------------------------
        if kind.ffn == DENSE:
            c = comps["ffn"]
            frac = T_node / max(T, 1)
            t = xpu.time(c.flops * frac / tp, c.bytes * frac / tp)
            ar = _comm_time(BYTES * T_node * d * (tp - 1) / tp,
                            system.nvlink_bw)
            out.add("ffn", (t + ar) * mult,
                    xpu.energy(c.flops / nodes / tp,
                               c.bytes / nodes / tp) * n_dev * mult)
        elif kind.ffn == MOE:
            m = cfg.moe
            cts = counts if counts is not None else sample_counts(rng, cfg, T)
            # device selection per policy and stage type (C1 table, §IV)
            moe_on_pim = use_pim and not mix.is_mixed
            if hetero:
                # PIM devices own the (single) MoE weight copy: every stage's
                # MoE runs there, mixed stages included => compute-bound tail
                t_moe = _moe_time_ep(system, cfg, cts, pim, n_dev)
                e_dev = pim
            elif policy == "gpu" or (policy == "duplex" and not moe_on_pim):
                t_moe = _moe_time_ep(system, cfg, cts, xpu)
                e_dev = xpu
            elif policy == "duplex":
                t_moe = _moe_time_ep(system, cfg, cts, pim)
                e_dev = pim
            else:  # co-processing policies
                et = policy == "duplex_pe_et" or system.moe_dist == "et"
                t_moe, t_x, t_p = _moe_time_coproc(system, cfg, cts, xpu,
                                                   pim, et=et)
                e_dev = pim if t_p >= t_x else xpu
            # all-to-all dispatch+combine (in-node; IB share across nodes)
            a2a_bytes = BYTES * T * m.top_k * d * 2
            bw = system.nvlink_bw if nodes == 1 else system.ib_bw
            comm = _comm_time(a2a_bytes / n_dev, bw)
            mats = 3 if cfg.gated_ffn else 2
            flops_l = 2.0 * mats * int(cts.sum()) * d * m.d_ff_expert
            bytes_l = (BYTES * mats * d * m.d_ff_expert
                       * int((cts > 0).sum())
                       + BYTES * int(cts.sum())
                       * (2 * d + mats * m.d_ff_expert))
            out.add("moe", (t_moe + comm) * mult,
                    e_dev.energy(flops_l, bytes_l) * mult)
            out.energy += a2a_bytes * 8.0 * E_IO_EXT * 1e-12 * mult

    # LM head (per output token; xPU, vocab-TP)
    out_tokens = mix.batch_size
    fl = 2.0 * out_tokens * d * cfg.vocab_size
    by = BYTES * (d * cfg.vocab_size) + BYTES * out_tokens * cfg.vocab_size
    out.add("lm_head", xpu.time(fl / n_dev, by / n_dev), xpu.energy(fl, by))
    return out
