"""Roofline terms of a step from the dry run's per-op counts.

Port of ``repro/launch/roofline.py``. Three terms per (arch x shape x mesh)
cell, in seconds, from per-device counts (``launch/op_cost.py``):

  compute    = flops_per_device            / peak FLOP/s
  memory     = bytes_per_device            / HBM bandwidth
  collective = collective_bytes_per_device / link bandwidth

Hardware constants: one NVIDIA H100 SXM, 989e12 FLOP/s bf16 dense and
3.35e12 B/s HBM3 (the figures of ``PERF.md`` section 6 and
``chip_smoke.py``), and 50e9 B/s of link per GPU: one 400 Gb/s NDR
InfiniBand port per GPU, as in a DGX H100. Every mesh axis of the (16, 16)
and (2, 16, 16) production meshes spans more than one 8-GPU NVLink node,
so the network, not NVLink, bounds each collective.

The reference parses collective operand sizes out of HLO text
(``collective_bytes_from_hlo``); the port has no HLO, and the walker
counts the collective ops as they run.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig

PEAK_FLOPS = 989e12        # bf16 dense, per H100 SXM
HBM_BW = 3.35e12           # B/s per H100 (HBM3)
LINK_BW = 50e9             # B/s per GPU: one 400 Gb/s NDR InfiniBand port


@dataclass
class RooflineTerms:
    chips: int
    # per-device quantities (the walker's counts on one shard)
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, int] = field(default_factory=dict)
    # analytic model quantities (useful work, from core/opb.py)
    model_flops_global: float = 0.0
    model_bytes_global: float = 0.0

    @property
    def flops_global(self) -> float:
        return self.flops_per_device * self.chips

    @property
    def bytes_global(self) -> float:
        return self.bytes_per_device * self.chips

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — remat, padding and redundancy."""
        if self.flops_global <= 0:
            return 0.0
        return self.model_flops_global / self.flops_global

    @property
    def useful_byte_ratio(self) -> float:
        """analytic-minimum bytes / counted bytes — re-reads and unfused
        intermediates."""
        if self.bytes_global <= 0:
            return 0.0
        return self.model_bytes_global / self.bytes_global

    @property
    def t_ideal(self) -> float:
        """The time the *useful* work needs on this hardware: the larger of
        the analytic compute and memory terms."""
        return max(self.model_flops_global / self.chips / PEAK_FLOPS,
                   self.model_bytes_global / self.chips / HBM_BW)

    @property
    def roofline_fraction(self) -> float:
        """t_ideal / t_bound: how close the counted step is to the analytic
        roofline of its own workload (1.0 = no waste anywhere)."""
        if self.t_bound <= 0:
            return 0.0
        return self.t_ideal / self.t_bound

    @property
    def flop_mfu_at_bound(self) -> float:
        """Classic MFU view (useful FLOPs / peak at t_bound)."""
        if self.t_bound <= 0:
            return 0.0
        return self.model_flops_global / self.chips / self.t_bound / PEAK_FLOPS

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, dominant=self.dominant,
                 t_bound=self.t_bound, t_ideal=self.t_ideal,
                 useful_flop_ratio=self.useful_flop_ratio,
                 useful_byte_ratio=self.useful_byte_ratio,
                 roofline_fraction=self.roofline_fraction,
                 flop_mfu_at_bound=self.flop_mfu_at_bound,
                 flops_global=self.flops_global, bytes_global=self.bytes_global)
        return d


def _stage_totals(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[float, float]:
    """(MODEL_FLOPS, MODEL_BYTES): the analytic floors of the workload, the
    reference's. FLOPs: per-op analytic counts (``core/opb.py``), about 6·N·D
    for training and 2·N_active·D for decode, attention explicit. Bytes:
    weights touched once per pass, the KV cache streamed once for decode,
    the optimizer state touched once per training step; activation traffic
    is not part of the floor."""
    from repro_torch.core.opb import decoding_only, mixed, stage_cost_breakdown
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        agg = stage_cost_breakdown(cfg, decoding_only(B, S))
        fl = sum(c.flops for c in agg.values())
        by = sum(c.weight_bytes for c in agg.values())
        by += sum(c.act_bytes for k, c in agg.items()
                  if k in ("attn_decode", "cross_attn", "mamba_decode"))
        return fl, by
    if cfg.is_encoder_decoder:
        S = S // 2  # decoder positions; the encoder mirrors them (2x below)
    agg = stage_cost_breakdown(cfg, mixed(0, 0, B, S))
    fl = sum(c.flops for c in agg.values())
    by = sum(c.weight_bytes for c in agg.values())
    if cfg.is_encoder_decoder:
        fl, by = 2.0 * fl, 2.0 * by
    if shape.kind == "train":
        fl = 3.0 * fl                      # forward + backward
        n = cfg.param_count()
        # weights fwd+bwd reads + grads write/read + fp32 moments read+write
        by = 2.0 * by + 4.0 * n + 16.0 * n
    return fl, by


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    return _stage_totals(cfg, shape)[0]


def model_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    return _stage_totals(cfg, shape)[1]


def terms_from_cost(cost, chips: int, *, model_fl: float = 0.0,
                    model_by: float = 0.0) -> RooflineTerms:
    """RooflineTerms from the walker's per-device ``Cost``."""
    return RooflineTerms(
        chips=chips, flops_per_device=cost.flops, bytes_per_device=cost.bytes,
        collective_bytes_per_device=cost.collective_bytes,
        collective_breakdown={k: int(v) for k, v in cost.collective.items()},
        model_flops_global=model_fl, model_bytes_global=model_by)
