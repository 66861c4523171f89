"""Configurations the port serves, and ``resolve_config`` by name."""
from repro_torch.configs.base import (ATTN, MAMBA, MOE, LayerKind, ModelConfig,
                                      MoEConfig, Segment, SSMConfig,
                                      small_test_config)


def resolve_config(name: str) -> ModelConfig:
    """``tiny-moe`` / ``tiny-dense`` (the test configs of the reference's
    ``launch/train.py::resolve_config``) or a full configuration by name."""
    if name == "tiny-dense":
        return small_test_config("tiny-dense")
    if name == "tiny-moe":
        return small_test_config(
            "tiny-moe", family="moe",
            moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=128))
    if name == "olmoe-1b-7b":
        from repro_torch.configs.olmoe_1b_7b import CONFIG
        return CONFIG
    if name == "jamba-v0.1-52b":
        from repro_torch.configs.jamba_v0_1_52b import CONFIG
        return CONFIG
    raise KeyError(f"unknown config {name!r}: the port serves tiny-moe, "
                   f"tiny-dense, olmoe-1b-7b and jamba-v0.1-52b")


__all__ = ["ATTN", "MAMBA", "MOE", "LayerKind", "ModelConfig", "MoEConfig",
           "SSMConfig", "Segment", "resolve_config", "small_test_config"]
