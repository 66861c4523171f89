"""Configurations the port serves, and ``resolve_config`` by name."""
from repro_torch.configs.base import (ATTN, MOE, LayerKind, ModelConfig,
                                      MoEConfig, Segment, small_test_config)


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
    raise KeyError(f"unknown config {name!r}: the port serves tiny-moe, "
                   f"tiny-dense and olmoe-1b-7b")


__all__ = ["ATTN", "MOE", "LayerKind", "ModelConfig", "MoEConfig", "Segment",
           "resolve_config", "small_test_config"]
