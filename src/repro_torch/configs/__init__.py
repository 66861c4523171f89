"""Configurations the port serves, and ``resolve_config`` by name."""
from repro_torch.configs.base import (ATTN, MAMBA, MOE, LayerKind, ModelConfig,
                                      MoEConfig, RunConfig, Segment, SSMConfig,
                                      reduced_config, small_test_config)


def resolve_config(name: str, reduced: bool = False) -> ModelConfig:
    """``tiny-moe`` / ``tiny-dense`` (the test configs of the reference's
    ``launch/train.py::resolve_config``) or a full configuration by name,
    cut to CPU size by ``reduced_config`` with ``reduced`` (the tiny
    configs are already small and ignore it, as the reference's do)."""
    if name == "tiny-dense":
        return small_test_config("tiny-dense")
    if name == "tiny-moe":
        return small_test_config(
            "tiny-moe", family="moe",
            moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=128))
    if name == "olmoe-1b-7b":
        from repro_torch.configs.olmoe_1b_7b import CONFIG
    elif name == "jamba-v0.1-52b":
        from repro_torch.configs.jamba_v0_1_52b import CONFIG
    else:
        raise KeyError(f"unknown config {name!r}: the port serves tiny-moe, "
                       f"tiny-dense, olmoe-1b-7b and jamba-v0.1-52b")
    return reduced_config(CONFIG) if reduced else CONFIG


__all__ = ["ATTN", "MAMBA", "MOE", "LayerKind", "ModelConfig", "MoEConfig",
           "RunConfig", "SSMConfig", "Segment", "reduced_config", "resolve_config",
           "small_test_config"]
