"""Configurations the port serves, and ``resolve_config`` by name."""
import importlib

from repro_torch.configs.base import (ATTN, MAMBA, MOE, LayerKind, ModelConfig,
                                      MoEConfig, RunConfig, Segment, SSMConfig,
                                      reduced_config, small_test_config)

# the full configurations by name, each in a module of its own
_MODULES = {"olmoe-1b-7b": "olmoe_1b_7b", "jamba-v0.1-52b": "jamba_v0_1_52b",
            "gemma3-4b": "gemma3_4b", "qwen3-8b": "qwen3_8b",
            "command-r-35b": "command_r_35b", "mistral-large-123b": "mistral_large_123b",
            "mamba2-2.7b": "mamba2_2p7b", "deepseek-moe-16b": "deepseek_moe_16b",
            "whisper-small": "whisper_small", "internvl2-1b": "internvl2_1b"}


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
    if name not in _MODULES:
        raise KeyError(f"unknown config {name!r}: the port serves tiny-moe, tiny-dense, "
                       f"{', '.join(_MODULES)}")
    cfg = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG
    return reduced_config(cfg) if reduced else cfg


__all__ = ["ATTN", "MAMBA", "MOE", "LayerKind", "ModelConfig", "MoEConfig",
           "RunConfig", "SSMConfig", "Segment", "reduced_config", "resolve_config",
           "small_test_config"]
