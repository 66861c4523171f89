"""Input stand-ins and logical-axis trees for every (architecture x shape)
cell: the dry run traces against these (``meta`` tensors: nothing is
allocated).

Port of ``repro/launch/specs.py``. Shape conventions:
  * train/prefill: tokens (GB, S) [+ modality-stub embeddings];
  * decode: tokens (GB, 1) against a cache of S positions;
  * whisper (enc-dec): S/2 encoder frames + S/2 decoder positions;
  * internvl2 (vlm): 1024 patch embeddings + (S - 1024) text tokens.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ATTN_CROSS, MAMBA, ModelConfig, ShapeConfig
from repro_torch.models.params import DTYPES

N_PATCH = 1024  # vlm stub: patch positions ahead of text


def sds(shape, dtype) -> torch.Tensor:
    """A ``meta`` stand-in of ``shape`` and ``dtype`` (a torch dtype or its
    name)."""
    dtype = DTYPES.get(dtype, dtype) if isinstance(dtype, str) else dtype
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Stand-ins for the step function's ``batch`` argument."""
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    if cfg.is_encoder_decoder:
        se = sd = S // 2
        if kind == "decode":
            return {"tokens": sds((B, 1), torch.int32)}
        out = {"frames": sds((B, se, cfg.d_model), cfg.dtype),
               "dec_tokens": sds((B, sd), torch.int32)}
        if kind == "prefill":
            out["true_len"] = sds((B,), torch.int32)
        return out
    if cfg.family == "vlm" and kind != "decode":
        n_text = max(S - N_PATCH, 1)
        out = {"tokens": sds((B, n_text), torch.int32),
               "patch_embeds": sds((B, N_PATCH, cfg.d_model), cfg.dtype)}
        if kind == "prefill":
            out["true_len"] = sds((B,), torch.int32)
        return out
    if kind == "decode":
        return {"tokens": sds((B, 1), torch.int32)}
    out = {"tokens": sds((B, S), torch.int32)}
    if kind == "prefill":
        out["true_len"] = sds((B,), torch.int32)
    return out


def batch_axes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Logical axes parallel to ``batch_specs``."""
    out = {}
    for k in batch_specs(cfg, shape):
        if k == "true_len":
            out[k] = ("act_batch",)
        elif k in ("frames", "patch_embeds"):
            out[k] = ("act_batch", None, None)
        else:
            out[k] = ("act_batch", None)
    return out


def _block_cache_axes(kind, kv_quant: bool = False) -> dict:
    if kind.mixer == MAMBA:
        return {"mamba": {
            "conv": ("layers", "act_batch", None, "act_mlp"),
            "ssm": ("layers", "act_batch", "act_heads", None, None),
        }}
    axes = {
        "k": ("layers", "act_batch", "act_kv_seq", "act_kv_heads", None),
        "v": ("layers", "act_batch", "act_kv_seq", "act_kv_heads", None),
        "pos": ("layers", "act_batch", "act_kv_seq"),
        "len": ("layers", "act_batch"),
    }
    if kv_quant:
        axes["k_scale"] = ("layers", "act_batch", "act_kv_seq", "act_kv_heads")
        axes["v_scale"] = axes["k_scale"]
    if kind.mixer == ATTN_CROSS:
        axes["cross_k"] = ("layers", "act_batch", "act_kv_seq", "act_kv_heads", None)
        axes["cross_v"] = axes["cross_k"]
        axes["cross_len"] = ("layers", "act_batch")
    return axes


def cache_axes(cfg: ModelConfig, kv_quant: bool = False) -> list:
    """Logical axes parallel to ``models/model.py::init_cache``'s dense cache."""
    return [{"blocks": tuple(_block_cache_axes(k, kv_quant) for k in seg.pattern)}
            for seg in cfg.segments]


def decode_max_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    return shape.seq_len // 2 if cfg.is_encoder_decoder else shape.seq_len


def cell_input_specs(cfg: ModelConfig, shape: ShapeConfig,
                     kv_quant: bool = False) -> Dict[str, Any]:
    """Everything the cell's step consumes besides the parameters:
    {"batch"}, and for a decode cell {"cache"} (``init_cache`` on
    ``meta``)."""
    from repro_torch.models.model import init_cache
    out: Dict[str, Any] = {"batch": batch_specs(cfg, shape)}
    if shape.kind == "decode":
        out["cache"] = init_cache(cfg, shape.global_batch, decode_max_len(cfg, shape),
                                  device="meta", kv_quant=kv_quant)
    return out


def cell_input_axes(cfg: ModelConfig, shape: ShapeConfig,
                    kv_quant: bool = False) -> Dict[str, Any]:
    out: Dict[str, Any] = {"batch": batch_axes(cfg, shape)}
    if shape.kind == "decode":
        out["cache"] = cache_axes(cfg, kv_quant)
    return out
