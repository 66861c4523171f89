"""Parameters: the seeded initialiser and the bridge from numpy trees.

The tree has the reference's nesting (``repro/models/model.py::model_specs``):
``embed.table``, ``segments[i].blocks[j].{norm1, mixer, norm2, ffn}``,
``final_norm.scale`` and ``lm_head.table``; every leaf under a segment has a
leading stacked ``layers`` axis, so layer i of a segment is ``leaf[i]``.

* :func:`init_model` draws a fresh tree from its own ``torch.Generator``
  with the reference's init kinds (``normal`` scaled by 1/sqrt(fan-in),
  ``small_normal`` = 0.02, ``ones``) and dtypes (router in float32). Its
  numbers differ from ``jax.random``'s for the same seed.
* :func:`from_numpy_tree` converts a tree of numpy arrays — e.g. the JAX
  package's parameters passed through ``np.asarray`` — into the port's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DENSE, MOE, NONE, ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Spec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: str
    init: str = "normal"       # normal | small_normal | ones | zeros


def _dense(d_in, d_out, pd, bias=False):
    out = {"kernel": Spec((d_in, d_out), pd)}
    if bias:
        out["bias"] = Spec((d_out,), pd, "zeros")
    return out


def _block_specs(cfg: ModelConfig, kind) -> dict:
    d, hd, pd = cfg.d_model, cfg.resolved_head_dim, cfg.param_dtype
    mixer = {"wq": _dense(d, cfg.num_heads * hd, pd, cfg.attn_bias),
             "wk": _dense(d, cfg.num_kv_heads * hd, pd, cfg.attn_bias),
             "wv": _dense(d, cfg.num_kv_heads * hd, pd, cfg.attn_bias),
             "wo": _dense(cfg.num_heads * hd, d, pd)}
    if cfg.qk_norm:
        mixer["q_norm"] = {"scale": Spec((hd,), pd, "ones")}
        mixer["k_norm"] = {"scale": Spec((hd,), pd, "ones")}
    specs: Dict[str, Any] = {"norm1": {"scale": Spec((d,), pd, "ones")},
                             "mixer": mixer}
    if kind.ffn != NONE and not cfg.parallel_block:
        specs["norm2"] = {"scale": Spec((d,), pd, "ones")}
    if kind.ffn == DENSE:
        specs["ffn"] = {"wi_gate": Spec((d, cfg.d_ff), pd),
                        "wi_up": Spec((d, cfg.d_ff), pd),
                        "wo": Spec((cfg.d_ff, d), pd)}
    elif kind.ffn == MOE:
        m = cfg.moe
        specs["ffn"] = {"router": Spec((d, m.num_experts), "float32", "small_normal"),
                        "wo": Spec((m.num_experts, m.d_ff_expert, d), pd),
                        "wi_gate": Spec((m.num_experts, d, m.d_ff_expert), pd),
                        "wi_up": Spec((m.num_experts, d, m.d_ff_expert), pd)}
    return specs


def _stack(tree, n: int):
    if isinstance(tree, Spec):
        return Spec((n,) + tree.shape, tree.dtype, tree.init)
    if isinstance(tree, tuple):
        return tuple(_stack(v, n) for v in tree)
    return {k: _stack(v, n) for k, v in tree.items()}


def model_specs(cfg: ModelConfig) -> dict:
    """The parameter tree as :class:`Spec` leaves (gated SwiGLU FFNs, no
    shared experts — the architectures the port serves)."""
    assert cfg.gated_ffn and not (cfg.moe and cfg.moe.num_shared_experts), \
        "the port serves gated FFNs without shared experts"
    specs: Dict[str, Any] = {
        "embed": {"table": Spec((cfg.vocab_size, cfg.d_model), cfg.param_dtype,
                                "small_normal")},
        "segments": tuple(
            _stack({"blocks": tuple(_block_specs(cfg, k) for k in seg.pattern)},
                   seg.repeats) for seg in cfg.segments),
        "final_norm": {"scale": Spec((cfg.d_model,), cfg.param_dtype, "ones")},
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"table": Spec((cfg.vocab_size, cfg.d_model),
                                          cfg.param_dtype, "small_normal")}
    return specs


def _materialize(spec: Spec, gen: torch.Generator, device) -> torch.Tensor:
    dtype = DTYPES[spec.dtype]
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = 0.02 if spec.init == "small_normal" else 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    # one leading slice at a time bounds the float32 staging buffer
    for i in range(spec.shape[0] if len(spec.shape) >= 3 else 1):
        dst = out[i] if len(spec.shape) >= 3 else out
        src = torch.randn(dst.shape, generator=gen, device=device, dtype=torch.float32)
        dst.copy_(src.mul_(std))
    return out


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, Spec):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters at ``cfg``'s widths, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_model(device='cuda') but no CUDA device is "
                           "available; pass device='cpu' explicitly")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return _map(model_specs(cfg), lambda s: _materialize(s, gen, device))


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")                 # writable, contiguous copy
    if a.dtype.name == "bfloat16":             # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_numpy_tree(tree, device="cuda"):
    """Convert a parameter tree of numpy arrays (dicts / tuples / lists of
    arrays, the reference's nesting) into the port's tensors on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("from_numpy_tree(device='cuda') but no CUDA device "
                           "is available; pass device='cpu' explicitly")
    return _map(tree, lambda a: _to_tensor(a, device))
