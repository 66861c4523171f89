"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds. Builds happen at first use, one ``nvcc``
per source all started together, into ``_build/`` beside this file (listed
in ``.gitignore``); a library is named by a hash of its sources and flags,
so an edited source is rebuilt and an unchanged one is reused.

Launch counts live here too: each wrapper adds one to its kernel's count
when it launches the kernel, and nowhere else, so a caller can show that a
run really went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("decode_attn.cu", "moe_gemm.cu", "moe_gemv.cu", "ssd_decode.cu",
           "flash_attn.cu", "flash_fwd_sm90.cu", "flash_bwd_sm90.cu",
           "chunk_attn_sm90.cu", "decode_sm90.cu", "moe_gemv_sm90.cu", "moe_gemm_sm90.cu",
           "chunk_int8_sm90.cu", "chunk_f32_sm90.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DTYPE_CODES = {"float32": 0, "bfloat16": 1}   # csrc/common.cuh DTYPE_*

# one entry per kernel wrapper; see module docstring
launch_counts: Dict[str, int] = {
    "paged_decode_attention": 0,
    "chunked_prefill_attention": 0,
    # the bf16 and float32 tensor-core routes of the one above, counted in both
    "chunked_prefill_attention_sm90": 0,
    "chunked_prefill_attention_f32_sm90": 0,
    "ragged_moe_gemm": 0,
    "ragged_moe_gemv": 0,
    # the bf16 tensor-core routes of the hot GEMMs and the cold GEMVs,
    # counted in both
    "ragged_moe_gemm_sm90": 0,
    "moe_gemm_sm90": 0,
    "ragged_moe_gemv_sm90": 0,
    "moe_gemv_sm90": 0,
    "paged_decode_attention_int8": 0,
    "chunked_prefill_attention_int8": 0,
    # the split route of the int8 paged decode (decode_sm90.cu) and the
    # tensor-core route of the int8 chunk (chunk_int8_sm90.cu), counted in both
    "paged_decode_attention_int8_sm90": 0,
    "chunked_prefill_attention_int8_sm90": 0,
    "moe_gemm": 0,
    "moe_gemv": 0,
    "decode_attention": 0,
    "ssd_decode": 0,
    "flash_attention": 0,
    "flash_attention_bwd": 0,
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME
        home = CUDA_HOME
    cand = Path(home) / "bin" / "nvcc" if home else None
    if cand is not None and cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):       # headers feed every source
        if p.suffix == ".cuh" or p.name == source:
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.
    Returns {source: library path}; raises with nvcc's output on failure.
    The ptxas report (registers, shared memory, spills) of each build is
    kept beside its library as ``<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {s: _lib_path(s) for s in SOURCES}
    todo = {s: p for s, p in paths.items() if not p.exists()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for s, p in todo.items():
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / s)]
            procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), tmp)
        errors = []
        for s, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            paths[s].with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {s} (exit {proc.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, paths[s])
        if errors:
            raise RuntimeError("\n".join(errors))
    return paths


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (building every kernel first if
    needed)."""
    with _lock:
        if source not in _libs:
            for s, p in build_all().items():
                _libs[s] = ctypes.CDLL(str(p))
        return _libs[source]


@functools.lru_cache(maxsize=None)
def bind(source: str, name: str, n_ptr: int, n_int: int, n_float: int = 0):
    """C function ``name`` of ``source`` with the argument layout (int dtype,
    n_ptr pointers, n_int ints, n_float floats, stream) shared by every
    kernel entry point here. Pointers and the stream pass as c_void_p — a
    plain Python int would be cut to 32 bits."""
    fn = getattr(library(source), name)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptr
                   + [ctypes.c_int] * n_int + [ctypes.c_float] * n_float
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {err})")
