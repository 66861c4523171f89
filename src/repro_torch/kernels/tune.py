"""Times kernels on the card at other settings of their constants, by
CUDA-graph replay, in turns: the bf16 hot GEMMs (``csrc/moe_gemm_sm90.cu``;
stages) against the other tensor-core design, ``mma.sync`` with the live
rows as M (the cold GEMV's kernel, ``csrc/moe_gemv_sm90.cu``, which
computes the same function in passes of 64 rows), at OLMoE-1B-7B's widths
(32 hot experts at capacity 64, ragged and padded, and at 128) and
Jamba-v0.1's (8 at 8); the dense decode attention (``csrc/decode_sm90.cu``;
tile, tiles a split and stages) at ``chip_smoke.py``'s two bf16 shapes
(Jamba-v0.1's KV 8, qpk 4, hd 128, Smax 1024; lengths 0-1024 seeded, and
path c's 128-544), and the bf16 cold GEMVs (``csrc/moe_gemv_sm90.cu``;
stages) at OLMoE-1B-7B's widths (48 experts at capacity 48, ragged and
padded) and Jamba-v0.1's (8 at 8):

    PYTHONPATH=src python -m repro_torch.kernels.tune

Prints one line a setting and round; the kernels are built at first use.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attn as da
from repro_torch.kernels import moe_gemm as hm
from repro_torch.kernels import moe_gemv as mg

# (positions a tile, tiles a split, stages); the first is the shipped one
SETTINGS = [(32, 4, 2), (16, 8, 2), (16, 4, 2), (64, 2, 2)]
# weight stages of the cold GEMVs; the first is the shipped one
GEMV_STAGES = [2, 3, 4, 6, 8]
# weight stages of the hot GEMMs; the first is the shipped one (at C > 64
# the kernel fits at most 4, so 5 runs as 4 there)
GEMM_STAGES = [2, 3, 4, 5]


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time a call: ``iters`` calls captured in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def shapes():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B, KV, qpk, hd, Smax = 16, 8, 4, 128, 1024
    row = torch.randint(0, Smax + 1, (B,), generator=gen, device="cuda").to(torch.int32)
    row[0], row[1] = 0, Smax
    path_c = torch.tensor([round(128 + i * 416 / 15) for i in range(B)], dtype=torch.int32,
                          device="cuda")
    r = lambda *s: torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
    k, v, q = r(B, Smax, KV, hd), r(B, Smax, KV, hd), r(B, KV, qpk, hd)
    return {"row": (q, k, v, row), "path c": (q, k, v, path_c)}


def _experts(gen, E, n, C, d, f):
    w = lambda *s: (torch.randn(s, generator=gen, device="cuda") / s[-2] ** 0.5).to(
        torch.bfloat16)
    ws = (w(E, d, f), w(E, d, f), w(E, f, d))
    x = torch.randn((n, C, d), generator=gen, device="cuda").to(torch.bfloat16)
    perm = torch.randperm(E, generator=gen, device="cuda")[:n].to(torch.int32)
    counts = torch.randint(0, C + 1, (n,), generator=gen, device="cuda").to(torch.int32)
    return x, ws, perm, counts


def gemm_cases():
    """{label: (hot GEMM call, the mma.sync kernel's call, args)}"""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {}
    for label, E, n, C, d, f in (("olmoe C64", 64, 32, 64, 2048, 1024),
                                 ("olmoe C128", 64, 32, 128, 2048, 1024),
                                 ("jamba", 16, 8, 8, 4096, 14336)):
        x, ws, perm, counts = _experts(gen, E, n, C, d, f)
        out[f"{label} ragged"] = (hm.ragged_moe_gemm_kernel, mg.ragged_moe_gemv_kernel,
                                  (x, *ws, perm, counts))
        if label == "olmoe C64":
            out[f"{label} padded"] = (hm.moe_gemm_kernel, mg.moe_gemv_kernel,
                                      (x, *ws, perm))
    return out


def tune_gemm() -> None:
    cases = gemm_cases()
    for rnd in range(2):
        for stages in GEMM_STAGES:
            hm.STAGES = stages
            times = {name: graph_ms(lambda f=fn, a=args: f(*a))
                     for name, (fn, _, args) in cases.items()}
            print(f"tune hot_gemm round {rnd} wgmma stages={stages}: "
                  + " ".join(f"{n}={t:.4f}ms" for n, t in times.items()), flush=True)
        times = {name: graph_ms(lambda f=fn, a=args: f(*a))
                 for name, (_, fn, args) in cases.items()}
        print(f"tune hot_gemm round {rnd} mma.sync (moe_gemv_sm90.cu, stages="
              f"{mg.STAGES}): " + " ".join(f"{n}={t:.4f}ms" for n, t in times.items()),
              flush=True)
    hm.STAGES = GEMM_STAGES[0]


def gemv_cases():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {}
    for label, E, n, C, d, f in (("olmoe", 64, 48, 48, 2048, 1024),
                                 ("jamba", 16, 8, 8, 4096, 14336)):
        x, ws, perm, counts = _experts(gen, E, n, C, d, f)
        out[f"{label} ragged"] = (mg.ragged_moe_gemv_kernel, (x, *ws, perm, counts))
        if label == "olmoe":
            out[f"{label} padded"] = (mg.moe_gemv_kernel, (x, *ws, perm))
    return out


def main() -> None:
    tune_gemm()
    gemv = gemv_cases()
    for rnd in range(2):
        for stages in GEMV_STAGES:
            mg.STAGES = stages
            times = {name: graph_ms(lambda f=fn, a=args: f(*a))
                     for name, (fn, args) in gemv.items()}
            print(f"tune cold_gemv round {rnd} stages={stages}: "
                  + " ".join(f"{n}={t:.4f}ms" for n, t in times.items()), flush=True)
    mg.STAGES = GEMV_STAGES[0]
    del gemv
    cases = shapes()
    shipped = (da.DENSE_TILE, da.DENSE_TILES_PER_SPLIT, da.STAGES)
    for rnd in range(2):
        for tile, tps, stages in SETTINGS:
            da.DENSE_TILE, da.DENSE_TILES_PER_SPLIT, da.STAGES = tile, tps, stages
            times = {name: graph_ms(lambda a=args: da.decode_attention_kernel(*a))
                     for name, args in cases.items()}
            print(f"tune decode_attention round {rnd} tile={tile} tiles/split={tps} "
                  f"stages={stages}: " + " ".join(f"{n}={t:.4f}ms" for n, t in times.items()),
                  flush=True)
    da.DENSE_TILE, da.DENSE_TILES_PER_SPLIT, da.STAGES = shipped


if __name__ == "__main__":
    main()
