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
padded) and Jamba-v0.1's (8 at 8); the int8 paged decode's split route
(``csrc/decode_sm90.cu``; pages a split and stages) and the int8 chunk
attention (``csrc/chunk_int8_sm90.cu``; keys a step) at ``chip_smoke.py``'s
int8 shapes (OLMoE-1B-7B's KV 16, qpk 1, hd 128, page 16, and a GQA qpk 4;
path b's decode lengths 144-544 and its 64-token chunk after 448
positions):

    PYTHONPATH=src python -m repro_torch.kernels.tune [section ...]

with sections among hot_gemm, cold_gemv, decode_attention, int8_decode,
int8_chunk and int8_scaling (the int8 attention beside the bf16 one at
contexts of 64-1024 keys; all when none is named). Prints one line a setting and round;
the kernels are built at first use. The int8 sections call only the int8
wrappers, so the script also times another checkout's kernels:
``PYTHONPATH=<checkout>/src python src/repro_torch/kernels/tune.py
int8_decode int8_chunk`` (a checkout without the split constant is timed
once, as it is).
"""
from __future__ import annotations

import sys

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
# (pages a split, stages) of the int8 paged decode, and keys a step of the
# int8 chunk (16-key pages: 4, 2 or 1 a step); the first is the shipped one
INT8_SETTINGS = [(8, 2), (4, 2), (16, 2), (8, 3), (8, 1)]
INT8_CHUNK_STEP_KEYS = [64, 32, 16]
# chip_smoke.py's decode lengths: its seeded row and path a's (path b's too)
ROW_LENS = (0, 1, 15, 16, 17, 100, 257, 511, 512, 640, 700, 800, 900, 1000, 1023, 1024)
PATH_LENS = tuple(round(144 + i * 400 / 15) for i in range(16))


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


def _int8_pools(gen, lens, KV, page=16, hd=128, maxp=64):
    """int8 pools quantized from random K/V, block tables giving each
    sequence its own pages (unused columns on the null page 0)."""
    from repro_torch.kernels.quant import int8_quantize
    P = 1 + len(lens) * maxp
    k8, ks = int8_quantize(torch.randn((P, KV, page, hd), generator=gen, device="cuda"))
    v8, vs = int8_quantize(torch.randn((P, KV, page, hd), generator=gen, device="cuda"))
    bt = torch.zeros((len(lens), maxp), dtype=torch.int32, device="cuda")
    ids = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    nxt = 0
    for b, n in enumerate(lens):
        need = -(-n // page)
        bt[b, :need] = ids[nxt:nxt + need].to(torch.int32)
        nxt += need
    return k8, ks, v8, vs, bt


def int8_decode_cases():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {}
    for label, lens, KV, qpk in (("olmoe", ROW_LENS, 16, 1), ("gqa qpk4", ROW_LENS, 4, 4),
                                 ("path b", PATH_LENS, 16, 1)):
        k8, ks, v8, vs, bt = _int8_pools(gen, lens, KV)
        q = torch.randn((len(lens), KV, qpk, 128), generator=gen, device="cuda").to(
            torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        out[label] = (q, k8, ks, v8, vs, lengths, bt)
    return out


def int8_chunk_cases():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {}
    for label, starts, clens, KV, qpk in (
            ("olmoe Sc64", (0, 64, 448, 0), (64, 64, 30, 0), 16, 1),
            ("gqa qpk4 Sc64", (0, 64, 448, 0), (64, 64, 30, 0), 4, 4),
            ("path b start448", (448,), (64,), 16, 1)):
        totals = [a + c for a, c in zip(starts, clens)]
        k8, ks, v8, vs, bt = _int8_pools(gen, totals, KV)
        q = torch.randn((len(starts), KV, 64 * qpk, 128), generator=gen, device="cuda").to(
            torch.bfloat16)
        ints = [torch.tensor(x, dtype=torch.int32, device="cuda") for x in (totals, starts)]
        out[label] = ((q, k8, ks, v8, vs, *ints, bt), qpk)
    return out


def tune_int8_decode() -> None:
    cases = int8_decode_cases()
    split = hasattr(da, "INT8_PAGES_PER_SPLIT")
    shipped = (da.INT8_PAGES_PER_SPLIT, da.STAGES) if split else None
    for rnd in range(2):
        for setting in INT8_SETTINGS if split else [None]:
            if setting:
                da.INT8_PAGES_PER_SPLIT, da.STAGES = setting
            times = {name: graph_ms(lambda a=args: da.paged_decode_attention_int8_kernel(*a))
                     for name, args in cases.items()}
            what = (f"pages/split={setting[0]} stages={setting[1]}" if setting
                    else "as checked out")
            print(f"tune int8_decode round {rnd} {what}: "
                  + " ".join(f"{n}={t:.4f}ms" for n, t in times.items()), flush=True)
    if split:
        da.INT8_PAGES_PER_SPLIT, da.STAGES = shipped


def tune_int8_chunk() -> None:
    cases = int8_chunk_cases()
    steps = hasattr(da, "INT8_CHUNK_STEP_KEYS")
    shipped = da.INT8_CHUNK_STEP_KEYS if steps else None
    for rnd in range(2):
        for keys in INT8_CHUNK_STEP_KEYS if steps else [None]:
            if keys:
                da.INT8_CHUNK_STEP_KEYS = keys
            times = {name: graph_ms(
                lambda a=args, k=qpk: da.chunked_prefill_attention_int8_kernel(*a, qpk=k))
                for name, (args, qpk) in cases.items()}
            what = f"keys/step={keys}" if keys else "as checked out"
            print(f"tune int8_chunk round {rnd} {what}: "
                  + " ".join(f"{n}={t:.4f}ms" for n, t in times.items()), flush=True)
    if steps:
        da.INT8_CHUNK_STEP_KEYS = shipped


def int8_scaling() -> None:
    """Device time against context length, int8 beside bf16 at the same
    shape (OLMoE-1B-7B's KV 16, qpk 1, hd 128, page 16): one 64-token chunk
    after `start` positions, and a decode stage of 16 rows of `start` + 64
    keys each; the slope is the cost a page, the intercept a launch's fixed
    cost."""
    from repro_torch.kernels.quant import int8_quantize
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for start in (0, 64, 192, 448, 960):
        n = start + 64
        k = torch.randn((1 + 16 * 64, 16, 16, 128), generator=gen, device="cuda")
        v = torch.randn_like(k)
        (k8, ks), (v8, vs) = int8_quantize(k), int8_quantize(v)
        kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
        bt = (torch.arange(16 * 64, device="cuda").reshape(16, 64) + 1).to(torch.int32)
        tot = torch.full((1,), n, dtype=torch.int32, device="cuda")
        st = torch.full((1,), start, dtype=torch.int32, device="cuda")
        qc = torch.randn((1, 16, 64, 128), generator=gen, device="cuda").to(torch.bfloat16)
        qd = torch.randn((16, 16, 1, 128), generator=gen, device="cuda").to(torch.bfloat16)
        lens = torch.full((16,), n, dtype=torch.int32, device="cuda")
        times = {
            "int8 chunk": graph_ms(lambda: da.chunked_prefill_attention_int8_kernel(
                qc, k8, ks, v8, vs, tot, st, bt[:1], qpk=1)),
            "bf16 chunk": graph_ms(lambda: da.chunked_prefill_attention_kernel(
                qc, kb, vb, tot, st, bt[:1], qpk=1)),
            "int8 decode": graph_ms(lambda: da.paged_decode_attention_int8_kernel(
                qd, k8, ks, v8, vs, lens, bt)),
            "bf16 decode": graph_ms(lambda: da.paged_decode_attention_kernel(
                qd, kb, vb, lens, bt)),
        }
        print(f"tune int8_scaling keys={n} pages={n // 16}: "
              + " ".join(f"{name}={t:.4f}ms" for name, t in times.items()), flush=True)
        del k, v, k8, v8, kb, vb


def tune_cold_gemv() -> None:
    gemv = gemv_cases()
    for rnd in range(2):
        for stages in GEMV_STAGES:
            mg.STAGES = stages
            times = {name: graph_ms(lambda f=fn, a=args: f(*a))
                     for name, (fn, args) in gemv.items()}
            print(f"tune cold_gemv round {rnd} stages={stages}: "
                  + " ".join(f"{n}={t:.4f}ms" for n, t in times.items()), flush=True)
    mg.STAGES = GEMV_STAGES[0]


def tune_decode_attention() -> None:
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


SECTIONS = {"hot_gemm": tune_gemm, "cold_gemv": tune_cold_gemv,
            "decode_attention": tune_decode_attention, "int8_decode": tune_int8_decode,
            "int8_chunk": tune_int8_chunk, "int8_scaling": int8_scaling}


def main(argv=None) -> None:
    names = list(sys.argv[1:] if argv is None else argv) or list(SECTIONS)
    unknown = [n for n in names if n not in SECTIONS]
    if unknown:
        raise SystemExit(f"unknown sections {unknown}; choose among {list(SECTIONS)}")
    for name in names:
        SECTIONS[name]()


if __name__ == "__main__":
    main()
