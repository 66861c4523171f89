"""A torch mirror of the float32 chunk kernel's arithmetic, for the tests.

``chunk_f32_sm90.cu`` computes the float32 chunked-prefill attention on the
tensor cores in 3xTF32: each float32 operand is split into a TF32 high part
and a TF32 low part (``cvt.rna.tf32.f32``: to nearest, ties away from zero)
and each product is taken as lo hi + hi lo + hi hi in float32, over 64-key
tiles assembled from a sequence's live pages, with the online softmax in
float32 between them (each 32-key half of a tile its own, merged at the
end, and with splits each split's, merged in order).
``chunk_attention_tf32`` does the same in plain torch, so a test can hold
it against the JAX package's Pallas kernel on the CPU
(``tests/test_torch_chunk_f32.py``) and against the kernel on the card
(``tests/test_torch_cuda.py``). Not a ``test_`` file: nothing is collected
here.

    PYTHONPATH=src python tests/torch_chunk_mirror.py

prints, for the CPU test's cases, the largest difference from the Pallas
kernel (interpret mode) of the mirror with three products and with one
(hi hi alone), which is why the kernel takes three."""
import math

import torch

NEG_INF = -1e30    # the reference kernels' mask value
KT = 64            # keys a tile, as the kernel's


def tf32_split(x):
    """x (float32) = hi + lo, each rounded to TF32 as ``cvt.rna.tf32.f32``
    rounds: 13 low mantissa bits dropped, to nearest, ties away from zero
    (adding half of the dropped unit to the magnitude's bits carries into
    the kept ones exactly when the dropped part is at least half)."""
    def rna(t):
        return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def mm_tf32(a, b, products=3):
    """a @ b from TF32 parts in float32: (lo hi + hi lo) + hi hi, each
    product summed on its own as the kernel's score accumulators are, or hi
    hi alone with ``products=1``."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    if products == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def chunk_attention_tf32(q, k_pages, v_pages, totals, starts, block_tables, *, qpk: int,
                         softcap: float = 0.0, products: int = 3, nsplit: int = 1):
    """The layout of ``chunked_prefill_attention_plain``, float32: q (B, KV,
    R, hd) with R = Sc * qpk, heads innermost; pools (P, KV, page, hd);
    totals, starts (B,); block_tables (B, maxp). Per 64-row tile of a
    sequence, the keys below kend = min(total, maxp * page, the tile's last
    position + 1) in tiles of 64 from the live pages (keys of pages past
    the one holding kend - 1 read as zeros), each tile's scores and P V
    from TF32 parts. As in the kernel, the tiles go to ``nsplit`` splits in
    runs of ceil(tiles / nsplit); in each split the two 32-key halves of
    every tile keep their own running max, sum and accumulator, merged at
    the split's end, and the splits merge in order. -> (B, KV, R, hd)
    float32."""
    B, KV, R, hd = q.shape
    page, maxp = k_pages.shape[2], block_tables.shape[1]
    scale = 1.0 / math.sqrt(hd)
    out = torch.zeros_like(q)
    for b in range(B):
        total, start = int(totals[b]), int(starts[b])
        klim = min(total, maxp * page)
        for r0 in range(0, R, 64):
            r1 = min(r0 + 64, R)
            qpos = start + torch.arange(r0, r1) // qpk                   # (rows,)
            kend = min(klim, start + (r1 - 1) // qpk + 1)
            if kend <= 0:
                continue
            n_pages, n_tiles = -(-kend // page), -(-kend // KT)
            per = -(-n_tiles // nsplit)
            qt = q[b, :, r0:r1]                                          # (KV, rows, hd)
            splits = []
            for j0 in range(0, n_tiles, per):
                halves = [[torch.full((KV, r1 - r0, 1), NEG_INF), torch.zeros((KV, r1 - r0, 1)),
                           torch.zeros((KV, r1 - r0, hd))] for _ in range(2)]
                for t0 in range(j0 * KT, min(n_tiles, j0 + per) * KT, KT):
                    for h, state in enumerate(halves):
                        kpos = torch.arange(t0 + h * KT // 2, t0 + (h + 1) * KT // 2)
                        pg = kpos // page
                        on = pg < n_pages
                        pid = block_tables[b, pg.clamp_max(n_pages - 1)].long()
                        k, v = (torch.where(on[None, :, None],
                                            pages[pid, :, kpos % page].transpose(0, 1), 0.0)
                                for pages in (k_pages, v_pages))         # (KV, 32, hd)
                        s = mm_tf32(qt, k.transpose(1, 2), products) * scale
                        if softcap > 0.0:
                            s = softcap * torch.tanh(s / softcap)
                        valid = (kpos[None] <= qpos[:, None]) & (kpos[None] < klim)
                        s = torch.where(valid[None], s, -torch.inf)
                        m, l, acc = state
                        mx = torch.maximum(m, s.amax(-1, keepdim=True))
                        alpha = torch.exp(m - mx)
                        p = torch.exp(s - mx)
                        state[:] = [mx, l * alpha + p.sum(-1, keepdim=True),
                                    acc * alpha + mm_tf32(p, v, products)]
                (m0, l0, acc0), (m1, l1, acc1) = halves
                mx = torch.maximum(m0, m1)
                a0, a1 = torch.exp(m0 - mx), torch.exp(m1 - mx)
                splits.append((mx, l0 * a0 + l1 * a1, acc0 * a0 + acc1 * a1))
            if len(splits) == 1:
                _, l, acc = splits[0]
            else:
                mx = torch.stack([m for m, _, _ in splits]).amax(0)
                l, acc = 0.0, 0.0
                for m, ls, a in splits:
                    w = torch.exp(m - mx)
                    l, acc = l + ls * w, acc + a * w
            out[b, :, r0:r1] = acc / l.clamp_min(1e-37)
    return out


def main():
    import numpy as np
    import jax.numpy as jnp
    from repro.kernels.decode_attn import chunked_prefill_attention_kernel as pallas_chunk
    from test_torch_chunk_f32 import CASES, case_inputs

    for case in CASES:
        q, k, v, totals, starts, bt = case_inputs(*case[:3])
        hd, page, qpk, softcap = case
        want = np.asarray(pallas_chunk(*map(jnp.asarray, (q, k, v, totals, starts, bt)),
                                       qpk=qpk, softcap=softcap, interpret=True))
        errs = []
        for products in (3, 1):
            got = chunk_attention_tf32(*map(torch.tensor, (q, k, v, totals, starts, bt)),
                                       qpk=qpk, softcap=softcap, products=products).numpy()
            errs.append(float(np.abs(got - want).max()))
        print(f"hd {hd} page {page} qpk {qpk} softcap {softcap}: max |mirror - Pallas| "
              f"three products {errs[0]:.3e}, one product {errs[1]:.3e} "
              f"(max |Pallas| {float(np.abs(want).max()):.3f})")


if __name__ == "__main__":
    main()
