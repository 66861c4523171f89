// The float32 chunked-prefill attention on Hopper's tensor cores in 3xTF32
// (mma.sync), its paged K/V read through the block tables by cp.async.
//
//   * chunk_f32_sm90_kernel <- src/repro/kernels/decode_attn.py:
//                              chunked_prefill_attention_kernel (fp body
//                              _chunked_prefill_kernel), in float32
//
// bf16 runs chunk_attn_sm90.cu; float32 at other head or page sizes (tiny-moe's
// head_dim 16, head_dim 256) stays the scalar kernel of decode_attn.cu.
//
// What bounds it on the card. The kernel phase's first case (4 sequences,
// 16 KV heads, hd 128, 64-row chunks after prefixes of 0-448 keys) needs
// 315 MFLOP and 15 MB: 0.0045 ms by bytes, 0.0047 ms by operations at the
// CUDA cores' 67 TFLOP/s (0.0019 ms for three products at the TF32 tensor
// cores' 495). So it sits at both bounds at once, and neither sets its time:
// a serving stage's chunk is 16-64 work items on 132 streaming
// multiprocessors, each walking its prefix one key tile after another, and
// the longest item sets the time. So the products run on the tensor cores,
// the softmax in registers, the loads of the next tile overlap them, and a
// call of fewer items than SMs spreads each item's tiles over several
// blocks (splits, merged by a second kernel).
//
// Why 3xTF32 keeps the float32 band. One TF32 product keeps 11 significant
// bits of each operand (relative error 2^-11), far outside the reference's
// 2e-5. Each float32 operand is split into a TF32 high part and a TF32 low
// part, hi = x and lo = x - hi rounded to TF32 as cvt.rna.tf32.f32 rounds
// (to nearest, ties away from zero; x - hi is exact), so x = hi + lo to
// about 2^-22 relative. Then a b = a_hi b_hi + a_hi b_lo +
// a_lo b_hi + a_lo b_lo, and the kernel takes the first three: the dropped
// term is near 2^-22 |a b|. A product of two TF32 values is exact in float32
// and the tensor core accumulates in float32, so each score and each output
// sum is float32's own up to summation order. The design keeps every other
// step in float32 too:
//   * q is split once a block into hi and lo planes in shared memory; K and
//     V are split as their fragments are loaded (no TF32 copy of a tile);
//   * p is split the same way before P V: it is not rounded to a narrower
//     type (the float32 body rounds p to float32, a no-op);
//   * the softmax runs in float32 with the accurate expf and tanhf (no
//     ex2.approx), and the epilogue writes acc / max(l, 1e-37) as the scalar
//     kernel does.
//
// Design (kernel 2's decomposition, chunk_attn_sm90.cu):
//   * A work item is BM = 64 rows of the kernel layout (B, KV, R, hd) of one
//     (sequence, KV head), R = Sc * qpk; row r is chunk position
//     start + r / qpk. Items run one a block, the last row tiles (the longest
//     key ranges) first. Rows past R read as zeros and are never written.
//   * Eight warps: warp w owns rows 16 (w % 4) of the item and keys 32 (w / 4)
//     of every key tile, with its own running max, sum and accumulators; the
//     epilogue merges the two key halves of each row (lane to lane: the same
//     rows and columns) through shared memory. A warp's serial chain a tile
//     is half a tile, and two warps share each sub-partition's scheduler: an
//     item is one block, and at 16-64 items the card's SMs are not all busy,
//     so the time is the chain's latency, not the card's rate.
//   * Each item bounds its key loop on the device: keys below
//     kend = min(total, the table's width, the last row's position + 1), in
//     tiles of KT = 64. Only tiles that cross the causal edge or kend
//     evaluate the mask (kpos <= qpos and kpos < total); an item with
//     total == 0 loads no key and writes zeros.
//   * Splits: the wrapper picks nsplit from the call's shapes alone
//     (decode_attn.py::chunk_f32_splits: up to SMs / items blocks an item).
//     Split s of an item takes its live tiles [s per, (s + 1) per), per =
//     ceil(n_tiles / nsplit), counted on the device (no host sync); a split
//     past them exits. With nsplit > 1 each split writes its rows'
//     unnormalised accumulators, max and sum to a workspace, and
//     chunk_f32_merge_kernel combines the live splits in split order (a
//     fixed order: the result does not depend on scheduling).
//   * A key tile is 64 / page pages. Each thread reads its rows' page ids
//     from block_tables[b] on the device and copies 16 bytes at a time with
//     cp.async into a two-stage ring, so the next tile's loads overlap this
//     tile's products. Pages past the one that holds kend - 1 are not read:
//     their rows are zero-filled (cp.async with a source size of 0), so
//     p = 0 never meets a non-finite value.
//   * S = Q K^T and O += P V on mma.sync.m16n8k8 (TF32 in, float32
//     accumulators), three products a fragment pair: lo hi, hi lo, hi hi
//     (in S into three accumulator sets, added at the end, so that the
//     depth loop runs twelve independent chains). The depth index of a
//     fragment is permuted, the same way in both operands (the sum does not depend on it): in S, logical depth
//     t and t + 4 are head dims 2t and 2t + 1, so each q and K fragment is
//     one 8-byte load; in P V, logical keys t and t + 4 are keys 2t and
//     2t + 1, so the S accumulators are P's A fragments as they lie.
//   * Shared-memory rows are padded so that a fragment's loads hit distinct
//     banks: q and K rows by 8 floats (8-byte loads of rows g, columns 2t),
//     V rows by 4 (4-byte loads of rows 2t and 2t + 1, columns g).
// Its times on the card are in PERF.md section 6.
#include "common.cuh"

using port::NEG_INF;

namespace {

constexpr int BM = 64;         // query rows per work item (four row groups of 16)
constexpr int KT = 64;         // keys per tile (two halves of 32)
constexpr int STAGES = 2;      // K/V tiles in flight
constexpr int THREADS = 256;   // warp w: rows 16 (w % 4), keys 32 (w / 4) of each tile

template <int HD> constexpr int QS = HD + 8;   // row strides in floats
template <int HD> constexpr int KS = HD + 8;
template <int HD> constexpr int VS = HD + 4;

template <int HD>
constexpr size_t smem_bytes() {
  return (2 * (size_t)BM * QS<HD> + STAGES * (size_t)KT * (KS<HD> + VS<HD>)) * sizeof(float);
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (13 low mantissa
// bits dropped, to nearest, ties away from zero: half of the dropped unit
// added to the magnitude's bits carries into the kept ones exactly when
// the dropped part is at least half), in two integer operations: nvcc
// emits cvt.rna.tf32.f32 with a compare and a select around it, and the
// splits of K and V are a large share of the kernel's instructions
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each a TF32 value
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// D (16 x 8, float32) += A (16 x 8, tf32) B (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, or 16 zero bytes when !live (nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The live key tiles of work item (b, rt): keys below kend = min(total,
// the table's width, the item's last row's position + 1), in tiles of KT.
__device__ __forceinline__ int item_tiles(const int* totals, const int* starts, int b, int rt,
                                          int R, int qpk, int page, int maxp, int& kend) {
  const int q_last = starts[b] + (min((rt + 1) * BM, R) - 1) / qpk;
  kend = min(min(totals[b], maxp * page), q_last + 1);
  return kend > 0 ? (kend + KT - 1) / KT : 0;
}

// A split's partial results in the workspace: per (item, split), BM rows of
// WS<HD> floats: the row's unnormalised accumulator (HD), its max, its sum.
template <int HD> constexpr int WS = HD + 4;   // 16-byte rows

// grid ceil(R / BM) * KV * B * nsplit; q (B, KV, R, hd), pools (P, KV, page,
// hd), totals, starts (B,), block_tables (B, maxp) int32; out like q, all
// float32 and contiguous; page a power of two. Block x is split x % nsplit
// of item x / nsplit; with nsplit > 1 each split writes its partial results
// to ws ((ceil(R / BM) KV B, nsplit, BM, WS)), and chunk_f32_merge_kernel
// writes out.
template <int HD>
__global__ void __launch_bounds__(THREADS)
chunk_f32_sm90_kernel(const float* __restrict__ q, const float* __restrict__ k_pages,
                      const float* __restrict__ v_pages, const int* __restrict__ totals,
                      const int* __restrict__ starts, const int* __restrict__ block_tables,
                      float* __restrict__ out, float* __restrict__ ws, int B, int KV, int R,
                      int qpk, int page, int maxp, int nsplit, float softcap, float scale) {
  constexpr int Q_S = QS<HD>, K_S = KS<HD>, V_S = VS<HD>;
  constexpr int CH = HD / 4;                   // 16-byte chunks a row
  constexpr int NO = HD / 2;                   // accumulators a thread: 16 rows x HD a warp
  extern __shared__ __align__(16) float smem[];
  float* qh = smem;                            // (BM, Q_S) tf32 high parts of q
  float* ql = qh + BM * Q_S;                   // and low parts
  float* kv0 = ql + BM * Q_S;                  // stage st: K at kv0 + st (K + V), V after

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;     // fragment row group, thread in group
  const int wr = (warp & 3) * 16;              // this warp's rows of the item
  const int kh = (warp >> 2) * (KT / 2);       // and its half of each key tile
  const int lp = 31 - __clz(page);
  const int n_rt = (R + BM - 1) / BM;
  const int split = (int)blockIdx.x % nsplit, item = (int)blockIdx.x / nsplit;
  const int rt = n_rt - 1 - item / (KV * B), rem = item % (KV * B);
  const int g = rem % KV, b = rem / KV;
  const int r0 = rt * BM;
  const int start = starts[b];
  const int q_first = start + r0 / qpk;
  const int klim = min(totals[b], maxp * page);   // keys the table holds and the mask lets in
  int kend;
  const int n_tiles = item_tiles(totals, starts, b, rt, R, qpk, page, maxp, kend);
  const int n_pages = kend > 0 ? (kend + page - 1) >> lp : 0;   // live pages
  const int* bt = block_tables + (size_t)b * maxp;
  // this block's share of the item's live tiles, in runs of ceil(n_tiles /
  // nsplit); a split past them writes nothing (the merge skips it)
  const int per = (n_tiles + nsplit - 1) / nsplit;
  const int j0 = split * per, j1 = min(n_tiles, j0 + per);
  if (nsplit > 1 && j0 >= j1) return;

  // tile j's K and V rows into stage j % STAGES, one cp.async group
  auto load_tile = [&](int j) {
    float* ks = kv0 + (j % STAGES) * KT * (K_S + V_S);
    float* vs = ks + KT * K_S;
    for (int e = tid; e < KT * CH; e += THREADS) {
      const int row = e / CH, c = e % CH;
      const int pg = j * (KT >> lp) + (row >> lp);
      const bool on = pg < n_pages;
      const size_t off =
          on ? (((size_t)bt[pg] * KV + g) * page + (row & (page - 1))) * HD + 4 * c : 0;
      cp_async16((uint32_t)__cvta_generic_to_shared(ks + row * K_S + 4 * c), k_pages + off, on);
      cp_async16((uint32_t)__cvta_generic_to_shared(vs + row * V_S + 4 * c), v_pages + off, on);
    }
    cp_async_commit();
  };
  if (j0 < j1) load_tile(j0);

  // q, split once: rows past R are zeros
  for (int e = tid; e < BM * CH; e += THREADS) {
    const int row = e / CH, c = e % CH, r = r0 + row;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < R)
      x = *reinterpret_cast<const float4*>(q + (((size_t)b * KV + g) * R + r) * HD + 4 * c);
    uint4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(qh + row * Q_S + 4 * c) = hi;
    *reinterpret_cast<uint4*>(ql + row * Q_S + 4 * c) = lo;
  }

  // this thread's two rows (accumulator rows gr and gr + 8 of its warp's
  // 16) and their positions (-1: a row past R)
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + wr + gr + 8 * i;
    qpos[i] = r < R ? start + r / qpk : -1;
  }
  float o[NO], s[KT / 4];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  for (int j = j0; j < j1; ++j) {
    if (j + 1 < j1) {
      load_tile(j + 1);
      cp_async_wait<1>();                      // tile j has landed (this thread's part)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                           // ... and every thread's; q's planes too
    const float* ks = kv0 + (j % STAGES) * KT * (K_S + V_S) + kh * K_S;
    const float* vs = kv0 + (j % STAGES) * KT * (K_S + V_S) + KT * K_S + kh * V_S;

    // S = Q K^T: 16 rows x 32 keys a warp, HD / 8 steps of depth 8; the
    // three products sum in three accumulator sets (lo hi, hi lo, hi hi),
    // added once at the end: twelve independent chains of HD / 8 products,
    // where one set would make four chains of 3 HD / 8
    float sx[2][KT / 4];
#pragma unroll
    for (int i = 0; i < KT / 4; ++i) s[i] = sx[0][i] = sx[1][i] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < HD / 8; ++kk) {
      const int col = kk * 8 + 2 * tq;
      const float2 h0 = *reinterpret_cast<const float2*>(qh + (wr + gr) * Q_S + col);
      const float2 h1 = *reinterpret_cast<const float2*>(qh + (wr + gr + 8) * Q_S + col);
      const float2 l0 = *reinterpret_cast<const float2*>(ql + (wr + gr) * Q_S + col);
      const float2 l1 = *reinterpret_cast<const float2*>(ql + (wr + gr + 8) * Q_S + col);
      const uint32_t ah[4] = {__float_as_uint(h0.x), __float_as_uint(h1.x),
                              __float_as_uint(h0.y), __float_as_uint(h1.y)};
      const uint32_t al[4] = {__float_as_uint(l0.x), __float_as_uint(l1.x),
                              __float_as_uint(l0.y), __float_as_uint(l1.y)};
      uint32_t bh[KT / 16][2], bl[KT / 16][2];
#pragma unroll
      for (int nn = 0; nn < KT / 16; ++nn) {
        const float2 kx = *reinterpret_cast<const float2*>(ks + (nn * 8 + gr) * K_S + col);
        split_tf32(kx.x, bh[nn][0], bl[nn][0]);
        split_tf32(kx.y, bh[nn][1], bl[nn][1]);
      }
#pragma unroll
      for (int nn = 0; nn < KT / 16; ++nn) mma_tf32(sx[0] + 4 * nn, al, bh[nn][0], bh[nn][1]);
#pragma unroll
      for (int nn = 0; nn < KT / 16; ++nn) mma_tf32(sx[1] + 4 * nn, ah, bl[nn][0], bl[nn][1]);
#pragma unroll
      for (int nn = 0; nn < KT / 16; ++nn) mma_tf32(s + 4 * nn, ah, bh[nn][0], bh[nn][1]);
    }
#pragma unroll
    for (int i = 0; i < KT / 4; ++i) s[i] += sx[0][i] + sx[1][i];

    // online softmax in float32, as the reference: s * scale, the softcap,
    // the mask (-inf: exp gives an exact 0, the reference's gate); each key
    // half keeps its own running max and sum until the epilogue
    const int t0 = j * KT + kh;
    const bool edge = t0 + KT / 2 > klim || t0 + KT / 2 - 1 > q_first;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m_r[i];
#pragma unroll
      for (int nn = 0; nn < KT / 16; ++nn) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[nn * 4 + i * 2 + c] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          if (edge) {
            const int kpos = t0 + nn * 8 + 2 * tq + c;
            if (kpos > qpos[i] || kpos >= klim) x = -INFINITY;   // qpos -1: every key
          }
          s[nn * 4 + i * 2 + c] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = expf(m_r[i] - mx);
      m_r[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nn = 0; nn < KT / 16; ++nn) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = expf(s[nn * 4 + i * 2 + c] - mx);
          sum += p;
          s[nn * 4 + i * 2 + c] = p;
        }
      }
      l_r[i] = l_r[i] * alpha + sum;           // this thread's share of the row
#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn) {
        o[nn * 4 + i * 2] *= alpha;
        o[nn * 4 + i * 2 + 1] *= alpha;
      }
    }

    // O += P V over this warp's 32 keys: P's fragments are the S
    // accumulators (keys 2t, 2t + 1 as logical depth t, t + 4), V's loaded
    // from rows 2t and 2t + 1
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(s[kk * 4 + 0], ah[0], al[0]);   // (row gr,     key 2t)
      split_tf32(s[kk * 4 + 2], ah[1], al[1]);   // (row gr + 8, key 2t)
      split_tf32(s[kk * 4 + 1], ah[2], al[2]);   // (row gr,     key 2t + 1)
      split_tf32(s[kk * 4 + 3], ah[3], al[3]);   // (row gr + 8, key 2t + 1)
      const float* v0 = vs + (kk * 8 + 2 * tq) * V_S + gr;
      // four column tiles at a time: their 12 products interleave, and o
      // stays in registers (every index static)
#pragma unroll
      for (int n0 = 0; n0 < HD / 8; n0 += 4) {
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          split_tf32(v0[(n0 + u) * 8], bh[u][0], bl[u][0]);
          split_tf32(v0[V_S + (n0 + u) * 8], bh[u][1], bl[u][1]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) mma_tf32(o + 4 * (n0 + u), al, bh[u][0], bh[u][1]);
#pragma unroll
        for (int u = 0; u < 4; ++u) mma_tf32(o + 4 * (n0 + u), ah, bl[u][0], bl[u][1]);
#pragma unroll
        for (int u = 0; u < 4; ++u) mma_tf32(o + 4 * (n0 + u), ah, bh[u][0], bh[u][1]);
      }
    }
    __syncthreads();                           // stage j % STAGES is free for tile j + 2
  }

  // the second key half's (m, l, o) to the first's, lane for lane (the same
  // rows and columns), through the ring's shared memory
  float* xs = kv0 + (warp & 3) * 32 + lane;    // entry i at xs[128 i]
  if (kh) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      xs[128 * i] = m_r[i];
      xs[128 * (2 + i)] = l_r[i];
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) xs[128 * (4 + i)] = o[i];
  }
  __syncthreads();
  if (kh) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m1 = xs[128 * i], mx = fmaxf(m_r[i], m1);
    const float a0 = expf(m_r[i] - mx), a1 = expf(m1 - mx);
    float l = l_r[i] * a0 + xs[128 * (2 + i)] * a1;
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (qpos[i] < 0) continue;
    const int r = r0 + wr + gr + 8 * i;
    // one split: the output; more: this split's unnormalised accumulator,
    // max and sum
    const bool whole = nsplit == 1;
    float* dst = whole ? out + (((size_t)b * KV + g) * R + r) * HD + 2 * tq
                       : ws + ((((size_t)(b * KV + g) * n_rt + rt) * nsplit + split) * BM + r - r0)
                                  * WS<HD>;
    const float den = whole ? fmaxf(l, 1e-37f) : 1.f;
#pragma unroll
    for (int nn = 0; nn < HD / 8; ++nn) {
      const int e = nn * 4 + i * 2;
      *reinterpret_cast<float2*>(dst + (whole ? 0 : 2 * tq) + nn * 8) =
          make_float2((o[e] * a0 + xs[128 * (4 + e)] * a1) / den,
                      (o[e + 1] * a0 + xs[128 * (5 + e)] * a1) / den);
    }
    if (!whole && tq == 0) {
      dst[HD] = mx;
      dst[HD + 1] = l;
    }
  }
}

// Rows of an item a merge block covers: one thread a (row, 4 columns), so
// that no thread walks the splits twice over for more than one of them.
template <int HD> constexpr int MERGE_ROWS = 256 / (HD / 4);

// grid ceil(R / BM) * KV * B * BM / MERGE_ROWS (item (b KV + g) ceil(R / BM)
// + rt, then its row blocks), 256 threads: each row of the item from its
// live splits' partial results, in split order: out = sum_s acc_s
// e^(m_s - m) / max(sum_s l_s e^(m_s - m), 1e-37) with m the largest m_s;
// an item with no live tile writes zeros.
template <int HD>
__global__ void __launch_bounds__(256)
chunk_f32_merge_kernel(const float* __restrict__ ws, const int* __restrict__ totals,
                       const int* __restrict__ starts, float* __restrict__ out, int KV, int R,
                       int qpk, int page, int maxp, int nsplit) {
  constexpr int PARTS = BM / MERGE_ROWS<HD>;
  const int n_rt = (R + BM - 1) / BM;
  const int item = (int)blockIdx.x / PARTS;
  const int rt = item % n_rt, bg = item / n_rt, b = bg / KV;
  const int row = ((int)blockIdx.x % PARTS) * MERGE_ROWS<HD> + threadIdx.x / (HD / 4);
  const int c = 4 * (threadIdx.x % (HD / 4)), r = rt * BM + row;
  if (r >= R) return;
  int kend;
  const int n_tiles = item_tiles(totals, starts, b, rt, R, qpk, page, maxp, kend);
  const int per = (n_tiles + nsplit - 1) / nsplit;
  const int n_live = per > 0 ? (n_tiles + per - 1) / per : 0;
  const float* w0 = ws + (size_t)item * nsplit * BM * WS<HD>;
  float mx = NEG_INF;
  for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, w0[(s * BM + row) * WS<HD> + HD]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_live; ++s) {
    const float* w = w0 + (s * BM + row) * WS<HD>;
    const float a = expf(w[HD] - mx);
    const float4 x = *reinterpret_cast<const float4*>(w + c);
    l += w[HD + 1] * a;
    acc.x += x.x * a;
    acc.y += x.y * a;
    acc.z += x.z * a;
    acc.w += x.w * a;
  }
  const float den = fmaxf(l, 1e-37f);
  *reinterpret_cast<float4*>(out + ((size_t)bg * R + r) * HD + c) =
      make_float4(acc.x / den, acc.y / den, acc.z / den, acc.w / den);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* totals, const void* starts,
           const void* bt, void* out, void* ws, int B, int KV, int R, int qpk, int page,
           int maxp, int nsplit, float softcap, float scale, cudaStream_t stream) {
  const int n_work = (R + BM - 1) / BM * KV * B;
  if (n_work == 0) return (int)cudaSuccess;
  cudaError_t err = port::allow_smem(chunk_f32_sm90_kernel<HD>, smem_bytes<HD>());
  if (err != cudaSuccess) return (int)err;
  chunk_f32_sm90_kernel<HD><<<n_work * nsplit, THREADS, smem_bytes<HD>(), stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)totals,
      (const int*)starts, (const int*)bt, (float*)out, (float*)ws, B, KV, R, qpk, page, maxp,
      nsplit, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  chunk_f32_merge_kernel<HD><<<n_work * (BM / MERGE_ROWS<HD>), 256, 0, stream>>>(
      (const float*)ws, (const int*)totals, (const int*)starts, (float*)out, KV, R, qpk, page,
      maxp, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// float32 only. q (B, KV, R, hd) with R = Sc * qpk, heads innermost; pools
// (P, KV, page, hd); totals, starts (B,) and block_tables (B, maxp) int32;
// out like q. All contiguous, q and the pools 16-byte aligned. hd 64 or
// 128; page 8, 16, 32 or 64. With nsplit > 1, ws holds ceil(R / 64) KV B
// nsplit 64 (hd + 4) float32 (16-byte aligned); with 1 it is not read.
// Returns a cudaError_t code (0 = launched).
int chunked_prefill_attention_f32_sm90(int dtype, const void* q, const void* k_pages,
                                       const void* v_pages, const void* totals,
                                       const void* starts, const void* block_tables, void* out,
                                       void* ws, int B, int KV, int R, int qpk, int hd,
                                       int page, int maxp, int nsplit, float softcap,
                                       float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != DTYPE_F32 || (page != 8 && page != 16 && page != 32 && page != 64) ||
      qpk < 1 || nsplit < 1 || (nsplit > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (hd == 64)
    return launch<64>(q, k_pages, v_pages, totals, starts, block_tables, out, ws, B, KV, R,
                      qpk, page, maxp, nsplit, softcap, scale, s);
  if (hd == 128)
    return launch<128>(q, k_pages, v_pages, totals, starts, block_tables, out, ws, B, KV, R,
                       qpk, page, maxp, nsplit, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
