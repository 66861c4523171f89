// The int8 chunked-prefill attention on Hopper's int8 tensor cores
// (mma.sync), its paged int8 K/V read through the block tables by TMA.
//
//   * chunk_int8_sm90_kernel <- src/repro/kernels/decode_attn.py:503
//       chunked_prefill_attention_kernel (int8 body
//       _chunked_prefill_kernel_int8, :446), q in float32 and bfloat16, at
//       head_dim 64 or 128 and pages of 8, 16, 32 or 64 keys
//
// Other shapes run the scalar kernel of decode_attn.cu.
//
// The function, a page at a time as the TPU kernel's int8 body walks it:
//   s   = ((float(q8 . k8) * q_scale) * k_scale) * scale, then the softcap
//   p   = exp(s - m_new), gated by the mask (kpos <= qpos, kpos < total)
//   pv8 = p * v_scale requantized per row over this page (pv_scale)
//   acc = acc * alpha + float(pv8 . v8) * pv_scale;  out = acc / max(l, 1e-37)
// with q8 the row's int8 quantization. Each page is one requantization
// step and m is updated a page at a time as the reference does, so pv8 is
// the plain version's (chunked_prefill_attention_int8_plain), not merely
// equal up to .5 steps; only float32 sums are taken in another order.
//
// What bounds it on the card: bytes in principle (64 rows do about 64
// operations a K/V byte they read, far below the ~1000 Op/B knee of int8),
// latency in practice: a serving stage holds one to a few chunks, so a
// call is 16-64 work items on 132 streaming multiprocessors, and the
// longest item walks its pages one after another, a dependent chain of an
// S product, the row statistics and a PV product each. So the products run
// on the int8 tensor cores, the statistics in registers, and the loads of
// the next pages overlap them.
//
// Design:
//   * A work item is BM = 64 rows of the kernel layout (B, KV, R, hd) of one
//     (sequence, KV head), R = Sc * qpk; row r is chunk position
//     start + r / qpk. Eight consumer warps own 8 rows each, the upper 8
//     rows of their 16-row mma tiles held at zero: that halves each lane's
//     per-element work (one row, not two) and puts two warps on each
//     scheduler to hide each other's latency, where the tensor cores have
//     time to spare. One thread of a ninth warp (the producer) issues every
//     load. Items run one a block,
//     the last row tiles (the longest key ranges) first. Each item bounds
//     its page loop on the device: keys below kend = min(total, the table's
//     width, the last row's position + 1), the scalar kernel's bound (a page
//     wholly past a row's mask leaves its state exactly as it was); an item
//     with total == 0 loads nothing and writes zeros.
//   * Loads: a stage is one page: its int8 K and V slabs by TMA boxes of a
//     4-d map over the pool (hd, page, KV, P), swizzled over hd-byte rows
//     (128-byte swizzle at hd 128, 64-byte at hd 64: plain copies of
//     unswizzled rows would put the 8 keys of a fragment load in one bank
//     group), and its float32 K and V scale slabs by bulk copies, all on
//     the stage's full barrier; STAGES pages in flight, freed by an empty
//     barrier each consumer warp arrives on. The producer warp reads the
//     page ids from block_tables on the device, a lane a page.
//   * q is read and quantized a row at a time by its warp (abs-max over the
//     row, the 1e-8 floor, round half to even), held as the A fragments of
//     S = q8 k8^T on mma.sync.m16n8k32.s8: the K page stored [keys, hd] is
//     already the "col" B operand, and ldmatrix (b16, no transpose) on
//     int8 rows gives each lane 4 consecutive hd bytes of one key.
//   * A row's 16 scores of a 16-key page sit on the 4 lanes of a quad: its
//     max, exp, sum and amax come from quad shuffles, and pv8 is requantized
//     in registers. The lane of quad t holds keys {2t, 2t+1, 8+2t, 9+2t};
//     the int32 PV sum does not depend on key order, so PV's depth runs in
//     that order, and the requantized p is the A fragment of
//     mma.sync.m16n8k16.s8 as it lies (a 8-key page pads k with zeros).
//   * The B operand of PV wants 4 consecutive keys of one hd column, which
//     V's [keys, hd] layout does not give, and neither ldmatrix.trans nor
//     wgmma transposes 8-bit operands. So the consumer warps transpose each
//     V page once into shared memory (V^T: hd rows of 16 key bytes a k16
//     step, in PV's key order; 4 x 4 byte transposes with __byte_perm),
//     double-buffered behind one named barrier a page, and read it with
//     ldmatrix. Each page's int32 PV is folded into the float32
//     accumulator as acc * alpha + float(pv) * pv_scale.
//
// Its times on the card are in PERF.md section 6.
#include "hopper.cuh"

using port::NEG_INF;
using namespace sm90;

namespace {

constexpr int BM = 64;          // query rows per work item
constexpr int STAGES = 4;       // pages in flight
constexpr int RW = 8;           // rows a consumer warp owns: the upper 8 rows of its
                                // m16 tiles are zeros, so a lane holds one row
constexpr int NR = RW / 8;      // rows a lane holds
constexpr int CONSUMERS = BM / RW * 32;   // eight warps
constexpr int THREADS = CONSUMERS + 32;   // and the producer warp

// D (16 x 8, int32) += A (16 x 32, s8) B (32 x 8, s8)
__device__ __forceinline__ void mma_k32(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D (16 x 8, int32) += A (16 x 16, s8) B (16 x 8, s8)
__device__ __forceinline__ void mma_k16(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Byte offset of byte x of row r of a swizzled page of HD-byte rows as TMA
// lays it out (base aligned to 1024 bytes): the 16-byte chunk index XORed
// with address bits 7-9 (128-byte swizzle) or 7-8 (64-byte).
template <int HD>
__device__ __forceinline__ uint32_t swz(int r, int x) {
  const uint32_t a = (uint32_t)(r * HD + x);
  return a ^ (((a >> 7) & (HD == 128 ? 7u : 3u)) << 4);
}

// PV's depth order within a k16 step: position 4t + i holds key
// {2t, 2t+1, 8+2t, 9+2t}[i], the keys of quad lane t's S fragment.
__device__ __forceinline__ int pv_key(int t, int i) { return (i >> 1) * 8 + 2 * t + (i & 1); }

__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// A stage: PPS pages' K, then their V ((PPS, PAGE, HD) int8 each), then
// their K scales and V scales ((PPS, PAGE) float32 each)
template <int HD, int PAGE, int PPS>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return (PPS * (2 * PAGE * HD + 8 * PAGE) + 1023) & ~1023u;
}
// V^T of a step: (PPS, k16 steps, HD, 16) int8
template <int HD, int PAGE, int PPS>
__host__ __device__ constexpr uint32_t vt_bytes() {
  return PPS * (PAGE >= 16 ? PAGE / 16 : 1) * HD * 16;
}
// the ring, two V^T buffers, q8 (BM, HD), q scales (BM)
template <int HD, int PAGE, int PPS>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + STAGES * stage_bytes<HD, PAGE, PPS>() + 2 * vt_bytes<HD, PAGE, PPS>() +
         BM * HD + BM * 4;
}

// grid ceil(R / BM) * KV * B; q, out (B, KV, R, hd) contiguous in T; the
// int8 pools through their tensor maps; scale pools (P, KV, PAGE) float32;
// totals, starts (B,), block_tables (B, maxp) int32. Warps 0-7 consume,
// warp 8 produces. A step takes PPS pages: one stage of the ring, one V^T
// buffer, one named barrier; within it each page is still its own
// requantization step, in order.
template <typename T, int HD, int PAGE, int PPS>
__global__ void __launch_bounds__(THREADS)
chunk_int8_sm90_kernel(const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const T* __restrict__ q,
                       const float* __restrict__ k_scales, const float* __restrict__ v_scales,
                       const int* __restrict__ totals, const int* __restrict__ starts,
                       const int* __restrict__ block_tables, T* __restrict__ out, int B, int KV,
                       int R, int qpk, int maxp, float softcap, float scale) {
  constexpr int NT = PAGE / 8;                  // 8-key tiles of S a page
  constexpr int KS = PAGE >= 16 ? PAGE / 16 : 1;   // k16 steps of PV a page
  constexpr int KK = HD / 32;                   // k32 steps of S
  constexpr int ND = HD / 8;                    // 8-column tiles of the output
  constexpr uint32_t KV_BYTES = PAGE * HD, SC_BYTES = PAGE * 4;
  constexpr uint32_t STAGE = stage_bytes<HD, PAGE, PPS>(), VT = vt_bytes<HD, PAGE, PPS>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];   // full[s], empty[s]
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);      // stage st at st * STAGE
  uint8_t* const vt_s = sbase + STAGES * STAGE;        // V^T of step j at (j & 1) * VT
  int8_t* const q8_s = reinterpret_cast<int8_t*>(vt_s + 2 * VT);   // (BM, HD)
  float* const qsc_s = reinterpret_cast<float*>(q8_s + BM * HD);   // (BM,)
  const uint32_t full0 = smem_addr(bars), empty0 = full0 + 8 * STAGES;

  const int tid = threadIdx.x;
  const int n_rt = (R + BM - 1) / BM;
  const int rt = n_rt - 1 - (int)blockIdx.x / (KV * B), rem = blockIdx.x % (KV * B);
  const int g = rem % KV, b = rem / KV, r0 = rt * BM;
  const int total = totals[b], start = starts[b];
  const int q_last = start + (min(r0 + BM, R) - 1) / qpk;
  const int kend = min(min(total, maxp * PAGE), q_last + 1);
  const int n_pages = kend > 0 ? (kend + PAGE - 1) / PAGE : 0;
  const int n_steps = (n_pages + PPS - 1) / PPS;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer warp: the lanes read 32 page ids at a time, lane 0 issues
    // each step's pages into its stage
    const int lane = tid & 31;
    const int* bt = block_tables + (size_t)b * maxp;
    for (int j0 = 0; j0 < n_pages; j0 += 32) {
      const int pid_l = j0 + lane < n_pages ? bt[j0 + lane] : 0;
      for (int i = 0; i < min(32, n_pages - j0); ++i) {
        const int pid = __shfl_sync(0xffffffffu, pid_l, i), jp = j0 + i;
        const int j = jp / PPS, p = jp - j * PPS, st = j % STAGES;
        if (lane == 0) {
          const uint32_t full = full0 + 8 * st, dst = base + st * STAGE;
          if (p == 0) {
            if (j >= STAGES) mbar_wait(empty0 + 8 * st, ((j / STAGES) & 1) ^ 1);
            mbar_expect_tx(full, min(PPS, n_pages - j * PPS) * (2 * KV_BYTES + 2 * SC_BYTES));
          }
          const size_t sc = ((size_t)pid * KV + g) * PAGE;
          tma_load_4d(dst + p * KV_BYTES, &tm_k, full, 0, 0, g, pid);
          tma_load_4d(dst + (PPS + p) * KV_BYTES, &tm_v, full, 0, 0, g, pid);
          bulk_load(dst + 2 * PPS * KV_BYTES + p * SC_BYTES, k_scales + sc, SC_BYTES, full);
          bulk_load(dst + 2 * PPS * KV_BYTES + (PPS + p) * SC_BYTES, v_scales + sc, SC_BYTES,
                    full);
        }
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  {
    // q8: the warp's RW rows quantized (rows past R: zeros), all their
    // loads issued first
    float x[RW][HD / 32];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = r0 + warp * RW + i;
      const T* src = q + (((size_t)b * KV + g) * R + min(r, R - 1)) * HD;
#pragma unroll
      for (int e = 0; e < HD / 32; ++e) x[i][e] = r < R ? port::to_f(src[lane + 32 * e]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int rl = warp * RW + i;
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < HD / 32; ++e) amax = fmaxf(amax, fabsf(x[i][e]));
      const float sc = port::i8_scale(port::warp_max(amax)), rc = port::rcp_for(sc);
      int8_t* dst = q8_s + rl * HD + lane;
      if (!isinf(sc)) {
#pragma unroll
        for (int e = 0; e < HD / 32; ++e) dst[32 * e] = port::quant_i8(x[i][e], sc, rc);
      } else {                  // a row holding inf: only the division gives the recipe's values
#pragma unroll
        for (int e = 0; e < HD / 32; ++e) dst[32 * e] = port::quant_i8(x[i][e], sc);
      }
      if (lane == 0) qsc_s[rl] = sc;
    }
  }
  __syncwarp();
  // the A fragments of S, k32 step kk: rows gq and (at NR 2) gq + 8, hd
  // bytes 32 kk + 4 tq (+ 16); the rows a warp does not own are zeros
  uint32_t qa[KK][4];
  const int8_t* qr = q8_s + (warp * RW + gq) * HD + 4 * tq;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(qr + 32 * kk);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(qr + 32 * kk + 16);
    qa[kk][1] = NR > 1 ? *reinterpret_cast<const uint32_t*>(qr + 8 * HD + 32 * kk) : 0u;
    qa[kk][3] = NR > 1 ? *reinterpret_cast<const uint32_t*>(qr + 8 * HD + 32 * kk + 16) : 0u;
  }
  // this lane's rows: q scales and positions (-1: a row past R)
  float q_sc[NR], m_r[NR], l_r[NR];
  int qpos[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int rl = warp * RW + gq + 8 * i, r = r0 + rl;
    q_sc[i] = qsc_s[rl];
    qpos[i] = r < R ? start + r / qpk : -1;
    m_r[i] = NEG_INF;
    l_r[i] = 0.f;
  }
  float acc[ND][2 * NR];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int c = 0; c < 2 * NR; ++c) acc[n][c] = 0.f;
  const float r127 = port::rcp_for(127.f);

  for (int j = 0; j < n_steps; ++j) {
    const int st = j % STAGES, np = min(PPS, n_pages - j * PPS);
    const uint8_t* stage = sbase + st * STAGE;
    const float* ksc = reinterpret_cast<const float*>(stage + 2 * PPS * KV_BYTES);
    const float* vsc = ksc + PPS * PAGE;
    uint8_t* vt = vt_s + (j & 1) * VT;
    mbar_wait(full0 + 8 * st, (j / STAGES) & 1);

    // V^T of the step's pages: row d of (page p, k16 step ks) holds, at
    // bytes 4t .. 4t + 3, keys 16 ks + pv_key(t, 0 .. 3) of column d. A unit
    // is one 4 x 4 block.
    constexpr int UNITS = PPS * KS * 4 * (HD / 4);
#pragma unroll
    for (int u = tid; u < UNITS; u += CONSUMERS) {
      const int t = u & 3, c = (u >> 2) % (HD / 4), pk = (u >> 2) / (HD / 4);
      const int p = pk / KS, ks = pk - p * KS;
      if (p < np) {
        const uint8_t* vp = stage + (PPS + p) * KV_BYTES;
        uint32_t w[4], col[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = 16 * ks + pv_key(t, i);
          w[i] = key < PAGE ? *reinterpret_cast<const uint32_t*>(vp + swz<HD>(key, 4 * c)) : 0u;
        }
        port::transpose4x4(w[0], w[1], w[2], w[3], col);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<uint32_t*>(vt + (pk * HD + 4 * c + e) * 16 + 4 * t) = col[e];
      }
    }
    // V^T is in; every consumer is past step j - 1, so the other buffer
    // (step j + 1's) is free as well
    bar_consumers();

    // S = q8 k8^T: the warp's rows x the step's keys in int32;
    // ldmatrix.x4 of 8 keys x 64 hd bytes gives the B fragments of two k32
    // steps
    int s[PPS][NT][4];
#pragma unroll
    for (int p = 0; p < PPS; ++p) {
      if (p >= np) break;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[p][nt][c] = 0;
#pragma unroll
        for (int h = 0; h < HD / 64; ++h) {
          uint32_t kb[4];
          ldsm_x4(base + st * STAGE + p * KV_BYTES +
                      swz<HD>(8 * nt + (lane & 7), 64 * h + 16 * (lane >> 3)),
                  kb);
          mma_k32(s[p][nt], qa[2 * h], kb[0], kb[1]);
          mma_k32(s[p][nt], qa[2 * h + 1], kb[2], kb[3]);
        }
      }
    }

    // per row and page, in page order: scores, the page's max, alpha, p
    // gated by the mask, its sum, p * v_scale and its amax over the quad,
    // then pv8 packed as PV's A fragments (row gq in pa[..][0], gq + 8 in
    // pa[..][1], zeros at NR 1). The page maxima are independent; only m and
    // l chain. The
    // softcap is one uniform branch over all the scores, and each row and
    // page divides by its pv scale through one reciprocal.
    uint32_t pa[PPS][KS][2];
    float alpha[PPS][NR], pv_sc[PPS][NR];
#pragma unroll
    for (int p = 0; p < PPS; ++p)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) pa[p][ks][1] = 0u;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      float x[PPS][NT][2], mx[PPS];
      bool ok[PPS][NT][2];
#pragma unroll
      for (int p = 0; p < PPS; ++p)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = 8 * nt + 2 * tq + c, kpos = (j * PPS + p) * PAGE + key;
            ok[p][nt][c] = p < np && kpos <= qpos[i] && kpos < total;
            x[p][nt][c] = port::i8_product(s[p][nt][2 * i + c], q_sc[i], ksc[p * PAGE + key],
                                           scale);
          }
      if (softcap > 0.f) {
        const float rcap = port::rcp_for(softcap);
#pragma unroll
        for (int p = 0; p < PPS; ++p)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              x[p][nt][c] = __fmul_rn(softcap, tanhf(port::div_by(x[p][nt][c], softcap, rcap)));
      }
#pragma unroll
      for (int p = 0; p < PPS; ++p) {
        mx[p] = NEG_INF;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            x[p][nt][c] = ok[p][nt][c] ? x[p][nt][c] : NEG_INF;
            mx[p] = fmaxf(mx[p], x[p][nt][c]);
          }
        mx[p] = fmaxf(mx[p], __shfl_xor_sync(0xffffffffu, mx[p], 1));
        mx[p] = fmaxf(mx[p], __shfl_xor_sync(0xffffffffu, mx[p], 2));
      }
      float m_new[PPS], sum[PPS], amax[PPS];
#pragma unroll
      for (int p = 0; p < PPS; ++p) {
        m_new[p] = fmaxf(p ? m_new[p - 1] : m_r[i], mx[p]);
        alpha[p][i] = expf((p ? m_new[p - 1] : m_r[i]) - m_new[p]);
        sum[p] = amax[p] = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = 8 * nt + 2 * tq + c;
            // gated: a masked key adds exactly 0 even while m is NEG_INF
            const float e = ok[p][nt][c] ? expf(x[p][nt][c] - m_new[p]) : 0.f;
            sum[p] += e;
            x[p][nt][c] = __fmul_rn(e, vsc[p * PAGE + key]);
            amax[p] = fmaxf(amax[p], fabsf(x[p][nt][c]));
          }
        sum[p] += __shfl_xor_sync(0xffffffffu, sum[p], 1);
        sum[p] += __shfl_xor_sync(0xffffffffu, sum[p], 2);
        amax[p] = fmaxf(amax[p], __shfl_xor_sync(0xffffffffu, amax[p], 1));
        amax[p] = fmaxf(amax[p], __shfl_xor_sync(0xffffffffu, amax[p], 2));
        pv_sc[p][i] = port::i8_scale(amax[p], r127);
        const float rsc = port::rcp_for(pv_sc[p][i]);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t w = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int nt = 2 * ks + (e >> 1);
            if (nt < NT)
              w |= (uint32_t)(uint8_t)port::quant_i8(x[p][nt][e & 1], pv_sc[p][i], rsc)
                   << (8 * e);
          }
          pa[p][ks][i] = w;
        }
      }
#pragma unroll
      for (int p = 0; p < PPS; ++p) l_r[i] = l_r[i] * alpha[p][i] + sum[p];
      m_r[i] = m_new[PPS - 1];
    }
    // the stage's K, V and scales are all read
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);

    // PV, page by page: 4 output tiles a ldmatrix.x4 of V^T, int32 over the
    // page's k16 steps (|pv| <= 64 * 127^2 < 2^22), then folded into the
    // float32 accumulator
#pragma unroll
    for (int n0 = 0; n0 < ND; n0 += 4) {
#pragma unroll
      for (int p = 0; p < PPS; ++p) {
        if (p >= np) break;
        int pv[4][4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c) pv[m][c] = 0;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t vb[4];
          ldsm_x4(smem_addr(vt) + ((p * KS + ks) * HD + 8 * n0 + lane) * 16, vb);
#pragma unroll
          for (int m = 0; m < 4; ++m) mma_k16(pv[m], pa[p][ks][0], pa[p][ks][1], vb[m]);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int c = 0; c < 2 * NR; ++c)
            acc[n0 + m][c] = __fmaf_rn(acc[n0 + m][c], alpha[p][c >> 1],
                                       __fmul_rn(port::i2f_exact(pv[m][c]), pv_sc[p][c >> 1]));
      }
    }
  }

  // out = acc / max(l, 1e-37): row gq + 8 i, columns 8 n + 2 tq, + 1
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    if (qpos[i] < 0) continue;
    const int r = r0 + warp * RW + gq + 8 * i;
    T* o = out + (((size_t)b * KV + g) * R + r) * HD + 2 * tq;
    const float den = fmaxf(l_r[i], 1e-37f), rden = port::rcp_for(den);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float v0 = port::div_by(acc[n][2 * i], den, rden);
      const float v1 = port::div_by(acc[n][2 * i + 1], den, rden);
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float2*>(o + 8 * n) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * n) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

struct Args {
  const void *q, *k, *ks, *v, *vs, *totals, *starts, *bt;
  void* out;
  int B, KV, R, qpk, maxp, P;
  float softcap, scale;
};

template <typename T, int HD, int PAGE, int PPS>
int launch(const Args& a, cudaStream_t stream) {
  const int n_work = (a.R + BM - 1) / BM * a.KV * a.B;
  if (n_work == 0) return (int)cudaSuccess;
  CUtensorMap tm_k, tm_v;
  if (!int8_pages_map(&tm_k, a.k, a.P, a.KV, PAGE, HD) ||
      !int8_pages_map(&tm_v, a.v, a.P, a.KV, PAGE, HD))
    return (int)cudaErrorInvalidValue;
  auto kernel = chunk_int8_sm90_kernel<T, HD, PAGE, PPS>;
  constexpr size_t smem = smem_bytes<HD, PAGE, PPS>();
  cudaError_t err = port::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_work, THREADS, smem, stream>>>(
      tm_k, tm_v, (const T*)a.q, (const float*)a.ks, (const float*)a.vs, (const int*)a.totals,
      (const int*)a.starts, (const int*)a.bt, (T*)a.out, a.B, a.KV, a.R, a.qpk, a.maxp,
      a.softcap, a.scale);
  return (int)cudaGetLastError();
}

// pages a step: 1, 2, 4 or 8, at most 64 keys
template <typename T, int HD, int PAGE>
int launch_pps(int pps, const Args& a, cudaStream_t stream) {
  if (pps == 1) return launch<T, HD, PAGE, 1>(a, stream);
  if constexpr (PAGE <= 32)
    if (pps == 2) return launch<T, HD, PAGE, 2>(a, stream);
  if constexpr (PAGE <= 16)
    if (pps == 4) return launch<T, HD, PAGE, 4>(a, stream);
  if constexpr (PAGE <= 8)
    if (pps == 8) return launch<T, HD, PAGE, 8>(a, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int HD>
int launch_page(int page, int pps, const Args& a, cudaStream_t stream) {
  switch (page) {
    case 8: return launch_pps<T, HD, 8>(pps, a, stream);
    case 16: return launch_pps<T, HD, 16>(pps, a, stream);
    case 32: return launch_pps<T, HD, 32>(pps, a, stream);
    case 64: return launch_pps<T, HD, 64>(pps, a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_hd(int hd, int page, int pps, const Args& a, cudaStream_t stream) {
  if (hd == 64) return launch_page<T, 64>(page, pps, a, stream);
  if (hd == 128) return launch_page<T, 128>(page, pps, a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// int8 pools (P, KV, page, hd) with float32 scale pools (P, KV, page); q
// (B, KV, R, hd) in `dtype` with R = Sc * qpk, heads innermost; totals,
// starts (B,) and block_tables (B, maxp) int32; out like q. All contiguous,
// the pools and scale pools 16-byte aligned. hd 64 or 128; page 8, 16, 32
// or 64; pps pages a step, 1, 2, 4 or 8 with pps * page at most 64.
// Returns a cudaError_t code (0 = launched; cudaErrorInvalidValue also
// when cuTensorMapEncodeTiled refuses a map).
int chunked_prefill_attention_int8_sm90(int dtype, const void* q, const void* k_pages,
                                        const void* k_scales, const void* v_pages,
                                        const void* v_scales, const void* totals,
                                        const void* starts, const void* block_tables, void* out,
                                        int B, int KV, int R, int qpk, int hd, int page, int maxp,
                                        int P, int pps, float softcap, float scale,
                                        void* stream) {
  if (qpk < 1) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, k_scales, v_pages, v_scales, totals, starts, block_tables, out,
               B,  KV,      R,        qpk,     maxp,     P,      softcap, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32) return launch_hd<float>(hd, page, pps, a, s);
  if (dtype == DTYPE_BF16) return launch_hd<__nv_bfloat16>(hd, page, pps, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
