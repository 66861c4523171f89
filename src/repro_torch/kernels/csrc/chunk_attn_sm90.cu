// The bf16 chunked-prefill attention on Hopper's tensor cores (wgmma), its
// paged K/V read through the block tables by TMA.
//
//   * chunk_attn_sm90_kernel <- src/repro/kernels/decode_attn.py:
//                               chunked_prefill_attention_kernel (fp body
//                               _chunked_prefill_kernel), in bfloat16
//
// The float32 route, bf16 at other head or page sizes, and the int8 body
// stay the scalar kernels of decode_attn.cu.
//
// What bounds it on the card: bytes in principle (a 64-row tile does about
// 64 FLOPs a K/V byte it reads at qpk 1, below the H100's ~295 Op/B knee),
// latency in practice: a serving stage holds one to a few chunks, so a call
// is 16-64 work items on 132 streaming multiprocessors, each walking its
// prefix in turn, and the longest item sets the time: its key tiles one
// after another, each an S product, the softmax and a PV product. So the
// products run on the tensor cores, the softmax in registers, and the
// loads of the next tile overlap them.
//
// Design:
//   * A work item is BM = 64 rows of the kernel layout (B, KV, R, hd) of one
//     (sequence, KV head), R = Sc * qpk; row r is chunk position
//     start + r / qpk. One consumer warpgroup owns the 64 rows; one thread of
//     a fifth warp (the producer) issues every load. Items run one a block,
//     the last row tiles (the longest key ranges) first. Rows past R read as
//     zeros (the tensor map's bound) and are never written.
//   * Each item bounds its key loop on the device: keys below
//     kend = min(total, the pool columns' width, the last row's position + 1),
//     in tiles of KT = 64. Only tiles that cross the causal edge or kend
//     evaluate the mask (kpos <= qpos and kpos < total); an item with
//     total == 0 loads nothing and writes zeros.
//   * Paged K/V by TMA: a key tile is 64 / page pages. The producer warp
//     reads the tile's page ids from block_tables[b] on the device and
//     issues, for each live page, one box per 64-column panel from a 4-d
//     tensor map over the pool seen as (hd, page, KV, P), 128-byte swizzle.
//     Each page lands at a 1024-byte-aligned offset (page 8, 16, 32 or 64
//     rows), so the pages concatenate into the same swizzled 64-row tile
//     that flash_fwd_sm90.cu's descriptors read. Nothing is read past the
//     page that holds kend - 1; the skipped pages of a last tile leave
//     their rows masked, and V rows there are zeroed once (or hold an
//     earlier tile's finite values), so 0 * V stays 0. K/V go through a
//     two-stage ring with full and empty mbarriers, so loads overlap the
//     products; Q comes by TMA over (hd, R, KV, B).
//   * S = Q K^T is wgmma (Q and K K-major, 64 x 64 a tile); the online
//     softmax runs in registers in float32 (scale, softcap tanh, mask, p
//     gated by the mask as the reference does); P is rounded to bf16 (the
//     reference's p.astype(v.dtype)) and repacked as the A fragment of
//     O += P V, V read MN-major. The epilogue writes acc / max(l, 1e-37).
//
// m is kept in log2 units (scale * log2(e) folded into one multiply a score)
// and p = 2^(x - m) comes from one ex2.approx, as in flash_fwd_sm90.cu. Its
// times on the card are in PERF.md section 6.
#include "hopper.cuh"

using port::NEG_INF;
using namespace sm90;

namespace {

constexpr int BM = 64;         // query rows per work item (one warpgroup)
constexpr int KT = 64;         // keys per tile
constexpr int STAGES = 2;      // K/V tiles in flight
constexpr int CONSUMERS = 128; // one warpgroup
constexpr int THREADS = CONSUMERS + 32;   // and the producer warp

// grid ceil(R / BM) * KV * B; q and the pools through their tensor maps;
// totals, starts (B,), block_tables (B, maxp) int32; out (B, KV, R, hd) bf16
// contiguous. Warps 0-3 are the consumer warpgroup, warp 4 the producer.
template <int HD>
__global__ void __launch_bounds__(THREADS)
chunk_attn_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const int* __restrict__ totals, const int* __restrict__ starts,
                       const int* __restrict__ block_tables, __nv_bfloat16* __restrict__ out,
                       int B, int KV, int R, int qpk, int page, int maxp, float softcap,
                       float scale) {
  constexpr int Q_BYTES = BM * HD * 2, KV_BYTES = KT * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 1];   // full[s], empty[s], q full
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;                  // Q: HD / 64 panels of BM rows
  const uint32_t kv_s = base + Q_BYTES;       // stage st: K at kv_s + 2 st KV_BYTES, V after
  const uint32_t full0 = smem_addr(bars), empty0 = full0 + 8 * STAGES;
  const uint32_t qfull = empty0 + 8 * STAGES;

  const int tid = threadIdx.x;
  const int n_rt = (R + BM - 1) / BM;
  const int rt = n_rt - 1 - (int)blockIdx.x / (KV * B), rem = blockIdx.x % (KV * B);
  const int g = rem % KV, b = rem / KV;
  const int r0 = rt * BM;
  const int start = starts[b];
  const int q_first = start + r0 / qpk, q_last = start + (min(r0 + BM, R) - 1) / qpk;
  const int klim = min(totals[b], maxp * page);   // keys the table holds and the mask lets in
  const int kend = min(klim, q_last + 1);
  const int n_tiles = kend > 0 ? (kend + KT - 1) / KT : 0;
  const int n_pages = kend > 0 ? (kend + page - 1) / page : 0;   // live pages
  const int ppt = KT / page;                                     // pages a tile

  if (n_pages < n_tiles * ppt && n_tiles <= STAGES) {
    // the last tile skips pages, and its stage holds no earlier tile: zero
    // its V so that p = 0 never meets a non-finite leftover
    uint4* v0 = reinterpret_cast<uint4*>(smem_raw + (base - raw) + Q_BYTES +
                                         (2 * ((n_tiles - 1) % STAGES) + 1) * KV_BYTES);
    for (int i = tid; i < KV_BYTES / 16; i += THREADS) v0[i] = make_uint4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, CONSUMERS);
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer warp: lane 0 issues the loads; the warp reads each tile's
    // page ids together
    const int lane = tid & 31;
    if (n_tiles == 0) return;
    if (lane == 0) {
      mbar_expect_tx(qfull, Q_BYTES);
#pragma unroll
      for (int p = 0; p < HD / 64; ++p)
        tma_load_4d(q_s + p * BM * 128, &tm_q, qfull, p * 64, r0, g, b);
    }
    const int* bt = block_tables + (size_t)b * maxp;
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES, pg0 = j * ppt, np = min(ppt, n_pages - pg0);
      const int pid_l = lane < np ? bt[pg0 + lane] : 0;
      if (j >= STAGES) mbar_wait(empty0 + 8 * st, ((j / STAGES) & 1) ^ 1);
      const uint32_t full = full0 + 8 * st, ks = kv_s + st * 2 * KV_BYTES;
      if (lane == 0) mbar_expect_tx(full, np * page * HD * 4);
      for (int i = 0; i < np; ++i) {
        const int pid = __shfl_sync(0xffffffffu, pid_l, i);
        if (lane == 0) {
#pragma unroll
          for (int p = 0; p < HD / 64; ++p) {
            const uint32_t dst = ks + p * KT * 128 + i * page * 128;
            tma_load_4d(dst, &tm_k, full, p * 64, 0, g, pid);
            tma_load_4d(dst + KV_BYTES, &tm_v, full, p * 64, 0, g, pid);
          }
        }
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  // scores in log2 units: s * scale * log2(e), or under a softcap
  // softcap * log2(e) * tanh(s * scale / softcap)
  const float mul = softcap > 0.f ? scale / softcap : scale * LOG2E;
  const float cap = softcap * LOG2E;
  float o[HD / 2], s[KT / 2];
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  // this thread's two rows (accumulator rows lane / 4 and lane / 4 + 8 of
  // its warp's 16) and their positions (-1: a row past R)
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + warp * 16 + (lane >> 2) + 8 * i;
    qpos[i] = r < R ? start + r / qpk : -1;
  }
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  if (n_tiles > 0) mbar_wait(qfull, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    mbar_wait(full0 + 8 * st, (j / STAGES) & 1);   // tile j has landed
    const uint32_t ks = kv_s + st * 2 * KV_BYTES, vs = ks + KV_BYTES;

    // S = Q K^T: 64 rows x KT keys, hd / 16 steps
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t panel = kk >> 2, col = (kk & 3) * 32;
      wgmma_ss(s, desc_sw128(q_s + panel * BM * 128 + col, 16, 1024),
               desc_sw128(ks + panel * KT * 128 + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    const int t0 = j * KT;
    const bool edge = t0 + KT > klim || t0 + KT - 1 > q_first;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m_r[i];
#pragma unroll
      for (int nn = 0; nn < KT / 8; ++nn) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[nn * 4 + i * 2 + c] * mul;
          if (softcap > 0.f) x = cap * tanhf(x);
          if (edge) {
            const int kpos = t0 + nn * 8 + 2 * (lane & 3) + c;
            if (kpos > qpos[i] || kpos >= klim) x = -INFINITY;   // qpos -1: every key
          }
          s[nn * 4 + i * 2 + c] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = ex2(m_r[i] - mx);
      m_r[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nn = 0; nn < KT / 8; ++nn) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = ex2(s[nn * 4 + i * 2 + c] - mx);   // 0 where masked (-inf)
          sum += p;
          s[nn * 4 + i * 2 + c] = p;
        }
      }
      l_r[i] = l_r[i] * alpha + sum;         // this thread's share of the row
#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn) {
        o[nn * 4 + i * 2] *= alpha;
        o[nn * 4 + i * 2 + 1] *= alpha;
      }
    }

    // O += P V: P (bf16) from registers, V MN-major from shared memory
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[8 * kk + 0], s[8 * kk + 1]),
                             pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                             pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                             pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
      wgmma_rs(o, a, desc_sw128(vs + kk * 16 * 128, KT * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
    mbar_arrive(empty0 + 8 * st);             // this thread is done with stage st
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (qpos[i] < 0) continue;
    const int r = r0 + warp * 16 + (lane >> 2) + 8 * i;
    const size_t base_o = (((size_t)b * KV + g) * R + r) * HD + 2 * (lane & 3);
    const float den = fmaxf(l, 1e-37f);
#pragma unroll
    for (int nn = 0; nn < HD / 8; ++nn)
      *reinterpret_cast<__nv_bfloat162*>(out + base_o + nn * 8) =
          __floats2bfloat162_rn(o[nn * 4 + i * 2] / den, o[nn * 4 + i * 2 + 1] / den);
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)BM * HD * 2 + STAGES * 2 * (size_t)KT * HD * 2;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* totals, const void* starts,
           const void* bt, void* out, int B, int KV, int R, int qpk, int page, int maxp, int P,
           float softcap, float scale, cudaStream_t stream) {
  const int n_work = (R + BM - 1) / BM * KV * B;
  if (n_work == 0) return (int)cudaSuccess;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!head_rows_map(&tm_q, q, B, KV, R, HD, BM) ||
      !head_rows_map(&tm_k, k, P, KV, page, HD, page) ||
      !head_rows_map(&tm_v, v, P, KV, page, HD, page))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = port::allow_smem(chunk_attn_sm90_kernel<HD>, smem_bytes<HD>());
  if (err != cudaSuccess) return (int)err;
  chunk_attn_sm90_kernel<HD><<<n_work, THREADS, smem_bytes<HD>(), stream>>>(
      tm_q, tm_k, tm_v, (const int*)totals, (const int*)starts, (const int*)bt,
      (__nv_bfloat16*)out, B, KV, R, qpk, page, maxp, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 only. q (B, KV, R, hd) with R = Sc * qpk, heads innermost; pools
// (P, KV, page, hd); totals, starts (B,) and block_tables (B, maxp) int32;
// out like q. All contiguous, q and the pools 16-byte aligned. hd 64 or
// 128; page 8, 16, 32 or 64. Returns a cudaError_t code (0 = launched;
// cudaErrorInvalidValue also when cuTensorMapEncodeTiled refuses a map).
int chunked_prefill_attention_sm90(int dtype, const void* q, const void* k_pages,
                                   const void* v_pages, const void* totals, const void* starts,
                                   const void* block_tables, void* out, int B, int KV, int R,
                                   int qpk, int hd, int page, int maxp, int P, float softcap,
                                   float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != DTYPE_BF16 || (page != 8 && page != 16 && page != 32 && page != 64) || qpk < 1)
    return (int)cudaErrorInvalidValue;
  if (hd == 64)
    return launch<64>(q, k_pages, v_pages, totals, starts, block_tables, out, B, KV, R, qpk,
                      page, maxp, P, softcap, scale, s);
  if (hd == 128)
    return launch<128>(q, k_pages, v_pages, totals, starts, block_tables, out, B, KV, R, qpk,
                       page, maxp, P, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
