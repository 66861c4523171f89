// The decode attention on Hopper, over the paged pool and over the dense
// cache: each sequence's live key range split across blocks, its key tiles
// brought into a ring in shared memory by bulk copies, and the splits
// merged in a fixed order.
//
//   * decode_split_kernel<.., PAGED>, decode_merge_kernel
//       <- src/repro/kernels/decode_attn.py:280 paged_decode_attention_kernel
//          (fp body _paged_decode_kernel, :168), in float32 and bfloat16
//   * decode_split_kernel<.., DENSE>, decode_merge_kernel
//       <- src/repro/kernels/decode_attn.py:127 decode_attention_kernel
//          (body _decode_kernel, :77), in float32 and bfloat16
//   * decode_split_int8_kernel, decode_merge_kernel
//       <- src/repro/kernels/decode_attn.py:280 paged_decode_attention_kernel
//          (int8 body _paged_decode_kernel_int8, :222), q in float32 and
//          bfloat16, at head_dim a multiple of 16 and pages of a multiple
//          of 4 keys; other pages run the scalar kernel of decode_attn.cu
//
// What bounds it on the card: bytes. A decode row does 2 * qpk FLOPs a K or
// V element it reads, about qpk operations a byte in bf16, far below the
// H100's ~295 Op/B knee; the least time is the live K/V bytes over 3.35 TB/s.
// To come near it the card needs enough loads in flight on every SM, and no
// block may walk a long sequence alone while the others idle.
//
// Design (a "tile" is a page of the pool, or `tile` consecutive positions
// of the dense cache):
//   * The split. The grid is (B * KV, nsplit) with nsplit = ceil(ntiles /
//     TPS) from the row's width alone (the table's maxp pages, or
//     ceil(Smax / tile) tiles of the dense cache), so the launch needs no
//     host sync on `lengths` and can be captured in a CUDA graph. A block
//     reads lengths[b] itself, takes the live tiles [lo, hi) (the window's
//     first tile up to the tile that holds position min(length, kend) - 1,
//     kend the keys the row holds) and covers tiles [lo + s TPS, min(lo +
//     (s + 1) TPS, hi)); a block whose range is empty exits at once. Every
//     tile of a live range holds a valid key, so every live split has a
//     finite max and a sum >= 1.
//   * The ring. The (page id, KV head) slab of a pool (P, KV, page, hd) is
//     one contiguous run of page * hd elements, so one cp.async.bulk brings
//     it in. In the dense cache (B, Smax, KV, hd) a head's keys are rows ss
//     elements apart, so a tile is one TMA box of a tensor map over the
//     cache seen as (hd, KV, Smax, B) with its own strides (a layer view of
//     a stacked cache is read in place; positions past Smax read as zeros
//     and are masked). Either completes on the stage's mbarrier. Warp 0
//     reads the split's page ids, a lane each; its lane 0 first issues
//     `stages` tiles of K and V, then tile j - 1 + stages once every thread
//     is past tile j - 1 (with one stage, tile j + 1 once every thread is
//     past tile j).
//   * The arithmetic, on the CUDA cores in float32, with one barrier a tile.
//     q is scaled once into shared memory and read into registers for up to
//     QG heads a pass. A half-warp scores one key: its lanes read the key
//     row in 16-byte words and reduce with shuffles, into one of two score
//     buffers (tile j in buffer j & 1, so the next tile's scores never
//     overwrite scores still being read). After the barrier every thread
//     takes the tile's max of its head from the shared scores itself and
//     keeps its own running max m, its keys' share of the sum l and its
//     output words of the accumulator in registers for the whole split;
//     p is gated by the mask as the reference does and kept in float32 for
//     PV, which reads V in 16-byte words. (The reference rounds p to the
//     cache dtype first, p.astype(v.dtype), for its bf16 MXU operands; here
//     that rounding, taken against each split's own running max, made the
//     result depend on how a row was split: in path c's decode check one
//     split layout moved a near-tied logit by 0.46, PERF.md section 6.)
//     The threads of a head split its keys into groups whose shares are
//     summed in a fixed order at the split's end.
//   * The merge. Each live split writes float32 (acc, m, l) for its qpk rows
//     into a workspace (B, KV, nsplit, qpk, hd + 2). A second launch, its
//     blocks over (sequence, KV head) and 128-element runs of the qpk rows,
//     reads lengths to know how many splits are live, takes each head's max
//     M and weights over them a warp a head, and merges them in split order,
//     an output element a thread:
//     out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-37). No
//     float atomics: the result does not depend on the order blocks run in,
//     and a sequence with no live key writes exact zeros.
//
// The int8 body (decode_split_int8_kernel, below) shares the split, the
// ring and the merge; a stage holds a page's int8 K and V and their float32
// scales, and the per-page requantization of p * v_scale is kept.
//
// Why no tensor cores: at qpk query heads a KV head the kernel does about
// qpk operations a byte. At OLMoE's qpk 1 no wgmma or mma.sync tile has rows
// to fill, and at qpk 4-8 the 67 TFLOP/s of the float32 CUDA cores still
// outrun 3.35 TB/s x qpk Op/B. Its times on the card are in PERF.md
// section 6.
#include "hopper.cuh"

using port::from_f;
using port::NEG_INF;
using port::to_f;
using port::unpack16;
using port::warp_max;

namespace {

constexpr int THREADS = 128;
constexpr int HALVES = THREADS / 16;   // half-warps: keys scored at once
constexpr int GQA_HEADS = 4;           // query heads a score pass holds in registers at qpk > 1
constexpr int MAX_STAGES = 4;
constexpr int MAX_TPS = 32;            // a page id a lane of warp 0
constexpr bool PAGED = false, DENSE = true;

// The dense cache's K and V as TMA tensor maps (unused by the paged kernel).
struct CacheMaps {
  CUtensorMap k, v;
};

// A key is live below lim = min(length, the keys the row holds) and, with a
// window, past length - 1 - window.
__device__ __forceinline__ bool decode_valid(int kpos, int lim, int length, int window) {
  return kpos < lim && (window <= 0 || kpos > length - 1 - window);
}

// The live tiles [lo, hi) of a sequence: from the tile holding the window's
// first position up to the tile holding position length - 1 (a length past
// the row's ntiles tiles attends what the row holds).
__device__ __forceinline__ void live_tiles(int length, int window, int tile, int ntiles, int& lo,
                                           int& hi) {
  const int first = (window > 0 && length - window > 0) ? length - window : 0;
  lo = first / tile;
  hi = min((length + tile - 1) / tile, ntiles);
}

// floats of shared memory after the ring: q (qpk, hd), two buffers of tile
// scores (2, qpk, tile), rounded up to 16 bytes; then the key groups'
// partial accumulators (THREADS words of E floats) and sums (THREADS)
__host__ __device__ __forceinline__ int red_offset(int qpk, int hd, int tile) {
  return (qpk * (hd + 2 * tile) + 3) & ~3;
}

template <typename T>
__host__ __device__ __forceinline__ size_t smem_bytes(int qpk, int hd, int tile, int stages) {
  return 128 + (size_t)stages * 2 * tile * hd * sizeof(T) +
         ((size_t)red_offset(qpk, hd, tile) + (size_t)THREADS * (16 / sizeof(T) + 1)) * 4;
}

// grid (B * KV, nsplit); q (B, KV, qpk, hd); paged: pools (P, KV, tile, hd)
// and block_tables (B, ntiles), 16-byte aligned, hd a multiple of 8; dense:
// the maps of a (B, Smax, KV, hd) cache, boxes of hd x 1 x tile x 1. kend:
// the keys a row holds (ntiles * tile paged, Smax dense). ws (B, KV, nsplit,
// qpk, hd + 2) float32: a live split's unnormalised accumulator, then its
// running max m and sum l, for each query head. WPL: 16-byte words of a key
// row a lane scores (ceil(words / 16)); NW: output words a thread
// accumulates when the qpk * words output words outnumber the threads (else
// 1, and the threads split the keys into THREADS / (qpk * words) groups);
// QG: query heads a score pass holds in registers (1 at qpk 1, else 4).
template <typename T, int WPL, int NW, int QG, bool LAYOUT>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const __grid_constant__ CacheMaps maps, const T* __restrict__ q,
                    const T* __restrict__ k_pages, const T* __restrict__ v_pages,
                    const int* __restrict__ lengths, const int* __restrict__ block_tables,
                    float* __restrict__ ws, int KV, int qpk, int hd, int tile, int ntiles,
                    int kend, int window, int tps, int stages, float softcap, float scale) {
  constexpr int E = 16 / sizeof(T);             // elements a 16-byte word
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[MAX_STAGES];
  __shared__ int pid_s[MAX_TPS];

  const int bg = blockIdx.x, b = bg / KV, g = bg - b * KV, split = blockIdx.y;
  const int length = lengths[b], lim = min(length, kend);
  int lo, hi;
  live_tiles(length, window, tile, ntiles, lo, hi);
  const int p0 = lo + split * tps, np = min(tps, hi - p0);
  if (np <= 0) return;                          // the whole block, before any barrier

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int words = hd / E;                     // 16-byte words of a key row
  const size_t slab = (size_t)tile * hd;        // elements of a (tile, head) slab
  const uint32_t slab_bytes = (uint32_t)(slab * sizeof(T));
  T* ring = reinterpret_cast<T*>(smem_raw + ((128 - (sm90::smem_addr(smem_raw) & 127)) & 127));
  float* q_s = reinterpret_cast<float*>(ring + (size_t)stages * 2 * slab);   // (qpk, hd)
  float* s_s = q_s + qpk * hd;                  // (2, qpk, tile) scores, tile j in j & 1
  float* red_s = q_s + red_offset(qpk, hd, tile);   // (groups, qpk * words, E)
  float* redl_s = red_s + THREADS * E;          // (groups, qpk)
  const uint32_t ring_a = sm90::smem_addr(ring), bar0 = sm90::smem_addr(bars);

  auto issue = [&](int j) {                     // tile j of the split into its stage
    const int st = j % stages;
    const uint32_t bar = bar0 + 8 * st, dst = ring_a + st * 2 * slab_bytes;
    sm90::mbar_expect_tx(bar, 2 * slab_bytes);
    if constexpr (LAYOUT == DENSE) {
      sm90::tma_load_4d(dst, &maps.k, bar, 0, g, (p0 + j) * tile, b);
      sm90::tma_load_4d(dst + slab_bytes, &maps.v, bar, 0, g, (p0 + j) * tile, b);
    } else {
      const size_t src = ((size_t)pid_s[j] * KV + g) * slab;
      sm90::bulk_load(dst, k_pages + src, slab_bytes, bar);
      sm90::bulk_load(dst + slab_bytes, v_pages + src, slab_bytes, bar);
    }
  };
  if (warp == 0) {
    if constexpr (LAYOUT == PAGED) {
      if (lane < np) pid_s[lane] = block_tables[(size_t)b * ntiles + p0 + lane];
      __syncwarp();
    }
    if (lane == 0) {
      for (int st = 0; st < stages; ++st) sm90::mbar_init(bar0 + 8 * st, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int j = 0; j < min(stages, np); ++j) issue(j);
    }
  }
  const size_t head_off = (size_t)bg * qpk * hd;
  for (int e = tid; e < qpk * hd; e += THREADS) q_s[e] = to_f(q[head_off + e]) * scale;
  __syncthreads();

  // PV: output word o = h * words + c (head h, 16-byte column c). Each thread
  // keeps the running max m and its keys' share of the sum l of its words'
  // heads: every thread of a head takes the same tile max from the same
  // scores, so the key groups' shares add up at the end.
  const int OW = qpk * words;
  const int groups = OW <= THREADS ? THREADS / OW : 1;
  const int kg = OW <= THREADS ? tid / OW : 0;
  int o_h[NW], o_c[NW];
  bool o_on[NW];
  float acc[NW][E], m_r[NW], l_r[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int o = OW <= THREADS ? tid % OW : tid + i * THREADS;
    o_on[i] = kg < groups && o < OW && (OW <= THREADS ? i == 0 : true);
    o_h[i] = o / words;
    o_c[i] = o - o_h[i] * words;
    m_r[i] = NEG_INF;
    l_r[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  const int hw = tid >> 4, li = tid & 15;
  for (int j = 0; j < np; ++j) {
    const int st = j % stages, k0 = (p0 + j) * tile;
    const T* k_s = ring + (size_t)st * 2 * slab;
    const T* v_s = k_s + slab;
    float* sc = s_s + (j & 1) * qpk * tile;
    sm90::mbar_wait(bar0 + 8 * st, (j / stages) & 1);

    // scores: a half-warp a key, its lanes across the row's 16-byte words
    for (int h0 = 0; h0 < qpk; h0 += QG) {
      float qr[QG][WPL][E];
#pragma unroll
      for (int hh = 0; hh < QG; ++hh)
#pragma unroll
        for (int w = 0; w < WPL; ++w) {
          const int c = li + 16 * w;
          const bool on = h0 + hh < qpk && c < words;
#pragma unroll
          for (int e4 = 0; e4 < E; e4 += 4) {
            const float4 x = on ? *reinterpret_cast<const float4*>(
                                      q_s + (h0 + hh) * hd + c * E + e4)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
            qr[hh][w][e4] = x.x;
            qr[hh][w][e4 + 1] = x.y;
            qr[hh][w][e4 + 2] = x.z;
            qr[hh][w][e4 + 3] = x.w;
          }
        }
#pragma unroll 2
      for (int t0 = 0; t0 < tile; t0 += HALVES) {
        const int t = t0 + hw;
        float kf[WPL][E];
#pragma unroll
        for (int w = 0; w < WPL; ++w) {
          const int c = li + 16 * w;
          unpack16(t < tile && c < words
                       ? *reinterpret_cast<const uint4*>(k_s + (size_t)t * hd + c * E)
                       : make_uint4(0, 0, 0, 0),
                   kf[w]);
        }
        const bool valid = t < tile && decode_valid(k0 + t, lim, length, window);
#pragma unroll
        for (int hh = 0; hh < QG; ++hh) {
          if (h0 + hh >= qpk) break;            // the same for every lane
          float d = 0.f;
#pragma unroll
          for (int w = 0; w < WPL; ++w)
#pragma unroll
            for (int e = 0; e < E; ++e) d += qr[hh][w][e] * kf[w][e];
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
          if (li == 0 && t < tile) {
            if (softcap > 0.f) d = softcap * tanhf(d / softcap);
            sc[(h0 + hh) * tile + t] = valid ? d : NEG_INF;
          }
        }
      }
    }
    // the scores are in; every thread is past tile j - 1, so its stage is free
    __syncthreads();
    if (stages > 1 && tid == 0 && j >= 1 && j - 1 + stages < np) issue(j - 1 + stages);

    // online softmax and PV: keys at or past lim have p == 0 and are not read
    const int nlive = min(tile, lim - k0);
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if (!o_on[i]) continue;
      const float* sh = sc + o_h[i] * tile;
      float mx = NEG_INF;
#pragma unroll 8
      for (int t = 0; t < tile; ++t) mx = fmaxf(mx, sh[t]);
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = expf(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= alpha;
      for (int t = kg; t < nlive; t += groups) {
        // gated: a masked entry contributes exactly 0 even while m is NEG_INF
        const float p = decode_valid(k0 + t, lim, length, window) ? expf(sh[t] - m_new) : 0.f;
        l_r[i] += p;
        float vf[E];
        unpack16(*reinterpret_cast<const uint4*>(v_s + (size_t)t * hd + o_c[i] * E), vf);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] += p * vf[e];
      }
    }
    if (stages == 1 && j + 1 < np) {            // one stage: free it before the next wait
      __syncthreads();
      if (tid == 0) issue(j + 1);
    }
  }

  // the split's (acc, m, l): key groups summed in order
  float* wsb = ws + ((size_t)bg * gridDim.y + split) * qpk * (hd + 2);
  if (groups > 1) {
    if (o_on[0]) {
#pragma unroll
      for (int e = 0; e < E; ++e) red_s[((size_t)kg * OW + tid % OW) * E + e] = acc[0][e];
      if (o_c[0] == 0) {
        redl_s[kg * qpk + o_h[0]] = l_r[0];
        if (kg == 0) wsb[o_h[0] * (hd + 2) + hd] = m_r[0];
      }
    }
    __syncthreads();
    for (int o = tid; o < OW; o += THREADS) {
      float sum[E];
#pragma unroll
      for (int e = 0; e < E; ++e) sum[e] = 0.f;
      for (int k = 0; k < groups; ++k)
#pragma unroll
        for (int e = 0; e < E; ++e) sum[e] += red_s[((size_t)k * OW + o) * E + e];
      const int h = o / words, c = o - h * words;
#pragma unroll
      for (int e = 0; e < E; ++e) wsb[h * (hd + 2) + c * E + e] = sum[e];
      if (c == 0) {
        float l = 0.f;
        for (int k = 0; k < groups; ++k) l += redl_s[k * qpk + h];
        wsb[h * (hd + 2) + hd + 1] = l;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if (!o_on[i]) continue;
      float* r = wsb + o_h[i] * (hd + 2);
#pragma unroll
      for (int e = 0; e < E; ++e) r[o_c[i] * E + e] = acc[i][e];
      if (o_c[i] == 0) {
        r[hd] = m_r[i];
        r[hd + 1] = l_r[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The int8 split body: int8 pools with float32 per-(token, KV head) scale
// pools, each page exactly as the TPU kernel's int8 body computes it:
//   s   = ((float(q8 . k8) * q_scale) * k_scale) * scale, then the softcap
//   p   = exp(s - m_new), gated by the mask
//   pv8 = p * v_scale requantized per row over this page (pv_scale)
//   acc = acc * alpha + float(pv8 . v8) * pv_scale
// over the split's pages with the split's own running max m; the merge
// kernel above then combines the splits' (acc, m, l). Requantization is
// scale-invariant above the recipe's 1e-8 scale floor, so there a split's
// own m gives the same pv8 as the sequence's in exact arithmetic; in float
// a value within rounding of a .5 step can move by one int8 step. Below
// it (p * v_scale under 1.27e-6 on a whole page, ~10 below the sequence's
// max) the page walk requantizes on the floor's coarser grid, and a split
// whose own max is lower keeps more of the page: at most 0.5e-8 * 127 a key
// of such a page, over l (kernels/decode_attn.py::
// paged_decode_attention_int8_split_plain is this arithmetic, split by
// split).
// ---------------------------------------------------------------------------

// A stage: the int8 K and V slabs (page, hd) of one (page id, KV head), then
// its float32 K and V scale slabs (page): four bulk copies, each a whole
// number of 16-byte words when page % 4 == 0.
__host__ __device__ __forceinline__ size_t i8_stage_bytes(int hd, int page) {
  return 2 * (size_t)page * hd + 8 * (size_t)page;
}

// Shared memory after the ring: float32 scores (qpk, page) and five per-row
// values (m, l, alpha, pv scale, q scale), rounded up to 16 bytes; then int8
// q (qpk, hd) and pv (qpk, page).
__host__ __device__ __forceinline__ size_t i8_rows_bytes(int qpk, int page) {
  return ((size_t)qpk * (page + 5) * 4 + 15) & ~(size_t)15;
}

__host__ __device__ __forceinline__ size_t i8_smem_bytes(int qpk, int hd, int page,
                                                         int stages) {
  return 128 + (size_t)stages * i8_stage_bytes(hd, page) + i8_rows_bytes(qpk, page) +
         (size_t)qpk * (hd + page);
}

// grid (B * KV, nsplit); q (B, KV, qpk, hd); int8 pools (P, KV, page, hd)
// and float32 scale pools (P, KV, page), all 16-byte aligned; hd a multiple
// of 16 up to 256, page a multiple of 4; ws as decode_split_kernel's. The
// block's pages, split and ring are decode_split_kernel's. The arithmetic
// runs on the CUDA cores: at qpk 1-4 a row is far too thin for a 16-row
// mma. q is quantized once a block, a warp a row. Scores: hd / 16 lanes a
// key, __dp4a over 16-byte words, summed with shuffles. A page's max, exp,
// sum and amax of a row: one warp, its lanes across the keys, with
// shuffles. PV: four lanes share an output word (4 columns of one row),
// each takes every fourth run of 4 keys, transposes the 4 x 4 bytes of V
// with __byte_perm and takes __dp4a with the row's 4 pv8 bytes; the four
// int32 sums are exact in any order, added with shuffles, and each lane
// folds one column into its float32 accumulator. NS: output words a lane
// group holds (ceil(qpk * hd / 4 / 32)).
template <typename T, int NS>
__global__ void __launch_bounds__(THREADS)
decode_split_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_pages,
                         const float* __restrict__ k_scales, const int8_t* __restrict__ v_pages,
                         const float* __restrict__ v_scales, const int* __restrict__ lengths,
                         const int* __restrict__ block_tables, float* __restrict__ ws, int KV,
                         int qpk, int hd, int page, int maxp, int window, int pps, int stages,
                         float softcap, float scale) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[MAX_STAGES];
  __shared__ int pid_s[MAX_TPS];

  const int bg = blockIdx.x, b = bg / KV, g = bg - b * KV, split = blockIdx.y;
  const int length = lengths[b], lim = min(length, maxp * page);
  int lo, hi;
  live_tiles(length, window, page, maxp, lo, hi);
  const int p0 = lo + split * pps, np = min(pps, hi - p0);
  if (np <= 0) return;                          // the whole block, before any barrier

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t kv_bytes = (uint32_t)page * hd, sc_bytes = (uint32_t)page * 4;
  const uint32_t stage_bytes = (uint32_t)i8_stage_bytes(hd, page);
  unsigned char* ring = smem_raw + ((128 - (sm90::smem_addr(smem_raw) & 127)) & 127);
  float* s_s = reinterpret_cast<float*>(ring + (size_t)stages * stage_bytes);  // (qpk, page)
  float* m_s = s_s + qpk * page;
  float* l_s = m_s + qpk;
  float* alpha_s = l_s + qpk;
  float* pvsc_s = alpha_s + qpk;
  float* qsc_s = pvsc_s + qpk;
  int8_t* q8 = reinterpret_cast<int8_t*>(s_s) + i8_rows_bytes(qpk, page);      // (qpk, hd)
  int8_t* pv8 = q8 + qpk * hd;                                                 // (qpk, page)
  const uint32_t ring_a = sm90::smem_addr(ring), bar0 = sm90::smem_addr(bars);

  auto issue = [&](int j) {                     // page j of the split into its stage
    const int st = j % stages;
    const uint32_t bar = bar0 + 8 * st, dst = ring_a + st * stage_bytes;
    const size_t slab = (size_t)pid_s[j] * KV + g;
    sm90::mbar_expect_tx(bar, stage_bytes);
    sm90::bulk_load(dst, k_pages + slab * kv_bytes, kv_bytes, bar);
    sm90::bulk_load(dst + kv_bytes, v_pages + slab * kv_bytes, kv_bytes, bar);
    sm90::bulk_load(dst + 2 * kv_bytes, k_scales + slab * page, sc_bytes, bar);
    sm90::bulk_load(dst + 2 * kv_bytes + sc_bytes, v_scales + slab * page, sc_bytes, bar);
  };
  if (warp == 0) {
    if (lane < np) pid_s[lane] = block_tables[(size_t)b * maxp + p0 + lane];
    __syncwarp();
    if (lane == 0) {
      for (int st = 0; st < stages; ++st) sm90::mbar_init(bar0 + 8 * st, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int j = 0; j < min(stages, np); ++j) issue(j);
    }
  }
  port::quantize_rows(q + (size_t)bg * qpk * hd, qpk, qpk, hd, q8, qsc_s);
  if (tid < qpk) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int G = hd / 16;                        // lanes a key row: 1-16
  const int gl = tid % G, gk = tid / G;         // this lane's word, and key of a pass
  const int W4 = hd / 4;                        // output words of a row
  const int kl = tid & 3;                       // this lane's share of a word's keys
  float acc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) acc[i] = 0.f;

  for (int j = 0; j < np; ++j) {
    const int st = j % stages, k0 = (p0 + j) * page;
    const int8_t* k_s = reinterpret_cast<const int8_t*>(ring) + (size_t)st * stage_bytes;
    const int8_t* v_s = k_s + kv_bytes;
    const float* ks_s = reinterpret_cast<const float*>(v_s + kv_bytes);
    const float* vs_s = ks_s + page;
    sm90::mbar_wait(bar0 + 8 * st, (j / stages) & 1);

    // scores: G lanes a key across its 16-byte words
    for (int t0 = 0; t0 < page; t0 += THREADS / G) {   // the same for every lane
      const int t = t0 + gk;
      const bool row_ok = t < page;
      const uint4 kw = row_ok ? reinterpret_cast<const uint4*>(k_s + (size_t)t * hd)[gl]
                              : make_uint4(0u, 0u, 0u, 0u);
      const bool valid = row_ok && decode_valid(k0 + t, lim, length, window);
      const float ksc = row_ok ? ks_s[t] : 0.f;
      for (int h = 0; h < qpk; ++h) {
        int d = port::dot16(reinterpret_cast<const uint4*>(q8 + h * hd)[gl], kw, 0);
        for (int o = G / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if (row_ok && gl == 0)
          s_s[h * page + t] = valid ? port::i8_score(d, qsc_s[h], ksc, scale, softcap) : NEG_INF;
      }
    }
    // the scores are in; every thread is past page j - 1, so its stage is free
    __syncthreads();
    if (stages > 1 && tid == 0 && j >= 1 && j - 1 + stages < np) issue(j - 1 + stages);

    // a warp a row: the page's max, p gated by the mask, its sum, p * v_scale
    // and its amax, then pv8 requantized over the page
    for (int h = warp; h < qpk; h += THREADS / 32) {
      float* sr = s_s + h * page;
      float mx = NEG_INF;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, sr[t]);
      mx = warp_max(mx);
      const float m_old = m_s[h], m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f, amax = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float p = decode_valid(k0 + t, lim, length, window) ? expf(sr[t] - m_new) : 0.f;
        sum += p;
        const float pv = __fmul_rn(p, vs_s[t]);
        sr[t] = pv;
        amax = fmaxf(amax, fabsf(pv));
      }
      sum = port::warp_sum(sum);
      const float sc = port::i8_scale(warp_max(amax), port::rcp_for(127.f));
      const float rsc = port::rcp_for(sc);
      for (int t = lane; t < page; t += 32) pv8[h * page + t] = port::quant_i8(sr[t], sc, rsc);
      if (lane == 0) {
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m_new;
        alpha_s[h] = alpha;
        pvsc_s[h] = sc;
      }
    }
    __syncthreads();

    // PV: lanes 4w .. 4w + 3 of a pass share output word i * 32 + w
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int si = i * (THREADS / 4) + (tid >> 2);
      const bool on = si < qpk * W4;
      const int h = on ? si / W4 : 0, c = on ? si - h * W4 : 0;
      int a[4] = {0, 0, 0, 0};
      if (on) {
        for (int t0 = 4 * kl; t0 < page; t0 += 16) {
          const int* vr = reinterpret_cast<const int*>(v_s + (size_t)t0 * hd) + c;
          const uint32_t w0 = vr[0], w1 = vr[W4], w2 = vr[2 * W4], w3 = vr[3 * W4];
          const int pw = *reinterpret_cast<const int*>(pv8 + h * page + t0);
          uint32_t col[4];                      // column 4c + e of keys t0 .. t0 + 3
          port::transpose4x4(w0, w1, w2, w3, col);
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = __dp4a((int)col[e], pw, a[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[e] += __shfl_xor_sync(0xffffffffu, a[e], 1);
        a[e] += __shfl_xor_sync(0xffffffffu, a[e], 2);
      }
      const int mine = kl == 0 ? a[0] : kl == 1 ? a[1] : kl == 2 ? a[2] : a[3];
      if (on)
        acc[i] = __fadd_rn(__fmul_rn(acc[i], alpha_s[h]), __fmul_rn((float)mine, pvsc_s[h]));
    }
    if (stages == 1 && j + 1 < np) {            // one stage: free it before the next wait
      __syncthreads();
      if (tid == 0) issue(j + 1);
    }
  }

  // the split's (acc, m, l); m and l were last written before the page's
  // second barrier
  float* wsb = ws + ((size_t)bg * gridDim.y + split) * qpk * (hd + 2);
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int si = i * (THREADS / 4) + (tid >> 2);
    if (si < qpk * W4) {
      const int h = si / W4, c = si - h * W4;
      wsb[h * (hd + 2) + 4 * c + kl] = acc[i];
    }
  }
  if (tid < qpk) {
    wsb[tid * (hd + 2) + hd] = m_s[tid];
    wsb[tid * (hd + 2) + hd + 1] = l_s[tid];
  }
}

// grid (B * KV, ceil(qpk * hd / THREADS)); the live splits of each
// (sequence, KV head) merged in split order, an output element a thread;
// out (B, KV, qpk, hd) like q. Shared memory: the weights
// e^(m_s - M) (qpk, nsplit), then l_s times them (qpk, nsplit), then the
// merged sums (qpk).
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_merge_kernel(const float* __restrict__ ws, const int* __restrict__ lengths,
                    T* __restrict__ out, int KV, int qpk, int hd, int tile, int ntiles,
                    int window, int tps, int nsplit) {
  extern __shared__ float w_s[];
  float* lw_s = w_s + qpk * nsplit;
  float* den_s = lw_s + qpk * nsplit;
  const int bg = blockIdx.x, b = bg / KV, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int lo, hi;
  live_tiles(lengths[b], window, tile, ntiles, lo, hi);
  const int nlive = hi > lo ? (hi - lo + tps - 1) / tps : 0;
  const int row = hd + 2;
  const size_t stride = (size_t)qpk * row;      // one split's rows
  const float* wsb = ws + (size_t)bg * nsplit * stride;

  // a warp a query head of this block's elements: the max over the splits,
  // each split's weight, and the merged sum l taken in split order
  const int h_end = min(qpk, ((int)blockIdx.y * THREADS + THREADS + hd - 1) / hd);
  for (int h = (int)blockIdx.y * THREADS / hd + warp; h < h_end; h += THREADS / 32) {
    const float* r = wsb + h * row;
    float mx = NEG_INF;
    for (int s = lane; s < nlive; s += 32) mx = fmaxf(mx, r[s * stride + hd]);
    mx = warp_max(mx);
    for (int s = lane; s < nlive; s += 32) {
      const float w = expf(r[s * stride + hd] - mx);
      w_s[h * nsplit + s] = w;
      lw_s[h * nsplit + s] = r[s * stride + hd + 1] * w;
    }
    __syncwarp();
    if (lane == 0) {
      float l = 0.f;
      for (int s = 0; s < nlive; ++s) l += lw_s[h * nsplit + s];
      den_s[h] = fmaxf(l, 1e-37f);
    }
  }
  __syncthreads();
  const int e = blockIdx.y * THREADS + tid;
  if (e < qpk * hd) {
    const int h = e / hd, d = e - h * hd;
    const float* r = wsb + h * row + d;
    const float* w = w_s + h * nsplit;
    float acc = 0.f;
#pragma unroll 4
    for (int s = 0; s < nlive; ++s) acc += r[s * stride] * w[s];
    out[(size_t)bg * qpk * hd + e] = from_f<T>(acc / den_s[h]);
  }
}

// What a launch reads: the paged pools and tables, or the dense cache's maps.
struct Source {
  CacheMaps maps;
  const void *k, *v, *bt;
};

struct Shape {
  int B, KV, qpk, hd, tile, ntiles, kend, window, tps, stages;
  float softcap, scale;
};

template <typename T>
int launch_merge(void* ws, const void* lengths, void* out, const Shape& s, int nsplit,
                 cudaStream_t stream) {
  const size_t msmem = ((size_t)2 * s.qpk * nsplit + s.qpk) * sizeof(float);
  cudaError_t err = port::allow_smem(decode_merge_kernel<T>, msmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 mgrid(s.B * s.KV, (s.qpk * s.hd + THREADS - 1) / THREADS);
  decode_merge_kernel<T><<<mgrid, THREADS, msmem, stream>>>(
      (const float*)ws, (const int*)lengths, (T*)out, s.KV, s.qpk, s.hd, s.tile, s.ntiles,
      s.window, s.tps, nsplit);
  return (int)cudaGetLastError();
}

template <typename T, int WPL, int NW, int QG, bool LAYOUT>
int launch(const Source& src, const void* q, const void* lengths, void* ws, void* out,
           const Shape& s, cudaStream_t stream) {
  const int nsplit = (s.ntiles + s.tps - 1) / s.tps;
  if (nsplit > 0) {
    const size_t smem = smem_bytes<T>(s.qpk, s.hd, s.tile, s.stages);
    auto kernel = decode_split_kernel<T, WPL, NW, QG, LAYOUT>;
    cudaError_t err = port::allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(s.B * s.KV, nsplit), THREADS, smem, stream>>>(
        src.maps, (const T*)q, (const T*)src.k, (const T*)src.v, (const int*)lengths,
        (const int*)src.bt, (float*)ws, s.KV, s.qpk, s.hd, s.tile, s.ntiles, s.kend, s.window,
        s.tps, s.stages, s.softcap, s.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return launch_merge<T>(ws, lengths, out, s, nsplit, stream);
}

template <typename T, int WPL, bool LAYOUT>
int launch_nw(int nw, const Source& src, const void* q, const void* lengths, void* ws,
              void* out, const Shape& s, cudaStream_t stream) {
#define D_LAUNCH(NW, QG) launch<T, WPL, NW, QG, LAYOUT>(src, q, lengths, ws, out, s, stream)
  if (s.qpk == 1) return D_LAUNCH(1, 1);
  switch (nw) {
    case 1: return D_LAUNCH(1, GQA_HEADS);
    case 2: return D_LAUNCH(2, GQA_HEADS);
    case 4: return D_LAUNCH(4, GQA_HEADS);
    case 8: return D_LAUNCH(8, GQA_HEADS);
  }
#undef D_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool LAYOUT>
int launch_dtype(const Source& src, const void* q, const void* lengths, void* ws, void* out,
                 Shape s, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int words = s.hd / E, ow = s.qpk * words;
  const int wpl = (words + 15) / 16;
  int nw = 1;
  while (nw * THREADS < ow) nw *= 2;
  if (nw > 8) return (int)cudaErrorInvalidValue;
  // as many stages as fit one block's shared memory, at least one
  while (s.stages > 1 && smem_bytes<T>(s.qpk, s.hd, s.tile, s.stages) > 227 * 1024) --s.stages;
  if (smem_bytes<T>(s.qpk, s.hd, s.tile, s.stages) > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (wpl == 1) return launch_nw<T, 1, LAYOUT>(nw, src, q, lengths, ws, out, s, stream);
  if (wpl == 2) return launch_nw<T, 2, LAYOUT>(nw, src, q, lengths, ws, out, s, stream);
  if constexpr (E == 4)                           // float32 at head_dim past 128
    return launch_nw<T, 4, LAYOUT>(nw, src, q, lengths, ws, out, s, stream);
  return (int)cudaErrorInvalidValue;
}

template <bool LAYOUT>
int launch_any(int dtype, const Source& src, const void* q, const void* lengths, void* ws,
               void* out, const Shape& s, cudaStream_t stream) {
  if (s.hd % 8 || s.hd > 256 || s.hd < 8 || s.qpk < 1 || s.tile < 1 || s.tps < 1 ||
      s.tps > MAX_TPS || s.stages < 1 || s.stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  if (s.B * s.KV == 0) return (int)cudaSuccess;
  if (dtype == DTYPE_F32) return launch_dtype<float, LAYOUT>(src, q, lengths, ws, out, s, stream);
  if (dtype == DTYPE_BF16)
    return launch_dtype<__nv_bfloat16, LAYOUT>(src, q, lengths, ws, out, s, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int NS>
int launch_int8(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                const void* lengths, const void* bt, void* ws, void* out, const Shape& s,
                cudaStream_t stream) {
  const int nsplit = (s.ntiles + s.tps - 1) / s.tps;
  if (nsplit > 0) {
    const size_t smem = i8_smem_bytes(s.qpk, s.hd, s.tile, s.stages);
    auto kernel = decode_split_int8_kernel<T, NS>;
    cudaError_t err = port::allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(s.B * s.KV, nsplit), THREADS, smem, stream>>>(
        (const T*)q, (const int8_t*)k, (const float*)ks, (const int8_t*)v, (const float*)vs,
        (const int*)lengths, (const int*)bt, (float*)ws, s.KV, s.qpk, s.hd, s.tile, s.ntiles,
        s.window, s.tps, s.stages, s.softcap, s.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return launch_merge<T>(ws, lengths, out, s, nsplit, stream);
}

template <typename T>
int launch_int8_ns(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                   const void* lengths, const void* bt, void* ws, void* out, const Shape& s,
                   cudaStream_t stream) {
  const int words = s.qpk * s.hd / 4;           // output words, THREADS / 4 a pass
#define I8_LAUNCH(NS) launch_int8<T, NS>(q, k, ks, v, vs, lengths, bt, ws, out, s, stream)
  if (words <= 32) return I8_LAUNCH(1);
  if (words <= 64) return I8_LAUNCH(2);
  if (words <= 128) return I8_LAUNCH(4);
  if (words <= 256) return I8_LAUNCH(8);
  if (words <= 512) return I8_LAUNCH(16);
  if (words <= 1024) return I8_LAUNCH(32);
#undef I8_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// int8 pools (P, KV, page, hd) with float32 scale pools (P, KV, page); q
// (B, KV, qpk, hd) and out in `dtype`; lengths (B,) and block_tables (B,
// maxp) int32; ws (B, KV, ceil(maxp / pps), qpk, hd + 2) float32 scratch.
// All contiguous, the pools and scale pools 16-byte aligned. hd a multiple
// of 16 up to 256, page a multiple of 4 (a scale slab is then whole 16-byte
// words), qpk * hd at most 4096, pps 1-32 pages a split, stages 1-4 (fewer
// where they do not fit shared memory). Returns a cudaError_t code (0 =
// launched).
int paged_decode_attention_int8_sm90(int dtype, const void* q, const void* k_pages,
                                     const void* k_scales, const void* v_pages,
                                     const void* v_scales, const void* lengths,
                                     const void* block_tables, void* ws, void* out, int B,
                                     int KV, int qpk, int hd, int page, int maxp, int window,
                                     int pps, int stages, float softcap, float scale,
                                     void* stream) {
  if (hd % 16 || hd < 16 || hd > 256 || page % 4 || page < 4 || qpk < 1 ||
      qpk * hd > 4096 || pps < 1 || pps > MAX_TPS || stages < 1 || stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  if (B * KV == 0) return (int)cudaSuccess;
  Shape s{B, KV, qpk, hd, page, maxp, maxp * page, window, pps, stages, softcap, scale};
  while (s.stages > 1 && i8_smem_bytes(qpk, hd, page, s.stages) > 227 * 1024) --s.stages;
  if (i8_smem_bytes(qpk, hd, page, s.stages) > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return launch_int8_ns<float>(q, k_pages, k_scales, v_pages, v_scales, lengths,
                                 block_tables, ws, out, s, st);
  if (dtype == DTYPE_BF16)
    return launch_int8_ns<__nv_bfloat16>(q, k_pages, k_scales, v_pages, v_scales, lengths,
                                         block_tables, ws, out, s, st);
  return (int)cudaErrorInvalidValue;
}


// q (B, KV, qpk, hd); pools (P, KV, page, hd), 16-byte aligned; lengths (B,)
// and block_tables (B, maxp) int32; ws (B, KV, ceil(maxp / pps), qpk, hd + 2)
// float32 scratch; out like q. All contiguous. hd a multiple of 8 up to 256,
// qpk * hd at most 8 * 128 16-byte words, pps 1-32 pages a split, stages 1-4
// pages in flight (fewer where they do not fit shared memory). Returns a
// cudaError_t code (0 = launched).
int paged_decode_attention_sm90(int dtype, const void* q, const void* k_pages,
                                const void* v_pages, const void* lengths,
                                const void* block_tables, void* ws, void* out, int B, int KV,
                                int qpk, int hd, int page, int maxp, int window, int pps,
                                int stages, float softcap, float scale, void* stream) {
  Source src{};
  src.k = k_pages;
  src.v = v_pages;
  src.bt = block_tables;
  const Shape s{B, KV, qpk, hd, page, maxp, maxp * page, window, pps, stages, softcap, scale};
  return launch_any<PAGED>(dtype, src, q, lengths, ws, out, s, (cudaStream_t)stream);
}

// q (B, KV, qpk, hd) contiguous; k, v (B, Smax, KV, hd) with the element
// strides sb, ss of their first two dimensions (the same for both), KV and
// hd contiguous, base and strides 16-byte aligned; lengths (B,) int32; ws
// (B, KV, ceil(ceil(Smax / tile) / tps), qpk, hd + 2) float32 scratch; out
// like q. hd a multiple of 8 up to 256, tile * hd * element size a multiple
// of 128 bytes, tile at most 256 keys, tps 1-32 tiles a split, stages 1-4.
// Returns a cudaError_t code (0 = launched).
int decode_attention_sm90(int dtype, const void* q, const void* k, const void* v,
                          const void* lengths, void* ws, void* out, int B, int Smax, int KV,
                          int qpk, int hd, int sb, int ss, int window, int tile, int tps,
                          int stages, float softcap, float scale, void* stream) {
  const int item = dtype == DTYPE_F32 ? 4 : 2;
  if (B * KV == 0) return (int)cudaSuccess;
  if (tile < 1 || tile > 256 || ((size_t)tile * hd * item) % 128 || Smax < 1)
    return (int)cudaErrorInvalidValue;
  Source src{};
  const CUtensorMapDataType type =
      dtype == DTYPE_F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!sm90::cache_map(&src.maps.k, type, item, k, B, Smax, KV, hd, sb, ss, tile) ||
      !sm90::cache_map(&src.maps.v, type, item, v, B, Smax, KV, hd, sb, ss, tile))
    return (int)cudaErrorInvalidValue;
  const Shape s{B, KV, qpk, hd, tile, (Smax + tile - 1) / tile, Smax, window, tps, stages,
                softcap, scale};
  return launch_any<DENSE>(dtype, src, q, lengths, ws, out, s, (cudaStream_t)stream);
}

}  // extern "C"
