// The paged decode attention on Hopper: each sequence's live page range
// split across blocks, its pages brought into a ring in shared memory by
// bulk copies, and the splits merged in a fixed order.
//
//   * paged_decode_split_kernel, paged_decode_merge_kernel
//       <- src/repro/kernels/decode_attn.py:280 paged_decode_attention_kernel
//          (fp body _paged_decode_kernel, :168), in float32 and bfloat16
//
// The int8 body stays the scalar kernel of decode_attn.cu.
//
// What bounds it on the card: bytes. A decode row does 2 * qpk FLOPs a K or
// V element it reads, about qpk operations a byte in bf16, far below the
// H100's ~295 Op/B knee; the least time is the live K/V bytes over 3.35 TB/s.
// To come near it the card needs enough loads in flight on every SM, and no
// block may walk a long sequence alone while the others idle.
//
// Design:
//   * The split. The grid is (B * KV, nsplit) with nsplit = ceil(maxp / PPS)
//     from the table's width alone, so the launch needs no host sync on
//     `lengths` and can be captured in a CUDA graph. A block reads
//     lengths[b] itself, takes the live pages [lo, hi) (the window's first
//     page up to the page that holds position length - 1, within the table)
//     and covers pages [lo + s PPS, min(lo + (s + 1) PPS, hi)); a block
//     whose range is empty exits at once. Every page of a live range holds a
//     valid key, so every live split has a finite max and a sum >= 1.
//   * The ring. The (page id, KV head) slab of a pool (P, KV, page, hd) is
//     one contiguous run of page * hd elements, so one cp.async.bulk brings
//     it in, completing on an mbarrier: no tensor map. Warp 0 reads the
//     split's page ids, a lane each; its lane 0 first issues `stages` pages
//     of K and V, then page j - 1 + stages once every thread is past page
//     j - 1 (with one stage, page j + 1 once every thread is past page j).
//   * The arithmetic, on the CUDA cores in float32, with one barrier a page.
//     q is scaled once into shared memory and read into registers for up to
//     QG heads a pass. A half-warp scores one key: its lanes read the key
//     row in 16-byte words and reduce with shuffles, into one of two score
//     buffers (page j in buffer j & 1, so the next page's scores never
//     overwrite scores still being read). After the barrier every thread
//     takes the page's max of its head from the shared scores itself and
//     keeps its own running max m, its keys' share of the sum l and its
//     output words of the accumulator in registers for the whole split;
//     p is gated by the mask as the reference does and rounded to the pool
//     dtype before PV (the reference's p.astype(v.dtype)), and PV reads V in
//     16-byte words. The threads of a head split its keys into groups whose
//     shares are summed in a fixed order at the split's end. Masking, the
//     softcap and the running (m, l, acc) are those of the scalar kernel
//     this replaces.
//   * The merge. Each live split writes float32 (acc, m, l) for its qpk rows
//     into a workspace (B, KV, nsplit, qpk, hd + 2). A second launch, its
//     blocks over (sequence, KV head) and 128-element runs of the qpk rows,
//     reads lengths to know how many splits are live, takes each head's max
//     M and weights over them a warp a head, and merges them in split order,
//     an output element a thread:
//     out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-37). No
//     float atomics: the result does not depend on the order blocks run in,
//     and a sequence with no live page writes exact zeros.
//
// Why no tensor cores: at qpk query heads a KV head the kernel does about
// qpk operations a byte. At OLMoE's qpk 1 no wgmma or mma.sync tile has rows
// to fill, and at qpk 4-8 the 67 TFLOP/s of the float32 CUDA cores still
// outrun 3.35 TB/s x qpk Op/B. Its times on the card are in PERF.md
// section 6.
#include "hopper.cuh"

using port::from_f;
using port::NEG_INF;
using port::round_to;
using port::to_f;
using port::unpack16;
using port::warp_max;

namespace {

constexpr int THREADS = 128;
constexpr int HALVES = THREADS / 16;   // half-warps: keys scored at once
constexpr int GQA_HEADS = 4;           // query heads a score pass holds in registers at qpk > 1
constexpr int MAX_STAGES = 4;
constexpr int MAX_PPS = 32;            // a page id a lane of warp 0

__device__ __forceinline__ bool decode_valid(int kpos, int length, int window) {
  return kpos < length && (window <= 0 || kpos > length - 1 - window);
}

// The live pages [lo, hi) of a sequence: from the page holding the window's
// first position up to the page holding position length - 1 (a length past
// the table's width attends what the table holds).
__device__ __forceinline__ void live_pages(int length, int window, int page, int maxp, int& lo,
                                           int& hi) {
  const int first = (window > 0 && length - window > 0) ? length - window : 0;
  lo = first / page;
  hi = min((length + page - 1) / page, maxp);
}

// floats of shared memory after the ring: q (qpk, hd), two buffers of page
// scores (2, qpk, page), rounded up to 16 bytes; then the key groups'
// partial accumulators (THREADS words of E floats) and sums (THREADS)
__host__ __device__ __forceinline__ int red_offset(int qpk, int hd, int page) {
  return (qpk * (hd + 2 * page) + 3) & ~3;
}

template <typename T>
__host__ __device__ __forceinline__ size_t smem_bytes(int qpk, int hd, int page, int stages) {
  return 128 + (size_t)stages * 2 * page * hd * sizeof(T) +
         ((size_t)red_offset(qpk, hd, page) + (size_t)THREADS * (16 / sizeof(T) + 1)) * 4;
}

// grid (B * KV, nsplit); q (B, KV, qpk, hd); pools (P, KV, page, hd), 16-byte
// aligned, hd a multiple of 8; ws (B, KV, nsplit, qpk, hd + 2) float32: a
// live split's unnormalised accumulator, then its running max m and sum l,
// for each query head. WPL: 16-byte words of a key row a lane scores
// (ceil(words / 16)); NW: output words a thread accumulates when the
// qpk * words output words outnumber the threads (else 1, and the threads
// split the keys into THREADS / (qpk * words) groups); QG: query heads a
// score pass holds in registers (1 at qpk 1, else 4).
template <typename T, int WPL, int NW, int QG>
__global__ void __launch_bounds__(THREADS)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages, const int* __restrict__ lengths,
                          const int* __restrict__ block_tables, float* __restrict__ ws,
                          int KV, int qpk, int hd, int page, int maxp, int window, int pps,
                          int stages, float softcap, float scale) {
  constexpr int E = 16 / sizeof(T);             // elements a 16-byte word
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[MAX_STAGES];
  __shared__ int pid_s[MAX_PPS];

  const int bg = blockIdx.x, b = bg / KV, g = bg - b * KV, split = blockIdx.y;
  const int length = lengths[b];
  int lo, hi;
  live_pages(length, window, page, maxp, lo, hi);
  const int p0 = lo + split * pps, np = min(pps, hi - p0);
  if (np <= 0) return;                          // the whole block, before any barrier

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int words = hd / E;                     // 16-byte words of a key row
  const size_t slab = (size_t)page * hd;        // elements of a (page, head) slab
  const uint32_t slab_bytes = (uint32_t)(slab * sizeof(T));
  T* ring = reinterpret_cast<T*>(smem_raw + ((128 - (sm90::smem_addr(smem_raw) & 127)) & 127));
  float* q_s = reinterpret_cast<float*>(ring + (size_t)stages * 2 * slab);   // (qpk, hd)
  float* s_s = q_s + qpk * hd;                  // (2, qpk, page) scores, page j in j & 1
  float* red_s = q_s + red_offset(qpk, hd, page);   // (groups, qpk * words, E)
  float* redl_s = red_s + THREADS * E;          // (groups, qpk)
  const uint32_t ring_a = sm90::smem_addr(ring), bar0 = sm90::smem_addr(bars);

  auto issue = [&](int j) {                     // page j of the split into its stage
    const int st = j % stages;
    const uint32_t bar = bar0 + 8 * st, dst = ring_a + st * 2 * slab_bytes;
    const size_t src = ((size_t)pid_s[j] * KV + g) * slab;
    sm90::mbar_expect_tx(bar, 2 * slab_bytes);
    sm90::bulk_load(dst, k_pages + src, slab_bytes, bar);
    sm90::bulk_load(dst + slab_bytes, v_pages + src, slab_bytes, bar);
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
  const size_t head_off = (size_t)bg * qpk * hd;
  for (int e = tid; e < qpk * hd; e += THREADS) q_s[e] = to_f(q[head_off + e]) * scale;
  __syncthreads();

  // PV: output word o = h * words + c (head h, 16-byte column c). Each thread
  // keeps the running max m and its keys' share of the sum l of its words'
  // heads: every thread of a head takes the same page max from the same
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
    const int st = j % stages, k0 = (p0 + j) * page;
    const T* k_s = ring + (size_t)st * 2 * slab;
    const T* v_s = k_s + slab;
    float* sc = s_s + (j & 1) * qpk * page;
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
      for (int t0 = 0; t0 < page; t0 += HALVES) {
        const int t = t0 + hw;
        float kf[WPL][E];
#pragma unroll
        for (int w = 0; w < WPL; ++w) {
          const int c = li + 16 * w;
          unpack16(t < page && c < words
                       ? *reinterpret_cast<const uint4*>(k_s + (size_t)t * hd + c * E)
                       : make_uint4(0, 0, 0, 0),
                   kf[w]);
        }
        const bool valid = t < page && decode_valid(k0 + t, length, window);
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
          if (li == 0 && t < page) {
            if (softcap > 0.f) d = softcap * tanhf(d / softcap);
            sc[(h0 + hh) * page + t] = valid ? d : NEG_INF;
          }
        }
      }
    }
    // the scores are in; every thread is past page j - 1, so its stage is free
    __syncthreads();
    if (stages > 1 && tid == 0 && j >= 1 && j - 1 + stages < np) issue(j - 1 + stages);

    // online softmax and PV: keys past length - 1 have p == 0 and are not read
    const int nlive = min(page, length - k0);
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if (!o_on[i]) continue;
      const float* sh = sc + o_h[i] * page;
      float mx = NEG_INF;
#pragma unroll 8
      for (int t = 0; t < page; ++t) mx = fmaxf(mx, sh[t]);
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = expf(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= alpha;
      for (int t = kg; t < nlive; t += groups) {
        // gated: a masked entry contributes exactly 0 even while m is NEG_INF
        const float p = decode_valid(k0 + t, length, window) ? expf(sh[t] - m_new) : 0.f;
        l_r[i] += p;
        float vf[E];
        unpack16(*reinterpret_cast<const uint4*>(v_s + (size_t)t * hd + o_c[i] * E), vf);
        const float pr = round_to<T>(p);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] += pr * vf[e];
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

// grid (B * KV, ceil(qpk * hd / THREADS)); the live splits of each
// (sequence, KV head) merged in split order, an output element a thread;
// out (B, KV, qpk, hd) like q. Shared memory: the weights
// e^(m_s - M) (qpk, nsplit), then l_s times them (qpk, nsplit), then the
// merged sums (qpk).
template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_merge_kernel(const float* __restrict__ ws, const int* __restrict__ lengths,
                          T* __restrict__ out, int KV, int qpk, int hd, int page, int maxp,
                          int window, int pps, int nsplit) {
  extern __shared__ float w_s[];
  float* lw_s = w_s + qpk * nsplit;
  float* den_s = lw_s + qpk * nsplit;
  const int bg = blockIdx.x, b = bg / KV, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int lo, hi;
  live_pages(lengths[b], window, page, maxp, lo, hi);
  const int nlive = hi > lo ? (hi - lo + pps - 1) / pps : 0;
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

template <typename T, int WPL, int NW, int QG>
int launch(const void* q, const void* k, const void* v, const void* lengths, const void* bt,
           void* ws, void* out, int B, int KV, int qpk, int hd, int page, int maxp, int window,
           int pps, int stages, float softcap, float scale, cudaStream_t stream) {
  const int nsplit = (maxp + pps - 1) / pps;
  if (nsplit > 0) {
    const size_t smem = smem_bytes<T>(qpk, hd, page, stages);
    cudaError_t err = port::allow_smem(paged_decode_split_kernel<T, WPL, NW, QG>, smem);
    if (err != cudaSuccess) return (int)err;
    paged_decode_split_kernel<T, WPL, NW, QG>
        <<<dim3(B * KV, nsplit), THREADS, smem, stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (const int*)lengths, (const int*)bt,
            (float*)ws, KV, qpk, hd, page, maxp, window, pps, stages, softcap, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t msmem = ((size_t)2 * qpk * nsplit + qpk) * sizeof(float);
  cudaError_t err = port::allow_smem(paged_decode_merge_kernel<T>, msmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 mgrid(B * KV, (qpk * hd + THREADS - 1) / THREADS);
  paged_decode_merge_kernel<T><<<mgrid, THREADS, msmem, stream>>>(
      (const float*)ws, (const int*)lengths, (T*)out, KV, qpk, hd, page, maxp, window, pps,
      nsplit);
  return (int)cudaGetLastError();
}

template <typename T, int WPL>
int launch_nw(int nw, const void* q, const void* k, const void* v, const void* lengths,
              const void* bt, void* ws, void* out, int B, int KV, int qpk, int hd, int page,
              int maxp, int window, int pps, int stages, float softcap, float scale,
              cudaStream_t s) {
#define PD_LAUNCH(NW, QG)                                                                   \
  launch<T, WPL, NW, QG>(q, k, v, lengths, bt, ws, out, B, KV, qpk, hd, page, maxp, window, \
                         pps, stages, softcap, scale, s)
  if (qpk == 1) return PD_LAUNCH(1, 1);
  switch (nw) {
    case 1: return PD_LAUNCH(1, GQA_HEADS);
    case 2: return PD_LAUNCH(2, GQA_HEADS);
    case 4: return PD_LAUNCH(4, GQA_HEADS);
    case 8: return PD_LAUNCH(8, GQA_HEADS);
  }
#undef PD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, const void* lengths,
                 const void* bt, void* ws, void* out, int B, int KV, int qpk, int hd, int page,
                 int maxp, int window, int pps, int stages, float softcap, float scale,
                 cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);
  const int words = hd / E, ow = qpk * words;
  const int wpl = (words + 15) / 16;
  int nw = 1;
  while (nw * THREADS < ow) nw *= 2;
  if (nw > 8) return (int)cudaErrorInvalidValue;
  // as many stages as fit one block's shared memory, at least one
  while (stages > 1 && smem_bytes<T>(qpk, hd, page, stages) > 227 * 1024) --stages;
  if (smem_bytes<T>(qpk, hd, page, stages) > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (wpl == 1)
    return launch_nw<T, 1>(nw, q, k, v, lengths, bt, ws, out, B, KV, qpk, hd, page, maxp,
                           window, pps, stages, softcap, scale, s);
  if (wpl == 2)
    return launch_nw<T, 2>(nw, q, k, v, lengths, bt, ws, out, B, KV, qpk, hd, page, maxp,
                           window, pps, stages, softcap, scale, s);
  if constexpr (E == 4)                           // float32 at head_dim past 128
    return launch_nw<T, 4>(nw, q, k, v, lengths, bt, ws, out, B, KV, qpk, hd, page, maxp,
                           window, pps, stages, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

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
  cudaStream_t s = (cudaStream_t)stream;
  if (hd % 8 || hd > 256 || hd < 8 || qpk < 1 || page < 1 || pps < 1 || pps > MAX_PPS ||
      stages < 1 || stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  if (B * KV == 0) return (int)cudaSuccess;
  if (dtype == DTYPE_F32)
    return launch_dtype<float>(q, k_pages, v_pages, lengths, block_tables, ws, out, B, KV, qpk,
                               hd, page, maxp, window, pps, stages, softcap, scale, s);
  if (dtype == DTYPE_BF16)
    return launch_dtype<__nv_bfloat16>(q, k_pages, v_pages, lengths, block_tables, ws, out, B,
                                       KV, qpk, hd, page, maxp, window, pps, stages, softcap,
                                       scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
