// Paged attention kernels for Hopper (sm_90a): single-token decode and
// chunked prefill, both reading K/V through per-sequence block tables.
//
// Replaces (TPU / Pallas):
//   * paged_decode_kernel     <- src/repro/kernels/decode_attn.py:
//                                paged_decode_attention_kernel (fp body
//                                _paged_decode_kernel)
//   * chunked_prefill_kernel  <- src/repro/kernels/decode_attn.py:
//                                chunked_prefill_attention_kernel (fp body
//                                _chunked_prefill_kernel)
//
// What bounds them on the card: bytes. A decode row does 2*qpk FLOPs per K/V
// element it reads (about qpk Op/B in bf16), far below the H100's ~295 Op/B
// knee; a 64-token chunk reads its prefix once per (sequence, KV head, row
// tile) and is still bandwidth-bound at these widths.
//
// What the design does about it: the TPU kernel elides DMAs of dead pages by
// clamping its scalar-prefetch index map to a resident page. Here each block
// reads `lengths` / `totals` and `block_tables` itself on the device and
// loops only over live pages (decode: the window's first page up to
// ceil(len/page); chunk: up to the tile's causal bound), so dead pages cost
// neither bytes nor a host sync. Each page is read once per block. Scores
// and the online softmax (running max m, sum l, accumulator) stay in shared
// memory in float32; p is rounded to the pool dtype before PV as the TPU
// kernel does. Blocks run one per (sequence, KV head[, row tile]), no
// cross-block reduction, so results do not depend on scheduling order.
// Later work: split-K over pages with a log-sum-exp merge, and wgmma tiles.
#include "common.cuh"

using port::from_f;
using port::NEG_INF;
using port::round_to;
using port::to_f;
using port::warp_sum;

namespace {

constexpr int THREADS = 128;
constexpr int MAX_HD = 256;        // 8 key elements per lane
constexpr int CHUNK_ROWS = 16;     // query rows per chunk block

__device__ __forceinline__ bool decode_valid(int kpos, int length, int window) {
  return kpos < length && (window <= 0 || kpos > length - 1 - window);
}

// grid (B, KV); q (B, KV, qpk, hd); pools (P, KV, page, hd); out like q.
template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ lengths,
                    const int* __restrict__ block_tables, T* __restrict__ out,
                    int KV, int qpk, int hd, int page, int maxp, int window,
                    float softcap, float scale) {
  extern __shared__ float smem[];
  const int rows = qpk * hd;
  float* q_s = smem;                 // (qpk, hd)
  float* acc = q_s + rows;           // (qpk, hd)
  float* p_s = acc + rows;           // (qpk, page) scores, then probabilities
  float* m_s = p_s + qpk * page;     // (qpk,) running max
  float* l_s = m_s + qpk;            // (qpk,) running sum
  float* a_s = l_s + qpk;            // (qpk,) rescale factor of this page

  const int b = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const int length = lengths[b];
  const size_t head_off = ((size_t)b * KV + g) * rows;

  for (int e = tid; e < rows; e += blockDim.x) {
    q_s[e] = to_f(q[head_off + e]);
    acc[e] = 0.f;
  }
  if (tid < qpk) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  // live pages only: from the page holding the window's first position up
  // to the page holding position length-1
  int first = 0;
  if (window > 0 && length - window > 0) first = length - window;
  // (a length past the table width attends what the table holds)
  const int pg_lo = first / page;
  const int pg_hi = min((length + page - 1) / page, maxp);

  for (int pg = pg_lo; pg < pg_hi; ++pg) {
    const int pid = block_tables[(size_t)b * maxp + pg];
    const size_t base = ((size_t)pid * KV + g) * (size_t)page * hd;
    const T* kp = k_pages + base;
    const T* vp = v_pages + base;
    const int k0 = pg * page;

    // scores: one warp per key row, lanes across hd
    for (int t = warp; t < page; t += nwarps) {
      float kr[MAX_HD / 32];
#pragma unroll
      for (int i = 0; i < MAX_HD / 32; ++i) {
        const int c = lane + 32 * i;
        kr[i] = c < hd ? to_f(kp[(size_t)t * hd + c]) : 0.f;
      }
      const bool valid = decode_valid(k0 + t, length, window);
      for (int h = 0; h < qpk; ++h) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < MAX_HD / 32; ++i) {
          const int c = lane + 32 * i;
          if (c < hd) part += q_s[h * hd + c] * kr[i];
        }
        part = warp_sum(part);
        if (lane == 0) {
          float s = part * scale;
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          p_s[h * page + t] = valid ? s : NEG_INF;
        }
      }
    }
    __syncthreads();

    // online-softmax statistics, one thread per query head
    if (tid < qpk) {
      const int h = tid;
      float mx = NEG_INF;
      for (int t = 0; t < page; ++t) mx = fmaxf(mx, p_s[h * page + t]);
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        // gated: a masked entry contributes exactly 0 even while m is NEG_INF
        const float p = decode_valid(k0 + t, length, window)
                            ? expf(p_s[h * page + t] - m_new) : 0.f;
        p_s[h * page + t] = p;
        sum += p;
      }
      l_s[h] = l_s[h] * alpha + sum;
      m_s[h] = m_new;
      a_s[h] = alpha;
    }
    __syncthreads();

    // PV: entries past length-1 have p == 0 and are not read
    const int nlive = min(page, length - k0);
    for (int e = tid; e < rows; e += blockDim.x) {
      const int h = e / hd, d = e - h * hd;
      float a = acc[e] * a_s[h];
      for (int t = 0; t < nlive; ++t)
        a += round_to<T>(p_s[h * page + t]) * to_f(vp[(size_t)t * hd + d]);
      acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < rows; e += blockDim.x) {
    const int h = e / hd;
    out[head_off + e] = from_f<T>(acc[e] / fmaxf(l_s[h], 1e-37f));
  }
}

__device__ __forceinline__ bool chunk_valid(int kpos, int qpos, int total) {
  return kpos <= qpos && kpos < total;
}

// grid (B, KV, ceil(R / CHUNK_ROWS)); q (B, KV, R, hd) with R = Sc*qpk and
// heads innermost (row r is chunk position start + r/qpk); out like q.
template <typename T>
__global__ void __launch_bounds__(THREADS)
chunked_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages, const int* __restrict__ totals,
                       const int* __restrict__ starts, const int* __restrict__ block_tables,
                       T* __restrict__ out, int KV, int R, int qpk, int hd, int page,
                       int maxp, float softcap, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                          // (ROWS, hd)
  float* acc = q_s + CHUNK_ROWS * hd;         // (ROWS, hd)
  float* p_s = acc + CHUNK_ROWS * hd;         // (ROWS, page)
  float* m_s = p_s + CHUNK_ROWS * page;       // (ROWS,)
  float* l_s = m_s + CHUNK_ROWS;              // (ROWS,)
  float* a_s = l_s + CHUNK_ROWS;              // (ROWS,)
  T* k_s = reinterpret_cast<T*>(a_s + CHUNK_ROWS);   // (page, hd)
  T* v_s = k_s + (size_t)page * hd;                   // (page, hd)

  const int b = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int r0 = blockIdx.z * CHUNK_ROWS;
  const int nrows = min(CHUNK_ROWS, R - r0);
  const int total = totals[b];
  const int start = starts[b];
  const size_t row_off = (((size_t)b * KV + g) * R + r0) * hd;

  for (int e = tid; e < CHUNK_ROWS * hd; e += blockDim.x) {
    const int r = e / hd;
    q_s[e] = r < nrows ? to_f(q[row_off + e]) : 0.f;
    acc[e] = 0.f;
  }
  if (tid < CHUNK_ROWS) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  // causal bound of the tile: its last row attends kpos <= qmax
  const int qmax = start + (r0 + nrows - 1) / qpk;
  const int kend = min(total, qmax + 1);
  const int pg_hi = kend > 0 ? min((kend + page - 1) / page, maxp) : 0;

  for (int pg = 0; pg < pg_hi; ++pg) {
    const int pid = block_tables[(size_t)b * maxp + pg];
    const size_t base = ((size_t)pid * KV + g) * (size_t)page * hd;
    for (int e = tid; e < page * hd; e += blockDim.x) {
      k_s[e] = k_pages[base + e];
      v_s[e] = v_pages[base + e];
    }
    __syncthreads();

    const int k0 = pg * page;
    for (int pr = tid; pr < CHUNK_ROWS * page; pr += blockDim.x) {
      const int r = pr / page, t = pr - r * page;
      const int qpos = start + (r0 + r) / qpk;
      float s = 0.f;
      for (int i = 0; i < hd; ++i) s += q_s[r * hd + i] * to_f(k_s[t * hd + i]);
      s *= scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      p_s[pr] = (r < nrows && chunk_valid(k0 + t, qpos, total)) ? s : NEG_INF;
    }
    __syncthreads();

    if (tid < CHUNK_ROWS) {
      const int r = tid;
      const int qpos = start + (r0 + r) / qpk;
      float mx = NEG_INF;
      for (int t = 0; t < page; ++t) mx = fmaxf(mx, p_s[r * page + t]);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        // p is gated by the mask: a row with nothing valid in this page
        // (chunk padding, or a position before every key here) adds 0
        const float p = (r < nrows && chunk_valid(k0 + t, qpos, total))
                            ? expf(p_s[r * page + t] - m_new) : 0.f;
        p_s[r * page + t] = p;
        sum += p;
      }
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();

    for (int e = tid; e < CHUNK_ROWS * hd; e += blockDim.x) {
      const int r = e / hd, d = e - r * hd;
      float a = acc[e] * a_s[r];
      for (int t = 0; t < page; ++t)
        a += round_to<T>(p_s[r * page + t]) * to_f(v_s[t * hd + d]);
      acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < nrows * hd; e += blockDim.x) {
    const int r = e / hd;
    out[row_off + e] = from_f<T>(acc[e] / fmaxf(l_s[r], 1e-37f));
  }
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v, const void* lengths,
                  const void* bt, void* out, int B, int KV, int qpk, int hd, int page,
                  int maxp, int window, float softcap, float scale, cudaStream_t stream) {
  if (hd > MAX_HD) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * qpk * hd + qpk * page + 3 * qpk) * sizeof(float);
  cudaError_t err = port::allow_smem(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<T><<<dim3(B, KV), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)lengths, (const int*)bt, (T*)out,
      KV, qpk, hd, page, maxp, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chunk(const void* q, const void* k, const void* v, const void* totals,
                 const void* starts, const void* bt, void* out, int B, int KV, int R,
                 int qpk, int hd, int page, int maxp, float softcap, float scale,
                 cudaStream_t stream) {
  const size_t smem = (size_t)(2 * CHUNK_ROWS * hd + CHUNK_ROWS * page + 3 * CHUNK_ROWS)
                          * sizeof(float)
                      + (size_t)2 * page * hd * sizeof(T);
  cudaError_t err = port::allow_smem(chunked_prefill_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, KV, (R + CHUNK_ROWS - 1) / CHUNK_ROWS);
  chunked_prefill_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)totals, (const int*)starts,
      (const int*)bt, (T*)out, KV, R, qpk, hd, page, maxp, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = launched).
int paged_decode_attention(int dtype, const void* q, const void* k_pages,
                           const void* v_pages, const void* lengths,
                           const void* block_tables, void* out, int B, int KV, int qpk,
                           int hd, int page, int maxp, int window, float softcap,
                           float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return launch_decode<float>(q, k_pages, v_pages, lengths, block_tables, out, B, KV,
                                qpk, hd, page, maxp, window, softcap, scale, s);
  if (dtype == DTYPE_BF16)
    return launch_decode<__nv_bfloat16>(q, k_pages, v_pages, lengths, block_tables, out,
                                        B, KV, qpk, hd, page, maxp, window, softcap,
                                        scale, s);
  return (int)cudaErrorInvalidValue;
}

int chunked_prefill_attention(int dtype, const void* q, const void* k_pages,
                              const void* v_pages, const void* totals, const void* starts,
                              const void* block_tables, void* out, int B, int KV, int R,
                              int qpk, int hd, int page, int maxp, float softcap,
                              float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return launch_chunk<float>(q, k_pages, v_pages, totals, starts, block_tables, out, B,
                               KV, R, qpk, hd, page, maxp, softcap, scale, s);
  if (dtype == DTYPE_BF16)
    return launch_chunk<__nv_bfloat16>(q, k_pages, v_pages, totals, starts, block_tables,
                                       out, B, KV, R, qpk, hd, page, maxp, softcap,
                                       scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
