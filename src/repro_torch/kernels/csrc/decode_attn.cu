// Attention kernels for Hopper (sm_90a): chunked prefill reading K/V
// through per-sequence block tables, and the int8 bodies of the paged decode
// and chunked prefill.
//
// Replaces (TPU / Pallas):
//   * chunked_prefill_kernel  <- src/repro/kernels/decode_attn.py:
//                                chunked_prefill_attention_kernel (fp body
//                                _chunked_prefill_kernel), in float32 and
//                                at the shapes chunk_attn_sm90.cu does not
//                                take; bf16 at head_dim 64 or 128 and pages
//                                of 8-64 keys runs that tensor-core kernel
//   * paged_decode_int8_kernel, chunked_prefill_int8_kernel
//                             <- the int8 bodies of the same two functions
//                                (_paged_decode_kernel_int8,
//                                _chunked_prefill_kernel_int8), at the
//                                shapes the Hopper kernels do not take: the
//                                decode at pages not a multiple of 4 keys
//                                (decode_sm90.cu takes the rest), the chunk
//                                at head_dim other than 64 and 128 or pages
//                                outside 8-64 (chunk_int8_sm90.cu takes the
//                                rest)
// The float paged decode (fp body _paged_decode_kernel) and the dense-cache
// decode (decode_attention_kernel) are decode_sm90.cu.
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
#include "common.cuh"

using port::dot16;
using port::from_f;
using port::i8_scale;
using port::i8_score;
using port::NEG_INF;
using port::quant_i8;
using port::quantize_rows;
using port::round_to;
using port::to_f;

namespace {

constexpr int THREADS = 128;
constexpr int MAX_HD = 256;        // the largest head_dim the kernels take
constexpr int CHUNK_ROWS = 16;     // query rows per chunk block

__device__ __forceinline__ bool decode_valid(int kpos, int length, int window) {
  return kpos < length && (window <= 0 || kpos > length - 1 - window);
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

// ---------------------------------------------------------------------------
// int8 bodies: int8 page pools with float32 per-(token, KV head) scale pools
// (P, KV, page). Per page, exactly as the TPU kernels' int8 bodies:
//   s  = ((float(q8 . k8) * q_scale) * k_scale) * scale   (int32 dot)
//   p  = exp(s - m_new), gated by the mask
//   pv = requantize(p * v_scale) per row OVER THIS PAGE, then pv8 . v8
//   acc = acc * alpha + float(pv8 . v8) * pv_scale
// One page is one requantization step: pages are never fused or split,
// because the per-page requantization is part of the function (a per-row
// requantization over the whole context gives other values). q is
// quantized per row once per block. Products that feed a requantization
// use __fmul_rn so the compiler cannot contract them into an FMA with
// another rounding than the plain version's.
// ---------------------------------------------------------------------------

constexpr int I8_ROWS = 16;        // chunk query rows per block

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Shared memory of an int8 block of `rows` query rows: float32 acc (rows,
// hd), scores (rows, page), five per-row values, the page's K and V scales
// (page each); then int8 q (rows, hd), pv (rows, page), and `kv_pages`
// staged pages (page, hd).
__host__ __device__ inline size_t i8_float_count(int rows, int hd, int page) {
  return (size_t)rows * hd + (size_t)rows * page + 5 * (size_t)rows + 2 * (size_t)page;
}

__host__ __device__ inline size_t i8_smem_bytes(int rows, int hd, int page, int kv_pages) {
  return align16(i8_float_count(rows, hd, page) * sizeof(float)) + (size_t)rows * hd +
         align16((size_t)rows * page) + (size_t)kv_pages * page * hd;
}

struct I8Smem {
  float *acc, *p, *m, *l, *alpha, *q_sc, *pv_sc, *ks, *vs;
  int8_t *q8, *pv8, *kv;
};

__device__ inline I8Smem i8_smem(unsigned char* base, int rows, int hd, int page) {
  I8Smem s;
  s.acc = reinterpret_cast<float*>(base);
  s.p = s.acc + rows * hd;
  s.m = s.p + rows * page;
  s.l = s.m + rows;
  s.alpha = s.l + rows;
  s.q_sc = s.alpha + rows;
  s.pv_sc = s.q_sc + rows;
  s.ks = s.pv_sc + rows;
  s.vs = s.ks + page;
  s.q8 = reinterpret_cast<int8_t*>(base + align16(i8_float_count(rows, hd, page) * sizeof(float)));
  s.pv8 = s.q8 + rows * hd;
  s.kv = s.pv8 + align16((size_t)rows * page);
  return s;
}

// Online-softmax statistics and the per-page requantization of one row:
// p = exp(s - m_new) where valid (else 0) into l; pv = p * v_scale
// requantized over the page into pv8 / pv_sc (v_scale staged in s.vs). One
// thread per row.
template <typename Valid>
__device__ __forceinline__ void i8_row_stats(const I8Smem& s, int r, int page, Valid valid) {
  float* pr = s.p + r * page;
  float mx = NEG_INF;
  for (int t = 0; t < page; ++t) mx = fmaxf(mx, pr[t]);
  const float m_old = s.m[r];
  const float m_new = fmaxf(m_old, mx);
  const float alpha = expf(m_old - m_new);
  float sum = 0.f, amax = 0.f;
  for (int t = 0; t < page; ++t) {
    const float p = valid(t) ? expf(pr[t] - m_new) : 0.f;
    sum += p;
    const float pv = __fmul_rn(p, s.vs[t]);
    pr[t] = pv;
    amax = fmaxf(amax, fabsf(pv));
  }
  const float sc = i8_scale(amax);
  for (int t = 0; t < page; ++t) s.pv8[r * page + t] = quant_i8(pr[t], sc);
  s.l[r] = s.l[r] * alpha + sum;
  s.m[r] = m_new;
  s.alpha[r] = alpha;
  s.pv_sc[r] = sc;
}

// acc[r, d] = acc * alpha + float(sum_t pv8[r, t] v8[t, d]) * pv_sc over
// the first `nlive` keys of the staged V page.
__device__ __forceinline__ void i8_pv(const I8Smem& s, const int8_t* v_s, int rows, int hd,
                                      int page, int nlive) {
  for (int e = threadIdx.x; e < rows * hd; e += blockDim.x) {
    const int r = e / hd, d = e - r * hd;
    int a = 0;
    for (int t = 0; t < nlive; ++t) a += (int)s.pv8[r * page + t] * (int)v_s[t * hd + d];
    s.acc[e] = __fadd_rn(__fmul_rn(s.acc[e], s.alpha[r]), __fmul_rn((float)a, s.pv_sc[r]));
  }
}

// grid (B, KV); q (B, KV, qpk, hd); pools (P, KV, page, hd) int8; scale
// pools (P, KV, page) float32; out like q. hd / 16 lanes read one key row
// with 16-byte loads, so a warp covers 32 / (hd / 16) rows per load and the
// block a whole page of K in one wave.
template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_pages,
                         const float* __restrict__ k_scales, const int8_t* __restrict__ v_pages,
                         const float* __restrict__ v_scales, const int* __restrict__ lengths,
                         const int* __restrict__ block_tables, T* __restrict__ out, int KV,
                         int qpk, int hd, int page, int maxp, int window, float softcap,
                         float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const I8Smem s = i8_smem(smem_raw, qpk, hd, page);
  int8_t* v_s = s.kv;
  const int b = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const int length = lengths[b];
  const size_t head_off = ((size_t)b * KV + g) * qpk * hd;
  const int G = hd / 16;             // lanes per key row
  const int rpw = 32 / G;            // key rows per warp per load

  quantize_rows(q + head_off, qpk, qpk, hd, s.q8, s.q_sc);
  for (int e = tid; e < qpk * hd; e += blockDim.x) s.acc[e] = 0.f;
  if (tid < qpk) {
    s.m[tid] = NEG_INF;
    s.l[tid] = 0.f;
  }
  __syncthreads();

  int first = 0;
  if (window > 0 && length - window > 0) first = length - window;
  const int pg_lo = first / page;
  const int pg_hi = min((length + page - 1) / page, maxp);

  for (int pg = pg_lo; pg < pg_hi; ++pg) {
    const int pid = block_tables[(size_t)b * maxp + pg];
    const size_t base = ((size_t)pid * KV + g) * (size_t)page * hd;
    const int8_t* kp = k_pages + base;
    const float* ksp = k_scales + ((size_t)pid * KV + g) * page;
    const int k0 = pg * page;
    // V page and V scales to shared memory, issued with the K loads below
    for (int i = tid; i < page * hd / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(v_s)[i] = reinterpret_cast<const uint4*>(v_pages + base)[i];
    for (int t = tid; t < page; t += blockDim.x) s.vs[t] = v_scales[((size_t)pid * KV + g) * page + t];

    for (int t0 = warp * rpw; t0 < page; t0 += nwarps * rpw) {   // warp-uniform
      const int t = t0 + lane / G, w = lane % G;
      const bool row_ok = t < page;
      const uint4 kw = row_ok ? reinterpret_cast<const uint4*>(kp + (size_t)t * hd)[w]
                              : make_uint4(0u, 0u, 0u, 0u);
      const bool valid = row_ok && decode_valid(k0 + t, length, window);
      const float ks = row_ok ? ksp[t] : 0.f;
      for (int h = 0; h < qpk; ++h) {
        int part = dot16(reinterpret_cast<const uint4*>(s.q8 + h * hd)[w], kw, 0);
        for (int o = G / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        if (row_ok && w == 0)
          s.p[h * page + t] = valid ? i8_score(part, s.q_sc[h], ks, scale, softcap) : NEG_INF;
      }
    }
    __syncthreads();
    if (tid < qpk)
      i8_row_stats(s, tid, page, [&](int t) { return decode_valid(k0 + t, length, window); });
    __syncthreads();
    i8_pv(s, v_s, qpk, hd, page, min(page, length - k0));
    __syncthreads();
  }

  for (int e = tid; e < qpk * hd; e += blockDim.x)
    out[head_off + e] = from_f<T>(s.acc[e] / fmaxf(s.l[e / hd], 1e-37f));
}

// grid (B, KV, ceil(R / I8_ROWS)); q (B, KV, R, hd), heads innermost; int8
// pools and float32 scale pools as the decode kernel; out like q. K and V
// pages are staged in shared memory; a thread's dot walks the 16-byte words
// of its key row starting at word t (mod hd / 16), so the threads of one
// load phase hit different banks.
template <typename T>
__global__ void __launch_bounds__(THREADS)
chunked_prefill_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_pages,
                            const float* __restrict__ k_scales,
                            const int8_t* __restrict__ v_pages,
                            const float* __restrict__ v_scales, const int* __restrict__ totals,
                            const int* __restrict__ starts,
                            const int* __restrict__ block_tables, T* __restrict__ out, int KV,
                            int R, int qpk, int hd, int page, int maxp, float softcap,
                            float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const I8Smem s = i8_smem(smem_raw, I8_ROWS, hd, page);
  int8_t* k_s = s.kv;
  int8_t* v_s = s.kv + page * hd;
  const int b = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int r0 = blockIdx.z * I8_ROWS;
  const int nrows = min(I8_ROWS, R - r0);
  const int total = totals[b];
  const int start = starts[b];
  const size_t row_off = (((size_t)b * KV + g) * R + r0) * hd;
  const int W = hd / 16;             // 16-byte words per row

  quantize_rows(q + row_off, nrows, I8_ROWS, hd, s.q8, s.q_sc);
  for (int e = tid; e < I8_ROWS * hd; e += blockDim.x) s.acc[e] = 0.f;
  if (tid < I8_ROWS) {
    s.m[tid] = NEG_INF;
    s.l[tid] = 0.f;
  }
  __syncthreads();

  const int qmax = start + (r0 + nrows - 1) / qpk;
  const int kend = min(total, qmax + 1);
  const int pg_hi = kend > 0 ? min((kend + page - 1) / page, maxp) : 0;

  for (int pg = 0; pg < pg_hi; ++pg) {
    const int pid = block_tables[(size_t)b * maxp + pg];
    const size_t base = ((size_t)pid * KV + g) * (size_t)page * hd;
    for (int i = tid; i < page * W; i += blockDim.x) {
      reinterpret_cast<uint4*>(k_s)[i] = reinterpret_cast<const uint4*>(k_pages + base)[i];
      reinterpret_cast<uint4*>(v_s)[i] = reinterpret_cast<const uint4*>(v_pages + base)[i];
    }
    for (int t = tid; t < page; t += blockDim.x) {
      s.ks[t] = k_scales[((size_t)pid * KV + g) * page + t];
      s.vs[t] = v_scales[((size_t)pid * KV + g) * page + t];
    }
    __syncthreads();

    const int k0 = pg * page;
    for (int pr = tid; pr < I8_ROWS * page; pr += blockDim.x) {
      const int r = pr / page, t = pr - r * page;
      const uint4* qr = reinterpret_cast<const uint4*>(s.q8 + r * hd);
      const uint4* kr = reinterpret_cast<const uint4*>(k_s + t * hd);
      int dot = 0;
      for (int i = 0; i < W; ++i) {
        const int w = (i + t) % W;
        dot = dot16(qr[w], kr[w], dot);
      }
      const int qpos = start + (r0 + r) / qpk;
      const bool valid = r < nrows && chunk_valid(k0 + t, qpos, total);
      s.p[pr] = valid ? i8_score(dot, s.q_sc[r], s.ks[t], scale, softcap) : NEG_INF;
    }
    __syncthreads();
    if (tid < I8_ROWS) {
      const int r = tid;
      const int qpos = start + (r0 + r) / qpk;
      // p is gated by the mask: a padded row, or a row before every key of
      // this page, adds exactly 0
      i8_row_stats(s, r, page,
                   [&](int t) { return r < nrows && chunk_valid(k0 + t, qpos, total); });
    }
    __syncthreads();
    i8_pv(s, v_s, I8_ROWS, hd, page, page);
    __syncthreads();
  }

  for (int e = tid; e < nrows * hd; e += blockDim.x)
    out[row_off + e] = from_f<T>(s.acc[e] / fmaxf(s.l[e / hd], 1e-37f));
}

inline bool i8_shape_ok(int hd, int page) {
  // hd / 16 lanes per key row must divide a warp; 16-byte rows
  return hd >= 16 && hd <= MAX_HD && hd % 16 == 0 && (32 % (hd / 16)) == 0 && page > 0;
}

template <typename T>
int launch_decode_int8(const void* q, const void* k, const void* ks, const void* v,
                       const void* vs, const void* lengths, const void* bt, void* out, int B,
                       int KV, int qpk, int hd, int page, int maxp, int window, float softcap,
                       float scale, cudaStream_t stream) {
  if (!i8_shape_ok(hd, page)) return (int)cudaErrorInvalidValue;
  const size_t smem = i8_smem_bytes(qpk, hd, page, 1);
  cudaError_t err = port::allow_smem(paged_decode_int8_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_int8_kernel<T><<<dim3(B, KV), THREADS, smem, stream>>>(
      (const T*)q, (const int8_t*)k, (const float*)ks, (const int8_t*)v, (const float*)vs,
      (const int*)lengths, (const int*)bt, (T*)out, KV, qpk, hd, page, maxp, window, softcap,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chunk_int8(const void* q, const void* k, const void* ks, const void* v,
                      const void* vs, const void* totals, const void* starts, const void* bt,
                      void* out, int B, int KV, int R, int qpk, int hd, int page, int maxp,
                      float softcap, float scale, cudaStream_t stream) {
  if (!i8_shape_ok(hd, page)) return (int)cudaErrorInvalidValue;
  const size_t smem = i8_smem_bytes(I8_ROWS, hd, page, 2);
  cudaError_t err = port::allow_smem(chunked_prefill_int8_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, KV, (R + I8_ROWS - 1) / I8_ROWS);
  chunked_prefill_int8_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const int8_t*)k, (const float*)ks, (const int8_t*)v, (const float*)vs,
      (const int*)totals, (const int*)starts, (const int*)bt, (T*)out, KV, R, qpk, hd, page,
      maxp, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = launched).
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

// int8 pools (P, KV, page, hd) with float32 scale pools (P, KV, page); q and
// out in `dtype`. hd a multiple of 16 with hd / 16 dividing 32, pools
// 16-byte aligned. Returns a cudaError_t code (0 = launched).
int paged_decode_attention_int8(int dtype, const void* q, const void* k_pages,
                                const void* k_scales, const void* v_pages,
                                const void* v_scales, const void* lengths,
                                const void* block_tables, void* out, int B, int KV, int qpk,
                                int hd, int page, int maxp, int window, float softcap,
                                float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return launch_decode_int8<float>(q, k_pages, k_scales, v_pages, v_scales, lengths,
                                     block_tables, out, B, KV, qpk, hd, page, maxp, window,
                                     softcap, scale, s);
  if (dtype == DTYPE_BF16)
    return launch_decode_int8<__nv_bfloat16>(q, k_pages, k_scales, v_pages, v_scales, lengths,
                                             block_tables, out, B, KV, qpk, hd, page, maxp,
                                             window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}

int chunked_prefill_attention_int8(int dtype, const void* q, const void* k_pages,
                                   const void* k_scales, const void* v_pages,
                                   const void* v_scales, const void* totals, const void* starts,
                                   const void* block_tables, void* out, int B, int KV, int R,
                                   int qpk, int hd, int page, int maxp, float softcap,
                                   float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return launch_chunk_int8<float>(q, k_pages, k_scales, v_pages, v_scales, totals, starts,
                                    block_tables, out, B, KV, R, qpk, hd, page, maxp, softcap,
                                    scale, s);
  if (dtype == DTYPE_BF16)
    return launch_chunk_int8<__nv_bfloat16>(q, k_pages, k_scales, v_pages, v_scales, totals,
                                            starts, block_tables, out, B, KV, R, qpk, hd, page,
                                            maxp, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
