// Flash attention for the training path in float32: the forward with its
// row log-sum-exp, and the backward that recomputes the scores from it.
// bfloat16 runs the tensor-core kernels of flash_fwd_sm90.cu and
// flash_bwd_sm90.cu (a TF32 product would leave the float32 band, so
// float32 stays on scalar FMAs).
//
//   * flash_fwd_kernel        <- src/repro/kernels/flash_attn.py:
//                                flash_attention_kernel (body _flash_kernel),
//                                which is the forward of _flash_core, in float32
//   * flash_bwd_delta_kernel, flash_bwd_dkdv_kernel, flash_bwd_dq_kernel
//                             <- src/repro/models/attention.py: _flash_core_bwd
//                                (the custom VJP's backward; the JAX package
//                                runs it through XLA, with no Pallas kernel),
//                                in float32
//
// What bounds them on the card: operations. A (q tile, k tile) pair does
// 4*hd FLOPs per score (QK^T and PV; the backward 3.5x that) on data that
// stays in shared memory, far above the H100's ~295 Op/B knee.
//
// What the design does about it, kept simple: scalar float32 FMAs from
// shared memory, 256 threads as a 16 x 16 grid, each thread a 4 x (n/16)
// block of a 64-row tile product. Tiles are staged in shared memory as
// float32 rows padded by one word, so the row-wise and column-wise reads of
// the products fall in distinct banks. Every block bounds its key (or
// query) loop on the device from the causal and window edges, the Hopper
// form of the TPU body's pl.when block skip, so a causal layer does about
// half the tiles. The model layout (B, S, H, hd) / (B, S, KV, hd) is read
// in place through its strides (the reference's wrapper transposes and
// pads). GQA: a forward block holds one q tile's rows for all qpk heads of
// a KV head (row r = position q0 + r / qpk, head g*qpk + r % qpk), so each
// K/V tile is loaded once per group; the dK/dV block loops over the
// group's heads itself, so the GQA sum stays inside the block.
//
// Numerics follow the reference: float32 scores, scale, then softcap
// (softcap * tanh(s / softcap)), the masks kpos < S, qpos >= kpos (causal)
// and kpos > qpos - window, online softmax with float32 m, l and
// accumulator, out = acc / max(l, 1e-37), lse = m + log(l) (0 where
// l == 0). p is gated by the mask (the reference's is not; its final
// result is the gated one, since a row's last tile always holds a live
// key). With score_bf16 the forward runs the reference's bf16 score chain
// (the rounding points of flash_fwd_sm90.cu's CHAIN, with expf). Backward:
// D = rowsum(dO * O) from the forward's output, p = exp(s - lse), dV = p^T
// dO, dP = dO V^T, dS = p (dP - D) (times 1 - t^2 under softcap, zero
// outside the mask), dQ = dS K * scale, dK = dS^T Q * scale.
// No float atomics: dK/dV blocks own their key rows, dQ blocks their query
// rows, so the gradients are the same from run to run.
#include "common.cuh"

using port::from_f;
using port::NEG_INF;
using port::round_to;
using port::to_f;
using port::warp_sum;

namespace {

constexpr int THREADS = 256;   // a 16 x 16 grid: ty = tid / 16, tx = tid % 16
constexpr int TM = 64;         // rows of a block's own tile (queries, or keys for dK/dV)
constexpr int TK = 64;         // keys per step of the forward and dQ loops
constexpr int TQB = 32;        // query rows per step of the dK/dV loop

// acc[i][j] += sum_k A[(ty + 16 i) * sam + k * sak] * B[k * sbk + (tx + 16 j) * sbn]
template <int MI, int NJ>
__device__ __forceinline__ void tile_fma(float (&acc)[MI][NJ], const float* A, int sam,
                                         int sak, const float* B, int sbk, int sbn, int K,
                                         int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[MI], b[NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i) a[i] = A[(ty + 16 * i) * sam + k * sak];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = B[k * sbk + (tx + 16 * j) * sbn];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Reductions over the 16 threads of one row (a half warp).
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  // every lane of the row takes the first lane's sum, so the row's threads
  // agree bit for bit
  return __shfl_sync(0xffffffffu, v, threadIdx.x & 16);
}

// Rows [0, rows) of hd elements into dst (rows, ld) as float32; row r comes
// from src + off(r), or is zero where off(r) < 0.
template <typename T, typename Off>
__device__ __forceinline__ void stage(float* dst, int ld, int rows, int hd, const T* src,
                                      Off off) {
  for (int e = threadIdx.x; e < rows * hd; e += THREADS) {
    const int r = e / hd, c = e - r * hd;
    const long long o = off(r);
    dst[r * ld + c] = o >= 0 ? to_f(src[o + c]) : 0.f;
  }
}

__device__ __forceinline__ bool live(int qpos, int kpos, int causal, int window) {
  return (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

// x rounded to bf16 and back: a rounding point of the bf16 score chain
__device__ __forceinline__ float bf16r(float x) { return round_to<__nv_bfloat16>(x); }

// The scaled, softcapped score of the bf16 score chain: the product, times
// bf16(scale), s / softcap, its tanh and softcap times that, each rounded.
__device__ __forceinline__ float score_chain(float dot, float scale, float softcap) {
  float s = bf16r(bf16r(dot) * bf16r(scale));
  if (softcap > 0.f) s = bf16r(softcap * bf16r(tanhf(bf16r(s / softcap))));
  return s;
}

// The scaled, softcapped score; t = tanh(s / softcap) for the backward.
__device__ __forceinline__ float score(float dot, float scale, float softcap, float& t) {
  const float s = dot * scale;
  if (softcap > 0.f) {
    t = tanhf(s / softcap);
    return softcap * t;
  }
  t = 0.f;
  return s;
}

// ---------------------------------------------------------------------------
// Forward. grid (ceil(S / bq), KV, B); bq = TM / qpk query positions per
// block, R = bq * qpk <= TM rows. q (B, S, H, hd) with strides (qsb, qss);
// k, v (B, S, KV, hd) with strides (ksb, kss); out (B, S, H, hd) and lse
// (B, H, S) float32 contiguous; score_bf16 1: the bf16 score chain.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int S, int H, int qpk, int bq,
                 int qsb, int qss, int ksb, int kss, int causal, int window, int score_bf16,
                 float softcap, float scale) {
  constexpr int LD = HD + 1, LP = TK + 1, NJ = HD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;              // (TM, LD)
  float* k_s = q_s + TM * LD;     // (TK, LD)
  float* v_s = k_s + TK * LD;     // (TK, LD)
  float* p_s = v_s + TK * LD;     // (TM, LP) probabilities, rounded to T

  const int qt = gridDim.x - 1 - blockIdx.x;     // the longest causal tiles first
  const int g = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = qt * bq;
  const int nq = min(bq, S - q0);
  const int R = nq * qpk;

  stage(q_s, LD, TM, HD, q, [&](int r) -> long long {
    if (r >= R) return -1;
    return (long long)b * qsb + (long long)(q0 + r / qpk) * qss
           + (long long)(g * qpk + r % qpk) * HD;
  });

  float m_r[4], l_r[4], acc[4][NJ];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = ty + 16 * i < R ? q0 + (ty + 16 * i) / qpk : -1;   // -1: a padding row
    m_r[i] = NEG_INF;
    l_r[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // keys any row of the tile can see
  const int k_hi = causal ? min(S, q0 + nq) : S;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int t0 = k_lo; t0 < k_hi; t0 += TK) {
    const int n = min(TK, k_hi - t0);
    __syncthreads();              // the previous step's readers of k_s/v_s/p_s are done
    const auto kv_off = [&](int r) -> long long {
      return r < n ? (long long)b * ksb + (long long)(t0 + r) * kss + (long long)g * HD : -1;
    };
    stage(k_s, LD, TK, HD, k, kv_off);
    stage(v_s, LD, TK, HD, v, kv_off);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_fma<4, 4>(s, q_s, LD, 1, k_s, 1, LD, HD, ty, tx);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float t;
        const float x = score_bf16 ? score_chain(s[i][j], scale, softcap)
                                   : score(s[i][j], scale, softcap, t);
        ok[j] = qpos[i] >= 0 && c < n && live(qpos[i], t0 + c, causal, window);
        s[i][j] = ok[j] ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = expf(m_r[i] - m_new);
      const float mb = score_bf16 ? bf16r(m_new) : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = ok[j] ? expf(score_bf16 ? bf16r(s[i][j] - mb) : s[i][j] - m_new) : 0.f;
        if (score_bf16) p = bf16r(p);
        sum += p;
        p_s[(ty + 16 * i) * LP + tx + 16 * j] = round_to<T>(p);
      }
      sum = row_sum(sum);
      l_r[i] = l_r[i] * alpha + sum;
      m_r[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_fma<4, NJ>(acc, p_s, LP, 1, v_s, LD, 1, n, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qpos[i] < 0) continue;
    const int r = ty + 16 * i, h = g * qpk + r % qpk;
    const size_t o = (((size_t)b * S + qpos[i]) * H + h) * HD;
    const float den = fmaxf(l_r[i], 1e-37f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[o + tx + 16 * j] = from_f<T>(acc[i][j] / den);
    if (tx == 0)
      lse[((size_t)b * H + h) * S + qpos[i]] = l_r[i] > 0.f ? m_r[i] + logf(l_r[i]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Backward pass 1: D[b, h, s] = sum_c dO[b, s, h, c] * O[b, s, h, c]; one
// warp per (b, s, h) row of the contiguous (B, S, H, hd) float32 out and
// dout.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const float* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int S, int H, int hd) {
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;                       // whole warps leave together
  const size_t off = (size_t)row * hd;
  float acc = 0.f;
  for (int c = lane; c < hd; c += 32) acc += to_f(dout[off + c]) * o[off + c];
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = row % H, s = (row / H) % S, b = row / (H * S);
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// Backward pass 2: dK, dV. grid (ceil(S / TM), KV, B); a block owns TM keys
// of one KV head and walks the query positions that can see them, in steps
// of TQB, for each of the group's qpk heads. dout (B, S, H, hd) contiguous;
// lse, delta (B, H, S); dk, dv (B, S, KV, hd) contiguous.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KV, int qpk,
                      int qsb, int qss, int ksb, int kss, int causal, int window,
                      float softcap, float scale) {
  constexpr int LD = HD + 1, LP = TQB + 1, NJ = HD / 16;
  extern __shared__ float smem[];
  float* k_s = smem;               // (TM, LD)
  float* v_s = k_s + TM * LD;      // (TM, LD)
  float* q_s = v_s + TM * LD;      // (TQB, LD)
  float* do_s = q_s + TQB * LD;    // (TQB, LD)
  float* p_s = do_s + TQB * LD;    // (TM, LP) p transposed: [key][query row]
  float* ds_s = p_s + TM * LP;     // (TM, LP) dS transposed
  float* lse_s = ds_s + TM * LP;   // (TQB,)
  float* d_s = lse_s + TQB;        // (TQB,)

  const int g = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = blockIdx.x * TM;
  const int nk = min(TM, S - k0);
  const auto kv_off = [&](int r) -> long long {
    return r < nk ? (long long)b * ksb + (long long)(k0 + r) * kss + (long long)g * HD : -1;
  };
  stage(k_s, LD, TM, HD, k, kv_off);
  stage(v_s, LD, TM, HD, v, kv_off);

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // query positions that see a key of this tile
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, k0 + nk - 1 + window) : S;
  for (int hh = 0; hh < qpk; ++hh) {
    const int h = g * qpk + hh;
    for (int p0 = q_lo; p0 < q_hi; p0 += TQB) {
      const int nq = min(TQB, q_hi - p0);
      __syncthreads();             // the previous step's readers are done
      stage(q_s, LD, TQB, HD, q, [&](int r) -> long long {
        return r < nq ? (long long)b * qsb + (long long)(p0 + r) * qss + (long long)h * HD
                      : -1;
      });
      stage(do_s, LD, TQB, HD, dout, [&](int r) -> long long {
        return r < nq ? (((long long)b * S + p0 + r) * H + h) * HD : -1;
      });
      if (threadIdx.x < TQB) {
        const int r = threadIdx.x;
        const size_t o = ((size_t)b * H + h) * S + p0 + r;
        lse_s[r] = r < nq ? lse[o] : 0.f;
        d_s[r] = r < nq ? delta[o] : 0.f;
      }
      __syncthreads();

      float s[4][2], dp[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
      tile_fma<4, 2>(s, k_s, LD, 1, q_s, 1, LD, HD, ty, tx);     // [key][query] = K Q^T
      tile_fma<4, 2>(dp, v_s, LD, 1, do_s, 1, LD, HD, ty, tx);   // [key][query] = V dO^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = tx + 16 * j;
          const bool ok = kr < nk && r < nq && live(p0 + r, k0 + kr, causal, window);
          float t;
          const float x = score(s[i][j], scale, softcap, t);
          const float p = ok ? expf(x - lse_s[r]) : 0.f;
          float ds = p * (dp[i][j] - d_s[r]);
          if (softcap > 0.f) ds *= 1.f - t * t;
          p_s[kr * LP + r] = p;
          ds_s[kr * LP + r] = ok ? ds : 0.f;
        }
      }
      __syncthreads();
      tile_fma<4, NJ>(dv_acc, p_s, LP, 1, do_s, LD, 1, nq, ty, tx);
      tile_fma<4, NJ>(dk_acc, ds_s, LP, 1, q_s, LD, 1, nq, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = ty + 16 * i;
    if (kr >= nk) continue;
    const size_t o = (((size_t)b * S + k0 + kr) * KV + g) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[o + tx + 16 * j] = from_f<T>(dk_acc[i][j] * scale);
      dv[o + tx + 16 * j] = from_f<T>(dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward pass 3: dQ. grid (ceil(S / TM), H, B); a block owns TM query
// positions of one head and walks the keys they can see. dq (B, S, H, hd)
// contiguous.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S, int H,
                    int qpk, int qsb, int qss, int ksb, int kss, int causal, int window,
                    float softcap, float scale) {
  constexpr int LD = HD + 1, LP = TK + 1, NJ = HD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;               // (TM, LD)
  float* do_s = q_s + TM * LD;     // (TM, LD)
  float* k_s = do_s + TM * LD;     // (TK, LD)
  float* v_s = k_s + TK * LD;      // (TK, LD)
  float* ds_s = v_s + TK * LD;     // (TM, LP)
  float* lse_s = ds_s + TM * LP;   // (TM,)
  float* d_s = lse_s + TM;         // (TM,)

  const int qt = gridDim.x - 1 - blockIdx.x;     // the longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, g = h / qpk;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = qt * TM;
  const int nq = min(TM, S - q0);
  stage(q_s, LD, TM, HD, q, [&](int r) -> long long {
    return r < nq ? (long long)b * qsb + (long long)(q0 + r) * qss + (long long)h * HD : -1;
  });
  stage(do_s, LD, TM, HD, dout, [&](int r) -> long long {
    return r < nq ? (((long long)b * S + q0 + r) * H + h) * HD : -1;
  });
  if (threadIdx.x < TM) {
    const int r = threadIdx.x;
    const size_t o = ((size_t)b * H + h) * S + q0 + r;
    lse_s[r] = r < nq ? lse[o] : 0.f;
    d_s[r] = r < nq ? delta[o] : 0.f;
  }

  float dq_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq_acc[i][j] = 0.f;

  const int k_hi = causal ? min(S, q0 + nq) : S;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int t0 = k_lo; t0 < k_hi; t0 += TK) {
    const int n = min(TK, k_hi - t0);
    __syncthreads();
    const auto kv_off = [&](int r) -> long long {
      return r < n ? (long long)b * ksb + (long long)(t0 + r) * kss + (long long)g * HD : -1;
    };
    stage(k_s, LD, TK, HD, k, kv_off);
    stage(v_s, LD, TK, HD, v, kv_off);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_fma<4, 4>(s, q_s, LD, 1, k_s, 1, LD, HD, ty, tx);      // [query][key] = Q K^T
    tile_fma<4, 4>(dp, do_s, LD, 1, v_s, 1, LD, HD, ty, tx);    // [query][key] = dO V^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = r < nq && c < n && live(q0 + r, t0 + c, causal, window);
        float t;
        const float x = score(s[i][j], scale, softcap, t);
        const float p = ok ? expf(x - lse_s[r]) : 0.f;
        float ds = p * (dp[i][j] - d_s[r]);
        if (softcap > 0.f) ds *= 1.f - t * t;
        ds_s[r * LP + c] = ok ? ds : 0.f;
      }
    }
    __syncthreads();
    tile_fma<4, NJ>(dq_acc, ds_s, LP, 1, k_s, LD, 1, n, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    const size_t o = (((size_t)b * S + q0 + r) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[o + tx + 16 * j] = from_f<T>(dq_acc[i][j] * scale);
  }
}

template <int HD>
constexpr size_t fwd_smem() { return (size_t)(3 * TM * (HD + 1) + TM * (TK + 1)) * 4; }
template <int HD>
constexpr size_t dkdv_smem() {
  return (size_t)(2 * TM * (HD + 1) + 2 * TQB * (HD + 1) + 2 * TM * (TQB + 1) + 2 * TQB) * 4;
}
template <int HD>
constexpr size_t dq_smem() {
  return (size_t)(2 * TM * (HD + 1) + 2 * TK * (HD + 1) + TM * (TK + 1) + 2 * TM) * 4;
}

struct Args {
  int B, S, H, KV, qsb, qss, ksb, kss, causal, window, score_bf16;
  float softcap, scale;
};

template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
               const Args& a, cudaStream_t stream) {
  const int qpk = a.H / a.KV, bq = TM / qpk;
  cudaError_t err = port::allow_smem(flash_fwd_kernel<T, HD>, fwd_smem<HD>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + bq - 1) / bq, a.KV, a.B);
  flash_fwd_kernel<T, HD><<<grid, THREADS, fwd_smem<HD>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, a.S, a.H, qpk, bq, a.qsb,
      a.qss, a.ksb, a.kss, a.causal, a.window, a.score_bf16, a.softcap, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
               const Args& a, cudaStream_t stream) {
  const int qpk = a.H / a.KV;
  const int rows = a.B * a.S * a.H;
  flash_bwd_delta_kernel<T><<<(rows * 32 + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      (const float*)out, (const T*)dout, (float*)delta, rows, a.S, a.H, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = port::allow_smem(flash_bwd_dkdv_kernel<T, HD>, dkdv_smem<HD>());
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<T, HD><<<dim3((a.S + TM - 1) / TM, a.KV, a.B), THREADS,
                                 dkdv_smem<HD>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, a.S, a.H, a.KV, qpk, a.qsb, a.qss, a.ksb, a.kss,
      a.causal, a.window, a.softcap, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = port::allow_smem(flash_bwd_dq_kernel<T, HD>, dq_smem<HD>());
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T, HD><<<dim3((a.S + TM - 1) / TM, a.H, a.B), THREADS, dq_smem<HD>(),
                               stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dq, a.S, a.H, qpk, a.qsb, a.qss, a.ksb, a.kss, a.causal,
      a.window, a.softcap, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// float32 only (bf16 runs flash_fwd_sm90.cu). q (B, S, H, hd) with element
// strides qsb, qss of its first two dimensions; k, v (B, S, KV, hd) with
// strides ksb, kss (the same for both); heads hd apart and hd contiguous.
// out (B, S, H, hd) and lse (B, H, S) float32 contiguous. hd 64 or 128;
// H / KV <= 64; score_bf16 1 runs the bf16 score chain. Returns a
// cudaError_t code (0 = launched).
int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* out,
                        void* lse, int B, int S, int H, int KV, int hd, int qsb, int qss,
                        int ksb, int kss, int causal, int window, int score_bf16,
                        float softcap, float scale, void* stream) {
  const Args a{B, S, H, KV, qsb, qss, ksb, kss, causal, window, score_bf16, softcap, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (H % KV || H / KV > TM) return (int)cudaErrorInvalidValue;
  if (dtype == DTYPE_F32 && hd == 64) return launch_fwd<float, 64>(q, k, v, out, lse, a, s);
  if (dtype == DTYPE_F32 && hd == 128) return launch_fwd<float, 128>(q, k, v, out, lse, a, s);
  return (int)cudaErrorInvalidValue;
}

// float32 only (bf16 runs flash_bwd_sm90.cu). Layouts as
// flash_attention_fwd; out, dout, dq (B, S, H, hd) and dk, dv (B, S, KV,
// hd) contiguous; lse and the scratch delta (B, H, S) float32.
// Three launches: delta, dK/dV, dQ. Returns a cudaError_t code (0 = launched).
int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse, void* delta,
                        void* dq, void* dk, void* dv, int B, int S, int H, int KV, int hd,
                        int qsb, int qss, int ksb, int kss, int causal, int window,
                        float softcap, float scale, void* stream) {
  const Args a{B, S, H, KV, qsb, qss, ksb, kss, causal, window, 0, softcap, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (H % KV) return (int)cudaErrorInvalidValue;
  if (dtype == DTYPE_F32 && hd == 64)
    return launch_bwd<float, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, a, s);
  if (dtype == DTYPE_F32 && hd == 128)
    return launch_bwd<float, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
