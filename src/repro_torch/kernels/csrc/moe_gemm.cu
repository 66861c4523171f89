// Ragged grouped GEMM for the hot experts of a duplex MoE layer, Hopper
// (sm_90a), float32: y[e] = (silu(x[e] Wg[p]) * (x[e] Wu[p])) Wo[p] with
// p = perm[e], over only the live rows (count[e]) of each expert's slot
// buffer. bfloat16 runs the tensor-core kernels of moe_gemm_sm90.cu;
// float32 stays here, on the CUDA cores, because TF32 products would leave
// its 1e-4 band.
//
// Replaces (TPU / Pallas): src/repro/kernels/moe_gemm.py:
//   * ragged_moe_gemm <- ragged_moe_gemm_kernel (body
//     _ragged_moe_gemm_kernel, operands from _live_block_operands);
//   * moe_gemm        <- moe_gemm_kernel (body _moe_gemm_kernel), the
//     capacity-padded variant: the same kernels with no counts, so every
//     (expert, token tile) of the capacity is loaded and computed, as the
//     TPU kernel's full (E, nC, nF) grid does. Its output equals the
//     ragged one's wherever the dead slots hold zeros; what differs is the
//     work, which follows the capacity instead of the routed tokens.
//
// What bounds it on the card: at decode-sized stages (a few tokens per hot
// expert) the bytes of the three weight matrices, read once per live token
// tile; at chunked-prefill stages with tens of tokens per expert it moves
// toward the operation bound. This first version uses SIMT float32 FMAs out
// of shared memory, so at large tiles it is bound by its own FMA issue rate
// long before the tensor cores' bound.
//
// What the design does about it: the TPU kernel clamps dead (expert, token
// block) grid steps to a resident block so their DMAs are elided. Here every
// block reads count[e] on the device and a token tile that starts at or past
// it does no loads at all (phase A returns, phase B writes its zero rows and
// returns): weight bytes and FLOPs follow the live tiles and the host never
// syncs on the counts. Experts are read IN PLACE through perm (rank ->
// expert id), so no permuted copy of the expert weights is ever built.
// The SwiGLU runs in two phases: phase A writes h = silu(x Wg) * (x Wu)
// rounded to the storage dtype (the TPU kernel's rounding point) to a
// scratch buffer, phase B multiplies by Wo with float32 accumulation over
// the whole d_ff inside one block, so sums have a fixed order (no atomics).
// The scratch round trip is the price of the simple version.
#include "common.cuh"

using port::from_f;
using port::silu;
using port::to_f;

namespace {

constexpr int TM = 32;      // token rows per tile
constexpr int TN = 64;      // output columns per tile
constexpr int TK = 32;      // reduction depth per shared-memory stage
constexpr int THREADS = 256;
// thread (ty, tx) owns rows ty*2 + {0,1} and columns tx*4 + {0..3}

// Phase A: h[e, c, n] = silu(sum_k x[e,c,k] wg[p,k,n]) * (sum_k x[e,c,k] wu[p,k,n])
// grid (ceil(f/TN), ceil(C/TM), Eh)
template <typename T>
__global__ void __launch_bounds__(THREADS)
gate_up_kernel(const T* __restrict__ x, const T* __restrict__ wg, const T* __restrict__ wu,
               const int* __restrict__ perm, const int* __restrict__ counts,
               T* __restrict__ h, int C, int d, int f) {
  __shared__ float xs[TM][TK + 1];
  __shared__ float gs[TK][TN];
  __shared__ float us[TK][TN];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int cnt = counts ? counts[e] : C;   // null: every slot live
  if (m0 >= cnt) return;                      // dead token tile: no loads
  const size_t woff = (size_t)perm[e] * d * f;
  const T* xe = x + (size_t)e * C * d;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  float ag[2][4] = {}, au[2][4] = {};
  for (int k0 = 0; k0 < d; k0 += TK) {
    for (int i = tid; i < TM * TK; i += THREADS) {
      const int r = i / TK, k = i % TK;
      const int row = m0 + r, col = k0 + k;
      xs[r][k] = (row < C && col < d) ? to_f(xe[(size_t)row * d + col]) : 0.f;
    }
    for (int i = tid; i < TK * TN; i += THREADS) {
      const int k = i / TN, n = i % TN;
      const int kk = k0 + k, col = n0 + n;
      const bool in = kk < d && col < f;
      gs[k][n] = in ? to_f(wg[woff + (size_t)kk * f + col]) : 0.f;
      us[k][n] = in ? to_f(wu[woff + (size_t)kk * f + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
      const float x0 = xs[ty * 2][k], x1 = xs[ty * 2 + 1][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float g = gs[k][tx * 4 + j], u = us[k][tx * 4 + j];
        ag[0][j] += x0 * g;
        ag[1][j] += x1 * g;
        au[0][j] += x0 * u;
        au[1][j] += x1 * u;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + ty * 2 + i;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < f)
        h[((size_t)e * C + row) * f + col] = from_f<T>(silu(ag[i][j]) * au[i][j]);
    }
  }
}

// Phase B: y[e, c, n] = sum_k h[e,c,k] wo[p,k,n] for c < count[e], else 0.
// grid (ceil(d/TN), ceil(C/TM), Eh); the whole d_ff reduction is one block's
// loop, so its order is fixed.
template <typename T>
__global__ void __launch_bounds__(THREADS)
down_kernel(const T* __restrict__ h, const T* __restrict__ wo, const int* __restrict__ perm,
            const int* __restrict__ counts, T* __restrict__ y, int C, int d, int f) {
  __shared__ float hs[TM][TK + 1];
  __shared__ float ws[TK][TN];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int cnt = counts ? counts[e] : C;   // null: every slot live
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  T* ye = y + (size_t)e * C * d;

  float acc[2][4] = {};
  if (m0 < cnt) {
    const size_t woff = (size_t)perm[e] * f * d;
    const T* he = h + (size_t)e * C * f;
    for (int k0 = 0; k0 < f; k0 += TK) {
      for (int i = tid; i < TM * TK; i += THREADS) {
        const int r = i / TK, k = i % TK;
        const int row = m0 + r, col = k0 + k;
        hs[r][k] = (row < cnt && col < f) ? to_f(he[(size_t)row * f + col]) : 0.f;
      }
      for (int i = tid; i < TK * TN; i += THREADS) {
        const int k = i / TN, n = i % TN;
        const int kk = k0 + k, col = n0 + n;
        ws[k][n] = (kk < f && col < d) ? to_f(wo[woff + (size_t)kk * d + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < TK; ++k) {
        const float h0 = hs[ty * 2][k], h1 = hs[ty * 2 + 1][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float w = ws[k][tx * 4 + j];
          acc[0][j] += h0 * w;
          acc[1][j] += h1 * w;
        }
      }
      __syncthreads();
    }
  }
  // live rows get the product, rows at or past the count come back zeroed
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + ty * 2 + i;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < d) ye[(size_t)row * d + col] = from_f<T>(row < cnt ? acc[i][j] : 0.f);
    }
  }
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wo, const void* perm,
           const void* counts, void* h, void* y, int Eh, int C, int d, int f,
           cudaStream_t stream) {
  const dim3 grid_a((f + TN - 1) / TN, (C + TM - 1) / TM, Eh);
  gate_up_kernel<T><<<grid_a, THREADS, 0, stream>>>(
      (const T*)x, (const T*)wg, (const T*)wu, (const int*)perm, (const int*)counts,
      (T*)h, C, d, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_b((d + TN - 1) / TN, (C + TM - 1) / TM, Eh);
  down_kernel<T><<<grid_b, THREADS, 0, stream>>>(
      (const T*)h, (const T*)wo, (const int*)perm, (const int*)counts, (T*)y, C, d, f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (Eh, C, d) float32 slot buffers in rank order; wg/wu (E, d, f) and wo (E, f, d)
// for ALL experts; perm (Eh,) expert id of each rank; counts (Eh,) live rows,
// already clamped to C; h (Eh, C, f) scratch; y (Eh, C, d) output.
// Returns a cudaError_t code (0 = launched).
int ragged_moe_gemm(int dtype, const void* x, const void* wg, const void* wu, const void* wo,
                    const void* perm, const void* counts, void* h, void* y, int Eh, int C,
                    int d, int f, void* stream) {
  if (dtype != DTYPE_F32) return (int)cudaErrorInvalidValue;
  if (Eh == 0 || C == 0) return 0;
  return launch<float>(x, wg, wu, wo, perm, counts, h, y, Eh, C, d, f, (cudaStream_t)stream);
}

// The capacity-padded variant: as ragged_moe_gemm with every one of the C
// slots of every expert live (no counts).
int moe_gemm(int dtype, const void* x, const void* wg, const void* wu, const void* wo,
             const void* perm, void* h, void* y, int Eh, int C, int d, int f, void* stream) {
  return ragged_moe_gemm(dtype, x, wg, wu, wo, perm, nullptr, h, y, Eh, C, d, f, stream);
}

}  // extern "C"
