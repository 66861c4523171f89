// Ragged gather-GEMV for the cold experts of a duplex MoE layer, Hopper
// (sm_90a), float32: the same SwiGLU FFN as the hot path, y[e] =
// (silu(x[e] Wg[p]) * (x[e] Wu[p])) Wo[p] with p = perm[e], for the k_cold
// least-loaded experts whose small (Cc, d) token slabs hold a handful of
// live rows each. bfloat16 runs the tensor-core kernels of
// moe_gemv_sm90.cu; float32 stays here, on the CUDA cores, because TF32
// products would leave its 1e-4 band.
//
// Replaces (TPU / Pallas): src/repro/kernels/moe_gemv.py:
//   * ragged_moe_gemv <- ragged_moe_gemv_kernel (body _ragged_moe_gemv_kernel);
//   * moe_gemv        <- moe_gemv_kernel (body _moe_gemv_kernel), the
//     capacity-padded variant: no counts, every cold expert streams its
//     weights and computes all Cc slots of its slab.
//
// What bounds it on the card: bytes. Each occupied cold expert streams its
// three d x d_ff weight matrices once and does 2 FLOPs per weight per live
// row, a few Op/B against the H100's ~295 Op/B knee.
//
// What the design does about it: one block per (cold expert, 64-column
// slice) streams that weight slice exactly once (for up to 64 live rows)
// with 16-byte vector loads, neighbouring threads on neighbouring
// addresses. The expert's live token rows pass through shared memory in
// step with the weights (32 columns of d at a time), so each slab element
// is loaded once per block — what keeping the whole (Cc, d) slab resident
// buys on the TPU — without a slab-sized (up to 256 KB) shared buffer.
// Experts are read in place through perm (no permuted weight copy). An
// expert with count 0 is skipped entirely: the TPU kernel clamps its index
// map to a resident block to elide the DMA, here the block reads the count
// on the device and returns before any weight load. The down-projection is
// a sum over d_ff: phase 2 gives one block the whole d_ff range for its
// output columns, so the reduction order is fixed and no float atomics are
// used (greedy parity depends on it).
#include "common.cuh"

using port::from_f;
using port::silu;
using port::to_f;

namespace {

constexpr int FS = 64;       // output columns per block
constexpr int KC = 32;       // reduction depth per shared-memory stage
constexpr int RT = 64;       // live rows per pass over the weight slice
constexpr int THREADS = 256;
// thread owns columns cg*8 .. cg*8+7 (cg = tid % 8) and rows rg, rg + 32
// (rg = tid / 8) of each 64-row pass

template <typename T>
__device__ __forceinline__ void load_weight_tile(T* dst, const T* __restrict__ src, int ld,
                                                 int k0, int n0) {
  constexpr int VEC = 16 / sizeof(T);                 // elements per 16 bytes
  for (int i = threadIdx.x; i < KC * FS / VEC; i += THREADS) {
    const int k = i / (FS / VEC), v = i % (FS / VEC);
    const uint4 val = *reinterpret_cast<const uint4*>(src + (size_t)(k0 + k) * ld + n0 + v * VEC);
    *reinterpret_cast<uint4*>(dst + k * FS + v * VEC) = val;
  }
}

// Phase 1: h[e, r, n] = silu(x[e,r] . wg[p,:,n]) * (x[e,r] . wu[p,:,n]) for
// r < count[e]. grid (f / FS, Ec).
template <typename T>
__global__ void __launch_bounds__(THREADS)
cold_gate_up_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                    const T* __restrict__ wu, const int* __restrict__ perm,
                    const int* __restrict__ counts, T* __restrict__ h, int Cc, int d, int f) {
  __shared__ float xs[RT][KC + 1];
  __shared__ __align__(16) T gs[KC * FS];
  __shared__ __align__(16) T us[KC * FS];
  const int e = blockIdx.y, n0 = blockIdx.x * FS;
  const int cnt = counts ? counts[e] : Cc;   // null: every slot live
  if (cnt == 0) return;                       // empty cold expert: no loads
  const size_t woff = (size_t)perm[e] * d * f;
  const T* xe = x + (size_t)e * Cc * d;
  const int tid = threadIdx.x, cg = tid % 8, rg = tid / 8;

  for (int r0 = 0; r0 < cnt; r0 += RT) {
    float ag[2][8] = {}, au[2][8] = {};
    for (int k0 = 0; k0 < d; k0 += KC) {
      for (int i = tid; i < RT * KC; i += THREADS) {
        const int r = i / KC, k = i % KC;
        const int row = r0 + r;
        xs[r][k] = row < cnt ? to_f(xe[(size_t)row * d + k0 + k]) : 0.f;
      }
      load_weight_tile(gs, wg + woff, f, k0, n0);
      load_weight_tile(us, wu + woff, f, k0, n0);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        const float x0 = xs[rg][k], x1 = xs[rg + 32][k];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float g = to_f(gs[k * FS + cg * 8 + j]);
          const float u = to_f(us[k * FS + cg * 8 + j]);
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
      const int row = r0 + rg + 32 * i;
      if (row >= cnt) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        h[((size_t)e * Cc + row) * f + n0 + cg * 8 + j] = from_f<T>(silu(ag[i][j]) * au[i][j]);
    }
  }
}

// Phase 2: y[e, r, n] = sum_k h[e,r,k] wo[p,k,n] for r < count[e], zero for
// the remaining rows up to Cc. grid (d / FS, Ec).
template <typename T>
__global__ void __launch_bounds__(THREADS)
cold_down_kernel(const T* __restrict__ h, const T* __restrict__ wo,
                 const int* __restrict__ perm, const int* __restrict__ counts,
                 T* __restrict__ y, int Cc, int d, int f) {
  __shared__ float hs[RT][KC + 1];
  __shared__ __align__(16) T ws[KC * FS];
  const int e = blockIdx.y, n0 = blockIdx.x * FS;
  const int cnt = counts ? counts[e] : Cc;   // null: every slot live
  const int tid = threadIdx.x, cg = tid % 8, rg = tid / 8;
  T* ye = y + (size_t)e * Cc * d;

  // dead rows (and every row of an empty expert) come back zeroed
  for (int i = tid; i < (Cc - cnt) * FS; i += THREADS) {
    const int row = cnt + i / FS, col = n0 + i % FS;
    ye[(size_t)row * d + col] = from_f<T>(0.f);
  }
  if (cnt == 0) return;
  const size_t woff = (size_t)perm[e] * f * d;
  const T* he = h + (size_t)e * Cc * f;

  for (int r0 = 0; r0 < cnt; r0 += RT) {
    float acc[2][8] = {};
    for (int k0 = 0; k0 < f; k0 += KC) {
      for (int i = tid; i < RT * KC; i += THREADS) {
        const int r = i / KC, k = i % KC;
        const int row = r0 + r;
        hs[r][k] = row < cnt ? to_f(he[(size_t)row * f + k0 + k]) : 0.f;
      }
      load_weight_tile(ws, wo + woff, d, k0, n0);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        const float h0 = hs[rg][k], h1 = hs[rg + 32][k];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float w = to_f(ws[k * FS + cg * 8 + j]);
          acc[0][j] += h0 * w;
          acc[1][j] += h1 * w;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + rg + 32 * i;
      if (row >= cnt) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ye[(size_t)row * d + n0 + cg * 8 + j] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wo, const void* perm,
           const void* counts, void* h, void* y, int Ec, int Cc, int d, int f,
           cudaStream_t stream) {
  cold_gate_up_kernel<T><<<dim3(f / FS, Ec), THREADS, 0, stream>>>(
      (const T*)x, (const T*)wg, (const T*)wu, (const int*)perm, (const int*)counts,
      (T*)h, Cc, d, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cold_down_kernel<T><<<dim3(d / FS, Ec), THREADS, 0, stream>>>(
      (const T*)h, (const T*)wo, (const int*)perm, (const int*)counts, (T*)y, Cc, d, f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (Ec, Cc, d) float32 cold slot buffers in rank order; wg/wu (E, d, f)
// and wo (E, f, d) for ALL experts, 16-byte aligned; perm (Ec,) expert id
// of each cold rank; counts (Ec,) live rows, already clamped to Cc; h
// (Ec, Cc, f) scratch; y (Ec, Cc, d) output. d and f must be multiples of
// 64. Returns a cudaError_t code (0 = launched).
int ragged_moe_gemv(int dtype, const void* x, const void* wg, const void* wu, const void* wo,
                    const void* perm, const void* counts, void* h, void* y, int Ec, int Cc,
                    int d, int f, void* stream) {
  if (dtype != DTYPE_F32 || d % FS != 0 || f % FS != 0) return (int)cudaErrorInvalidValue;
  if (Ec == 0 || Cc == 0) return 0;
  return launch<float>(x, wg, wu, wo, perm, counts, h, y, Ec, Cc, d, f, (cudaStream_t)stream);
}

// The capacity-padded variant: as ragged_moe_gemv with every one of the Cc
// slots of every cold expert live (no counts).
int moe_gemv(int dtype, const void* x, const void* wg, const void* wu, const void* wo,
             const void* perm, void* h, void* y, int Ec, int Cc, int d, int f, void* stream) {
  return ragged_moe_gemv(dtype, x, wg, wu, wo, perm, nullptr, h, y, Ec, Cc, d, f, stream);
}

}  // extern "C"
