// Mamba-2 (SSD) single-token state update for Hopper (sm_90a):
//   state' = state * exp(dt * -exp(A_log)) + dt * (B (x) x)
//   y      = C . state' + D * x
// per (sequence b, head h): state (N, P) float32, x (P,), dt scalar, B and C
// (N,) shared by the sequence's heads (ngroups = 1).
//
// Replaces (TPU / Pallas): src/repro/kernels/ssd_decode.py:
//   ssd_decode <- ssd_decode_kernel (body _ssd_decode_kernel).
//
// What bounds it on the card: bytes. It does about 5 operations per float32
// state element it reads and writes once (8 bytes), 0.6 Op/B, far below the
// H100's knee; the least time is 2 * B * H * N * P * 4 bytes over the HBM
// rate.
//
// What the design does about it: the state is read once and written once,
// and nothing else of size goes through memory. One block serves one
// (sequence, group of heads); P runs on the threads (neighbouring threads on
// neighbouring state addresses, so each row of N is one coalesced access)
// and each thread loops over N, so the C . state' contraction is a sum in
// one thread's registers with no cross-thread or cross-block reduction, in
// a fixed order. The loop over N issues SSD_NB loads before it uses any, so
// a warp keeps that many rows in flight. B and C are staged in shared
// memory once per block.
//
// In place: the new state overwrites the old one (the TPU kernel, like every
// JAX function, returns a new array). The caller's state tensor is the
// layer's cache leaf, so no second state buffer is allocated per step.
#include "common.cuh"

using port::from_f;
using port::to_f;

namespace {

constexpr int SSD_THREADS = 256;
constexpr int SSD_NB = 16;        // state rows loaded before use

// grid (B, ceil(H / hb)), block (P, hb) with hb = SSD_THREADS / P.
// state (B, H, N, P) float32, updated in place; x (B, H, P) in T; dt (B, H),
// a_log and d (H,), b and c (B, N), all float32; y (B, H, P) in T.
template <typename T>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_decode_kernel(float* __restrict__ state, const T* __restrict__ x,
                  const float* __restrict__ dt, const float* __restrict__ a_log,
                  const float* __restrict__ bm, const float* __restrict__ cm,
                  const float* __restrict__ dres, T* __restrict__ y, int H, int N, int P) {
  extern __shared__ float bc_s[];   // (2N,): this sequence's B, then C
  const int b = blockIdx.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < N; i += blockDim.x * blockDim.y) {
    bc_s[i] = bm[(size_t)b * N + i];
    bc_s[N + i] = cm[(size_t)b * N + i];
  }
  __syncthreads();
  const int p = threadIdx.x, h = blockIdx.y * blockDim.y + threadIdx.y;
  if (h >= H || p >= P) return;

  const size_t bh = (size_t)b * H + h;
  const float dtv = dt[bh];
  const float decay = expf(dtv * -expf(a_log[h]));
  const float xv = to_f(x[bh * P + p]);
  float* st = state + bh * (size_t)N * P + p;
  float acc = 0.f;
  for (int n0 = 0; n0 < N; n0 += SSD_NB) {
    float s[SSD_NB];
#pragma unroll
    for (int j = 0; j < SSD_NB; ++j)
      s[j] = n0 + j < N ? st[(size_t)(n0 + j) * P] : 0.f;
#pragma unroll
    for (int j = 0; j < SSD_NB; ++j) {
      const int n = n0 + j;
      if (n < N) {
        // (dt * B) * x, the TPU body's order
        s[j] = s[j] * decay + (dtv * bc_s[n]) * xv;
        st[(size_t)n * P] = s[j];
        acc += bc_s[N + n] * s[j];
      }
    }
  }
  y[bh * P + p] = from_f<T>(acc + dres[h] * xv);
}

template <typename T>
int launch_ssd(void* state, const void* x, const void* dt, const void* a_log, const void* b,
               const void* c, const void* d, void* y, int B, int H, int N, int P,
               cudaStream_t stream) {
  if (P < 1 || P > SSD_THREADS || N < 1) return (int)cudaErrorInvalidValue;
  const int hb = SSD_THREADS / P;
  const dim3 grid(B, (H + hb - 1) / hb);
  const size_t smem = (size_t)2 * N * sizeof(float);
  cudaError_t err = port::allow_smem(ssd_decode_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_decode_kernel<T><<<grid, dim3(P, hb), smem, stream>>>(
      (float*)state, (const T*)x, (const float*)dt, (const float*)a_log, (const float*)b,
      (const float*)c, (const float*)d, (T*)y, H, N, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x and y in `dtype`; everything else float32, contiguous. Returns a
// cudaError_t code (0 = launched).
int ssd_decode(int dtype, void* state, const void* x, const void* dt, const void* a_log,
               const void* b, const void* c, const void* d, void* y, int B, int H, int N,
               int P, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return launch_ssd<float>(state, x, dt, a_log, b, c, d, y, B, H, N, P, s);
  if (dtype == DTYPE_BF16)
    return launch_ssd<__nv_bfloat16>(state, x, dt, a_log, b, c, d, y, B, H, N, P, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
