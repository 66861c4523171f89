// The hot-expert grouped GEMM of a duplex MoE layer on Hopper's tensor
// cores, bf16: y[e] = (silu(x[e] Wg[p]) * (x[e] Wu[p])) Wo[p] with
// p = perm[e], over the live rows (counts[e]) of each hot expert's (C, d)
// slot buffer.
//
// Replaces (TPU / Pallas): src/repro/kernels/moe_gemm.py:
//   * ragged_moe_gemm_sm90 <- ragged_moe_gemm_kernel (:141, body
//     _ragged_moe_gemm_kernel), bfloat16;
//   * moe_gemm_sm90        <- moe_gemm_kernel (:65, body _moe_gemm_kernel),
//     the capacity-padded variant (no counts: every slot of every hot
//     expert live), bfloat16.
// float32 stays the scalar kernels of moe_gemm.cu: TF32 products would
// leave its 1e-4 band.
//
// What bounds it on the card: bytes. Each live hot expert's three d x d_ff
// weight matrices do 2 FLOPs a weight a live row: at OLMoE's C 64 that is
// 64 Op/B, at C 128 128 Op/B, under the H100's ~295 Op/B knee. The
// scalar parent read the weights once per 32-row token tile (twice at C 64,
// four times at C 128) and ran float32 FMAs.
//
// Design:
//   * Each live expert's weights are read once a launch for up to 128 live
//     rows. The product is taken transposed, D^T = W^T x^T: a 64-column
//     weight tile is the M = 64 operand of wgmma, read MN-major from shared
//     memory as TMA lands it, and the pass's rows are N (64 when C <= 64,
//     else 128), read K-major. So 1-128 rows take one pass over the
//     weights; more rows take more passes.
//   * Two launches, so every sum has a fixed order: gate/up, a block a
//     (hot expert, 128 columns of d_ff), grid (ceil(f / 128), Eh), writes
//     h = silu(x Wg) * (x Wu) rounded to bf16 (the TPU body's rounding
//     point before Wo) for the live rows; down, a block a (hot expert, 256
//     columns of d), grid (ceil(d / 256), Eh), writes y = h Wo for the live
//     rows and zeros for the dead ones. Each output's depth sum is one
//     chain of wgmma steps in order: no float atomics, no split over the
//     depth, equal bits from call to call (greedy parity depends on it).
//     Grids follow the shapes alone; a block reads counts[e] on the device
//     and one with no live rows loads nothing (the down launch still writes
//     its zeros), so the host never syncs and a CUDA graph can capture it.
//   * Weights by TMA. Wg, Wu (E d, f) and Wo (E f, d) are 2-d tensor maps
//     read in place through perm, in boxes of 64 rows x 64 columns with the
//     128-byte swizzle. A stage holds four weight boxes at one depth (Wg
//     and Wu at two 64-column steps; or four 64-column steps of Wo) and the
//     matching 64-deep panel of the pass's live rows of x (or h), one
//     16-row box a row group. A producer warp keeps `stages` stages in
//     flight on full/empty mbarriers. Two consumer warpgroups each own two
//     of the four boxes: gate and up of 64 columns (silu * up meets in
//     registers), or 128 columns of Wo. A block's rows are read once for
//     128 (or 256) output columns, so x and h cost a quarter to a half of
//     the weight bytes in L2 traffic, not as much again.
#include "hopper.cuh"

using port::silu;

namespace {

constexpr int CONSUMERS = 2;                       // warpgroups doing the products
constexpr int THREADS = 128 * CONSUMERS + 32;      // and one producer warp
constexpr int BK = 64;                             // depth of a stage
constexpr int NBOX = 2 * CONSUMERS;                // weight boxes a stage
constexpr int MAX_STAGES = 8;
constexpr uint32_t WBOX = BK * 64 * 2;             // bytes of a 64 x 64 weight box
constexpr uint32_t ABOX = 16 * BK * 2;             // bytes of a 16-row box of x or h

// The operands of one launch: two weight maps (gate and up; Wo twice) and
// the rows' map (x or h).
struct Maps {
  CUtensorMap w0, w1, a;
};

// One 64-column tile of the transposed product out: rows row0 + (0 .. NW)
// of out (those under cnt), columns col0 + (0 .. 63); SWIGLU: silu(a) * b,
// else a. Thread entry j holds column m = 16 wi + lane / 4 + 8 ((j / 2) % 2)
// of row c = 8 (j / 4) + 2 (lane % 4) + j % 2; lanes L and L ^ 4 hold
// columns m and m ^ 1 of the same two rows, so one exchange gives each a
// pair of adjacent columns of one row, stored as one bf16x2.
template <int NW, bool SWIGLU>
__device__ __forceinline__ void store_tile(const float (&a)[NW / 2], const float (&b)[NW / 2],
                                           __nv_bfloat16* out, int N, int row0, int cnt,
                                           int col0, int wi, int lane) {
  const int odd = (lane >> 2) & 1;                 // m odd: this lane takes row c + 1
#pragma unroll
  for (int j = 0; j < NW / 2; j += 2) {
    const float v0 = SWIGLU ? silu(a[j]) * b[j] : a[j];               // (m, c)
    const float v1 = SWIGLU ? silu(a[j + 1]) * b[j + 1] : a[j + 1];   // (m, c + 1)
    const float got = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
    const int row = row0 + 8 * (j >> 2) + 2 * (lane & 3) + odd;
    const int col = col0 + 16 * wi + (lane >> 2) + 8 * ((j >> 1) & 1) - odd;
    if (row < cnt)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
          odd ? __floats2bfloat162_rn(got, v1) : __floats2bfloat162_rn(v0, got);
  }
}

// DOWN false: h[e, r, n0 .. n0 + 127] = bf16(silu(x Wg) * (x Wu)) for the
// live rows r; maps w0 = Wg, w1 = Wu as (E d, f), a = x as (Eh C, d).
// DOWN true: y[e, r, n0 .. n0 + 255] = h Wo for the live rows, zeros for
// the others; w0 = w1 = Wo as (E f, d), a = h as (Eh C, f).
// K is the depth (d; f), N the output width (f; d); NW the rows a pass;
// grid (ceil(N / BN), Eh); `stages` stages in the ring.
template <bool DOWN, int NW>
__global__ void __launch_bounds__(THREADS, 1)
hot_sm90_kernel(const __grid_constant__ Maps maps, const int* __restrict__ perm,
                const int* __restrict__ counts, __nv_bfloat16* __restrict__ out, int C, int K,
                int N, int stages) {
  constexpr int BN = DOWN ? 64 * NBOX : 64 * NBOX / 2;   // output columns a block
  constexpr uint32_t STAGE = NBOX * WBOX + (NW / 16) * ABOX;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];

  const int e = blockIdx.y, n0 = blockIdx.x * BN;
  const int cnt = counts ? counts[e] : C;          // null: every slot live
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __nv_bfloat16* oe = out + (size_t)e * C * N;
  if constexpr (DOWN) {                            // dead rows come back zeroed
    const int w8 = min(BN, N - n0) / 8;
    for (int i = tid; i < (C - cnt) * w8; i += THREADS)
      *reinterpret_cast<uint4*>(oe + (size_t)(cnt + i / w8) * N + n0 + 8 * (i % w8)) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  if (cnt == 0) return;                            // empty hot expert: no loads

  // weight box b of a stage starts at column box_col(b): gate/up Wg, Wu,
  // Wg, Wu at two 64-column steps, down four 64-column steps of Wo; a box
  // at or past N is not loaded (N a multiple of 64, not of BN)
  auto box_col = [&](int b) { return n0 + 64 * (DOWN ? b : b / 2); };
  const int p = perm[e];
  const int nk = K / BK, nsteps = ((cnt + NW - 1) / NW) * nk;
  unsigned char* base = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base_a = sm90::smem_addr(base);
  const uint32_t full0 = sm90::smem_addr(full), empty0 = sm90::smem_addr(empty);
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      sm90::mbar_init(full0 + 8 * st, 1);
      sm90::mbar_init(empty0 + 8 * st, 4 * CONSUMERS);   // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CONSUMERS) {                     // the producer
    if (lane == 0) {
      int nb = 0;
      for (int b = 0; b < NBOX; ++b) nb += box_col(b) < N;
      for (int i = 0; i < nsteps; ++i) {
        const int st = i % stages, pass = i / nk, k0 = (i - pass * nk) * BK;
        const int ng = (min(NW, cnt - pass * NW) + 15) / 16;
        if (i >= stages) sm90::mbar_wait(empty0 + 8 * st, ((i / stages) - 1) & 1);
        const uint32_t bar = full0 + 8 * st, dst = base_a + st * STAGE;
        sm90::mbar_expect_tx(bar, nb * WBOX + ng * ABOX);
        for (int b = 0; b < NBOX; ++b)
          if (box_col(b) < N)
            sm90::tma_load_2d(dst + b * WBOX, DOWN || b % 2 == 0 ? &maps.w0 : &maps.w1, bar,
                              box_col(b), p * K + k0);
        for (int g = 0; g < ng; ++g)
          sm90::tma_load_2d(dst + NBOX * WBOX + g * ABOX, &maps.a, bar, k0,
                            e * C + pass * NW + 16 * g);
      }
    }
    return;
  }

  // consumer warpgroup wg: boxes 2 wg (tile 0) and 2 wg + 1 (tile 1)
  const int wg = warp >> 2, wi = warp & 3;
  const bool live0 = box_col(2 * wg) < N, live1 = box_col(2 * wg + 1) < N;
  float acc[2][NW / 2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) acc[t][j] = 0.f;
  for (int i = 0; i < nsteps; ++i) {
    const int st = i % stages, pass = i / nk, k0 = (i - pass * nk) * BK;
    const uint32_t sa = base_a + st * STAGE;
    sm90::mbar_wait(full0 + 8 * st, (i / stages) & 1);
    if (live0) {                                   // the same for the whole warpgroup
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // rows: 32 bytes a k16 step along the swizzled 128-byte rows;
        // weights: 16 rows (2048 bytes) a k16 step
        const uint64_t db = sm90::desc_sw128(sa + NBOX * WBOX + 32 * kk, 16, 1024);
        const uint32_t wa = sa + 2 * wg * WBOX + 2048 * kk;
        const int more = k0 > 0 || kk > 0;         // 0: a pass's first step overwrites
        sm90::wgmma_ss<1>(acc[0], sm90::desc_sw128(wa, WBOX, 1024), db, more);
        if (live1) sm90::wgmma_ss<1>(acc[1], sm90::desc_sw128(wa + WBOX, WBOX, 1024), db, more);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait0();
      sm90::fence_regs(acc[0]);
      sm90::fence_regs(acc[1]);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty0 + 8 * st);
    if (k0 + BK < K || !live0) continue;

    // the pass's last stage: its live rows out
    const int row0 = pass * NW;
    if constexpr (!DOWN) {
      store_tile<NW, true>(acc[0], acc[1], oe, N, row0, cnt, box_col(2 * wg), wi, lane);
    } else {
      store_tile<NW, false>(acc[0], acc[0], oe, N, row0, cnt, box_col(2 * wg), wi, lane);
      if (live1)
        store_tile<NW, false>(acc[1], acc[1], oe, N, row0, cnt, box_col(2 * wg + 1), wi, lane);
    }
  }
}

template <bool DOWN, int NW>
cudaError_t launch_phase(const Maps& maps, const void* perm, const void* counts, void* out,
                         int Eh, int C, int K, int N, int stages, cudaStream_t stream) {
  constexpr int BN = DOWN ? 64 * NBOX : 64 * NBOX / 2;
  constexpr size_t STAGE = NBOX * WBOX + (NW / 16) * ABOX;
  while (stages > 2 && 1024 + stages * STAGE > 220 * 1024) --stages;   // as many as fit
  const size_t smem = 1024 + stages * STAGE;
  cudaError_t err = port::allow_smem(hot_sm90_kernel<DOWN, NW>, smem);
  if (err != cudaSuccess) return err;
  hot_sm90_kernel<DOWN, NW><<<dim3((N + BN - 1) / BN, Eh), THREADS, smem, stream>>>(
      maps, (const int*)perm, (const int*)counts, (__nv_bfloat16*)out, C, K, N, stages);
  return cudaGetLastError();
}

template <int NW>
cudaError_t run(const Maps& up, const Maps& down, const void* perm, const void* counts,
                void* h, void* y, int Eh, int C, int d, int f, int stages, cudaStream_t s) {
  cudaError_t err = launch_phase<false, NW>(up, perm, counts, h, Eh, C, d, f, stages, s);
  if (err != cudaSuccess) return err;
  return launch_phase<true, NW>(down, perm, counts, y, Eh, C, f, d, stages, s);
}

}  // namespace

extern "C" {

// x (Eh, C, d) bf16 hot slot buffers in rank order; wg/wu (E, d, f) and wo
// (E, f, d) bf16 for ALL experts; perm (Eh,) expert id of each hot rank;
// counts (Eh,) live rows, already clamped to C (null: every slot live); h
// (Eh, C, f) bf16 scratch; y (Eh, C, d) output. All contiguous and 16-byte
// aligned, d and f multiples of 64; stages 2-8 in each block's ring (fewer
// where they do not fit shared memory). Passes of 64 rows when C <= 64,
// else of 128.
// Returns a cudaError_t code (0 = launched).
int ragged_moe_gemm_sm90(int dtype, const void* x, const void* wg, const void* wu,
                         const void* wo, const void* perm, const void* counts, void* h, void* y,
                         int E, int Eh, int C, int d, int f, int stages, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != DTYPE_BF16 || d % 64 || f % 64 || d <= 0 || f <= 0 || stages < 2 ||
      stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  if (Eh == 0 || C == 0) return 0;
  Maps up{}, down{};
  const bool ok = sm90::matrix_map(&up.w0, wg, f, E * d, BK) &&
                  sm90::matrix_map(&up.w1, wu, f, E * d, BK) &&
                  sm90::matrix_map(&up.a, x, d, Eh * C, 16) &&
                  sm90::matrix_map(&down.w0, wo, d, E * f, BK) &&
                  sm90::matrix_map(&down.w1, wo, d, E * f, BK) &&
                  sm90::matrix_map(&down.a, h, f, Eh * C, 16);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)(C > 64 ? run<128>(up, down, perm, counts, h, y, Eh, C, d, f, stages, s)
                      : run<64>(up, down, perm, counts, h, y, Eh, C, d, f, stages, s));
}

// The capacity-padded variant: as ragged_moe_gemm_sm90 with every one of
// the C slots of every hot expert live (no counts).
int moe_gemm_sm90(int dtype, const void* x, const void* wg, const void* wu, const void* wo,
                  const void* perm, void* h, void* y, int E, int Eh, int C, int d, int f,
                  int stages, void* stream) {
  return ragged_moe_gemm_sm90(dtype, x, wg, wu, wo, perm, nullptr, h, y, E, Eh, C, d, f,
                              stages, stream);
}

}  // extern "C"
