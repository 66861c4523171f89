// The cold-expert gather-GEMV of a duplex MoE layer on Hopper's tensor
// cores, bf16: y[e] = (silu(x[e] Wg[p]) * (x[e] Wu[p])) Wo[p] with
// p = perm[e], for the k_cold least-loaded experts whose small (Cc, d)
// token slabs hold a handful of live rows each.
//
// Replaces (TPU / Pallas): src/repro/kernels/moe_gemv.py:
//   * ragged_moe_gemv_sm90 <- ragged_moe_gemv_kernel (:114, body
//     _ragged_moe_gemv_kernel), bfloat16;
//   * moe_gemv_sm90        <- moe_gemv_kernel (:57, body _moe_gemv_kernel),
//     the capacity-padded variant (no counts: every slot of every cold
//     expert live), bfloat16.
// float32 stays the scalar kernel of moe_gemv.cu: TF32 products would leave
// its 1e-4 band.
//
// What bounds it on the card: bytes. Each occupied cold expert's three
// d x d_ff weight matrices are read once and do 2 FLOPs a weight a live row,
// a few to ~50 Op/B against the H100's ~295 Op/B knee. At the padded
// path's 48 live rows that is still ~29 GFLOP, more than the float32 CUDA
// cores finish in the byte bound's time, so the products go to the tensor
// cores.
//
// Design:
//   * Two launches. Gate/up: a block a (cold expert, 64 columns of d_ff),
//     grid (f / 64, Ec), writes h = silu(x Wg) * (x Wu) for the live rows,
//     rounded to bf16 as the TPU body does before Wo. Down: a block a (cold
//     expert, 64 columns of d), grid (d / 64, Ec), writes y = h Wo for the
//     live rows and zeros for the dead ones. Each output element's sum over
//     the depth is one thread's chain of mma.sync steps in a fixed order:
//     no float atomics, equal bits from call to call (greedy parity depends
//     on it). A block whose expert has count 0 loads nothing (the down
//     launch still writes its zeros).
//   * Weights by TMA. Wg, Wu (E d, f) and Wo (E f, d) are 2-d tensor maps
//     read in place through perm, in boxes of 64 rows x 64 columns with the
//     128-byte swizzle. A stage holds two weight boxes (gate and up at the
//     same depth; or two consecutive 64-row boxes of Wo) and the matching
//     k-panel of the live rows of x (or h): one 16-row box a row group, so
//     x is read once a block, in bf16. A producer warp keeps `stages`
//     stages in flight on full/empty mbarriers; four consumer warps take a
//     stage as soon as it lands.
//   * Products sized to the live rows. The rows are the M dimension of
//     mma.sync.m16n8k16 (bf16 in, float32 accumulators), padded to 16, not
//     to a block's worth of threads: Cc 8 runs one row group, Cc 48 three.
//     A warp owns 16 output columns (two n8 tiles, of gate and of up) for
//     every row group; ldmatrix reads the swizzled tiles without bank
//     conflicts (.trans for the weights, whose columns are contiguous).
//     More than 64 live rows take more passes over the weights.
#include "hopper.cuh"

using port::silu;

namespace {

constexpr int CONSUMERS = 4;                       // warps doing the products
constexpr int THREADS = 32 * (CONSUMERS + 1);      // and one producer warp
constexpr int BN = 64;                             // output columns a block
constexpr int BK = 64;                             // depth of a weight box
constexpr int ROWS = 64;                           // live rows a pass: four 16-row groups
constexpr int MAX_STAGES = 8;
constexpr uint32_t WBOX = BK * BN * 2;             // bytes of a weight box
constexpr uint32_t ABOX = 16 * BK * 2;             // bytes of a 16-row box of x or h

// The operands of one launch: two weight maps (gate and up; Wo twice) and
// the rows' map (x or h).
struct Maps {
  CUtensorMap w0, w1, a;
};

// Four 8x8 b16 matrices from shared memory, transposed, a lane's address a
// row each (sm90::ldsm_x4 without the transpose).
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D (16 x 8, float32) += A (16 x 16, bf16) B (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of row r, 16-byte chunk c of a 128-byte-swizzled tile whose
// base is 1024-byte aligned (TMA's layout).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// DOWN false: h[e, r, n0 .. n0 + 63] = bf16(silu(x Wg) * (x Wu)) for the
// live rows r; maps w0 = Wg, w1 = Wu as (E d, f), a = x as (Ec Cc, d).
// DOWN true: y[e, r, n0 .. n0 + 63] = h Wo for the live rows, zeros for
// the others; w0 = w1 = Wo as (E f, d), a = h as (Ec Cc, f).
// K is the depth (d; f), N the output width (f; d); grid (N / 64, Ec);
// ng_max = min(4, ceil(Cc / 16)) row groups a stage has room for; `stages`
// stages in the ring.
template <bool DOWN>
__global__ void __launch_bounds__(THREADS)
cold_sm90_kernel(const __grid_constant__ Maps maps, const int* __restrict__ perm,
                 const int* __restrict__ counts, __nv_bfloat16* __restrict__ out, int Cc,
                 int K, int N, int ng_max, int stages) {
  constexpr int NBX = DOWN ? 2 : 1;               // 64-deep boxes of the rows a stage
  constexpr int KSTEP = NBX * BK;                 // depth a stage covers
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];

  const int e = blockIdx.y, n0 = blockIdx.x * BN;
  const int cnt = counts ? counts[e] : Cc;        // null: every slot live
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __nv_bfloat16* oe = out + (size_t)e * Cc * N + n0;
  if constexpr (DOWN) {                           // dead rows come back zeroed
    for (int i = tid; i < (Cc - cnt) * (BN / 2); i += THREADS)
      *reinterpret_cast<uint32_t*>(oe + (size_t)(cnt + i / (BN / 2)) * N + 2 * (i % (BN / 2))) =
          0u;
  }
  if (cnt == 0) return;                           // empty cold expert: no loads

  const int p = perm[e];
  const int nk = (K + KSTEP - 1) / KSTEP, nsteps = ((cnt + ROWS - 1) / ROWS) * nk;
  const uint32_t stage_bytes = 2 * WBOX + (uint32_t)ng_max * NBX * ABOX;
  unsigned char* base = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base_a = sm90::smem_addr(base);
  const uint32_t full0 = sm90::smem_addr(full), empty0 = sm90::smem_addr(empty);
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      sm90::mbar_init(full0 + 8 * st, 1);
      sm90::mbar_init(empty0 + 8 * st, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS) {                        // the producer
    if (lane == 0) {
      for (int i = 0; i < nsteps; ++i) {
        const int st = i % stages, pass = i / nk, k0 = (i - pass * nk) * KSTEP;
        const int ng = (min(ROWS, cnt - pass * ROWS) + 15) / 16;
        const int nb = DOWN && k0 + BK < K ? 2 : 1;   // the down launch's last stage may hold one
        if (i >= stages) sm90::mbar_wait(empty0 + 8 * st, ((i / stages) - 1) & 1);
        const uint32_t bar = full0 + 8 * st, dst = base_a + st * stage_bytes;
        sm90::mbar_expect_tx(bar, (DOWN ? nb : 2) * WBOX + ng * nb * ABOX);
        sm90::tma_load_2d(dst, &maps.w0, bar, n0, p * K + k0);
        if (!DOWN || nb == 2)                     // up at the same depth; Wo's next 64 rows
          sm90::tma_load_2d(dst + WBOX, &maps.w1, bar, n0, p * K + k0 + (NBX - 1) * BK);
        for (int gi = 0; gi < ng; ++gi)
          for (int kb = 0; kb < nb; ++kb)
            sm90::tma_load_2d(dst + 2 * WBOX + (gi * NBX + kb) * ABOX, &maps.a, bar,
                              k0 + kb * BK, e * Cc + pass * ROWS + gi * 16);
      }
    }
    return;
  }

  // consumer warp `warp`: columns [16 warp, 16 warp + 16) of the block's 64,
  // two n8 tiles (and, gate/up, the same two of the up projection)
  float acc[4][4][4];
#pragma unroll
  for (int gi = 0; gi < 4; ++gi)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[gi][t][c] = 0.f;
  const int br = (lane & 7) + ((lane >> 3) & 1) * 8, bc = 2 * warp + (lane >> 4);   // ldmatrix.trans
  const int ar = lane & 15, ac = lane >> 4;                                         // ldmatrix
  for (int i = 0; i < nsteps; ++i) {
    const int st = i % stages, pass = i / nk, k0 = (i - pass * nk) * KSTEP;
    const int ng = (min(ROWS, cnt - pass * ROWS) + 15) / 16;
    const int nb = DOWN && k0 + BK < K ? 2 : 1;
    const uint32_t sa = base_a + st * stage_bytes;
    sm90::mbar_wait(full0 + 8 * st, (i / stages) & 1);
#pragma unroll
    for (int kb = 0; kb < NBX; ++kb) {
      if (kb >= nb) break;
      const uint32_t wb = sa + (DOWN ? kb * WBOX : 0);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t b[4], bu[4];
        ldsm_x4_t(wb + swz(16 * kk + br, bc), b);
        if constexpr (!DOWN) ldsm_x4_t(sa + WBOX + swz(16 * kk + br, bc), bu);
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) {
          if (gi >= ng) break;                    // the same for the whole warp
          uint32_t a[4];
          sm90::ldsm_x4(sa + 2 * WBOX + (gi * NBX + kb) * ABOX + swz(ar, 2 * kk + ac), a);
          mma(acc[gi][0], a, b[0], b[1]);
          mma(acc[gi][1], a, b[2], b[3]);
          if constexpr (!DOWN) {
            mma(acc[gi][2], a, bu[0], bu[1]);
            mma(acc[gi][3], a, bu[2], bu[3]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty0 + 8 * st);
    if (k0 + KSTEP < K) continue;

    // the pass's last stage: its rows out, the accumulators cleared
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) {
      if (gi >= ng) break;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = pass * ROWS + gi * 16 + (lane >> 2) + 8 * half;
          float v0 = acc[gi][t][2 * half], v1 = acc[gi][t][2 * half + 1];
          if constexpr (!DOWN) {                  // h = silu(gate) * up
            v0 = silu(v0) * acc[gi][t + 2][2 * half];
            v1 = silu(v1) * acc[gi][t + 2][2 * half + 1];
          }
          if (row < cnt)
            *reinterpret_cast<__nv_bfloat162*>(oe + (size_t)row * N + 16 * warp + 8 * t +
                                                2 * (lane & 3)) = __floats2bfloat162_rn(v0, v1);
        }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[gi][t][c] = 0.f;
    }
  }
}

template <bool DOWN>
cudaError_t launch_phase(const Maps& maps, const void* perm, const void* counts, void* out,
                         int Ec, int Cc, int K, int N, int stages, cudaStream_t stream) {
  const int ng_max = min(4, (Cc + 15) / 16);
  const size_t stage_bytes = 2 * WBOX + ng_max * (DOWN ? 2 : 1) * ABOX;
  while (stages > 2 && 1024 + stages * stage_bytes > 227 * 1024) --stages;   // as many as fit
  const size_t smem = 1024 + stages * stage_bytes;
  cudaError_t err = port::allow_smem(cold_sm90_kernel<DOWN>, smem);
  if (err != cudaSuccess) return err;
  cold_sm90_kernel<DOWN><<<dim3(N / BN, Ec), THREADS, smem, stream>>>(
      maps, (const int*)perm, (const int*)counts, (__nv_bfloat16*)out, Cc, K, N, ng_max,
      stages);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (Ec, Cc, d) bf16 cold slot buffers in rank order; wg/wu (E, d, f) and wo
// (E, f, d) bf16 for ALL experts; perm (Ec,) expert id of each cold rank;
// counts (Ec,) live rows, already clamped to Cc (null: every slot live); h
// (Ec, Cc, f) bf16 scratch; y (Ec, Cc, d) output. All contiguous and
// 16-byte aligned, d and f multiples of 64; stages 2-8 in each block's ring
// (fewer where they do not fit shared memory).
// Returns a cudaError_t code (0 = launched).
int ragged_moe_gemv_sm90(int dtype, const void* x, const void* wg, const void* wu,
                         const void* wo, const void* perm, const void* counts, void* h, void* y,
                         int E, int Ec, int Cc, int d, int f, int stages, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != DTYPE_BF16 || d % BN || f % BN || d <= 0 || f <= 0 || stages < 2 ||
      stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  if (Ec == 0 || Cc == 0) return 0;
  Maps up{}, down{};
  const bool ok = sm90::matrix_map(&up.w0, wg, f, E * d, BK) &&
                  sm90::matrix_map(&up.w1, wu, f, E * d, BK) &&
                  sm90::matrix_map(&up.a, x, d, Ec * Cc, 16) &&
                  sm90::matrix_map(&down.w0, wo, d, E * f, BK) &&
                  sm90::matrix_map(&down.w1, wo, d, E * f, BK) &&
                  sm90::matrix_map(&down.a, h, f, Ec * Cc, 16);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_phase<false>(up, perm, counts, h, Ec, Cc, d, f, stages, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_phase<true>(down, perm, counts, y, Ec, Cc, f, d, stages, s);
}

// The capacity-padded variant: as ragged_moe_gemv_sm90 with every one of
// the Cc slots of every cold expert live (no counts).
int moe_gemv_sm90(int dtype, const void* x, const void* wg, const void* wu, const void* wo,
                  const void* perm, void* h, void* y, int E, int Ec, int Cc, int d, int f,
                  int stages, void* stream) {
  return ragged_moe_gemv_sm90(dtype, x, wg, wu, wo, perm, nullptr, h, y, E, Ec, Cc, d, f,
                              stages, stream);
}

}  // extern "C"
