// The bf16 flash-attention backward on Hopper's tensor cores (wgmma).
//
//   * flash_bwd_prep_kernel, flash_bwd_dkdv_sm90_kernel, flash_bwd_dq_sm90_kernel
//                             <- src/repro/models/attention.py: _flash_core_bwd
//                                (the custom VJP's backward; the JAX package
//                                runs it through XLA, with no Pallas kernel),
//                                in bfloat16
//
// The float32 backward stays the scalar kernels of flash_attn.cu: a TF32
// product would leave the float32 band, and path d trains in bf16.
//
// What bounds it on the card: operations. Seven products of 2 * hd FLOPs
// a live (query, key) pair, 3.5x the forward's, on tiles that stay in
// shared memory, far above the H100's ~295 Op/B knee; so every product
// runs on the tensor cores as wgmma.mma_async bf16 -> float32.
//
// Design: three launches and no float atomics, so the gradients are the
// same bits from run to run.
//   1. prep: one warp a (b, s, h) row writes D = rowsum(dO * O) from the
//      float32 output, and lse * log2(e), into (B, H, S_pad) rows padded
//      to 64 positions, so a tile of either is one 16-byte-aligned bulk
//      copy (S_pad is the wrapper's too: kernels/flash_attn.py).
//   2. dK/dV: a block owns BN = 128 keys of one (b, KV head), split between
//      two consumer warpgroups of 64 keys; its K and V stay in shared
//      memory. A producer warpgroup (setmaxnreg 24 / 240, one thread works)
//      streams tiles of TQ = 64 query rows of Q and dO by TMA, with their
//      lse and D by bulk copy, through a two-stage ring of full / empty
//      mbarriers, for each head of the GQA group in turn (lse and D are
//      then contiguous in S, and the group's sum stays in the block's
//      registers). Per tile a warpgroup computes
//        S^T  = K Q^T            wgmma, K and Q K-major (64 x 64 x hd)
//        dP^T = V dO^T           wgmma, V and dO K-major
//        P^T  = exp(score(S^T) - lse), dS^T = P^T (dP^T - D) (1 - t^2)
//        dV  += P^T dO           wgmma, P^T from registers, dO MN-major
//        dK  += dS^T Q           wgmma, dS^T from registers, Q MN-major
//      and skips the tiles in which none of its keys is live.
//   3. dQ: a block owns the forward's work item, 128 rows of (position,
//      head-in-group) of one KV head, Q and dO resident (TMA boxes over
//      the (hd, qpk, KV, S, B) view give the rows in the GQA order); the
//      producer streams K/V tiles of KT = 128 keys; per tile
//        S = Q K^T, dP = dO V^T  wgmma, all K-major
//        dS = P (dP - D) (1 - t^2)
//        dQ += dS K              wgmma, dS from registers, K MN-major
//      The longest causal items run first.
// Key and query loops are bounded on the device from the causal and window
// edges; only the tiles that cross an edge (or S) evaluate the mask.
//
// Numerics follow the reference's _flash_core_bwd: float32 scores, scale,
// softcap (t = tanh(s / softcap), score softcap * t), the masks kpos < S,
// kpos <= qpos (causal), kpos > qpos - window; p = exp(score - lse) in
// float32 (one ex2.approx of the score and lse in log2 units), D from the
// forward's float32 output, dS = p (dP - D), times 1 - t^2 under softcap,
// zero outside the mask; float32 accumulators; dQ and dK times scale at
// the end; dq, dk, dv rounded to bf16. The one rounding the reference does
// not make: P and dS are rounded to bf16 as the A operands of the dV, dK
// and dQ products (the reference keeps them in float32). Its times on the
// card, and how far that rounding moves the gradients, are in PERF.md
// section 6.
#include "hopper.cuh"

using namespace sm90;

namespace {

constexpr int CONSUMERS = 256;            // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int BN = 128;   // keys a dK/dV block owns
constexpr int TQ = 64;    // query rows a dK/dV tile
constexpr int BM = 128;   // query rows a dQ block owns
constexpr int KT = 128;   // keys a dQ tile
constexpr int STAGES = 2; // tiles in flight
constexpr int PAD = 64;   // lse and D rows are padded to a multiple of PAD positions

// grid ceil(B S H / 8) of 256 threads. o, dout (B, S, H, hd) contiguous
// (float32, bf16); lse (B, H, S); delta and lse2 (B, H, sp).
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const float* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ delta,
                      float* __restrict__ lse2, int rows, int S, int sp, int H, int hd) {
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;                       // whole warps leave together
  const size_t off = (size_t)row * hd;
  float acc = 0.f;
  for (int c = 4 * lane; c < hd; c += 128) {
    const float4 x = *reinterpret_cast<const float4*>(o + off + c);
    const uint2 d = *reinterpret_cast<const uint2*>(dout + off + c);
    const float2 d01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&d.x));
    const float2 d23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&d.y));
    acc += x.x * d01.x + x.y * d01.y + x.z * d23.x + x.w * d23.y;
  }
  acc = port::warp_sum(acc);
  if (lane == 0) {
    const int h = row % H, s = (row / H) % S, b = row / (H * S);
    const size_t i = ((size_t)b * H + h) * sp + s;
    delta[i] = acc;
    lse2[i] = lse[((size_t)b * H + h) * S + s] * LOG2E;
  }
}

// The scaled, softcapped score of a raw dot product in log2 units, and the
// factor 1 - t^2 its gradient takes under softcap (mul: scale * log2(e),
// or scale / softcap under softcap, cap: softcap * log2(e)).
__device__ __forceinline__ float score2(float dot, float mul, float cap, bool capped,
                                        float& dtanh) {
  float x = dot * mul;
  dtanh = 1.f;
  if (capped) {
    const float t = tanhf(x);
    dtanh = 1.f - t * t;
    x = cap * t;
  }
  return x;
}

// grid ceil(S / BN) KV B, the blocks with the most query tiles first. k, v
// through tensor maps of BN-row boxes, q and dout of TQ-row boxes over
// (hd, H, S, B); lse2, delta (B, H, sp); dk, dv (B, S, KV, hd) bf16
// contiguous. Warps 0-7 are the two consumer warpgroups, 8-11 the
// producer.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse2, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int S, int sp, int H, int KV, int B, int qpk, int causal,
                           int window, float softcap, float scale) {
  constexpr int K_BYTES = BN * HD * 2, T_BYTES = TQ * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  // full[s], empty[s], kv full
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 1];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + K_BYTES;
  const uint32_t t_s = base + 2 * K_BYTES;              // stage st: Q, then dO
  const uint32_t f_s = t_s + STAGES * 2 * T_BYTES;      // stage st: lse2, then D
  const float* f_ptr = reinterpret_cast<const float*>(smem_raw + (f_s - smem_addr(smem_raw)));
  const uint32_t full0 = smem_addr(bars), empty0 = full0 + 8 * STAGES,
                 kvfull = empty0 + 8 * STAGES;

  const int tid = threadIdx.x;
  const int rank = blockIdx.x / (KV * B), rem = blockIdx.x % (KV * B);
  const int g = rem % KV, b = rem / KV;
  const int k0 = rank * BN, nk = min(BN, S - k0);
  // query positions that see a key of this block, in tiles of TQ
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, k0 + nk - 1 + window) : S;
  const int n_qt = (q_hi - q_lo + TQ - 1) / TQ;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, CONSUMERS);
    }
    mbar_init(kvfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: one thread brings K and V, then each head's query tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == CONSUMERS) {
      mbar_expect_tx(kvfull, 2 * K_BYTES);
#pragma unroll
      for (int p = 0; p < HD / 64; ++p) {
        tma_load_4d(k_s + p * BN * 128, &tm_k, kvfull, p * 64, g, k0, b);
        tma_load_4d(v_s + p * BN * 128, &tm_v, kvfull, p * 64, g, k0, b);
      }
      int it = 0;
      for (int hh = 0; hh < qpk; ++hh) {
        const int h = g * qpk + hh;
        for (int j = 0; j < n_qt; ++j, ++it) {
          const int st = it % STAGES, p0 = q_lo + j * TQ;
          if (it >= STAGES) mbar_wait(empty0 + 8 * st, ((it / STAGES) & 1) ^ 1);
          const uint32_t full = full0 + 8 * st, qs = t_s + st * 2 * T_BYTES;
          mbar_expect_tx(full, 2 * T_BYTES + 2 * TQ * 4);
#pragma unroll
          for (int p = 0; p < HD / 64; ++p) {
            tma_load_4d(qs + p * TQ * 128, &tm_q, full, p * 64, h, p0, b);
            tma_load_4d(qs + T_BYTES + p * TQ * 128, &tm_do, full, p * 64, h, p0, b);
          }
          const size_t o = ((size_t)b * H + h) * sp + p0;
          const uint32_t fs = f_s + st * 2 * TQ * 4;
          bulk_load(fs, lse2 + o, TQ * 4, full);
          bulk_load(fs + TQ * 4, delta + o, TQ * 4, full);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const bool capped = softcap > 0.f;
  const float mul = capped ? scale / softcap : scale * LOG2E;
  const float cap = softcap * LOG2E;
  const int kw0 = k0 + wg * 64;                  // this warpgroup's first key
  // this thread's two key rows (accumulator rows lane / 4 and lane / 4 + 8
  // of its warp's 16)
  int kpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kpos[i] = kw0 + warp * 16 + (lane >> 2) + 8 * i;
  float dk_acc[HD / 2], dv_acc[HD / 2], s[TQ / 2], dp[TQ / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < TQ / 2; ++i) s[i] = dp[i] = 0.f;
  mbar_wait(kvfull, 0);

  int it = 0;
  for (int hh = 0; hh < qpk; ++hh) {
    for (int j = 0; j < n_qt; ++j, ++it) {
      const int st = it % STAGES, p0 = q_lo + j * TQ;
      // no (query, key) pair of this tile is live for this warpgroup's keys
      const bool dead = kw0 >= S || (causal && p0 + TQ - 1 < kw0) ||
                        (window > 0 && p0 >= kw0 + 63 + window);
      mbar_wait(full0 + 8 * st, (it / STAGES) & 1);   // tile it has landed
      if (!dead) {
        const uint32_t qs = t_s + st * 2 * T_BYTES, dos = qs + T_BYTES;
        const float* lse_t = f_ptr + st * 2 * TQ;
        const float* d_t = lse_t + TQ;

        // S^T = K Q^T and dP^T = V dO^T: 64 keys x TQ queries, hd / 16 steps
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t panel = kk >> 2, col = (kk & 3) * 32;
          wgmma_ss(s, desc_sw128(k_s + panel * BN * 128 + wg * 64 * 128 + col, 16, 1024),
                   desc_sw128(qs + panel * TQ * 128 + col, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t panel = kk >> 2, col = (kk & 3) * 32;
          wgmma_ss(dp, desc_sw128(v_s + panel * BN * 128 + wg * 64 * 128 + col, 16, 1024),
                   desc_sw128(dos + panel * TQ * 128 + col, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(s);
        fence_regs(dp);

        const bool edge = (causal && p0 < kw0 + 63) ||
                          (window > 0 && p0 + TQ - 1 - kw0 >= window) || p0 + TQ > S;
        // P^T and dS^T, rounded to bf16 and packed as the A fragments of
        // the k16 steps over this tile's queries
        uint32_t pa[TQ / 16][4], da[TQ / 16][4];
#pragma unroll
        for (int nn = 0; nn < TQ / 8; ++nn) {
          const int col = nn * 8 + 2 * (lane & 3);
          const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
          const float2 dd = *reinterpret_cast<const float2*>(d_t + col);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float pv[2], dsv[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float dt;
              const float x = score2(s[nn * 4 + i * 2 + c], mul, cap, capped, dt);
              float p = ex2(x - (c ? l2.y : l2.x));
              float d = p * (dp[nn * 4 + i * 2 + c] - (c ? dd.y : dd.x)) * dt;
              if (edge) {
                const int qpos = p0 + col + c;
                if (qpos >= S || !live(qpos, kpos[i], causal, window)) p = d = 0.f;
              }
              pv[c] = p;
              dsv[c] = d;
            }
            // column block nn is k16 step nn / 2, register (nn & 1) * 2 + i
            pa[nn >> 1][(nn & 1) * 2 + i] = pack_bf16(pv[0], pv[1]);
            da[nn >> 1][(nn & 1) * 2 + i] = pack_bf16(dsv[0], dsv[1]);
          }
        }

        // dV += P^T dO and dK += dS^T Q: dO and Q MN-major from shared memory
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TQ / 16; ++kk)
          wgmma_rs(dv_acc, pa[kk], desc_sw128(dos + kk * 16 * 128, TQ * 128, 1024));
#pragma unroll
        for (int kk = 0; kk < TQ / 16; ++kk)
          wgmma_rs(dk_acc, da[kk], desc_sw128(qs + kk * 16 * 128, TQ * 128, 1024));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
      }
      mbar_arrive(empty0 + 8 * st);             // this thread is done with stage st
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kpos[i] >= S) continue;
    const size_t o = (((size_t)b * S + kpos[i]) * KV + g) * HD + 2 * (lane & 3);
#pragma unroll
    for (int nn = 0; nn < HD / 8; ++nn) {
      const int e = nn * 4 + i * 2;
      *reinterpret_cast<__nv_bfloat162*>(dk + o + nn * 8) =
          __floats2bfloat162_rn(dk_acc[e] * scale, dk_acc[e + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + nn * 8) =
          __floats2bfloat162_rn(dv_acc[e], dv_acc[e + 1]);
    }
  }
}

// grid ceil(S / bq) KV B; an item is bq = BM / qpk positions of one (b, KV
// head), the longest causal items first. q and dout through tensor maps
// over (hd, qpk, KV, S, B), k and v of KT-row boxes over (hd, KV, S, B);
// lse2, delta (B, H, sp); dq (B, S, H, hd) bf16 contiguous.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const float* __restrict__ lse2, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int S, int sp, int H, int KV, int B,
                         int qpk, int bq, int causal, int window, float softcap, float scale) {
  constexpr int Q_BYTES = BM * HD * 2, KV_BYTES = KT * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  // kv full[s], kv empty[s], q full
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 1];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + Q_BYTES;
  const uint32_t kv_s = base + 2 * Q_BYTES;   // stage st: K at kv_s + 2 st KV_BYTES, V after
  const uint32_t full0 = smem_addr(bars), empty0 = full0 + 8 * STAGES,
                 qfull = empty0 + 8 * STAGES;

  const int tid = threadIdx.x;
  const int n_qt = (S + bq - 1) / bq;
  const int qt = n_qt - 1 - blockIdx.x / (KV * B), rem = blockIdx.x % (KV * B);
  const int g = rem % KV, b = rem / KV;
  const int q0 = qt * bq, nq = min(bq, S - q0), R = nq * qpk, q_last = q0 + nq - 1;
  const int k_hi = causal ? min(S, q0 + nq) : S;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int n_tiles = (k_hi - k_lo + KT - 1) / KT;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, CONSUMERS);
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: one thread brings the item's Q and dO, then its K/V tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == CONSUMERS) {
      mbar_expect_tx(qfull, 2 * qpk * bq * HD * 2);
#pragma unroll
      for (int p = 0; p < HD / 64; ++p) {
        tma_load_5d(q_s + p * BM * 128, &tm_q, qfull, p * 64, 0, g, q0, b);
        tma_load_5d(do_s + p * BM * 128, &tm_do, qfull, p * 64, 0, g, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES;
        if (j >= STAGES) mbar_wait(empty0 + 8 * st, ((j / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st, ks = kv_s + st * 2 * KV_BYTES;
        mbar_expect_tx(full, 2 * KV_BYTES);
#pragma unroll
        for (int p = 0; p < HD / 64; ++p) {
          tma_load_4d(ks + p * KT * 128, &tm_k, full, p * 64, g, k_lo + j * KT, b);
          tma_load_4d(ks + KV_BYTES + p * KT * 128, &tm_v, full, p * 64, g, k_lo + j * KT, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const bool capped = softcap > 0.f;
  const float mul = capped ? scale / softcap : scale * LOG2E;
  const float cap = softcap * LOG2E;
  // this thread's two rows, their positions (-1: a padding row), heads,
  // lse in log2 units and D
  int qpos[2], head[2];
  float l2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * i;
    qpos[i] = r < R ? q0 + r / qpk : -1;
    head[i] = g * qpk + r % qpk;
    const size_t o = ((size_t)b * H + head[i]) * sp + max(qpos[i], 0);
    l2[i] = qpos[i] >= 0 ? lse2[o] : 0.f;
    dd[i] = qpos[i] >= 0 ? delta[o] : 0.f;
  }
  float dq_acc[HD / 2], s[KT / 2], dp[KT / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) s[i] = dp[i] = 0.f;
  mbar_wait(qfull, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    mbar_wait(full0 + 8 * st, (j / STAGES) & 1);   // tile j has landed
    const uint32_t ks = kv_s + st * 2 * KV_BYTES, vs = ks + KV_BYTES;

    // S = Q K^T and dP = dO V^T: 64 rows of this warpgroup x KT keys
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t panel = kk >> 2, col = (kk & 3) * 32;
      wgmma_ss(s, desc_sw128(q_s + panel * BM * 128 + wg * 64 * 128 + col, 16, 1024),
               desc_sw128(ks + panel * KT * 128 + col, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t panel = kk >> 2, col = (kk & 3) * 32;
      wgmma_ss(dp, desc_sw128(do_s + panel * BM * 128 + wg * 64 * 128 + col, 16, 1024),
               desc_sw128(vs + panel * KT * 128 + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    const int t0 = k_lo + j * KT;
    const bool edge = t0 + KT > k_hi || (causal && t0 + KT - 1 > q0) ||
                      (window > 0 && t0 <= q_last - window);
    // dS, rounded to bf16 and packed as the A fragments of the k16 steps
    // over this tile's keys
    uint32_t da[KT / 16][4];
#pragma unroll
    for (int nn = 0; nn < KT / 8; ++nn) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float dsv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float dt;
          const float x = score2(s[nn * 4 + i * 2 + c], mul, cap, capped, dt);
          const float p = ex2(x - l2[i]);
          float d = p * (dp[nn * 4 + i * 2 + c] - dd[i]) * dt;
          if (edge) {
            const int kpos = t0 + nn * 8 + 2 * (lane & 3) + c;
            if (qpos[i] < 0 || kpos >= k_hi || !live(qpos[i], kpos, causal, window)) d = 0.f;
          }
          dsv[c] = d;
        }
        da[nn >> 1][(nn & 1) * 2 + i] = pack_bf16(dsv[0], dsv[1]);
      }
    }

    // dQ += dS K: K MN-major from shared memory
    fence_regs(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      wgmma_rs(dq_acc, da[kk], desc_sw128(ks + kk * 16 * 128, KT * 128, 1024));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dq_acc);
    mbar_arrive(empty0 + 8 * st);               // this thread is done with stage st
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] < 0) continue;
    const size_t o = (((size_t)b * S + qpos[i]) * H + head[i]) * HD + 2 * (lane & 3);
#pragma unroll
    for (int nn = 0; nn < HD / 8; ++nn) {
      const int e = nn * 4 + i * 2;
      *reinterpret_cast<__nv_bfloat162*>(dq + o + nn * 8) =
          __floats2bfloat162_rn(dq_acc[e] * scale, dq_acc[e + 1] * scale);
    }
  }
}

template <int HD>
constexpr size_t dkdv_smem() {
  return 1024 + 2 * (size_t)BN * HD * 2 + STAGES * (2 * (size_t)TQ * HD * 2 + 2 * TQ * 4);
}
template <int HD>
constexpr size_t dq_smem() {
  return 1024 + 2 * (size_t)BM * HD * 2 + STAGES * 2 * (size_t)KT * HD * 2;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* lse, void* scratch, void* dq, void* dk, void* dv, int B, int S, int H,
           int KV, int qsb, int qss, int ksb, int kss, int causal, int window, float softcap,
           float scale, cudaStream_t stream) {
  const int qpk = H / KV, bq = BM / qpk, sp = (S + PAD - 1) / PAD * PAD;
  const int dsb = S * H * HD, dss = H * HD;   // dout's strides (contiguous)
  CUtensorMap tm_k, tm_v, tm_q, tm_do, tm_q5, tm_do5;
  if (!rows_map(&tm_k, k, B, S, KV, HD, ksb, kss, BN) ||
      !rows_map(&tm_v, v, B, S, KV, HD, ksb, kss, BN) ||
      !rows_map(&tm_q, q, B, S, H, HD, qsb, qss, TQ) ||
      !rows_map(&tm_do, dout, B, S, H, HD, dsb, dss, TQ) ||
      !gqa_map(&tm_q5, q, B, S, KV, qpk, bq, HD, qsb, qss) ||
      !gqa_map(&tm_do5, dout, B, S, KV, qpk, bq, HD, dsb, dss))
    return (int)cudaErrorInvalidValue;
  float* delta = (float*)scratch;
  float* lse2 = delta + (size_t)B * H * sp;

  const int rows = B * S * H;
  flash_bwd_prep_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(
      (const float*)out, (const __nv_bfloat16*)dout, (const float*)lse, delta, lse2, rows, S,
      sp, H, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = port::allow_smem(flash_bwd_dkdv_sm90_kernel<HD>, dkdv_smem<HD>());
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_sm90_kernel<HD><<<(S + BN - 1) / BN * KV * B, THREADS, dkdv_smem<HD>(),
                                   stream>>>(
      tm_k, tm_v, tm_q, tm_do, lse2, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, S, sp, H,
      KV, B, qpk, causal, window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = port::allow_smem(flash_bwd_dq_sm90_kernel<HD>, dq_smem<HD>());
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_sm90_kernel<HD><<<(S + bq - 1) / bq * KV * B, THREADS, dq_smem<HD>(), stream>>>(
      tm_q5, tm_do5, tm_k, tm_v, lse2, delta, (__nv_bfloat16*)dq, S, sp, H, KV, B, qpk, bq,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 only. q (B, S, H, hd) with element strides qsb, qss of its first two
// dimensions; k, v (B, S, KV, hd) with strides ksb, kss (the same for
// both); heads hd apart and hd contiguous; every row 16-byte aligned. out
// (B, S, H, hd) float32 (the forward's output before its cast), dout, dq
// (B, S, H, hd) bf16 and dk, dv (B, S, KV, hd) bf16, all contiguous and
// 16-byte aligned; lse (B, H, S) float32; scratch 2 B H S_pad float32,
// S_pad = S rounded up to a multiple of 64 (D and lse in log2 units).
// hd 64 or 128; H / KV <= 64. Three launches: prep, dK/dV, dQ. Returns a
// cudaError_t code (0 = launched; cudaErrorInvalidValue also when
// cuTensorMapEncodeTiled refuses a tensor map).
int flash_attention_bwd_sm90(int dtype, const void* q, const void* k, const void* v,
                             const void* out, const void* dout, const void* lse, void* scratch,
                             void* dq, void* dk, void* dv, int B, int S, int H, int KV, int hd,
                             int qsb, int qss, int ksb, int kss, int causal, int window,
                             float softcap, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != DTYPE_BF16 || H % KV || H / KV > 64) return (int)cudaErrorInvalidValue;
  if (hd == 64)
    return launch<64>(q, k, v, out, dout, lse, scratch, dq, dk, dv, B, S, H, KV, qsb, qss, ksb,
                      kss, causal, window, softcap, scale, s);
  if (hd == 128)
    return launch<128>(q, k, v, out, dout, lse, scratch, dq, dk, dv, B, S, H, KV, qsb, qss,
                       ksb, kss, causal, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
