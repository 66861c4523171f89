// The bf16 flash-attention forward on Hopper's tensor cores (wgmma).
//
//   * flash_fwd_sm90_kernel  <- src/repro/kernels/flash_attn.py:
//                               flash_attention_kernel (body _flash_kernel),
//                               the forward of _flash_core, in bfloat16
//
// The float32 forward stays the scalar kernel of flash_attn.cu: a TF32
// product would leave the float32 band, and path d trains in bf16.
//
// What bounds it on the card: operations. A (query tile, key tile) pair
// does 4 * hd FLOPs a score on tiles that stay in shared memory, far above
// the H100's ~295 Op/B knee, so the two products must run on the tensor
// cores: S = Q K^T and O += P V are wgmma.mma_async bf16 -> float32.
//
// Design:
//   * A work item is BM = 128 rows of one (batch, KV head), split between
//     two consumer warpgroups of 64 rows. Row r is position q0 + r / qpk
//     and head g * qpk + r % qpk, so each K/V tile is loaded once for the
//     whole GQA group; rows past nq * qpk (qpk need not divide 128) are
//     masked and never written.
//   * Blocks are persistent: one a streaming multiprocessor, each walking
//     the work items longest causal tile first, so one item's epilogue
//     and the next item's first loads overlap (12% less time at path d's
//     shape than a block an item, PERF.md).
//   * Q (two slots, one item ahead) and each K/V tile live in shared
//     memory in the 128-byte-swizzled layout the wgmma descriptors read
//     and TMA writes: rows of 64
//     bf16 (128 bytes), the 16-byte chunk c of row r stored at chunk
//     c ^ (r % 8), hd 128 split into two 64-column panels. Q and K are
//     K-major operands of S = Q K^T; V, stored the same way, is the
//     MN-major ("transposed") B operand of P V.
//   * All loads are TMA: a third warpgroup (the producer; one of its
//     threads works) issues each item's Q boxes into a free Q slot and
//     each K/V tile of KT = 128 keys into a free stage of a two-stage ring
//     that runs on across items; the hardware writes the swizzled layout
//     and reports to the slot's or stage's "full" mbarrier, and each
//     consumer thread arrives on its "empty" mbarrier once its
//     warpgroup's products are done with it. So no block-wide barrier
//     sits in the loops, loads overlap the products, and the two consumer
//     warpgroups drift apart, one's softmax overlapping the other's
//     products. The producer gives its registers to the consumers
//     (setmaxnreg 24 / 240): at the 168 a thread that 384 threads leave,
//     ptxas serialises the consumers' wgmma chains. The tensor maps are
//     encoded on the host for every call, from the strides: k and v over
//     their (hd, KV, S, B) view (rows past S read as zeros), q over (hd,
//     qpk, KV, S, B), whose boxes of qpk heads x bq positions are a work
//     item's rows in the GQA order.
//   * S stays in registers in the wgmma accumulator layout, where the
//     online softmax (float32 m, l, alpha, softcap tanh, mask gate) runs;
//     P is rounded to bf16 there (the reference's rounding point) and
//     repacked as the A fragment of the P V wgmma, which takes A from
//     registers: for 16-bit inputs the accumulator fragment of keys
//     16kk .. 16kk + 15 is exactly that A fragment.
//   * Each block bounds its key loop on the device from the causal and
//     window edges and runs the longest tiles first; only the tiles that
//     cross an edge evaluate the mask.
//
// Numerics follow the reference's forward: float32 scores, scale, softcap
// (softcap * tanh(s / softcap)), masks kpos < S, kpos <= qpos (causal),
// kpos > qpos - window; float32 m, l and accumulator; p rounded to bf16
// before PV; out = acc / max(l, 1e-37), also written in float32 when asked
// (the backward's D = rowsum(dO * O) reads it); lse = m + log(l), 0 where
// l == 0. p is gated by the mask (the reference's is not; its final
// result is the gated one, as a row's last tile always holds a live key).
// m is kept in log2 units (scale * log2(e) folded into one multiply a
// score) and p = 2^(x - m) comes from one ex2.approx; lse converts back.
// Its times on the card, and the designs tried before this one, are in
// PERF.md section 6.
#include "hopper.cuh"

using port::NEG_INF;
using namespace sm90;

namespace {

constexpr int BM = 128;        // query rows per block (two warpgroups of 64)
constexpr int KT = 128;        // keys per tile
constexpr int STAGES = 2;      // K/V tiles in flight
constexpr int CONSUMERS = 256; // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup

// grid min(items, SMs); an item is bq = BM / qpk positions of one (b, KV
// head), ceil(S / bq) KV B items in all. q, k, v through their tensor maps;
// out (B, S, H, hd) bf16, out32 (the same, float32, or null) and lse (B,
// H, S) float32 contiguous. Warps 0-7 are the two consumer warpgroups,
// warps 8-11 the producer.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ out32,
                      float* __restrict__ lse, int S, int H, int KV, int B, int qpk, int bq,
                      int causal, int window, float softcap, float scale) {
  constexpr int Q_BYTES = BM * HD * 2, KV_BYTES = KT * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  // kv full[s], kv empty[s], q full[2], q empty[2]
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 4];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s0 = base;                 // Q slot i at q_s0 + i Q_BYTES
  const uint32_t kv_s = base + 2 * Q_BYTES;   // stage st: K at kv_s + 2 st KV_BYTES, V after
  const uint32_t full0 = smem_addr(bars), empty0 = full0 + 8 * STAGES;
  const uint32_t qfull0 = empty0 + 8 * STAGES, qempty0 = qfull0 + 16;

  const int tid = threadIdx.x;
  const int n_qt = (S + bq - 1) / bq;
  const int n_work = n_qt * KV * B;
  // work item w: the longest causal tiles first, over every (batch, head)
  const auto item = [&](int w, int& q0, int& nq, int& g, int& b, int& k_lo, int& k_hi) {
    const int qt = n_qt - 1 - w / (KV * B), rem = w % (KV * B);
    g = rem % KV;
    b = rem / KV;
    q0 = qt * bq;
    nq = min(bq, S - q0);
    k_hi = causal ? min(S, q0 + nq) : S;
    k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  };

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, CONSUMERS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull0 + 8 * i, 1);
      mbar_init(qempty0 + 8 * i, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: one thread brings each item's Q into a free Q slot and
    // keeps STAGES K/V tiles in flight across items
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == CONSUMERS) {
      int it = 0, n = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++n) {
        int q0, nq, g, b, k_lo, k_hi;
        item(w, q0, nq, g, b, k_lo, k_hi);
        const int slot = n & 1;
        if (n >= 2) mbar_wait(qempty0 + 8 * slot, ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(qfull0 + 8 * slot, qpk * bq * HD * 2);
#pragma unroll
        for (int p = 0; p < HD / 64; ++p)
          tma_load_5d(q_s0 + slot * Q_BYTES + p * BM * 128, &tm_q, qfull0 + 8 * slot, p * 64, 0,
                      g, q0, b);
        const int n_tiles = (k_hi - k_lo + KT - 1) / KT;
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES) mbar_wait(empty0 + 8 * st, ((it / STAGES) & 1) ^ 1);
          const uint32_t full = full0 + 8 * st, ks = kv_s + st * 2 * KV_BYTES;
          mbar_expect_tx(full, 2 * KV_BYTES);
#pragma unroll
          for (int p = 0; p < HD / 64; ++p) {
            tma_load_4d(ks + p * KT * 128, &tm_k, full, p * 64, g, k_lo + j * KT, b);
            tma_load_4d(ks + KV_BYTES + p * KT * 128, &tm_v, full, p * 64, g, k_lo + j * KT, b);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  // scores in log2 units: s * scale * log2(e), or under a softcap
  // softcap * log2(e) * tanh(s * scale / softcap)
  const float mul = softcap > 0.f ? scale / softcap : scale * LOG2E;
  const float cap = softcap * LOG2E;
  float o[HD / 2], s[KT / 2];
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) s[i] = 0.f;

  int it = 0, n = 0;
  for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++n) {
    int q0, nq, g, b, k_lo, k_hi;
    item(w, q0, nq, g, b, k_lo, k_hi);
    const int R = nq * qpk, q_last = q0 + nq - 1;
    const int n_tiles = (k_hi - k_lo + KT - 1) / KT;
    // this thread's two rows (accumulator rows lane / 4 and lane / 4 + 8 of
    // its warp's 16) and their positions (-1: a padding row)
    int qpos[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * i;
      qpos[i] = r < R ? q0 + r / qpk : -1;
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
    const int slot = n & 1;
    const uint32_t q_s = q_s0 + slot * Q_BYTES;
    mbar_wait(qfull0 + 8 * slot, (n >> 1) & 1);   // this item's Q has landed

    for (int j = 0; j < n_tiles; ++j, ++it) {
      const int st = it % STAGES;
      mbar_wait(full0 + 8 * st, (it / STAGES) & 1);   // tile j has landed
      const uint32_t ks = kv_s + st * 2 * KV_BYTES, vs = ks + KV_BYTES;

      // S = Q K^T: 64 rows of this warpgroup x KT keys, hd / 16 steps
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t panel = kk >> 2, col = (kk & 3) * 32;
        wgmma_ss(s, desc_sw128(q_s + panel * BM * 128 + wg * 64 * 128 + col, 16, 1024),
                 desc_sw128(ks + panel * KT * 128 + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      if (j == n_tiles - 1) mbar_arrive(qempty0 + 8 * slot);   // done with this Q

      const int t0 = k_lo + j * KT;
      const bool edge = t0 + KT > k_hi || (causal && t0 + KT - 1 > q0) ||
                        (window > 0 && t0 <= q_last - window);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m_r[i];
#pragma unroll
        for (int nn = 0; nn < KT / 8; ++nn) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = s[nn * 4 + i * 2 + c] * mul;
            if (softcap > 0.f) x = cap * tanhf(x);
            if (edge) {
              const int kpos = t0 + nn * 8 + 2 * (lane & 3) + c;
              if (qpos[i] < 0 || kpos >= k_hi || !live(qpos[i], kpos, causal, window))
                x = -INFINITY;
            }
            s[nn * 4 + i * 2 + c] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = ex2(m_r[i] - mx);
        m_r[i] = mx;
        float sum = 0.f;
#pragma unroll
        for (int nn = 0; nn < KT / 8; ++nn) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = ex2(s[nn * 4 + i * 2 + c] - mx);   // 0 where masked (-inf)
            sum += p;
            s[nn * 4 + i * 2 + c] = p;
          }
        }
        l_r[i] = l_r[i] * alpha + sum;         // this thread's share of the row
#pragma unroll
        for (int nn = 0; nn < HD / 8; ++nn) {
          o[nn * 4 + i * 2] *= alpha;
          o[nn * 4 + i * 2 + 1] *= alpha;
        }
      }

      // O += P V: P (bf16) from registers, V MN-major from shared memory
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[8 * kk + 0], s[8 * kk + 1]),
                               pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                               pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                               pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
        wgmma_rs(o, a, desc_sw128(vs + kk * 16 * 128, KT * 128, 1024));
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
      mbar_arrive(empty0 + 8 * st);             // this thread is done with stage st
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_r[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (qpos[i] < 0) continue;
      const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * i;
      const int h = g * qpk + r % qpk;
      const size_t base_o = (((size_t)b * S + qpos[i]) * H + h) * HD + 2 * (lane & 3);
      const float den = fmaxf(l, 1e-37f);
#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn) {
        const float x0 = o[nn * 4 + i * 2] / den, x1 = o[nn * 4 + i * 2 + 1] / den;
        *reinterpret_cast<__nv_bfloat162*>(out + base_o + nn * 8) = __floats2bfloat162_rn(x0, x1);
        if (out32) *reinterpret_cast<float2*>(out32 + base_o + nn * 8) = make_float2(x0, x1);
      }
      if ((lane & 3) == 0)
        lse[((size_t)b * H + h) * S + qpos[i]] = l > 0.f ? m_r[i] / LOG2E + logf(l) : 0.f;
    }
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return 1024 + 2 * (size_t)BM * HD * 2 + STAGES * 2 * (size_t)KT * HD * 2;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, void* out32, void* lse,
           int B, int S, int H, int KV, int qsb, int qss, int ksb, int kss, int causal,
           int window, float softcap, float scale, cudaStream_t stream) {
  const int qpk = H / KV, bq = BM / qpk;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!gqa_map(&tm_q, q, B, S, KV, qpk, bq, HD, qsb, qss) ||
      !rows_map(&tm_k, k, B, S, KV, HD, ksb, kss, KT) ||
      !rows_map(&tm_v, v, B, S, KV, HD, ksb, kss, KT))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = port::allow_smem(flash_fwd_sm90_kernel<HD>, smem_bytes<HD>());
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_work = (S + bq - 1) / bq * KV * B;
  flash_fwd_sm90_kernel<HD><<<min(n_work, sms), THREADS, smem_bytes<HD>(), stream>>>(
      tm_q, tm_k, tm_v, (__nv_bfloat16*)out, (float*)out32, (float*)lse, S, H, KV, B, qpk, bq,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 only. q (B, S, H, hd) with element strides qsb, qss of its first two
// dimensions; k, v (B, S, KV, hd) with strides ksb, kss (the same for
// both); heads hd apart and hd contiguous; every row 16-byte aligned. out
// (B, S, H, hd) bf16, out32 (B, S, H, hd) float32 or null, lse (B, H, S)
// float32, all contiguous. hd 64 or 128; H / KV <= 64. Returns a
// cudaError_t code (0 = launched; cudaErrorInvalidValue also when
// cuTensorMapEncodeTiled refuses a tensor map).
int flash_attention_fwd_sm90(int dtype, const void* q, const void* k, const void* v,
                             void* out, void* out32, void* lse, int B, int S, int H, int KV,
                             int hd, int qsb, int qss, int ksb, int kss, int causal,
                             int window, float softcap, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != DTYPE_BF16 || H % KV || H / KV > 64) return (int)cudaErrorInvalidValue;
  if (hd == 64)
    return launch<64>(q, k, v, out, out32, lse, B, S, H, KV, qsb, qss, ksb, kss, causal,
                      window, softcap, scale, s);
  if (hd == 128)
    return launch<128>(q, k, v, out, out32, lse, B, S, H, KV, qsb, qss, ksb, kss, causal,
                       window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
