// GQA flash attention, the dk/dv backward pass, on Hopper's tensor cores
// (sm_90a, bf16).
//
// Replaces the Pallas TPU kernel `_bwd_dkv_kernel` of `_bwd_call` in
// src/repro/kernels/flash_attention.py (K5b), for bf16 q, k, v, dO at dh 64
// or 128 (the `sm90` route of kernels/flash_attention.py; fp32 and every
// other dh take the CUDA-core kernel of flash_attention_bwd.cu, the `simt`
// route).
// Same function: with the forward's mask (flash_attention_fwd_sm90.cu), its
// saved lse (fp32) and delta = rowsum(dO * o) (fp32, from the caller),
//   p  = valid ? exp(s - lse) : 0,   s = (q k^T) * scale,
//   ds = p * (dO v^T - delta),
//   dv = sum over the GQA group of p^T dO,
//   dk = scale * sum over the GQA group of ds^T q      (both in k's dtype).
//
// What bounds it on this card: at the hybrid's train shape (B 4, H 16,
// S 2048, dh 128, causal) the four products over the causal half are
// ~137 GFLOP, 0.139 ms at the 989 TFLOP/s bf16 tensor-core rate, against
// ~0.08 ms for its bytes: operations. So every product runs on the tensor
// cores (wgmma) while TMA streams the next tiles.
//
// Design:
// * One block per (b, kv head, 128-row kv tile): two warpgroups own 64 kv
//   rows each. K and V are loaded once and stay in shared memory (2 x 32 KB
//   at dh 128).
// * For each of the group's Hq/Hkv heads and each 64-row q tile of the
//   transposed band (the run-time `_q_band` bounds of
//   flash_attention_bwd.cu, for 128-row kv tiles) the Q and dO tiles
//   stream through a 3-stage ring (3 x 2 x 16 KB, full / empty mbarriers)
//   by TMA from 3-D tensor maps (dh, S, B·H), with that tile's lse·log2(e)
//   and delta rows beside them (lse = +inf past Sq, so p = 0 there without
//   a mask).
// * No producer warp: warp 0 also issues the loads, refilling the stage of
//   tile i - 1 with tile i + 2 after computing tile i. The block keeps the
//   whole register file for the two warpgroups (235 registers a thread at
//   dh 128, no spills). With a separate producer warpgroup the block has
//   384 threads, ptxas compiles every thread within 168 registers whatever
//   setmaxnreg asks for, and the 192 accumulator registers spill and
//   serialise the wgmmas (PERF.md, Findings).
// * All products in transposed form, so nothing goes back through shared
//   memory: S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, everything
//   K-major in shared memory); P^T = exp2(S^T·scale·log2(e) - lse·log2(e)),
//   masked only on tiles that cross the diagonal, the window edge or kv_len;
//   dS^T = P^T (dP^T - delta); then P^T and dS^T become bf16 A fragments in
//   registers for dV += P^T dO and dK += dS^T Q (wgmma m64nDHk16, dO and Q
//   MN-major: the transpose bit). P and dS are rounded to bf16 there where
//   the reference keeps fp32: the tests hold dv to the bf16 limit plus
//   2^-8 P^T |dO| and dk plus 2^-8 scale |dS|^T |Q|.
// * dK and dV accumulate in fp32 registers (128 a thread at dh 128) over the
//   whole GQA group and are written once: no atomics, so the result is the
//   same bit for bit on every launch. A kv tile past kv_len gets zeros.

#include "sm90.cuh"

namespace {

constexpr int BKV = 128;       // kv rows per block (2 warpgroups)
constexpr int BQ = 64;         // q rows per streamed tile
constexpr int STAGES = 3;
constexpr int THREADS = 256;   // 2 warpgroups; warp 0 also issues the loads
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Layout {
  static constexpr int KV = BKV * DH * 2;  // bytes of the k or v tile
  static constexpr int QT = BQ * DH * 2;   // bytes of a q or dO tile
  static constexpr int k = 0;
  static constexpr int v = KV;
  __host__ __device__ static constexpr int q(int s) { return 2 * KV + s * 2 * QT; }
  __host__ __device__ static constexpr int dout(int s) { return 2 * KV + s * 2 * QT + QT; }
  // per stage: lse·log2(e) [BQ] then delta [BQ], fp32
  __host__ __device__ static constexpr int rows(int s) { return 2 * KV + STAGES * 2 * QT + s * 8 * BQ; }
  static constexpr int bars = 2 * KV + STAGES * (2 * QT + 8 * BQ);
  static constexpr int bytes = bars + 8 * (1 + 2 * STAGES) + 1024;
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int hq, int hkv,
                          int sq, int sk, int q_offset, int kv_len,
                          int causal, int has_window, int window,
                          float scale) {
  using L = Layout<DH>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - sm90::smem_u32(smem_raw));
  const uint32_t bar_kv = base + L::bars;
  auto bar_full = [&](int s) { return bar_kv + 8 + 8 * s; };
  auto bar_empty = [&](int s) { return bar_kv + 8 + 8 * STAGES + 8 * s; };

  const int bg = blockIdx.x;                       // b * hkv + kv head
  const int b = bg / hkv, g = bg % hkv;
  const int rep = hq / hkv;
  const int k0 = blockIdx.y * BKV;
  const int krows = min(BKV, sk - k0);

  // The transposed band of this kv tile (_q_band as run-time loop bounds):
  // q tiles holding a row that may see one of keys k0 .. klast.
  const int klast = min(k0 + krows, kv_len) - 1;
  const int nq = (sq + BQ - 1) / BQ;
  int lo = 0, hi = -1;
  if (klast >= k0) {
    hi = nq - 1;
    if (causal) lo = max(0, sm90::floordiv(k0 - q_offset, BQ));
    if (has_window)
      hi = min(hi, sm90::floordiv(klast + window - 1 - q_offset, BQ));
  }

  // The stream: tile j is query head g·rep + j / nb, q tile lo + j % nb.
  const int nb = hi - lo + 1;
  const int n = (lo <= hi) ? rep * nb : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(bar_full(s), 1 + 32);   // expect_tx + warp 0's rows
      sm90::mbar_init(bar_empty(s), THREADS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  // Warp 0 loads tile j into stage j % STAGES: the lse·log2(e) and delta
  // rows by its lanes, the Q and dO boxes by TMA from lane 0.
  auto load_tile = [&](int j) {
    const int lane = threadIdx.x % 32, st = j % STAGES;
    const int bh = b * hq + g * rep + j / nb;
    const int q0 = (lo + j % nb) * BQ;
    float* rows = reinterpret_cast<float*>(gbase + L::rows(st));
#pragma unroll
    for (int r = lane; r < BQ; r += 32) {
      const int row = q0 + r;
      const bool in = row < sq;
      rows[r] = in ? lse[(size_t)bh * sq + row] * LOG2E : INFINITY;
      rows[BQ + r] = in ? delta[(size_t)bh * sq + row] : 0.f;
    }
    sm90::mbar_arrive(bar_full(st));
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(bar_full(st), 2 * L::QT);
#pragma unroll
      for (int c = 0; c < DH / 64; ++c) {
        sm90::tma_load_3d(base + L::q(st) + c * BQ * 128, &tm_q,
                          bar_full(st), 64 * c, q0, bh);
        sm90::tma_load_3d(base + L::dout(st) + c * BQ * 128, &tm_do,
                          bar_full(st), 64 * c, q0, bh);
      }
    }
  };
  if (warp == 0 && n > 0) {
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(bar_kv, 2 * L::KV);
#pragma unroll
      for (int c = 0; c < DH / 64; ++c) {
        sm90::tma_load_3d(base + L::k + c * BKV * 128, &tm_k, bar_kv, 64 * c,
                          k0, bg);
        sm90::tma_load_3d(base + L::v + c * BKV * 128, &tm_v, bar_kv, 64 * c,
                          k0, bg);
      }
    }
    for (int j = 0; j < min(n, STAGES); ++j) load_tile(j);
  }

  const int t = threadIdx.x % 128, lane = t % 32;
  const int rw = 64 * (threadIdx.x / 128);       // first kv row of the group
  const int r0 = (t / 32) * 16 + lane / 4;       // kv rows r0 and r0 + 8
  const int c0 = 2 * (lane % 4);                 // first q column of a block
  const float sl2 = scale * LOG2E;
  const int kpos0 = k0 + rw;                     // first key of the group
  float acc_k[DH / 2], acc_v[DH / 2];
#pragma unroll
  for (int r = 0; r < DH / 2; ++r) acc_k[r] = acc_v[r] = 0.f;

  if (n > 0) sm90::mbar_wait(bar_kv, 0);
  for (int i = 0; i < n; ++i) {
    const int stage = i % STAGES;
    const int q0 = (lo + i % nb) * BQ;
    sm90::mbar_wait(bar_full(stage), (i / STAGES) & 1);

    // -- S^T = K Q^T and dP^T = V dO^T ------------------------------------
    float s[32], dp[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r] = dp[r] = 0.f;
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      // column block kk / 4 of each tile, 32 bytes a k-step along its rows
      const uint32_t a_off = (kk / 4) * BKV * 128 + rw * 128 + (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * BQ * 128 + (kk % 4) * 32;
      sm90::MmaSS<64, 0>::run(
          s, sm90::desc_sw128(base + L::k + a_off, 16, 1024),
          sm90::desc_sw128(base + L::q(stage) + b_off, 16, 1024), kk > 0);
      sm90::MmaSS<64, 0>::run(
          dp, sm90::desc_sw128(base + L::v + a_off, 16, 1024),
          sm90::desc_sw128(base + L::dout(stage) + b_off, 16, 1024), kk > 0);
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

    // -- P^T, dS^T: register r is key r0 (+8), query column c ------------
    const float* rows =
        reinterpret_cast<const float*>(gbase + L::rows(stage));
    const int qpos0 = q_offset + q0;
    const bool interior =
        kpos0 + 64 <= kv_len && (!causal || qpos0 >= kpos0 + 63) &&
        (!has_window || qpos0 + BQ - 1 - kpos0 < window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + c0;
      const float2 l2 = *reinterpret_cast<const float2*>(rows + col);
      const float2 d2 = *reinterpret_cast<const float2*>(rows + BQ + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * j + e;
        float p = exp2f(s[r] * sl2 - ((e & 1) ? l2.y : l2.x));
        if (!interior) {
          const int kpos = kpos0 + r0 + 8 * (e >> 1);
          const int qpos = qpos0 + col + (e & 1);
          bool ok = kpos < kv_len;
          if (causal) ok = ok && qpos >= kpos;
          if (has_window) ok = ok && qpos - kpos < window;
          p = ok ? p : 0.f;
        }
        dp[r] = p * (dp[r] - ((e & 1) ? d2.y : d2.x));
        s[r] = p;
      }
    }
    uint32_t pa[16], da[16];
    sm90::acc_to_a(s, pa);
    sm90::acc_to_a(dp, da);

    // -- dV += P^T dO, dK += dS^T Q -------------------------------------
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {   // 16 q rows a k-step
      const uint32_t off = kk * 16 * 128;
      sm90::MmaRS<DH, 1>::run(
          acc_v, &pa[4 * kk],
          sm90::desc_sw128(base + L::dout(stage) + off, BQ * 128, 1024), 1);
      sm90::MmaRS<DH, 1>::run(
          acc_k, &da[4 * kk],
          sm90::desc_sw128(base + L::q(stage) + off, BQ * 128, 1024), 1);
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(acc_v);
    sm90::fence_regs(acc_k);
    sm90::mbar_arrive(bar_empty(stage));
    // Refill the stage of tile i - 1 with tile i - 1 + STAGES once both
    // warpgroups have released it (the other group is rarely a tile
    // behind, so this seldom waits).
    if (warp == 0 && i >= 1 && i - 1 + STAGES < n) {
      sm90::mbar_wait(bar_empty((i - 1) % STAGES), ((i - 1) / STAGES) & 1);
      load_tile(i - 1 + STAGES);
    }
  }

  // -- epilogue: dk = scale · acc_k, dv = acc_v, rows below sk ----------
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kpos0 + r0 + 8 * i;
    if (row >= sk) continue;
    const size_t at = ((size_t)bg * sk + row) * DH + c0;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(acc_k[4 * j + 2 * i] * scale,
                                acc_k[4 * j + 2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(acc_v[4 * j + 2 * i],
                                acc_v[4 * j + 2 * i + 1]);
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int b,
           int hq, int hkv, int sq, int sk, int q_offset, int kv_len,
           int causal, int has_window, int window, float scale,
           cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  if (!sm90::make_map(&tq, q, b * hq, sq, DH, BQ) ||
      !sm90::make_map(&tdo, dout, b * hq, sq, DH, BQ) ||
      !sm90::make_map(&tk, k, b * hkv, sk, DH, BKV) ||
      !sm90::make_map(&tv, v, b * hkv, sk, DH, BKV))
    return (int)cudaErrorInvalidValue;
  const int smem = Layout<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * hkv, (sk + BKV - 1) / BKV);
  flash_bwd_dkv_sm90_kernel<DH><<<grid, THREADS, smem, stream>>>(
      tq, tdo, tk, tv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), hq, hkv, sq, sk, q_offset, kv_len,
      causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout: (b, hq, sq, dh); k, v: (b, hkv, sk, dh), all bf16 (is_bf16 must
// be 1), contiguous, 16-byte aligned; lse, delta: (b, hq, sq) fp32; dk, dv
// like k. Needs dh in {64, 128}, hq % hkv == 0, 1 <= kv_len <= sk (the
// wrapper checks). Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for what it does not take or a tensor map the
// driver refuses.
extern "C" int flash_attention_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int hq,
    int hkv, int sq, int sk, int dh, int q_offset, int kv_len, int causal,
    int has_window, int window, int is_bf16, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return (int)cudaErrorInvalidValue;
  if (dh == 64)
    return launch<64>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, sq, sk,
                      q_offset, kv_len, causal, has_window, window, scale,
                      st);
  if (dh == 128)
    return launch<128>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, sq, sk,
                       q_offset, kv_len, causal, has_window, window, scale,
                       st);
  return (int)cudaErrorInvalidValue;
}
