// GQA flash attention, the dq backward pass, on Hopper's tensor cores
// (sm_90a, bf16).
//
// Replaces the Pallas TPU kernel `_bwd_dq_kernel` of `_bwd_call` in
// src/repro/kernels/flash_attention.py (K5a), for bf16 q, k, v, dO at dh 64
// or 128 (the `sm90` route of kernels/flash_attention.py; fp32 and every
// other dh take the CUDA-core kernel of flash_attention_bwd.cu, the `simt`
// route).
// Same function: with the forward's mask (flash_attention_fwd_sm90.cu), its
// saved lse (fp32) and delta = rowsum(dO * o) (fp32, from the caller),
//   p  = valid ? exp(s - lse) : 0,   s = (q k^T) * scale,
//   ds = p * (dO v^T - delta),
//   dq = scale * ds k                                   (in q's dtype).
//
// What bounds it on this card: at the hybrid's train shape (B 4, H 16,
// S 2048, dh 128, causal) the three products over the causal half are
// ~103 GFLOP, 0.104 ms at the 989 TFLOP/s bf16 tensor-core rate, against
// ~0.05 ms for its bytes: operations. So every product runs on the tensor
// cores (wgmma) while TMA streams the next kv tiles.
//
// Design:
// * One block per (b, q head, 128-row q tile), longest causal band first
//   (grid y reversed), 256 threads: two warpgroups own 64 q rows each, and
//   warp 0 also issues the loads (K5b's layout: no producer warpgroup, so
//   the block keeps the whole register file; with 384 threads ptxas holds
//   every thread to 168 registers, PERF.md). Q and dO (2 x 32 KB at dh
//   128) are loaded once by TMA; each thread keeps the lse·log2(e) and
//   delta of its two rows in registers (lse = +inf past Sq, so p = 0
//   there without a mask).
// * K and V tiles of 64 rows stream through a 4-stage ring (4 x 32 KB,
//   full / empty mbarriers) from 3-D tensor maps (dh, S, B·Hkv); warp 0
//   refills the stage of tile i - 1 with tile i + 3 after computing tile i.
// * S = Q K^T and dP = dO V^T are wgmma m64n64k16 from shared memory (all
//   K-major); P = exp2(S·scale·log2(e) - lse·log2(e)), masked only on tiles
//   that cross the diagonal, the window edge or kv_len; dS = P (dP -
//   delta) becomes bf16 A fragments in registers (acc_to_a) for
//   dQ += dS K, wgmma m64nDHk16 with K MN-major (the transpose bit). dS is
//   rounded to bf16 there where the reference keeps fp32: the tests hold dq
//   to the bf16 limit plus 2^-8 scale |dS| |K| (sm90_rounding_bound).
// * A warpgroup skips the products of a tile none of its 64 rows can see
//   (the diagonal tile of the upper rows, the window's far edge) but still
//   releases the stage.
// * dQ accumulates in fp32 registers (64 a thread at dh 128), scale is
//   applied once at the end, and each block owns its rows: no atomics, so
//   two launches agree bit for bit.

#include "sm90.cuh"

namespace {

constexpr int BQ = 128;        // q rows per block (2 warpgroups)
constexpr int BK = 64;         // kv rows per streamed tile
constexpr int STAGES = 4;
constexpr int THREADS = 256;   // 2 warpgroups; warp 0 also issues the loads
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Layout {
  static constexpr int QT = BQ * DH * 2;   // bytes of the q or dO tile
  static constexpr int KV = BK * DH * 2;   // bytes of one k or v tile
  static constexpr int q = 0;
  static constexpr int dout = QT;
  __host__ __device__ static constexpr int k(int s) { return 2 * QT + s * 2 * KV; }
  __host__ __device__ static constexpr int v(int s) { return 2 * QT + s * 2 * KV + KV; }
  static constexpr int bars = 2 * QT + STAGES * 2 * KV;  // q, full[S], empty[S]
  static constexpr int bytes = bars + 8 * (1 + 2 * STAGES) + 1024;
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int hq, int hkv,
                         int sq, int q_offset, int kv_len, int causal,
                         int has_window, int window, float scale) {
  using L = Layout<DH>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::bars;
  auto bar_full = [&](int s) { return bar_q + 8 + 8 * s; };
  auto bar_empty = [&](int s) { return bar_q + 8 + 8 * STAGES + 8 * s; };

  const int bh = blockIdx.x;                       // b * hq + h
  const int iq = gridDim.y - 1 - blockIdx.y;       // longest band first
  const int bg = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = iq * BQ;

  // The kv band of this q tile: _kv_band as run-time loop bounds.
  int hi = (kv_len + BK - 1) / BK - 1;
  if (causal) hi = min(hi, sm90::floordiv(q_offset + min(q0 + BQ, sq) - 1, BK));
  int lo = 0;
  if (has_window)
    lo = max(0, sm90::floordiv(q_offset + q0 - (window - 1), BK));
  const int n = max(0, hi - lo + 1);

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(bar_full(s), 1);
      sm90::mbar_init(bar_empty(s), THREADS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  // Lane 0 of warp 0 loads kv tile lo + j into stage j % STAGES.
  auto load_tile = [&](int j) {
    const int st = j % STAGES;
    sm90::mbar_arrive_expect_tx(bar_full(st), 2 * L::KV);
#pragma unroll
    for (int c = 0; c < DH / 64; ++c) {
      sm90::tma_load_3d(base + L::k(st) + c * BK * 128, &tm_k, bar_full(st),
                        64 * c, (lo + j) * BK, bg);
      sm90::tma_load_3d(base + L::v(st) + c * BK * 128, &tm_v, bar_full(st),
                        64 * c, (lo + j) * BK, bg);
    }
  };
  if (threadIdx.x == 0 && n > 0) {
    sm90::mbar_arrive_expect_tx(bar_q, 2 * L::QT);
#pragma unroll
    for (int c = 0; c < DH / 64; ++c) {
      sm90::tma_load_3d(base + L::q + c * BQ * 128, &tm_q, bar_q, 64 * c, q0,
                        bh);
      sm90::tma_load_3d(base + L::dout + c * BQ * 128, &tm_do, bar_q, 64 * c,
                        q0, bh);
    }
    for (int j = 0; j < min(n, STAGES); ++j) load_tile(j);
  }

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int rw = 64 * wg;                        // first q row of the group
  const int r0 = (t / 32) * 16 + lane / 4;       // q rows r0 and r0 + 8
  const int c0 = 2 * (lane % 4);                 // first key column of a block
  const float sl2 = scale * LOG2E;
  const int qpos0 = q_offset + q0 + rw;          // first query of the group
  float lrow[2], drow[2];                        // lse·log2(e), delta per row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rw + r0 + 8 * i;
    const bool in = row < sq;
    lrow[i] = in ? lse[(size_t)bh * sq + row] * LOG2E : INFINITY;
    drow[i] = in ? delta[(size_t)bh * sq + row] : 0.f;
  }
  // The kv tiles this group's rows can see (the block's band serves both).
  const int last_q = min(qpos0 + 63, q_offset + sq - 1);
  int ghi = hi, glo = lo;
  if (causal) ghi = min(ghi, sm90::floordiv(last_q, BK));
  if (has_window) glo = max(glo, sm90::floordiv(qpos0 - (window - 1), BK));

  float acc[DH / 2];
#pragma unroll
  for (int r = 0; r < DH / 2; ++r) acc[r] = 0.f;

  if (n > 0) sm90::mbar_wait(bar_q, 0);
  for (int i = 0; i < n; ++i) {
    const int stage = i % STAGES;
    const int it = lo + i;
    const int k0 = it * BK;
    sm90::mbar_wait(bar_full(stage), (i / STAGES) & 1);

    if (it >= glo && it <= ghi) {
      // -- S = Q K^T and dP = dO V^T ---------------------------------------
      float s[32], dp[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) s[r] = dp[r] = 0.f;
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        // column block kk / 4 of each tile, 32 bytes a k-step along its rows
        const uint32_t a_off = (kk / 4) * BQ * 128 + rw * 128 + (kk % 4) * 32;
        const uint32_t b_off = (kk / 4) * BK * 128 + (kk % 4) * 32;
        sm90::MmaSS<64, 0>::run(
            s, sm90::desc_sw128(base + L::q + a_off, 16, 1024),
            sm90::desc_sw128(base + L::k(stage) + b_off, 16, 1024), kk > 0);
        sm90::MmaSS<64, 0>::run(
            dp, sm90::desc_sw128(base + L::dout + a_off, 16, 1024),
            sm90::desc_sw128(base + L::v(stage) + b_off, 16, 1024), kk > 0);
      }
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);

      // -- P, dS: register r is query r0 (+8), key column 8(r/4) + c0 -----
      const bool interior =
          k0 + BK <= kv_len && (!causal || qpos0 >= k0 + BK - 1) &&
          (!has_window || qpos0 + 63 - k0 < window);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int h = (r >> 1) & 1;
        float p = exp2f(s[r] * sl2 - lrow[h]);
        if (!interior) {
          const int qpos = qpos0 + r0 + 8 * h;
          const int kpos = k0 + 8 * (r >> 2) + c0 + (r & 1);
          bool ok = kpos < kv_len;
          if (causal) ok = ok && qpos >= kpos;
          if (has_window) ok = ok && qpos - kpos < window;
          p = ok ? p : 0.f;
        }
        dp[r] = p * (dp[r] - drow[h]);
      }
      uint32_t da[16];
      sm90::acc_to_a(dp, da);

      // -- dQ += dS K ------------------------------------------------------
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)   // 16 kv rows a k-step
        sm90::MmaRS<DH, 1>::run(
            acc, &da[4 * kk],
            sm90::desc_sw128(base + L::k(stage) + kk * 16 * 128, BK * 128,
                             1024),
            1);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(acc);
    }
    sm90::mbar_arrive(bar_empty(stage));
    // Refill the stage of tile i - 1 with tile i - 1 + STAGES once both
    // warpgroups have released it. The whole warp waits, so it stays
    // converged for the next wgmma.
    if (warp == 0 && i >= 1 && i - 1 + STAGES < n) {
      sm90::mbar_wait(bar_empty((i - 1) % STAGES), ((i - 1) / STAGES) & 1);
      if (lane == 0) load_tile(i - 1 + STAGES);
      __syncwarp();
    }
  }

  // -- epilogue: dq = scale · acc, rows below sq ---------------------------
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rw + r0 + 8 * i;
    if (row >= sq) continue;
    __nv_bfloat16* drow_out = dq + ((size_t)bh * sq + row) * DH + c0;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(drow_out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * scale,
                                acc[4 * j + 2 * i + 1] * scale);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int b, int hq,
           int hkv, int sq, int sk, int q_offset, int kv_len, int causal,
           int has_window, int window, float scale, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  if (!sm90::make_map(&tq, q, b * hq, sq, DH, BQ) ||
      !sm90::make_map(&tdo, dout, b * hq, sq, DH, BQ) ||
      !sm90::make_map(&tk, k, b * hkv, sk, DH, BK) ||
      !sm90::make_map(&tv, v, b * hkv, sk, DH, BK))
    return (int)cudaErrorInvalidValue;
  const int smem = Layout<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_sm90_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * hq, (sq + BQ - 1) / BQ);
  flash_bwd_dq_sm90_kernel<DH><<<grid, THREADS, smem, stream>>>(
      tq, tdo, tk, tv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), hq,
      hkv, sq, q_offset, kv_len, causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout, dq: (b, hq, sq, dh); k, v: (b, hkv, sk, dh), all bf16 (is_bf16
// must be 1), contiguous, 16-byte aligned; lse, delta: (b, hq, sq) fp32.
// Needs dh in {64, 128}, hq % hkv == 0, 1 <= kv_len <= sk (the wrapper
// checks). Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for what it does not take or a tensor map the
// driver refuses.
extern "C" int flash_attention_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int b, int hq, int hkv,
    int sq, int sk, int dh, int q_offset, int kv_len, int causal,
    int has_window, int window, int is_bf16, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return (int)cudaErrorInvalidValue;
  if (dh == 64)
    return launch<64>(q, k, v, dout, lse, delta, dq, b, hq, hkv, sq, sk,
                      q_offset, kv_len, causal, has_window, window, scale, st);
  if (dh == 128)
    return launch<128>(q, k, v, dout, lse, delta, dq, b, hq, hkv, sq, sk,
                       q_offset, kv_len, causal, has_window, window, scale,
                       st);
  return (int)cudaErrorInvalidValue;
}
