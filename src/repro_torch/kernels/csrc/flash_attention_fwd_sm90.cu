// GQA flash attention, forward, on Hopper's tensor cores (sm_90a, bf16).
//
// Replaces the Pallas TPU kernel `_fwd_call` / `_fwd_kernel` in
// src/repro/kernels/flash_attention.py, for bf16 q, k, v at dh 64 or 128
// (the `sm90` route of kernels/flash_attention.py; fp32 and every other dh
// take the CUDA-core kernel of flash_attention_fwd.cu, the `simt` route). Same
// function: query row i sits at global position q_offset + i, key j at j,
//   valid_ij = j < kv_len [& i_pos >= j if causal]
//                         [& i_pos - j < window if a window is set],
//   s = (q k^T) * scale, masked to finfo(fp32).min / 2, online softmax over
//   kv tiles with p zeroed where invalid,
//   o = acc / max(l, 1e-30) in bf16, lse = m + log(max(l, 1e-30)) fp32.
// A row that sees no key gives o = 0 and lse = finfo.min / 2 + log 1e-30.
// The kv head of query head h is h / (Hq / Hkv).
//
// What bounds it on this card: at the hybrid's train shape (B 4, H 16,
// S 2048, dh 128, causal) the two products over the causal half are
// ~69 GFLOP, 0.070 ms at the 989 TFLOP/s bf16 tensor-core rate, against
// 0.040 ms for the 134 MB it must move: operations. So the products run on
// the tensor cores (wgmma) and the tiles arrive by TMA while they run.
//
// Design (FlashAttention-3's shape, without its intra-warpgroup pipelining):
// * One block per (b, head, 128-row q tile): warpgroup 0 is the producer,
//   one thread of which issues every TMA load; warpgroups 1 and 2 own 64 q
//   rows each. A 384-thread block compiles within 168 registers a thread,
//   which the consumers fit without spills (S, O and P fragments 160).
// * Q is loaded once; K and V tiles of 128 rows stream through a 2-stage
//   ring (full / empty mbarriers): Q 32 KB + 2 x (32 + 32) KB = 160 KB at
//   dh 128. Tiles are 64-column blocks with the 128-byte swizzle, from
//   3-D tensor maps (dh, S, B·H), so a ragged tail reads zeros.
// * S = Q K^T is wgmma m64n128k16 from shared memory (both K-major). The
//   online softmax runs on the accumulator fragment: the 4 lanes that share
//   a row reduce max by shuffles, exp2 with scale·log2(e) folded in, l is
//   summed per lane and reduced once at the end. P becomes bf16 A fragments
//   in registers (no trip through shared memory) for O += P V, wgmma
//   m64nDHk16 with V from shared memory MN-major (the transpose bit).
//   P is rounded to bf16 here where the reference keeps it in fp32: the
//   tests hold o to the bf16 limit plus 2^-8 (P |V|) / l.
// * The kv band has the run-time bounds of flash_attention_fwd.cu
//   (`_kv_band` from q_offset, window, causal and kv_len, floor division
//   for negative offsets). The element mask runs only on tiles that cross
//   the diagonal, the window edge, kv_len or a ragged tail; interior tiles
//   skip it.
// * Causal q tiles launch longest band first (grid y reversed, heads on x).

#include "sm90.cuh"

namespace {

constexpr int BQ = 128;        // q rows per block (2 consumer warpgroups)
constexpr int BK = 128;        // kv rows per tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;   // warpgroup 0 produces; 1, 2 consume
constexpr float NEG = -1.70141173319264429e38f;   // finfo(fp32).min / 2
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int DH>
struct Layout {
  static constexpr int Q = BQ * DH * 2;   // bytes of the q tile
  static constexpr int KV = BK * DH * 2;  // bytes of one k or v tile
  __host__ __device__ static constexpr int k(int s) { return Q + s * 2 * KV; }
  __host__ __device__ static constexpr int v(int s) { return Q + s * 2 * KV + KV; }
  static constexpr int bars = Q + STAGES * 2 * KV;  // q, full[S], empty[S]
  static constexpr int bytes = bars + 8 * (1 + 2 * STAGES) + 1024;
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int hq, int hkv, int sq, int q_offset, int kv_len,
                      int causal, int has_window, int window, float scale) {
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

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(bar_full(s), 1);
      sm90::mbar_init(bar_empty(s), 256);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load ---------------------------
    if (threadIdx.x == 0 && lo <= hi) {
      sm90::tma_prefetch(&tm_q);
      sm90::tma_prefetch(&tm_k);
      sm90::tma_prefetch(&tm_v);
      sm90::mbar_arrive_expect_tx(bar_q, L::Q);
#pragma unroll
      for (int c = 0; c < DH / 64; ++c)
        sm90::tma_load_3d(base + c * BQ * 128, &tm_q, bar_q, 64 * c, q0, bh);
      int stage = 0;
      uint32_t phase = 0;
      for (int it = lo; it <= hi; ++it) {
        sm90::mbar_wait(bar_empty(stage), phase ^ 1);
        sm90::mbar_arrive_expect_tx(bar_full(stage), 2 * L::KV);
#pragma unroll
        for (int c = 0; c < DH / 64; ++c) {
          sm90::tma_load_3d(base + L::k(stage) + c * BK * 128, &tm_k,
                            bar_full(stage), 64 * c, it * BK, bg);
          sm90::tma_load_3d(base + L::v(stage) + c * BK * 128, &tm_v,
                            bar_full(stage), 64 * c, it * BK, bg);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----------------------------------------
    const int t = threadIdx.x % 128, lane = t % 32;
    const int rw = 64 * (wg - 1);                  // first row of this group
    const int r0 = (t / 32) * 16 + lane / 4;       // rows r0 and r0 + 8
    const int c0 = 2 * (lane % 4);                 // first column of a block
    const float sl2 = scale * LOG2E;
    float acc[DH / 2];
#pragma unroll
    for (int r = 0; r < DH / 2; ++r) acc[r] = 0.f;
    float m[2] = {NEG, NEG};      // running max of s·log2(e), per row
    float lsum[2] = {0.f, 0.f};   // this lane's share of l, per row

    if (lo <= hi) sm90::mbar_wait(bar_q, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int it = lo; it <= hi; ++it) {
      const int k0 = it * BK;
      sm90::mbar_wait(bar_full(stage), phase);

      // -- S = Q K^T ----------------------------------------------------------
      float s[64];
#pragma unroll
      for (int r = 0; r < 64; ++r) s[r] = 0.f;
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        // column block kk / 4 (both tiles have 128-row blocks), 32 bytes a
        // k-step along its rows
        const uint32_t off = (kk / 4) * 128 * 128 + (kk % 4) * 32;
        sm90::MmaSS<128, 0>::run(
            s, sm90::desc_sw128(base + off + rw * 128, 16, 1024),
            sm90::desc_sw128(base + L::k(stage) + off, 16, 1024), kk > 0);
      }
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(s);

      // -- mask (boundary tiles only), scale, row max ----------------------
      const int qpos0 = q_offset + q0 + rw;        // first row of the group
      const bool interior =
          k0 + BK <= kv_len && (!causal || qpos0 >= k0 + BK - 1) &&
          (!has_window || qpos0 + 63 - k0 < window);
      float mx[2] = {m[0], m[1]};
      if (interior) {
#pragma unroll
        for (int r = 0; r < 64; ++r) {
          s[r] *= sl2;
          mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], s[r]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < 64; ++r) {
          const int kpos = k0 + 8 * (r >> 2) + c0 + (r & 1);
          const int qpos = qpos0 + r0 + 8 * ((r >> 1) & 1);
          bool ok = kpos < kv_len;
          if (causal) ok = ok && qpos >= kpos;
          if (has_window) ok = ok && qpos - kpos < window;
          s[r] = ok ? s[r] * sl2 : NEG;
          mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], s[r]);
        }
      }
      float corr[2], mu[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        corr[i] = exp2f(m[i] - mx[i]);
        m[i] = mx[i];
        // a row with no valid key so far: every s is NEG, p must be 0
        mu[i] = (mx[i] == NEG) ? 0.f : mx[i];
        lsum[i] *= corr[i];
      }

      // -- p = exp2(s - m), l, rescale acc, P to bf16 fragments ------------
#pragma unroll
      for (int r = 0; r < 64; ++r) {
        s[r] = exp2f(s[r] - mu[(r >> 1) & 1]);
        lsum[(r >> 1) & 1] += s[r];
      }
#pragma unroll
      for (int r = 0; r < DH / 2; ++r) acc[r] *= corr[(r >> 1) & 1];
      uint32_t pa[32];
      sm90::acc_to_a(s, pa);

      // -- O += P V ---------------------------------------------------------
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)   // 16 kv rows a k-step
        sm90::MmaRS<DH, 1>::run(
            acc, &pa[4 * kk],
            sm90::desc_sw128(base + L::v(stage) + kk * 16 * 128, BK * 128,
                             1024),
            1);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(acc);
      sm90::mbar_arrive(bar_empty(stage));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // -- epilogue: o = acc / max(l, 1e-30), lse = m + log max(l, 1e-30) ----
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 1);
      lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 2);
      const int row = q0 + rw + r0 + 8 * i;
      if (row >= sq) continue;
      const float l = fmaxf(lsum[i], 1e-30f);
      const float inv = 1.f / l;
      __nv_bfloat16* orow = o + ((size_t)bh * sq + row) * DH + c0;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv,
                                  acc[4 * j + 2 * i + 1] * inv);
      if (lane % 4 == 0)
        lse[(size_t)bh * sq + row] =
            ((m[i] == NEG) ? NEG : m[i] * LN2) + logf(l);
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int hq, int hkv, int sq, int sk, int q_offset, int kv_len,
           int causal, int has_window, int window, float scale,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!sm90::make_map(&tq, q, b * hq, sq, DH, BQ) ||
      !sm90::make_map(&tk, k, b * hkv, sk, DH, BK) ||
      !sm90::make_map(&tv, v, b * hkv, sk, DH, BK))
    return (int)cudaErrorInvalidValue;
  const int smem = Layout<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * hq, (sq + BQ - 1) / BQ);
  flash_fwd_sm90_kernel<DH><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      hq, hkv, sq, q_offset, kv_len, causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (b, hq, sq, dh); k, v: (b, hkv, sk, dh), all bf16 (is_bf16 must be
// 1), contiguous, 16-byte aligned; lse: (b, hq, sq) fp32. Needs dh in {64,
// 128}, hq % hkv == 0, 1 <= kv_len <= sk (the wrapper checks). Returns the
// launch's cudaGetLastError(), or cudaErrorInvalidValue for what it does
// not take or a tensor map the driver refuses.
extern "C" int flash_attention_fwd_sm90(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int b, int hq, int hkv, int sq, int sk,
                                        int dh, int q_offset, int kv_len,
                                        int causal, int has_window, int window,
                                        int is_bf16, float scale,
                                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return (int)cudaErrorInvalidValue;
  if (dh == 64)
    return launch<64>(q, k, v, o, lse, b, hq, hkv, sq, sk, q_offset, kv_len,
                      causal, has_window, window, scale, st);
  if (dh == 128)
    return launch<128>(q, k, v, o, lse, b, hq, hkv, sq, sk, q_offset, kv_len,
                       causal, has_window, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
