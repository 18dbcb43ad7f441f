// The one kernel body of the chunk forward (K1, lasp2_chunk_fwd_sm90.cu)
// and of the chunk backward's dq pass (K2a, lasp2_chunk_bwd_dq_sm90.cu) on
// Hopper's tensor cores (sm_90a, bf16). Per 64-row chunk, in order, with
// the carried state M (from 0),
//   out = (X B^T ⊙ D) A + e^{cb} ⊙ (X M^T),   M <- e^A M + (A ⊙ w)^T B,
// with cb = inclusive cumsum(log a) over the chunk, A = cb_last (the decay
// exponent, not the tile), w = e^{A - cb}, D_ij = e^{cb_i - cb_j} (i >= j)
// else 0. A is (BH, S, NA), B and X are (BH, S, NB), out (BH, S, NA) in
// bf16; M is NA x NB.
// * K2a is this with (A, B, X) = (k, v, dO): out = dq, M the forward's
//   state.
// * K1 is this with (A, B, X) = (v, k, q): the score tile is Q K^T ⊙ D,
//   M = (sum (V ⊙ w)^T K) is the transpose of the forward's state, so
//   X M^T = Q M_fwd and out = o. With STATE the kernel carries the last
//   chunk too and writes M^T (BH, NB, NA) in fp32 and sum(log a) (BH,).
//
// Precision. A, B and X are bf16 and enter exactly. The fp32 operands
// enter as two bf16 terms each, x_hi = bf16(x) and x_lo = bf16(x - x_hi),
// with two wgmmas into one fp32 accumulator (~2^-16 relative where one
// rounding leaves 2^-8): A ⊙ w in the carry (one term: K1's state leaves
// its 1e-4 limit under decay), M in X M^T (one term: o and dq leave their
// 4e-2 with resets) and the decayed score tile in its product with A (one
// term: dq leaves 4e-2; o keeps it with half the margin).
// tests/test_torch_chunk_routes.py emulates each choice on the CPU at
// BH 2 x S 2048 x 128. e^{cb} scales X M^T's fp32 rows after the product,
// so X stays exact.
//
// Design: grid (BH, NA / 64). The columns of out and the rows of M are
// independent across A's columns (out[:, c] needs the score tile and
// M[c, :] only), 128 blocks on 132 SMs at BH 64 x 128; every block reads
// all of B and X. A block is 288 threads: two consumer warpgroups and a
// producer warp.
// * Warp 8 loads chunk j's 64 columns of A (the block's) and all of B and
//   X by TMA (64-row boxes, 64-column blocks, 128-byte swizzle) into a
//   3-stage ring, and writes the chunk's decay rows (cb, e^{cb}, w, e^A;
//   sm90::chunk_decay_rows) beside them from log a, read by plain loads (a
//   row of S 37 is no multiple of 16 bytes, no TMA box stride). Full
//   barrier: expect_tx plus the warp's 32 arrivals; empty barrier: all 256
//   consumer threads. A ragged last chunk reads zeros (3-D tensor maps) and
//   log a = 0, which add nothing.
// * Warpgroup 1 owns the block's 64 rows of M in fp32 registers (one m64 x
//   NB accumulator) and runs the carry (sm90::carry_issue): M ⊙= e^A, then
//   M += (A ⊙ w)^T B with (A ⊙ w)^T as hi and lo A fragments read from the
//   A tile by ldmatrix.trans. It then writes M's hi and lo terms into one
//   of two buffers and arrives on that buffer's `ready` barrier; before it
//   overwrites a buffer it waits on its `free` barrier. The chunk's new
//   term does not depend on M, and the double buffer lets warpgroup 1 run
//   a chunk ahead: the chain is one carry and one X M^T product a chunk.
// * Warpgroup 0 owns out: sc = X B^T (both K-major), sc ⊙= D in fp32
//   registers, out = sc A with sc as hi and lo A fragments (A MN-major);
//   then, once M_{c-1}'s terms are ready, X M^T = X M_hi^T + X M_lo^T (M
//   K-major) and out += e^{cb} ⊙ X M^T. out goes through a bf16 staging
//   tile to a TMA store (rows past S are dropped); two warpgroup barriers
//   (bar.sync 1) guard the staging tile.
// * The role is the warpgroup index broadcast from lane 0 (__shfl_sync):
//   branching on threadIdx.x / 32 made ptxas take the consumers' paths for
//   divergent and serialise every wgmma (its warning C7520). ptxas holds
//   the 288 threads to 168 registers each, as it does 384; one m64 x 128
//   accumulator of M and its fragments fit without spills.
// * No atomics, every sum in fixed order: two launches agree bit for bit.

#pragma once

#include "sm90.cuh"

namespace lasp2_chunk_sm90 {

constexpr int C = 64;           // sequence rows per chunk
constexpr int STAGES = 3;
constexpr int THREADS = 288;    // warpgroups 0 (out), 1 (M); warp 8 loads
constexpr int CONSUMERS = 256;

template <int NB>
struct Layout {
  static constexpr int AT = C * 64 * 2;    // the A tile: this block's columns
  static constexpr int BT = C * NB * 2;    // bytes of a B or X tile
  static constexpr int ST = AT + 2 * BT;
  __host__ __device__ static constexpr int a(int s) { return s * ST; }
  __host__ __device__ static constexpr int b(int s) { return s * ST + AT; }
  __host__ __device__ static constexpr int x(int s) {
    return s * ST + AT + BT;
  }
  static constexpr int MT = 64 * NB * 2;   // one bf16 term of M's rows
  // M's hi and lo terms, two buffers
  __host__ __device__ static constexpr int m_hi(int buf) {
    return STAGES * ST + 2 * buf * MT;
  }
  __host__ __device__ static constexpr int m_lo(int buf) {
    return m_hi(buf) + MT;
  }
  static constexpr int out = STAGES * ST + 4 * MT;   // out in bf16 for TMA
  // per stage: cb, e^{cb}, w, e^A (sm90::chunk_decay_rows), fp32
  static constexpr int RW = 4 * C * 4;
  __host__ __device__ static constexpr int rows(int s) {
    return out + AT + s * RW;
  }
  // full[STAGES], empty[STAGES], ready[2], free[2]
  static constexpr int bars = out + AT + STAGES * RW;
  static constexpr int bytes = bars + 8 * (2 * STAGES + 4) + 1024;
};

template <int NB, bool STATE>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const __grid_constant__ CUtensorMap tm_a,
       const __grid_constant__ CUtensorMap tm_b,
       const __grid_constant__ CUtensorMap tm_x,
       const __grid_constant__ CUtensorMap tm_out,
       const float* __restrict__ la, float* __restrict__ state,
       float* __restrict__ log_decay, int s) {
  using L = Layout<NB>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - sm90::smem_u32(smem_raw));
  auto bar_full = [&](int st) { return base + L::bars + 8 * st; };
  auto bar_empty = [&](int st) { return base + L::bars + 8 * (STAGES + st); };
  auto bar_ready = [&](int b) { return base + L::bars + 8 * (2 * STAGES + b); };
  auto bar_free = [&](int b) {
    return base + L::bars + 8 * (2 * STAGES + 2 + b);
  };
  auto rows = [&](int st) {
    return reinterpret_cast<float*>(gbase + L::rows(st));
  };

  const int bh = blockIdx.x, a0 = 64 * blockIdx.y;
  const int nch = (s + C - 1) / C;
  const int lane = threadIdx.x % 32;
  // the role: warpgroup 0, 1, or 2 (warp 8, the producer), broadcast from
  // lane 0 so that ptxas sees it warp-uniform and keeps the wgmmas
  // asynchronous (it serialises them in a path it takes for divergent)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(bar_full(st), 1 + 32);   // expect_tx + warp 8's rows
      sm90::mbar_init(bar_empty(st), CONSUMERS);
    }
    for (int b = 0; b < 2; ++b) {
      sm90::mbar_init(bar_ready(b), 128);
      sm90::mbar_init(bar_free(b), 128);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // -- warp 8: the loads and the decay rows -----------------------------
  if (wg == 2) {
    const float* lab = la + (size_t)bh * s;
    float ld = 0.f;
    for (int j = 0; j < nch; ++j) {
      const int st = j % STAGES, t0 = j * C;
      const float l0 = (t0 + lane < s) ? lab[t0 + lane] : 0.f;
      const float l1 = (t0 + lane + 32 < s) ? lab[t0 + lane + 32] : 0.f;
      if (j >= STAGES) sm90::mbar_wait(bar_empty(st), (j / STAGES - 1) & 1);
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(bar_full(st), L::ST);
        sm90::tma_load_3d(base + L::a(st), &tm_a, bar_full(st), a0, t0, bh);
#pragma unroll
        for (int c = 0; c < NB / 64; ++c) {
          sm90::tma_load_3d(base + L::b(st) + c * C * 128, &tm_b,
                            bar_full(st), 64 * c, t0, bh);
          sm90::tma_load_3d(base + L::x(st) + c * C * 128, &tm_x,
                            bar_full(st), 64 * c, t0, bh);
        }
      }
      ld += sm90::chunk_decay_rows(l0, l1, rows(st));
      sm90::mbar_arrive(bar_full(st));
    }
    if (STATE && blockIdx.y == 0 && lane == 0) log_decay[bh] = ld;
    return;
  }

  const int t = threadIdx.x % 128;
  const int r0 = (t / 32) * 16 + lane / 4;   // accumulator rows r0, r0 + 8

  // -- warpgroup 1: the block's 64 rows of the carried state M ----------
  if (wg == 1) {
    float m[NB / 2];
#pragma unroll
    for (int r = 0; r < NB / 2; ++r) m[r] = 0.f;
    // without STATE the last chunk's M is not used
    const int carried = STATE ? nch : nch - 1;
    for (int c = 0; c < carried; ++c) {
      const int st = c % STAGES;
      sm90::mbar_wait(bar_full(st), (c / STAGES) & 1);
      const float* rw = rows(st);
      sm90::carry_issue<NB>(m, base + L::a(st), base + L::b(st), rw + 2 * C,
                            rw[3 * C]);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(m);
      sm90::mbar_arrive(bar_empty(st));
      if (c + 1 < nch) {   // M_c's terms for chunk c + 1's X M^T
        const int b = c % 2;
        if (c >= 2) sm90::mbar_wait(bar_free(b), ((c - 2) / 2) & 1);
        sm90::store_terms<NB>(m, gbase + L::m_hi(b), gbase + L::m_lo(b));
        sm90::fence_proxy_async();
        sm90::mbar_arrive(bar_ready(b));
      }
    }
    if (STATE) {
      // M^T in fp32 at state[bh, col, a0 + row]: row r0 (+8), column
      // 8 jj + c0 (+1) of M
      const int na = 64 * gridDim.y, c0 = 2 * (lane % 4);
      float* sb = state + (size_t)bh * NB * na + a0 + r0;
#pragma unroll
      for (int jj = 0; jj < NB / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sb[(size_t)(8 * jj + c0 + (e & 1)) * na + 8 * (e >> 1)] =
              m[4 * jj + e];
    }
    return;   // no load waits on the last chunk's stage
  }

  // -- warpgroup 0: out ---------------------------------------------------
  float sc[32], acc[32], xm[32];
  uint32_t shi[16], slo[16];
  for (int c = 0; c < nch; ++c) {
    const int st = c % STAGES;
    const uint32_t ab = base + L::a(st), bb = base + L::b(st);
    const uint32_t xb = base + L::x(st);
    sm90::mbar_wait(bar_full(st), (c / STAGES) & 1);
    const float* cb = rows(st);
    // sc = X B^T over NB
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < NB / 16; ++kk) {
      const uint32_t off = (kk / 4) * C * 128 + (kk % 4) * 32;
      sm90::MmaSS<64, 0>::run(sc, sm90::desc_sw128(xb + off, 16, 1024),
                              sm90::desc_sw128(bb + off, 16, 1024), kk > 0);
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(sc);
    sm90::causal_decay(sc, cb);
    sm90::split_to_a(sc, shi, slo);
    // out = (sc ⊙ D) A, the scores as hi and lo
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {   // 16 chunk rows j a k-step
      const uint64_t b = sm90::desc_sw128(ab + kk * 16 * 128, C * 128, 1024);
      sm90::MmaRS<64, 1>::run(acc, &shi[4 * kk], b, kk > 0);
      sm90::MmaRS<64, 1>::run(acc, &slo[4 * kk], b, 1);
    }
    sm90::wg_commit();
    if (c > 0) {
      // X M_{c-1}^T: M's terms K-major (rows of M along the row)
      const int b = (c - 1) % 2;
      sm90::mbar_wait(bar_ready(b), ((c - 1) / 2) & 1);
#pragma unroll
      for (int kk = 0; kk < NB / 16; ++kk) {
        const uint32_t off = (kk / 4) * C * 128 + (kk % 4) * 32;
        const uint32_t m_off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
        const uint64_t a = sm90::desc_sw128(xb + off, 16, 1024);
        sm90::MmaSS<64, 0>::run(
            xm, a, sm90::desc_sw128(base + L::m_hi(b) + m_off, 16, 1024),
            kk > 0);
        sm90::MmaSS<64, 0>::run(
            xm, a, sm90::desc_sw128(base + L::m_lo(b) + m_off, 16, 1024), 1);
      }
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(xm);
      sm90::mbar_arrive(bar_free(b));
      const float e[2] = {cb[C + r0], cb[C + r0 + 8]};
#pragma unroll
      for (int r = 0; r < 32; ++r)
        acc[r] = fmaf(e[(r >> 1) & 1], xm[r], acc[r]);
    } else {
      sm90::wg_wait<0>();
      sm90::fence_regs(acc);
    }
    sm90::mbar_arrive(bar_empty(st));
    // out in bf16 through the staging tile to a TMA store; the last store
    // has read the tile (thread 0 waits before the first barrier)
    if (t == 0) sm90::tma_store_wait_read();
    sm90::named_sync(1, 128);
    sm90::stage_bf16(acc, gbase + L::out);
    sm90::fence_proxy_async();
    sm90::named_sync(1, 128);
    if (t == 0) {
      sm90::tma_store_3d(&tm_out, base + L::out, a0, c * C, bh);
      sm90::tma_store_commit();
    }
  }
  if (t == 0) sm90::tma_store_wait_read();
}

// A, out: (bh, s, na); B, X: (bh, s, NB), bf16, contiguous, 16-byte
// aligned; la: (bh, s) fp32; with STATE, state (bh, NB, na) and log_decay
// (bh,) fp32 out. na a multiple of 64. Returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for a tensor map the driver
// refuses.
template <int NB, bool STATE>
int launch(const void* a, const void* b, const void* x, const void* la,
           void* out, void* state, void* log_decay, int bh, int s, int na,
           cudaStream_t stream) {
  CUtensorMap ta, tb, tx, tout;
  if (!sm90::make_map(&ta, a, bh, s, na, C) ||
      !sm90::make_map(&tb, b, bh, s, NB, C) ||
      !sm90::make_map(&tx, x, bh, s, NB, C) ||
      !sm90::make_map(&tout, out, bh, s, na, C))
    return (int)cudaErrorInvalidValue;
  static_assert(Layout<NB>::bytes <= 232448, "over 227 KB of shared memory");
  const int smem = Layout<NB>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel<NB, STATE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<NB, STATE><<<dim3(bh, na / 64), THREADS, smem, stream>>>(
      ta, tb, tx, tout, static_cast<const float*>(la),
      static_cast<float*>(state), static_cast<float*>(log_decay), s);
  return (int)cudaGetLastError();
}

}  // namespace lasp2_chunk_sm90
