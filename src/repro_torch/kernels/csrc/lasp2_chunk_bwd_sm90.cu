// Chunked decayed causal linear attention, the backward's dk/dv/dlog_a pass,
// on Hopper's tensor cores (sm_90a, bf16).
//
// Replaces the Pallas TPU kernel `_bwd_dkv_kernel` (pallas_call
// "lasp2_chunk_bwd_dkv") in src/repro/kernels/lasp2_chunk.py (K2b), for
// bf16 q, k, v, o, dO with dk and dv in {64, 128} (the `sm90` route of
// kernels/lasp2_chunk.py; fp32 and every other shape take the CUDA-core
// kernel of lasp2_chunk_bwd.cu, the `simt` route). Same function: per
// 64-row chunk, last chunk first, carrying the suffix state gradient N
// (dk x dv, seeded with dM),
//   dk = (dO V^T ⊙ D)^T Q + w ⊙ (V N^T),  dv = (Q K^T ⊙ D)^T dO + w ⊙ (K N),
//   r  = rowsum(dO ⊙ o) - rowsum(K ⊙ dk),  dlog_a_m = sum_{i >= m} r_i,
//   N <- e^A N + (Q ⊙ e^{cb})^T dO,
// with cb = inclusive cumsum(log a) over the chunk, A = cb_last,
// w = e^{A - cb}, D_ij = e^{cb_i - cb_j} (i >= j) else 0. dk, dv in bf16,
// dlog_a in fp32 without the constant <state, dM> + dA term.
//
// What bounds it on this card: at the training shape (BH 64, S 2048,
// dk = dv = 128) it must move ~240 MB (each input read once, each output
// written once), 0.072 ms at 3.35 TB/s, against ~22 GFLOP of products
// (~44 with the split operands below), ~0.045 ms at the bf16 tensor-core
// rate: bytes. But the chunks form a sequential chain through N, and a
// chunk's work is a dozen small dependent steps (products, decays,
// reductions, barriers), so a block is bound by that chain's latency; the
// design shortens the chain and runs two chains a bh.
//
// Precision. The reference keeps every intermediate in fp32, and dlog_a is
// a suffix sum over the whole sequence of r, which takes the difference of
// two rowsums of size ~|K||dk|: rounding the fp32 intermediates to bf16
// for the tensor cores moves dlog_a far past its fp32 limit. q, k, v, dO
// are bf16 already and enter the products exactly. The fp32 operands — the
// decayed scores sc and dsc, the carried N and Q ⊙ e^{cb} — each enter as
// two bf16 terms, x_hi = bf16(x) and x_lo = bf16(x - x_hi), with two
// wgmmas into one fp32 accumulator: ~2^-16 relative where one rounding
// leaves 2^-8. r and its suffix sum are taken in fp32 from dk's fp32
// accumulator, not from the bf16 dk that is stored. The result is held to
// the fp32 plain version's unchanged limits (PERF.md).
//
// Design: two blocks per bh, one cluster, 256 threads each = two
// warpgroups (128 blocks on 132 SMs at BH 64).
// * The sequence is split: block 1 runs the last chunks from dM; block 0
//   first carries N over those chunks alone (the N update only, on q and dO
//   tiles: "pre steps", about a third of a full step), then runs the first
//   chunks. split_chunk balances the two. At the end block 1 hands its sum
//   of r to block 0 through distributed shared memory, and block 0 adds it
//   to its dlog_a rows.
// * A step's q, k, v, dO tiles (64 rows, 64-column blocks with the 128-byte
//   swizzle, 64 KB at 128/128) arrive by TMA in a 2-stage ring; warp 0
//   also scans log a (read a step ahead) into cb, e^{cb}, e^A beside them
//   (full mbarrier: expect_tx + warp 0's 32 arrivals). A ragged last chunk
//   reads zeros (3-D tensor maps) and log a = 0, which add nothing.
// * Warpgroup 0 owns dk: S2^T = V dO^T (m64n64), dk = V N^T (N from shared
//   memory as hi and lo, K-major), dk ⊙= w, then dk += dsc^T Q with dsc^T
//   as hi/lo A fragments in registers (acc_to_a layout) and Q MN-major.
//   Warpgroup 1 owns dv the same way: S1^T = K Q^T, dv = K N (N MN-major),
//   dv ⊙= w, dv += sc^T dO. Everything is transposed, so no score tile goes
//   through shared memory. The decay factors use __expf.
// * r: warpgroup 0 takes rowsum(K ⊙ dk) from its fp32 accumulator and the
//   k tile; every thread a quarter row of rowsum(dO ⊙ o) from device
//   memory, its loads in flight during the first products; warp 0 forms r
//   and the suffix sum (shuffles, fixed order).
// * N lives in fp32 registers: warpgroup w holds rows 64w .. 64w + 63.
//   N ⊙= e^A, then N += (Q ⊙ e^{cb})^T dO with (Q ⊙ e^{cb})^T as hi and lo
//   A fragments in registers, read from the q tile by ldmatrix.trans.
// * Two block barriers a step. After the first (every read of the stage
//   and of N's old terms done) dk and dv go in bf16 to a staging buffer
//   and N's new hi and lo terms to theirs, with one proxy fence; after the
//   second, thread 0 stores dk and dv by TMA and warp 0 refills the stage.
// * No atomics, every sum in fixed order: two launches agree bit for bit.

#include "sm90.cuh"

namespace {

constexpr int C = 64;          // sequence rows per chunk
constexpr int STAGES = 2;
constexpr int THREADS = 256;   // 2 warpgroups; warp 0 also issues the loads

// The first N registers of an accumulator array sized for the wider of dk
// and dv (the whole array when dk = dv).
template <int N, int M>
__device__ __forceinline__ float (&head(float (&a)[M]))[N] {
  static_assert(N <= M, "head longer than its array");
  return *reinterpret_cast<float(*)[N]>(&a[0]);
}

// Block 0 of a pair runs chunks 0 .. nch2 - 1 after carrying N over the
// rest, which block 1 runs: a pre step costs a fraction of a full one, so
// block 0 takes a little under half.
__host__ __device__ __forceinline__ int split_chunk(int nch) {
  return nch * 13 / 32;
}

template <int DK, int DV>
struct Layout {
  static constexpr int QK = C * DK * 2;    // bytes of a q or k tile
  static constexpr int VD = C * DV * 2;    // bytes of a v or dO tile
  static constexpr int ST = 2 * QK + 2 * VD;
  __host__ __device__ static constexpr int q(int s) { return s * ST; }
  __host__ __device__ static constexpr int k(int s) { return s * ST + QK; }
  __host__ __device__ static constexpr int v(int s) { return s * ST + 2 * QK; }
  __host__ __device__ static constexpr int dout(int s) { return s * ST + 2 * QK + VD; }
  static constexpr int NT = DK * DV * 2;   // bytes of one bf16 term of N
  static constexpr int n_hi = STAGES * ST;
  static constexpr int n_lo = n_hi + NT;
  // dk and dv in bf16 on their way out by TMA
  static constexpr int out_dk = n_hi + 2 * NT;
  static constexpr int out_dv = out_dk + QK;
  // per stage: cb, e^{cb}, then e^A at [2C], fp32
  static constexpr int RW = 8 * C + 16;
  __host__ __device__ static constexpr int rows(int s) { return out_dv + VD + s * RW; }
  static constexpr int rk = out_dv + VD + STAGES * RW;         // [C] fp32
  static constexpr int rdo = rk + 4 * C;                       // [C] fp32
  static constexpr int bars = rdo + 4 * C;
  static constexpr int xfer = bars + 8 * STAGES;   // r's sum from block 1
  static constexpr int bytes = xfer + 16 + 1024;
};

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
chunk_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_dk,
                          const __grid_constant__ CUtensorMap tm_dv,
                          const float* __restrict__ la,
                          const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dO,
                          const float* __restrict__ dstate,
                          float* __restrict__ dla, int s) {
  using L = Layout<DK, DV>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - sm90::smem_u32(smem_raw));
  auto bar_full = [&](int st) { return base + L::bars + 8 * st; };
  float* const rk = reinterpret_cast<float*>(gbase + L::rk);
  float* const rdo = reinterpret_cast<float*>(gbase + L::rdo);

  // The pair of blocks of a bh (a cluster of 2): block 1 runs the last
  // nch - nch2 chunks from dM; block 0 first carries N from dM over those
  // chunks alone (pre steps: the N update only), then runs chunks nch2 - 1
  // .. 0. Step j is chunk nch - 1 - j on both.
  const int rank = blockIdx.x, bh = blockIdx.y;
  const int nch = (s + C - 1) / C;
  const int nch2 = split_chunk(nch);
  const int npre = (rank == 0 && nch2 > 0) ? nch - nch2 : 0;
  const int nsteps = rank == 1 ? nch - nch2 : (nch2 > 0 ? nch : 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st)
      sm90::mbar_init(bar_full(st), 1 + 32);   // expect_tx + warp 0's rows
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // Warp 0 loads step j (chunk nch - 1 - j) into stage j % STAGES: the
  // four tiles (a pre step: q and dO) by TMA from lane 0, and the scan of
  // log a (rows lane and lane + 32 in a0, a1, read ahead by load_la) by its
  // lanes.
  auto load_la = [&](int j, float& a0, float& a1) {
    const int t0 = (nch - 1 - j) * C, rows = min(C, s - t0);
    const float* lab = la + (size_t)bh * s + t0;
    a0 = (lane < rows) ? lab[lane] : 0.f;
    a1 = (lane + 32 < rows) ? lab[lane + 32] : 0.f;
  };
  auto load_tile = [&](int j, float a0, float a1) {
    const int st = j % STAGES;
    const int t0 = (nch - 1 - j) * C;
    if (lane == 0) {
      const bool pre = j < npre;
      sm90::mbar_arrive_expect_tx(bar_full(st),
                                  pre ? L::QK + L::VD : L::ST);
#pragma unroll
      for (int c = 0; c < DK / 64; ++c) {
        sm90::tma_load_3d(base + L::q(st) + c * C * 128, &tm_q, bar_full(st),
                          64 * c, t0, bh);
        if (!pre)
          sm90::tma_load_3d(base + L::k(st) + c * C * 128, &tm_k,
                            bar_full(st), 64 * c, t0, bh);
      }
#pragma unroll
      for (int c = 0; c < DV / 64; ++c) {
        if (!pre)
          sm90::tma_load_3d(base + L::v(st) + c * C * 128, &tm_v,
                            bar_full(st), 64 * c, t0, bh);
        sm90::tma_load_3d(base + L::dout(st) + c * C * 128, &tm_do,
                          bar_full(st), 64 * c, t0, bh);
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n0 = __shfl_up_sync(0xffffffffu, a0, off);
      const float n1 = __shfl_up_sync(0xffffffffu, a1, off);
      if (lane >= off) {
        a0 += n0;
        a1 += n1;
      }
    }
    a1 += __shfl_sync(0xffffffffu, a0, 31);
    const float A = __shfl_sync(0xffffffffu, a1, 31);
    float* r = reinterpret_cast<float*>(gbase + L::rows(st));
    r[lane] = a0;
    r[lane + 32] = a1;
    r[C + lane] = expf(a0);
    r[C + lane + 32] = expf(a1);
    if (lane == 0) r[2 * C] = expf(A);
    sm90::mbar_arrive(bar_full(st));
    __syncwarp();
  };
  if (warp == 0)
    for (int j = 0; j < min(nsteps, STAGES); ++j) {
      float a0, a1;
      load_la(j, a0, a1);
      load_tile(j, a0, a1);
    }

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int r0 = (t / 32) * 16 + lane / 4;       // accumulator rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);                 // first column of a block
  const bool owns_n = 64 * wg < DK;              // rows 64 wg .. of N

  // N (fp32, rows 64 wg + r0 (+8), columns 8 jj + c0 (+1)) from dM, and
  // its bf16 hi and lo terms into shared memory (rows c, 64-column blocks).
  float nacc[DV / 2];
  auto write_n = [&]() {
#pragma unroll
    for (int jj = 0; jj < DV / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 64 * wg + r0 + 8 * h, col = 8 * jj + c0;
        const uint32_t off = (col / 64) * DK * 128 + sm90::sw128_off(c, col % 64);
        const float x0 = nacc[4 * jj + 2 * h], x1 = nacc[4 * jj + 2 * h + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(hi);
        *reinterpret_cast<__nv_bfloat162*>(gbase + L::n_hi + off) = hi;
        *reinterpret_cast<__nv_bfloat162*>(gbase + L::n_lo + off) =
            __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
      }
  };
  if (owns_n) {
    const float* ds = dstate + (size_t)bh * DK * DV;
#pragma unroll
    for (int jj = 0; jj < DV / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 x = *reinterpret_cast<const float2*>(
            ds + (size_t)(64 * wg + r0 + 8 * h) * DV + 8 * jj + c0);
        nacc[4 * jj + 2 * h] = x.x;
        nacc[4 * jj + 2 * h + 1] = x.y;
      }
    write_n();
    sm90::fence_proxy_async();
  }
  __syncthreads();

  // N <- e^A N + (Q ⊙ e^{cb})^T dO, rows 64 wg .. of N, from the stage at
  // q tile qb and dO tile db: (Q ⊙ e^{cb})^T as hi and lo A fragments, read
  // from the q tile transposed. Only registers change, so the other
  // warpgroup may still be reading N's terms.
  auto n_update = [&](uint32_t qb, uint32_t db, const float* cb) {
    const float* ecb = cb + C;
    const int cw = 64 * wg + 16 * (t / 32) + 8 * ((lane / 8) & 1);
    uint32_t qhi[16], qlo[16];
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      uint32_t x[4];
      sm90::ldmatrix_x4_trans(
          qb + (cw / 64) * C * 128 +
              sm90::sw128_off(16 * kk + 8 * (lane / 16) + lane % 8, cw % 64),
          x);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int ii = 16 * kk + 8 * (m >> 1) + c0;
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&x[m]));
        const float y0 = f.x * ecb[ii], y1 = f.y * ecb[ii + 1];
        const __nv_bfloat162 h = __floats2bfloat162_rn(y0, y1);
        const float2 hf = __bfloat1622float2(h);
        qhi[4 * kk + m] = *reinterpret_cast<const uint32_t*>(&h);
        qlo[4 * kk + m] = sm90::pack_bf16(y0 - hf.x, y1 - hf.y);
      }
    }
    const float eA = cb[2 * C];
#pragma unroll
    for (int r = 0; r < DV / 2; ++r) nacc[r] *= eA;
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {   // 16 rows i a k-step
      const uint64_t b = sm90::desc_sw128(db + kk * 16 * 128, C * 128, 1024);
      sm90::MmaRS<DV, 1>::run(nacc, &qhi[4 * kk], b, 1);
      sm90::MmaRS<DV, 1>::run(nacc, &qlo[4 * kk], b, 1);
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(nacc);
  };

  float rsum = 0.f;   // sum of r over later chunks of this block (warp 0)
  for (int i = 0; i < nsteps; ++i) {
    const int stage = i % STAGES;
    const int t0 = (nch - 1 - i) * C, rows = min(C, s - t0);
    const float* cb = reinterpret_cast<const float*>(gbase + L::rows(stage));
    const uint32_t qb = base + L::q(stage), kb = base + L::k(stage);
    const uint32_t vb = base + L::v(stage), db = base + L::dout(stage);
    // log a of the step this stage is refilled with, read ahead (warp 0)
    float la0 = 0.f, la1 = 0.f;
    if (warp == 0 && i + STAGES < nsteps) load_la(i + STAGES, la0, la1);
    if (i < npre) {   // a pre step: carry N over a chunk of block 1
      sm90::mbar_wait(bar_full(stage), (i / STAGES) & 1);
      if (owns_n) {
        n_update(qb, db, cb);
        if (i + 1 == npre) {   // N's terms for the first chunk of its own
          write_n();
          sm90::fence_proxy_async();
        }
      }
      __syncthreads();   // the stage is read
      if (warp == 0 && i + STAGES < nsteps) load_tile(i + STAGES, la0, la1);
      continue;
    }
    // rowsum(dO ⊙ o), thread by thread: row threadIdx.x / 4, DV / 4
    // columns; the loads are in flight during the first products
    const int rdo_row = threadIdx.x / 4;
    uint4 xo[DV / 32], xd[DV / 32];
    {
      const size_t at = ((size_t)bh * s + t0 + rdo_row) * DV +
                        (threadIdx.x % 4) * (DV / 4);
#pragma unroll
      for (int u = 0; u < DV / 32; ++u) {
        const bool in = rdo_row < rows;
        xo[u] = in ? reinterpret_cast<const uint4*>(o + at)[u]
                   : make_uint4(0, 0, 0, 0);
        xd[u] = in ? reinterpret_cast<const uint4*>(dO + at)[u]
                   : make_uint4(0, 0, 0, 0);
      }
    }
    auto finish_rdo = [&]() {
      float acc = 0.f;
#pragma unroll
      for (int u = 0; u < DV / 32; ++u) {
        const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&xo[u]);
        const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&xd[u]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fa = __bfloat1622float2(a[e]);
          const float2 fb = __bfloat1622float2(b[e]);
          acc = fmaf(fa.x, fb.x, acc);
          acc = fmaf(fa.y, fb.y, acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (lane % 4 == 0) rdo[rdo_row] = acc;
    };
    sm90::mbar_wait(bar_full(stage), (i / STAGES) & 1);
    // S^T (rows j, columns i) ⊙ D^T: e^{cb_i - cb_j} where i >= j, else 0;
    // register r is row j = r0 + 8((r/2)%2), column i = 8(r/4) + c0 + r%2.
    // __expf (ex2.approx) is within 2 + 1.16|x| ulp of e^x: far below the
    // split terms' 2^-16 wherever the factor is not negligible.
    const float cbj[2] = {cb[r0], cb[r0 + 8]};
    const float wj[2] = {expf(cb[C - 1] - cbj[0]), expf(cb[C - 1] - cbj[1])};
    auto decay_scores = [&](float (&x)[32]) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 ci = *reinterpret_cast<const float2*>(cb + 8 * jj + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 4 * jj + e, h = e >> 1, ii = 8 * jj + c0 + (e & 1);
          const float d = __expf(((e & 1) ? ci.y : ci.x) - cbj[h]);
          x[r] = (ii >= r0 + 8 * h) ? x[r] * d : 0.f;
        }
      }
    };

    // -- warpgroup 0: dk (and rowsum(K ⊙ dk)); warpgroup 1: dv -------------
    // dk (warpgroup 0) or dv (warpgroup 1) in fp32, stored in bf16 at the
    // end of the step through the stage's tiles
    float out[(DK > DV ? DK : DV) / 2];
    float sc[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) sc[r] = 0.f;
    if (wg == 0) {
      auto& acc = head<DK / 2>(out);
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        const uint32_t off = (kk / 4) * C * 128 + (kk % 4) * 32;
        const uint32_t n_off = (kk / 4) * DK * 128 + (kk % 4) * 32;
        const uint64_t a = sm90::desc_sw128(vb + off, 16, 1024);
        sm90::MmaSS<64, 0>::run(sc, a, sm90::desc_sw128(db + off, 16, 1024),
                                kk > 0);
        sm90::MmaSS<DK, 0>::run(
            acc, a, sm90::desc_sw128(base + L::n_hi + n_off, 16, 1024),
            kk > 0);
        sm90::MmaSS<DK, 0>::run(
            acc, a, sm90::desc_sw128(base + L::n_lo + n_off, 16, 1024), 1);
      }
      sm90::wg_commit();
      finish_rdo();
      sm90::wg_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(acc);
      // register r: row j = r0 + 8((r/2)%2), column i = 8(r/4) + c0 + r%2
      decay_scores(sc);
#pragma unroll
      for (int r = 0; r < DK / 2; ++r) acc[r] *= wj[(r >> 1) & 1];
      uint32_t ahi[16], alo[16];
      sm90::split_to_a(sc, ahi, alo);
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {   // 16 rows i a k-step
        const uint64_t b = sm90::desc_sw128(qb + kk * 16 * 128, C * 128, 1024);
        sm90::MmaRS<DK, 1>::run(acc, &ahi[4 * kk], b, 1);
        sm90::MmaRS<DK, 1>::run(acc, &alo[4 * kk], b, 1);
      }
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(acc);
      // rowsum(K ⊙ dk) from the fp32 accumulator
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = r0 + 8 * h;
        float part = 0.f;
#pragma unroll
        for (int jj = 0; jj < DK / 8; ++jj) {
          const int col = 8 * jj + c0;
          const float2 kv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  gbase + L::k(stage) + (col / 64) * C * 128 +
                  sm90::sw128_off(j, col % 64)));
          part = fmaf(kv.x, acc[4 * jj + 2 * h], part);
          part = fmaf(kv.y, acc[4 * jj + 2 * h + 1], part);
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        if (lane % 4 == 0) rk[j] = part;
      }
    } else {
      auto& acc = head<DV / 2>(out);
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        const uint32_t off = (kk / 4) * C * 128 + (kk % 4) * 32;
        const uint64_t a = sm90::desc_sw128(kb + off, 16, 1024);
        sm90::MmaSS<64, 0>::run(sc, a, sm90::desc_sw128(qb + off, 16, 1024),
                                kk > 0);
        const uint32_t n_off = kk * 16 * 128;
        sm90::MmaSS<DV, 1>::run(
            acc, a, sm90::desc_sw128(base + L::n_hi + n_off, DK * 128, 1024),
            kk > 0);
        sm90::MmaSS<DV, 1>::run(
            acc, a, sm90::desc_sw128(base + L::n_lo + n_off, DK * 128, 1024),
            1);
      }
      sm90::wg_commit();
      finish_rdo();
      sm90::wg_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(acc);
      decay_scores(sc);
#pragma unroll
      for (int r = 0; r < DV / 2; ++r) acc[r] *= wj[(r >> 1) & 1];
      uint32_t ahi[16], alo[16];
      sm90::split_to_a(sc, ahi, alo);
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        const uint64_t b = sm90::desc_sw128(db + kk * 16 * 128, C * 128, 1024);
        sm90::MmaRS<DV, 1>::run(acc, &ahi[4 * kk], b, 1);
        sm90::MmaRS<DV, 1>::run(acc, &alo[4 * kk], b, 1);
      }
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(acc);
    }
    // -- N <- e^A N + (Q ⊙ e^{cb})^T dO ---------------------------------
    if (owns_n) n_update(qb, db, cb);
    // the last step's TMA store has read dk and dv out (long since)
    if (threadIdx.x == 0) sm90::tma_store_wait_read();
    __syncthreads();   // rk, rdo written; this chunk's reads of the stage and
                       // of N's terms are done

    // -- r and dlog_a: an inclusive suffix scan by warp 0 -----------------
    if (warp == 0) {
      float s0 = rdo[lane] - rk[lane], s1 = rdo[lane + 32] - rk[lane + 32];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n0 = __shfl_down_sync(0xffffffffu, s0, off);
        const float n1 = __shfl_down_sync(0xffffffffu, s1, off);
        if (lane + off < 32) {
          s0 += n0;
          s1 += n1;
        }
      }
      s0 += __shfl_sync(0xffffffffu, s1, 0);
      float* dlab = dla + (size_t)bh * s + t0;
      if (lane < rows) dlab[lane] = s0 + rsum;
      if (lane + 32 < rows) dlab[lane + 32] = s1 + rsum;
      rsum += __shfl_sync(0xffffffffu, s0, 0);
    }
    // -- dk (warpgroup 0) and dv (warpgroup 1) in bf16 for the TMA store
    // (the last one has read them: thread 0 waited before the barrier);
    // then N's new terms ------------------------------------------------------
    auto stage_out = [&](const auto& acc, uint32_t tile) {
      constexpr int NR = sizeof(acc) / sizeof(float);
#pragma unroll
      for (int jj = 0; jj < NR / 4; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = 8 * jj + c0;
          *reinterpret_cast<__nv_bfloat162*>(
              gbase + tile + (col / 64) * C * 128 +
              sm90::sw128_off(r0 + 8 * h, col % 64)) =
              __floats2bfloat162_rn(acc[4 * jj + 2 * h],
                                    acc[4 * jj + 2 * h + 1]);
        }
    };
    if (wg == 0)
      stage_out(head<DK / 2>(out), L::out_dk);
    else
      stage_out(head<DV / 2>(out), L::out_dv);
    if (owns_n) write_n();
    sm90::fence_proxy_async();
    __syncthreads();   // N's new terms and dk, dv visible to the async proxy

    // -- thread 0 stores dk and dv by TMA (rows past S are dropped); warp 0
    // refills the stage ---------------------------------------------------
    if (warp == 0) {
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < DK / 64; ++c)
          sm90::tma_store_3d(&tm_dk, base + L::out_dk + c * C * 128, 64 * c,
                             t0, bh);
#pragma unroll
        for (int c = 0; c < DV / 64; ++c)
          sm90::tma_store_3d(&tm_dv, base + L::out_dv + c * C * 128, 64 * c,
                             t0, bh);
        sm90::tma_store_commit();
      }
      if (i + STAGES < nsteps) load_tile(i + STAGES, la0, la1);
    }
  }
  if (threadIdx.x == 0) sm90::tma_store_wait_read();

  // -- block 0's dlog_a also sums r over block 1's chunks: block 1 hands
  // its sum over (distributed shared memory), block 0 adds it in ---------
  if (rank == 1 && threadIdx.x == 0)
    sm90::cluster_store(sm90::cluster_map(base + L::xfer, 0), rsum);
  sm90::cluster_sync();
  if (rank == 0 && npre > 0) {
    const float later = *reinterpret_cast<const float*>(gbase + L::xfer);
    float* dlab = dla + (size_t)bh * s;
    for (int m = threadIdx.x; m < nch2 * C; m += THREADS) dlab[m] += later;
  }
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, const void* la,
           const void* o, const void* dO, const void* dstate, void* dk_out,
           void* dv_out, void* dla, int bh, int s, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  if (!sm90::make_map(&tq, q, bh, s, DK, C) ||
      !sm90::make_map(&tk, k, bh, s, DK, C) ||
      !sm90::make_map(&tv, v, bh, s, DV, C) ||
      !sm90::make_map(&tdo, dO, bh, s, DV, C) ||
      !sm90::make_map(&tdk, dk_out, bh, s, DK, C) ||
      !sm90::make_map(&tdv, dv_out, bh, s, DV, C))
    return (int)cudaErrorInvalidValue;
  static_assert(Layout<DK, DV>::bytes <= 232448, "over 227 KB of shared memory");
  if (bh > 65535) return (int)cudaErrorInvalidValue;   // grid y
  const int smem = Layout<DK, DV>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      chunk_bwd_dkv_sm90_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // the 2 blocks of each bh as one cluster
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2, bh);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, chunk_bwd_dkv_sm90_kernel<DK, DV>, tq, tk, tv, tdo, tdk, tdv,
      static_cast<const float*>(la), static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dO),
      static_cast<const float*>(dstate), static_cast<float*>(dla), s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// q, k: (bh, s, dk); v, o, dO: (bh, s, dv), all bf16, contiguous, 16-byte
// aligned; la: (bh, s) and dstate: (bh, dk, dv) fp32; dk_out, dv_out out in
// bf16, dla: (bh, s) fp32 out. Needs dk, dv in {64, 128} and s >= 1 (the
// wrapper checks). Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it does not take or a tensor map the
// driver refuses.
extern "C" int lasp2_chunk_bwd_dkv_sm90(const void* q, const void* k,
                                        const void* v, const void* la,
                                        const void* o, const void* dO,
                                        const void* dstate, void* dk_out,
                                        void* dv_out, void* dla, int bh, int s,
                                        int dk, int dv, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LASP2_DKV_SM90(DK, DV)                                              \
  if (dk == DK && dv == DV)                                                 \
    return launch<DK, DV>(q, k, v, la, o, dO, dstate, dk_out, dv_out, dla,  \
                          bh, s, st);
  LASP2_DKV_SM90(64, 64)
  LASP2_DKV_SM90(64, 128)
  LASP2_DKV_SM90(128, 64)
  LASP2_DKV_SM90(128, 128)
#undef LASP2_DKV_SM90
  return (int)cudaErrorInvalidValue;
}
