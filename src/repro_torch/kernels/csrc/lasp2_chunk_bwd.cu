// Chunked decayed causal linear attention, backward, for Hopper (sm_90a):
// the two passes of the reference's `lasp2_chunk_bwd`.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/lasp2_chunk.py:
//   K2a `_bwd_dq_kernel`  (pallas_call "lasp2_chunk_bwd_dq"), forward order:
//     dq = (dO V^T ⊙ D) K + e^{cb} ⊙ (dO M^T),  M <- e^A M + (K ⊙ w)^T V;
//   K2b `_bwd_dkv_kernel` (pallas_call "lasp2_chunk_bwd_dkv"), reverse
//   order, carrying the suffix state gradient N seeded with dM:
//     dk = (dO V^T ⊙ D)^T Q + w ⊙ (V N^T),  dv = (Q K^T ⊙ D)^T dO + w ⊙ (K N),
//     r  = rowsum(dO ⊙ o) - rowsum(K ⊙ dk),  dlog_a_m = sum_{i >= m} r_i,
//     N <- e^A N + (Q ⊙ e^{cb})^T dO,
// with, per chunk, cb = inclusive cumsum(log a), A = cb_last,
// w = e^{A - cb}, D_ij = e^{cb_i - cb_j} (i >= j) else 0. Inputs q, k, v,
// o, dO in bf16 or fp32; log a, dM fp32. dq, dk, dv are written in the
// input dtype, dlog_a in fp32 without the constant <state, dM> + dA term
// (the autograd Function adds it).
//
// What bounds them on this card: at the training shape (BH 64 = 4 rows x
// 16 heads, S 2048, dk = dv = 128, bf16) K2a must move ~135 MB and K2b
// ~240 MB (each input read once, each output written once): ~0.040 and
// ~0.072 ms at 3.35 TB/s, against 13-22 GFLOP of products, ~13-22 us at
// the bf16 tensor-core rate, so both are bound by bytes. This first
// version, like K1, does its products in fp32 on the CUDA cores out of
// shared memory (no wgmma, no TMA), so it is bound by shared-memory
// traffic and fp32 issue rate instead; PERF.md keeps its time beside the
// bound.
//
// Design. The Pallas grids (BH, S/BLOCK) carry M (K2a) and N (K2b) across
// an ordered block axis in VMEM scratch. CUDA blocks run in no order, so
// the loop over 64-row chunks moves inside the thread block: forward for
// K2a, last chunk first for K2b. A ragged last chunk is zero-filled (q = k
// = v = dO = o = 0, log a = 0), which adds nothing to M, N, dq, dk, dv or
// r, so any S is exact and only rows < S are stored. Every decay factor is
// formed in log space as e^{cb_i - cb_j} <= 1, so the RESET_LOG_A = -60
// resets of packed documents are exact mid-chunk.
//
// K2a: the columns of dq are independent over dk (row c of M updates on
// its own, and dq[:, c] needs only the score tile and M[c, :]), so the
// grid is (BH, ceil(dk/64)): 128 blocks at BH 64, dk 128, each recomputing
// the 64 x 64 score tile dO V^T. Any dk and dv: the last dk and dv tiles
// are ragged, zero-filled on load and masked on store.
//
// K2b is not separable that way in dv (dk sums over dv, dv over dk, and r
// needs the whole dk row), so up to dk 128 it runs one block per bh: 64
// blocks on 132 SMs at BH 64, half the card idle. Past 128 (the taylor
// feature map's 1 + dh + dh^2: 1057 at dh 32, 16513 at dh 128) the whole
// row no longer fits one block's shared memory, so dk goes in slices of
// DKS = 128 rows over a grid (BH, slices). Each slice's block carries its
// rows N_t of the suffix state gradient (they update on their own) and
// writes its dk columns, which need only dO V^T and N_t. dv and r sum over
// dk: dv = sum_t [(Q_t K_t^T ⊙ D)^T dO + w ⊙ (K_t N_t)] and rowsum(K ⊙ dk)
// = sum_t rowsum(K_t ⊙ dk_t), so each block writes its partial dv and
// partial rowsum in fp32 to a workspace, and a second kernel of the same
// entry, one block per bh, sums them in slice order, casts dv, forms
// r = rowsum(dO ⊙ o) - rowsum(K ⊙ dk) and takes dlog_a's suffix sum, last
// chunk first. A slice narrower than 128 (and any dk not a multiple of 16)
// is zero-filled to a multiple of 16 in shared memory: zero columns of q
// and k add nothing to a score or a rowsum, and their N rows stay zero and
// are never stored.
//
// Shared memory. Both kernels walk dv in 64-column tiles (the last one
// ragged), so shared memory does not grow with dv: the carried state (M for K2a, N for K2b, fp32,
// dk x dv) lives in a global scratch tensor the wrapper allocates, owned
// by one block, re-read one 64-column tile at a time (it stays in L2: 4 MB
// at BH 64). Tiles are row-major with an odd row stride (65, or dk + 1),
// so a warp reading along a row or down a column hits distinct banks.
// K2a at any dk: k tile, dO, V, M tiles and the score tile, 5 x 64 x 65
// fp32 = 83 KB. K2b at a 128-row slice: q and k chunks (2 x 64 x 129), dO, V and
// N tiles (64 x 65, 64 x 65, 128 x 65), two score tiles (2 x 64 x 65) and
// row vectors: 171 KB. Both are above the default 48 KB, so each entry
// raises its kernel's dynamic shared-memory limit first.
//
// Each product is an outer-product loop: per step of the reduction a
// thread reads a few values of each operand and updates a 4 x 4 (or
// 4 x dk/16) register tile; 16 x 16 threads cover a 64 x 64 output.
// Sums across threads (r's rowsum of K ⊙ dk, dO ⊙ o) and across slices go
// through fixed-order reductions, never atomics, so results repeat bit for
// bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int C = 64;          // sequence rows per chunk
constexpr int TS = 65;         // odd row stride of the 64-wide tiles
constexpr int DT = 64;         // dk columns (K2a) / dv columns per tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int DKS = 128;       // K2b: dk columns per slice
constexpr int MAX_CT = DKS / 16;     // dk columns (or rows) per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Inclusive scan of log a over the chunk's 64 rows into cb[], by warp 0;
// rows >= `rows` count as log a = 0.
__device__ __forceinline__ void scan_log_a(const float* lab, int t0,
                                           int rows, float* cb, int tid) {
  if (tid < 32) {
    float a0 = (tid < rows) ? lab[t0 + tid] : 0.f;
    float a1 = (tid + 32 < rows) ? lab[t0 + tid + 32] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n0 = __shfl_up_sync(0xffffffffu, a0, off);
      const float n1 = __shfl_up_sync(0xffffffffu, a1, off);
      if (tid >= off) {
        a0 += n0;
        a1 += n1;
      }
    }
    a1 += __shfl_sync(0xffffffffu, a0, 31);
    cb[tid] = a0;
    cb[tid + 32] = a1;
  }
}

// Load rows [t0, t0 + rows) x columns [c0, c0 + 64) of a (s, width)
// row-major tensor into a 64 x 64 tile of stride TS; rows past `rows` and
// columns past `width` are zero.
template <typename T>
__device__ __forceinline__ void load_tile(const T* src, int width, int t0,
                                          int rows, int c0, float* dst,
                                          int tid) {
  for (int idx = tid; idx < C * DT; idx += THREADS) {
    const int i = idx / DT, j = idx - i * DT;
    dst[i * TS + j] = (i < rows && c0 + j < width)
                          ? to_f32(src[(size_t)(t0 + i) * width + c0 + j])
                          : 0.f;
  }
}

// ===========================================================================
// K2a: dq, forward order. Grid (BH, ceil(dk/64)); block y owns dq columns
// and M rows [c0, c0 + 64).
// ===========================================================================

size_t dq_smem_bytes() { return sizeof(float) * (size_t)(5 * C * TS + 3 * C); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
chunk_bwd_dq_kernel(const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ la, const T* __restrict__ dO,
                    T* __restrict__ dq, float* __restrict__ m_scratch, int s,
                    int dk, int dv) {
  extern __shared__ float smem[];
  float* kt = smem;              // [C][TS] k rows, columns c0..c0+63
  float* dos = kt + C * TS;      // [C][TS] dO tile
  float* vs = dos + C * TS;      // [C][TS] v tile
  float* ms = vs + C * TS;       // [64][TS] M rows c0.., v tile (old M)
  float* st = ms + C * TS;       // [C][TS] decayed scores dsc[i][j]
  float* cb = st + C * TS;       // [C] inclusive cumulative log decay
  float* w = cb + C;             // [C] e^{A - cb_j}
  float* ecb = w + C;            // [C] e^{cb_i}

  const int bh = blockIdx.x;
  const int c0 = blockIdx.y * DT;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  const T* kb = k + (size_t)bh * s * dk;
  const T* vb = v + (size_t)bh * s * dv;
  const T* dob = dO + (size_t)bh * s * dv;
  const float* lab = la + (size_t)bh * s;
  T* dqb = dq + (size_t)bh * s * dk;
  float* mb = m_scratch + (size_t)bh * dk * dv;

  const int nchunks = (s + C - 1) / C;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int t0 = ch * C;
    const int rows = min(C, s - t0);
    load_tile(kb, dk, t0, rows, c0, kt, tid);
    scan_log_a(lab, t0, rows, cb, tid);
    __syncthreads();
    const float A = cb[C - 1];
    const float eA = expf(A);
    if (tid < C) {
      w[tid] = expf(A - cb[tid]);
      ecb[tid] = expf(cb[tid]);
    }

    float dsc[4][4], inter[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) dsc[r][cc] = inter[r][cc] = 0.f;

    for (int v0 = 0; v0 < dv; v0 += DT) {
      load_tile(dob, dv, t0, rows, v0, dos, tid);
      load_tile(vb, dv, t0, rows, v0, vs, tid);
      // M before this chunk; zero before the first
      for (int idx = tid; idx < DT * DT; idx += THREADS) {
        const int c = idx / DT, j = idx - c * DT;
        ms[c * TS + j] = (ch > 0 && c0 + c < dk && v0 + j < dv)
                             ? mb[(size_t)(c0 + c) * dv + v0 + j]
                             : 0.f;
      }
      __syncthreads();
      // dsc_ij += dO_i . v_j and inter_ic += dO_i . M_c over this v tile
      for (int x = 0; x < DT; ++x) {
        float a[4], b[4], m4[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = dos[(ty + 16 * r) * TS + x];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          b[cc] = vs[(tx + 16 * cc) * TS + x];
          m4[cc] = ms[(tx + 16 * cc) * TS + x];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            dsc[r][cc] = fmaf(a[r], b[cc], dsc[r][cc]);
            inter[r][cc] = fmaf(a[r], m4[cc], inter[r][cc]);
          }
      }
      // M[c, v] <- e^A M[c, v] + sum_j k[j, c] w_j v[j, v]; rows ty + 16 r
      {
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
        for (int j = 0; j < C; ++j) {
          const float wj = w[j];
          float a[4], b[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = kt[j * TS + ty + 16 * r] * wj;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) b[cc] = vs[j * TS + tx + 16 * cc];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              acc[r][cc] = fmaf(a[r], b[cc], acc[r][cc]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int c = ty + 16 * r;
          if (c0 + c < dk) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const int j = tx + 16 * cc;
              if (v0 + j < dv)
                mb[(size_t)(c0 + c) * dv + v0 + j] =
                    fmaf(eA, ms[c * TS + j], acc[r][cc]);
            }
          }
        }
      }
      __syncthreads();   // the next tile's loads overwrite dos, vs, ms
    }

    // decayed score tile: st[i][j] = dsc_ij e^{cb_i - cb_j}, j <= i
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = tx + 16 * cc;
        st[i * TS + j] = (j <= i) ? dsc[r][cc] * expf(cb[i] - cb[j]) : 0.f;
      }
    }
    __syncthreads();

    // dq[i, c] = sum_j st[i][j] k[j, c] + e^{cb_i} inter[i, c]
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
      for (int j = 0; j < C; ++j) {
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = st[(ty + 16 * r) * TS + j];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) b[cc] = kt[j * TS + tx + 16 * cc];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            acc[r][cc] = fmaf(a[r], b[cc], acc[r][cc]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i < rows) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int c = c0 + tx + 16 * cc;
            if (c < dk)
              store(&dqb[(size_t)(t0 + i) * dk + c],
                    fmaf(ecb[i], inter[r][cc], acc[r][cc]));
          }
        }
      }
    }
    __syncthreads();   // the next chunk's loads overwrite kt, cb, w, ecb
  }
}

// ===========================================================================
// K2b: dk, dv, dlog_a, reverse order. Grid (BH, slices); block (bh, z) owns
// dk columns and N rows [z·DKS, z·DKS + DKS) of its bh.
// ===========================================================================

int round16(int x) { return (x + 15) / 16 * 16; }
int n_slices(int dk) { return (dk + DKS - 1) / DKS; }

// at a slice of `wp` columns (a multiple of 16)
size_t dkv_smem_bytes(int wp) {
  return sizeof(float) *
         (size_t)(2 * C * (wp + 1) + 4 * C * TS + wp * TS + 5 * C + 16 * C);
}

// rowsum(dO ⊙ o) of the chunk's rows into rdo[], warp `warp` taking rows
// warp, warp + 8, ...; rows >= `rows` are 0.
template <typename T>
__device__ __forceinline__ void rowsum_do_o(const T* dob, const T* ob,
                                            int dv, int t0, int rows,
                                            float* rdo, int warp, int lane) {
  for (int i = warp; i < C; i += THREADS / 32) {
    float acc = 0.f;
    if (i < rows)
      for (int x = lane; x < dv; x += 32)
        acc = fmaf(to_f32(dob[(size_t)(t0 + i) * dv + x]),
                   to_f32(ob[(size_t)(t0 + i) * dv + x]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) rdo[i] = acc;
  }
}

// dlog_a[m] = sum_{i >= m, this chunk} r_i + (sum of r over later chunks,
// `rsum`): an inclusive suffix scan of rr[] by warp 0, two rows per lane;
// adds this chunk's sum to rsum.
__device__ __forceinline__ void suffix_scan(const float* rr, int t0,
                                            int rows, float* dlab,
                                            float& rsum, int lane) {
  float s0 = rr[lane], s1 = rr[lane + 32];
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
  if (lane < rows) dlab[t0 + lane] = s0 + rsum;
  if (lane + 32 < rows) dlab[t0 + lane + 32] = s1 + rsum;
  rsum += __shfl_sync(0xffffffffu, s0, 0);
}

template <typename T, bool GEN>
__global__ void __launch_bounds__(THREADS)
chunk_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ la,
                     const T* __restrict__ o, const T* __restrict__ dO,
                     const float* __restrict__ dstate, T* __restrict__ dk_out,
                     T* __restrict__ dv_out, float* __restrict__ dla,
                     float* __restrict__ n_scratch,
                     float* __restrict__ dv_part, float* __restrict__ rk_part,
                     int s, int dk, int dv) {
  // this block's dk slice: columns [k0, k0 + wk), wp of them in shared
  // memory; with more than one slice (dv_part non-null) it writes partial
  // dv and rowsum(K ⊙ dk) for the reduction kernel. GEN is false for one
  // slice of a multiple of 16 and dv a multiple of 64, whose masks below
  // then fold away (on the H100 the general build took 6% longer at
  // dk = dv = 128, fp32).
  const int k0 = blockIdx.y * DKS;
  const int wk = GEN ? min(DKS, dk - k0) : dk;
  const int wp = GEN ? (wk + 15) / 16 * 16 : dk;
  const bool split = GEN && dv_part != nullptr;
  auto in_dv = [dv](int x) { return !GEN || x < dv; };
  auto in_dk = [wk](int c) { return !GEN || c < wk; };
  extern __shared__ float smem[];
  const int QS = wp + 1;         // odd row stride of the q and k chunks
  float* qs = smem;              // [C][QS] q chunk
  float* ks = qs + C * QS;       // [C][QS] k chunk
  float* dos = ks + C * QS;      // [C][TS] dO tile
  float* vs = dos + C * TS;      // [C][TS] v tile
  float* scs = vs + C * TS;      // [C][TS] sc[i][j] = (q_i.k_j) D_ij
  float* dscs = scs + C * TS;    // [C][TS] dsc[i][j] = (dO_i.v_j) D_ij
  float* ns = dscs + C * TS;     // [wp][TS] N, v tile (before this chunk)
  float* cb = ns + wp * TS;      // [C]
  float* w = cb + C;             // [C] e^{A - cb_j}
  float* ecb = w + C;            // [C] e^{cb_i}
  float* rdo = ecb + C;          // [C] rowsum(dO ⊙ o)
  float* rr = rdo + C;           // [C] r
  float* rpart = rr + C;         // [16][C] per-tx partial rowsum(K ⊙ dk)

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int ct = wp / 16;        // dk columns (or N rows) per thread

  const T* qb = q + (size_t)bh * s * dk + k0;
  const T* kb = k + (size_t)bh * s * dk + k0;
  const T* vb = v + (size_t)bh * s * dv;
  const T* ob = o + (size_t)bh * s * dv;
  const T* dob = dO + (size_t)bh * s * dv;
  const float* lab = la + (size_t)bh * s;
  const float* dsb = dstate + ((size_t)bh * dk + k0) * dv;
  T* dkb = dk_out + (size_t)bh * s * dk + k0;
  T* dvb = dv_out + (size_t)bh * s * dv;
  float* dlab = dla + (size_t)bh * s;
  float* nb = n_scratch + ((size_t)bh * dk + k0) * dv;
  const size_t slice_bh = (size_t)blockIdx.y * gridDim.x + bh;
  float* dvp = split ? dv_part + slice_bh * s * dv : nullptr;
  float* rkp = split ? rk_part + slice_bh * s : nullptr;

  float rsum = 0.f;              // sum of r over later chunks (warp 0)
  const int nchunks = (s + C - 1) / C;
  for (int ch = nchunks - 1; ch >= 0; --ch) {
    const int t0 = ch * C;
    const int rows = min(C, s - t0);
    // N before this chunk: dM for the last chunk, then the scratch
    const float* nsrc = (ch == nchunks - 1) ? dsb : nb;

    for (int idx = tid; idx < C * wp; idx += THREADS) {
      const int i = idx / wp, c = idx - i * wp;
      float qv = 0.f, kv = 0.f;
      if (i < rows && in_dk(c)) {
        qv = to_f32(qb[(size_t)(t0 + i) * dk + c]);
        kv = to_f32(kb[(size_t)(t0 + i) * dk + c]);
      }
      qs[i * QS + c] = qv;
      ks[i * QS + c] = kv;
    }
    scan_log_a(lab, t0, rows, cb, tid);
    if (!split) rowsum_do_o(dob, ob, dv, t0, rows, rdo, warp, lane);
    __syncthreads();
    const float A = cb[C - 1];
    const float eA = expf(A);
    if (tid < C) {
      w[tid] = expf(A - cb[tid]);
      ecb[tid] = expf(cb[tid]);
    }

    // sc[i][j] = (q_i . k_j) e^{cb_i - cb_j}, j <= i (this slice's part)
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
      for (int c = 0; c < wp; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qs[(ty + 16 * r) * QS + c];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) b[cc] = ks[(tx + 16 * cc) * QS + c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            acc[r][cc] = fmaf(a[r], b[cc], acc[r][cc]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int j = tx + 16 * cc;
          scs[i * TS + j] = (j <= i) ? acc[r][cc] * expf(cb[i] - cb[j]) : 0.f;
        }
      }
    }
    __syncthreads();   // scs, w, ecb visible

    float dsc[4][4];          // dO_i . v_j, rows i = ty + 16 r
    float dkn[4][MAX_CT];     // sum_v v[j, v] N[c, v], rows j = ty + 16 r
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) dsc[r][cc] = 0.f;
#pragma unroll
      for (int cc = 0; cc < MAX_CT; ++cc) dkn[r][cc] = 0.f;
    }

    for (int v0 = 0; v0 < dv; v0 += DT) {
      load_tile(dob, dv, t0, rows, v0, dos, tid);
      load_tile(vb, dv, t0, rows, v0, vs, tid);
      for (int idx = tid; idx < wp * DT; idx += THREADS) {
        const int c = idx / DT, j = idx - c * DT;
        ns[c * TS + j] = (in_dk(c) && in_dv(v0 + j))
                             ? nsrc[(size_t)c * dv + v0 + j] : 0.f;
      }
      __syncthreads();

      for (int x = 0; x < DT; ++x) {
        float a[4], b[4], nc[MAX_CT];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = dos[(ty + 16 * r) * TS + x];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) b[cc] = vs[(tx + 16 * cc) * TS + x];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            dsc[r][cc] = fmaf(a[r], b[cc], dsc[r][cc]);
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = vs[(ty + 16 * r) * TS + x];
#pragma unroll
        for (int cc = 0; cc < MAX_CT; ++cc)
          nc[cc] = (cc < ct) ? ns[(tx + 16 * cc) * TS + x] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < MAX_CT; ++cc)
            if (cc < ct) dkn[r][cc] = fmaf(a[r], nc[cc], dkn[r][cc]);
      }

      // dv[j, v] = sum_i sc[i][j] dO[i, v] + w_j sum_c k[j, c] N[c, v]
      // (over this slice's c: a partial where there are several slices)
      {
        float acc[4][4], kn[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[r][cc] = kn[r][cc] = 0.f;
        for (int i = 0; i < C; ++i) {
          float a[4], b[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = scs[i * TS + ty + 16 * r];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) b[cc] = dos[i * TS + tx + 16 * cc];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              acc[r][cc] = fmaf(a[r], b[cc], acc[r][cc]);
        }
        for (int c = 0; c < wp; ++c) {
          float a[4], b[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = ks[(ty + 16 * r) * QS + c];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) b[cc] = ns[c * TS + tx + 16 * cc];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              kn[r][cc] = fmaf(a[r], b[cc], kn[r][cc]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = ty + 16 * r;
          if (j < rows) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const int x = v0 + tx + 16 * cc;
              if (!in_dv(x)) continue;
              const float g = fmaf(w[j], kn[r][cc], acc[r][cc]);
              if (split)
                dvp[(size_t)(t0 + j) * dv + x] = g;
              else
                store(&dvb[(size_t)(t0 + j) * dv + x], g);
            }
          }
        }
      }

      // N[c, v] <- e^A N[c, v] + sum_i q[i, c] e^{cb_i} dO[i, v]; rows
      // c = ty + 16 r. Reads the tile of the old N, writes the scratch.
      {
        float acc[MAX_CT][4];
#pragma unroll
        for (int r = 0; r < MAX_CT; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
        for (int i = 0; i < C; ++i) {
          const float e = ecb[i];
          float a[MAX_CT], b[4];
#pragma unroll
          for (int r = 0; r < MAX_CT; ++r)
            a[r] = (r < ct) ? qs[i * QS + ty + 16 * r] * e : 0.f;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) b[cc] = dos[i * TS + tx + 16 * cc];
#pragma unroll
          for (int r = 0; r < MAX_CT; ++r) {
            if (r < ct) {
#pragma unroll
              for (int cc = 0; cc < 4; ++cc)
                acc[r][cc] = fmaf(a[r], b[cc], acc[r][cc]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < MAX_CT; ++r) {
          const int c = ty + 16 * r;
          if (r < ct && in_dk(c)) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const int j = tx + 16 * cc;
              if (in_dv(v0 + j))
                nb[(size_t)c * dv + v0 + j] =
                    fmaf(eA, ns[c * TS + j], acc[r][cc]);
            }
          }
        }
      }
      __syncthreads();   // the next tile's loads overwrite dos, vs, ns
    }

    // dsc[i][j] = (dO_i . v_j) e^{cb_i - cb_j}, j <= i
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = tx + 16 * cc;
        dscs[i * TS + j] = (j <= i) ? dsc[r][cc] * expf(cb[i] - cb[j]) : 0.f;
      }
    }
    __syncthreads();

    // dk[j, c] = sum_i dsc[i][j] q[i, c] + w_j dkn[j, c]; then this
    // thread's share of rowsum(K ⊙ dk) for its rows j = ty + 16 r
    {
      float acc[4][MAX_CT];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < MAX_CT; ++cc) acc[r][cc] = 0.f;
      for (int i = 0; i < C; ++i) {
        float a[4], b[MAX_CT];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = dscs[i * TS + ty + 16 * r];
#pragma unroll
        for (int cc = 0; cc < MAX_CT; ++cc)
          b[cc] = (cc < ct) ? qs[i * QS + tx + 16 * cc] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < MAX_CT; ++cc)
            if (cc < ct) acc[r][cc] = fmaf(a[r], b[cc], acc[r][cc]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = ty + 16 * r;
        float part = 0.f;
#pragma unroll
        for (int cc = 0; cc < MAX_CT; ++cc) {
          if (cc < ct) {
            const int c = tx + 16 * cc;
            const float g = fmaf(w[j], dkn[r][cc], acc[r][cc]);
            part = fmaf(ks[j * QS + c], g, part);
            if (j < rows && in_dk(c))
              store(&dkb[(size_t)(t0 + j) * dk + c], g);
          }
        }
        rpart[tx * C + j] = part;
      }
    }
    __syncthreads();
    if (tid < C) {
      float kd = 0.f;
#pragma unroll
      for (int t = 0; t < 16; ++t) kd += rpart[t * C + tid];
      if (split) {
        if (tid < rows) rkp[t0 + tid] = kd;
      } else {
        rr[tid] = rdo[tid] - kd;
      }
    }
    __syncthreads();
    if (!split && tid < 32) suffix_scan(rr, t0, rows, dlab, rsum, lane);
    __syncthreads();   // the next chunk's loads overwrite qs, ks, cb, rr
  }
}

// K2b's reduction over dk slices, one block per bh, last chunk first: dv =
// the slices' partial dv summed in slice order and cast; r = rowsum(dO ⊙
// o) - the slices' partial rowsum(K ⊙ dk) summed in slice order; dlog_a =
// r's suffix sum.
template <typename T>
__global__ void __launch_bounds__(THREADS)
chunk_bwd_dkv_reduce_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                            const float* __restrict__ dv_part,
                            const float* __restrict__ rk_part,
                            T* __restrict__ dv_out, float* __restrict__ dla,
                            int s, int dv, int slices) {
  __shared__ float rdo[C];
  __shared__ float rr[C];
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const size_t n_dv = (size_t)gridDim.x * s * dv;
  const size_t n_rk = (size_t)gridDim.x * s;
  const T* ob = o + (size_t)bh * s * dv;
  const T* dob = dO + (size_t)bh * s * dv;
  float* dlab = dla + (size_t)bh * s;

  float rsum = 0.f;              // sum of r over later chunks (warp 0)
  const int nchunks = (s + C - 1) / C;
  for (int ch = nchunks - 1; ch >= 0; --ch) {
    const int t0 = ch * C;
    const int rows = min(C, s - t0);
    const size_t row0 = (size_t)bh * s + t0;
    for (int idx = tid; idx < rows * dv; idx += THREADS) {
      const size_t at = row0 * dv + idx;
      float acc = dv_part[at];
      for (int t = 1; t < slices; ++t) acc += dv_part[t * n_dv + at];
      store(&dv_out[at], acc);
    }
    rowsum_do_o(dob, ob, dv, t0, rows, rdo, warp, lane);
    __syncthreads();
    if (tid < C) {
      float kd = 0.f;
      if (tid < rows) {
        kd = rk_part[row0 + tid];
        for (int t = 1; t < slices; ++t) kd += rk_part[t * n_rk + row0 + tid];
      }
      rr[tid] = rdo[tid] - kd;
    }
    __syncthreads();
    if (tid < 32) suffix_scan(rr, t0, rows, dlab, rsum, lane);
    __syncthreads();   // the next chunk overwrites rdo, rr
  }
}

template <typename K>
int raise_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch_dq(const void* k, const void* v, const void* la, const void* dO,
              void* dq, void* m_scratch, int bh, int s, int dk, int dv,
              cudaStream_t stream) {
  const size_t smem = dq_smem_bytes();
  const int err = raise_smem(chunk_bwd_dq_kernel<T>, smem);
  if (err) return err;
  const dim3 grid(bh, (dk + DT - 1) / DT);
  chunk_bwd_dq_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(la), static_cast<const T*>(dO),
      static_cast<T*>(dq), static_cast<float*>(m_scratch), s, dk, dv);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* la,
               const void* o, const void* dO, const void* dstate,
               void* dk_out, void* dv_out, void* dla, void* n_scratch,
               void* work, int work_slices, int bh, int s, int dk, int dv,
               cudaStream_t stream) {
  const int slices = n_slices(dk);
  if (slices > 1 && (work == nullptr || work_slices < slices))
    return (int)cudaErrorInvalidValue;
  const size_t smem = dkv_smem_bytes(round16(std::min(dk, DKS)));
  const bool gen = slices > 1 || dk % 16 || dv % DT;
  auto kernel = gen ? chunk_bwd_dkv_kernel<T, true>
                    : chunk_bwd_dkv_kernel<T, false>;
  int err = raise_smem(kernel, smem);
  if (err) return err;
  float* dv_part = slices > 1 ? static_cast<float*>(work) : nullptr;
  float* rk_part =
      slices > 1 ? dv_part + (size_t)slices * bh * s * dv : nullptr;
  kernel<<<dim3(bh, slices), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(la),
      static_cast<const T*>(o), static_cast<const T*>(dO),
      static_cast<const float*>(dstate), static_cast<T*>(dk_out),
      static_cast<T*>(dv_out), static_cast<float*>(dla),
      static_cast<float*>(n_scratch), dv_part, rk_part, s, dk, dv);
  err = (int)cudaGetLastError();
  if (err || slices == 1) return err;
  chunk_bwd_dkv_reduce_kernel<T><<<bh, THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dO), dv_part, rk_part,
      static_cast<T*>(dv_out), static_cast<float*>(dla), s, dv, slices);
  return (int)cudaGetLastError();
}

}  // namespace

// k: (bh, s, dk); v, dO: (bh, s, dv) in bf16 (is_bf16 = 1) or fp32; la:
// (bh, s) fp32; dq: (bh, s, dk) out, input dtype; m_scratch: (bh, dk, dv)
// fp32, any contents. All contiguous; any s, dk, dv >= 1. Returns the
// launch's cudaGetLastError().
extern "C" int lasp2_chunk_bwd_dq(const void* k, const void* v,
                                  const void* la, const void* dO, void* dq,
                                  void* m_scratch, int bh, int s, int dk,
                                  int dv, int is_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dq<__nv_bfloat16>(k, v, la, dO, dq, m_scratch, bh, s, dk,
                                    dv, st);
  return launch_dq<float>(k, v, la, dO, dq, m_scratch, bh, s, dk, dv, st);
}

// q, k: (bh, s, dk); v, o, dO: (bh, s, dv) in bf16 (is_bf16 = 1) or fp32;
// la: (bh, s) and dstate: (bh, dk, dv) fp32; dk_out, dv_out out in the
// input dtype, dla: (bh, s) fp32 out; n_scratch: (bh, dk, dv) fp32, any
// contents; work: work_slices x bh x s x (dv + 1) fp32, at least
// ceil(dk / 128) slices where dk > 128 (the slices' partial dv, then their
// partial rowsum(K ⊙ dk)), else unused (may be null; a smaller workspace
// gives cudaErrorInvalidValue). All contiguous, shapes as for
// lasp2_chunk_bwd_dq. Returns the launches' cudaGetLastError().
extern "C" int lasp2_chunk_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* la,
                                   const void* o, const void* dO,
                                   const void* dstate, void* dk_out,
                                   void* dv_out, void* dla, void* n_scratch,
                                   void* work, int work_slices, int bh,
                                   int s, int dk, int dv, int is_bf16,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dkv<__nv_bfloat16>(q, k, v, la, o, dO, dstate, dk_out,
                                     dv_out, dla, n_scratch, work,
                                     work_slices, bh, s, dk, dv, st);
  return launch_dkv<float>(q, k, v, la, o, dO, dstate, dk_out, dv_out, dla,
                           n_scratch, work, work_slices, bh, s, dk, dv, st);
}
