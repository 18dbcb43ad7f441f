// Chunked decayed causal linear attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `lasp2_chunk_fwd` / `_kernel` in
// src/repro/kernels/lasp2_chunk.py. Same function: for q, k (BH, S, dk),
// v (BH, S, dv) in bf16 or fp32 and log_a (BH, S) fp32, chunk by chunk
//   cb = inclusive cumsum(log a), A = cb_last,
//   o  = (Q K^T ⊙ D) V + (Q ⊙ e^{cb}) M,   D_ij = e^{cb_i - cb_j} (i >= j),
//   M <- e^{A} M + (K ⊙ e^{A - cb})^T V,
// returning o (q's dtype), the final M (BH, dk, dv) fp32 and sum(log a).
//
// What bounds it on this card: at the serving shape (BH 64, S 512,
// dk = dv = 128, bf16) the bytes it must move (~38 MB) take ~11 us at
// 3.35 TB/s and the matrix products ~3 us at the bf16 tensor-core rate, so
// the bound is bytes. This first version does its products in fp32 on the
// CUDA cores out of shared memory (no wgmma, no TMA), so it is bound by
// shared-memory traffic and fp32 issue rate instead; PERF.md keeps its
// time beside the bound.
//
// Design. The Pallas grid (BH, S/BLOCK) carries M across an ordered block
// axis in VMEM scratch. CUDA blocks run in no order, so the loop over
// sequence chunks moves inside a thread block and M stays in shared
// memory in fp32 for the whole sequence. The columns of o and M are
// independent across v, so the grid is (BH, ceil(dv/64)): at BH 64, dv 128
// that is 128 blocks for 132 SMs, where one block per bh would leave half the
// card idle. The chunk is 64 rows (the block size is a schedule, not
// semantics: re-blocking the scan is exact up to summation order); a
// ragged last chunk is zero-filled (q = k = v = 0, log a = 0), which adds
// nothing to M and leaves the decay alone, so any S is exact and only rows
// < S are stored. All decay math is fp32 in log space; every factor is
// <= 1, including the RESET_LOG_A = -60 resets of left-padded prefill.
//
// Any dk and dv. The last 64-column tile of v is ragged: its loads are
// zero-filled and its stores masked. dk goes in slices of at most
// DKS = 128 rows, each zero-filled up to a multiple of 16 in shared memory
// (zero rows of q and k add nothing to a score, and their rows of M stay
// zero and are never stored), so any width is exact. o is a sum over the
// slices, o = sum_t [(Q_t K_t^T ⊙ D) V + (Q_t ⊙ e^{cb}) M_t], and each
// slice's rows M_t of the state update on their own. So where dk is wider
// than one slice (the taylor feature map's 1 + dh + dh^2: 1057 at dh 32,
// 16513 at dh 128) the grid gains a slice axis, (BH, ceil(dv/64), slices):
// each block carries its slice's M_t, writes its rows of the final state,
// and writes its partial o in fp32 to a workspace; a second kernel of the
// same entry sums the partials in slice order and casts. No atomics, so
// two launches give the same bits.
//
// Shared memory at a 128-row slice: q and k k-major (2 x 128 x 65 fp32),
// k row-major (64 x 128), the v tile (64 x 64), the decayed score tile
// (64 x 65) and M (128 x 64): 166 KB, above the default 48 KB, so the
// entry raises the kernel's dynamic shared-memory limit first.
//
// Each product is an outer-product loop: per step of the reduction a
// thread reads 4 values of each operand and updates a 4 x 4 register
// tile (16 x 16 threads cover a 64 x 64 output). The k-major layouts keep
// those reads free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int C = 64;          // sequence rows per chunk
constexpr int CP = C + 1;      // padded row of the k-major tiles
constexpr int DVT = 64;        // v columns per thread block
constexpr int THREADS = 256;   // 16 x 16
constexpr int DKS = 128;       // dk rows per slice
constexpr int MAX_RT = DKS / 16;     // M rows per thread (state update)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

int round16(int x) { return (x + 15) / 16 * 16; }
int n_slices(int dk) { return (dk + DKS - 1) / DKS; }

// at a slice of `wp` rows (a multiple of 16)
size_t smem_bytes(int wp) {
  return sizeof(float) *
         (size_t)(2 * wp * CP + C * wp + C * DVT + C * CP + wp * DVT + 2 * C);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
chunk_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ la,
                 T* __restrict__ o, float* __restrict__ o_part,
                 float* __restrict__ state, float* __restrict__ log_decay,
                 int s, int dk, int dv) {
  // this block's dk slice: rows [k0, k0 + wk), wp of them in shared memory
  const int k0 = blockIdx.z * DKS;
  const int wk = min(DKS, dk - k0);
  const int wp = (wk + 15) / 16 * 16;
  extern __shared__ float smem[];
  float* qt = smem;              // [wp][CP] q, k-major
  float* kt = qt + wp * CP;      // [wp][CP] k, k-major
  float* kn = kt + wp * CP;      // [C][wp]  k, row-major
  float* vs = kn + C * wp;       // [C][DVT] v tile
  float* st = vs + C * DVT;      // [C][CP]  decayed scores, st[j][i] = S_ij
  float* m = st + C * CP;        // [wp][DVT] carried state, this slice
  float* cb = m + wp * DVT;      // [C] inclusive cumulative log decay
  float* w = cb + C;             // [C] e^{A - cb_j}

  const int bh = blockIdx.x;
  const int v0 = blockIdx.y * DVT;
  const int vw = min(DVT, dv - v0);  // columns of this v tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int rt = wp / 16;        // M rows owned per thread

  const T* qb = q + (size_t)bh * s * dk + k0;
  const T* kb = k + (size_t)bh * s * dk + k0;
  const T* vb = v + (size_t)bh * s * dv + v0;
  const float* lab = la + (size_t)bh * s;
  T* ob = o + (size_t)bh * s * dv + v0;
  // the partial o of this slice (split launches only)
  float* pb = o_part == nullptr ? nullptr
      : o_part + ((size_t)blockIdx.z * gridDim.x + bh) * s * dv + v0;

  for (int i = tid; i < wp * DVT; i += THREADS) m[i] = 0.f;
  float ld_total = 0.f;

  const int nchunks = (s + C - 1) / C;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * C;
    const int rows = min(C, s - t0);

    // -- load the chunk; rows past the end are zero -----------------------
    for (int idx = tid; idx < C * wp; idx += THREADS) {
      const int i = idx / wp, kk = idx - i * wp;
      float qv = 0.f, kv = 0.f;
      if (i < rows && kk < wk) {
        qv = to_f32(qb[(size_t)(t0 + i) * dk + kk]);
        kv = to_f32(kb[(size_t)(t0 + i) * dk + kk]);
      }
      qt[kk * CP + i] = qv;
      kt[kk * CP + i] = kv;
      kn[i * wp + kk] = kv;
    }
    for (int idx = tid; idx < C * DVT; idx += THREADS) {
      const int i = idx / DVT, j = idx - i * DVT;
      vs[idx] = (i < rows && j < vw)
                    ? to_f32(vb[(size_t)(t0 + i) * dv + j]) : 0.f;
    }
    // inclusive scan of log a over the 64 rows, by warp 0
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
    __syncthreads();
    const float A = cb[C - 1];
    if (tid < C) w[tid] = expf(A - cb[tid]);
    if (tid == 0) ld_total += A;

    // -- decayed scores S_ij = (q_i . k_j) e^{cb_i - cb_j}, j <= i ----------
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
      for (int kk = 0; kk < wp; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qt[kk * CP + ty + 16 * r];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) b[cc] = kt[kk * CP + tx + 16 * cc];
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
          const float d = (j <= i) ? expf(cb[i] - cb[j]) : 0.f;
          st[j * CP + i] = acc[r][cc] * d;
        }
      }
    }
    __syncthreads();

    // -- o = S V + e^{cb} (Q M), with M the state before this chunk --------
    {
      float intra[4][4], inter[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) intra[r][cc] = inter[r][cc] = 0.f;
      for (int j = 0; j < C; ++j) {
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = st[j * CP + ty + 16 * r];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) b[cc] = vs[j * DVT + tx + 16 * cc];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            intra[r][cc] = fmaf(a[r], b[cc], intra[r][cc]);
      }
      for (int kk = 0; kk < wp; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qt[kk * CP + ty + 16 * r];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) b[cc] = m[kk * DVT + tx + 16 * cc];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            inter[r][cc] = fmaf(a[r], b[cc], inter[r][cc]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i < rows) {
          const float e = expf(cb[i]);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int j = tx + 16 * cc;
            if (j >= vw) continue;
            const float out = fmaf(e, inter[r][cc], intra[r][cc]);
            if (pb == nullptr)
              store(&ob[(size_t)(t0 + i) * dv + j], out);
            else
              pb[(size_t)(t0 + i) * dv + j] = out;
          }
        }
      }
    }
    __syncthreads();   // every read of the old M is done

    // -- M <- e^A M + (K ⊙ w)^T V; this thread owns rows ty + 16 r ---------
    {
      float acc[MAX_RT][4];
#pragma unroll
      for (int r = 0; r < MAX_RT; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
      for (int j = 0; j < C; ++j) {
        const float wj = w[j];
        float b[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) b[cc] = vs[j * DVT + tx + 16 * cc];
#pragma unroll
        for (int r = 0; r < MAX_RT; ++r) {
          if (r < rt) {
            const float a = kn[j * wp + ty + 16 * r] * wj;
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              acc[r][cc] = fmaf(a, b[cc], acc[r][cc]);
          }
        }
      }
      const float eA = expf(A);
#pragma unroll
      for (int r = 0; r < MAX_RT; ++r) {
        if (r < rt) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            float* p = &m[(ty + 16 * r) * DVT + tx + 16 * cc];
            *p = fmaf(eA, *p, acc[r][cc]);
          }
        }
      }
    }
    __syncthreads();   // the next chunk's loads overwrite kn and vs
  }

  float* sb = state + ((size_t)bh * dk + k0) * dv + v0;
  for (int idx = tid; idx < wk * DVT; idx += THREADS) {
    const int kk = idx / DVT, j = idx - kk * DVT;
    if (j < vw) sb[(size_t)kk * dv + j] = m[idx];
  }
  if (blockIdx.y == 0 && blockIdx.z == 0 && tid == 0)
    log_decay[bh] = ld_total;
}

// o = the slices' partial o summed in slice order, cast to T.
template <typename T>
__global__ void __launch_bounds__(THREADS)
chunk_fwd_reduce_kernel(const float* __restrict__ o_part, T* __restrict__ o,
                        size_t n, int slices) {
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS) {
    float acc = o_part[i];
    for (int t = 1; t < slices; ++t) acc += o_part[(size_t)t * n + i];
    store(&o[i], acc);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* la,
           void* o, void* state, void* log_decay, void* work,
           int work_slices, int bh, int s, int dk, int dv,
           cudaStream_t stream) {
  const int slices = n_slices(dk);
  if (slices > 1 && (work == nullptr || work_slices < slices))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(round16(std::min(dk, DKS)));
  cudaError_t err = cudaFuncSetAttribute(
      chunk_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* o_part = slices > 1 ? static_cast<float*>(work) : nullptr;
  const dim3 grid(bh, (dv + DVT - 1) / DVT, slices);
  chunk_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(la),
      static_cast<T*>(o), o_part, static_cast<float*>(state),
      static_cast<float*>(log_decay), s, dk, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const size_t n = (size_t)bh * s * dv;
  const int blocks = (int)std::min<size_t>((n + THREADS - 1) / THREADS, 4096);
  chunk_fwd_reduce_kernel<T><<<blocks, THREADS, 0, stream>>>(
      o_part, static_cast<T*>(o), n, slices);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k: (bh, s, dk); v, o: (bh, s, dv) in bf16 (is_bf16 = 1) or fp32;
// la: (bh, s) fp32; state: (bh, dk, dv) fp32; log_decay: (bh,) fp32; work:
// work_slices x bh x s x dv fp32, at least ceil(dk / 128) slices where
// dk > 128 (the slices' partial o), else unused (may be null; a smaller
// workspace gives cudaErrorInvalidValue). All contiguous; any s, dk, dv >=
// 1. Returns the launches' cudaGetLastError().
extern "C" int lasp2_chunk_fwd(const void* q, const void* k, const void* v,
                               const void* la, void* o, void* state,
                               void* log_decay, void* work, int work_slices,
                               int bh, int s, int dk, int dv, int is_bf16,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, la, o, state, log_decay, work,
                                 work_slices, bh, s, dk, dv, st);
  return launch<float>(q, k, v, la, o, state, log_decay, work, work_slices,
                       bh, s, dk, dv, st);
}
