// GQA flash attention, both backward passes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of `_bwd_call` in
// src/repro/kernels/flash_attention.py: `_bwd_dq_kernel` (the dq pass, K5a)
// and `_bwd_dkv_kernel` (the dk/dv pass, K5b). Same functions: with the
// forward's mask (flash_attention_fwd.cu), its saved lse (fp32) and
// delta = rowsum(dO * o) (fp32, computed by the caller),
//   p  = valid ? exp(s - lse) : 0,   s = (q k^T) * scale,
//   ds = p * (dO v^T - delta),
//   dq = scale * ds k                                   (K5a, q's dtype)
//   dv = sum over the GQA group of p^T dO,
//   dk = scale * sum over the GQA group of ds^T q       (K5b, k's dtype).
//
// What bounds them on this card: at the hybrid's train shape (B 4, H 16,
// S 2048, dh 128, bf16, causal) K5a does three products over the causal
// half (~103 GFLOP, ~0.10 ms at the bf16 tensor-core rate) and K5b four
// (~137 GFLOP, ~0.14 ms), against 0.05-0.08 ms for their bytes: both are
// bound by operations. This first version does the products in fp32 on the
// CUDA cores out of shared memory, far from that bound; PERF.md keeps the
// times beside it.
//
// Design. The Pallas grids walk their bands on ordered axes with the sums
// in VMEM scratch. Here:
// * K5a: one thread block per (b, h, 64-row q tile), as the forward; the kv
//   band is a loop with run-time bounds (`_kv_band`); dq accumulates in
//   registers (a 4 x dh/16 tile per thread) and is written once.
// * K5b: kv-major, one thread block per (b, kv head, 64-row kv tile). The k
//   and v tiles stay in shared memory while the group's Hq/Hkv query heads
//   and, for each, the transposed band of q tiles (`_q_band`, run-time
//   bounds) stream by; dk and dv accumulate over the whole group in fp32
//   registers and are written once. Each block owns its outputs, so there
//   are no atomics and the results are deterministic.
// Ragged q or kv tails are zero-filled and masked; a kv tile past kv_len
// gets zero dk and dv.
//
// Any head dim up to 128, as the forward: built at DH = 16, 32, 64 and 128,
// a dh in between at the next width up (PAD), head columns past dh
// zero-filled on load and never stored; a dh equal to a built width runs
// the unpadded build, its strides compile-time constants.
//
// Shared memory at dh = 128 (fp32 tiles, odd row stride 65): K5a holds q,
// dO, k and v k-major and the ds tile (146 KB); K5b holds k, v, q and dO
// k-major and the p and ds tiles (163 KB). Both raise the dynamic limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // key rows per tile
constexpr int P = 65;          // padded row of the k-major tiles
constexpr int THREADS = 256;   // 16 x 16

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__host__ __device__ __forceinline__ int floordiv(int a, int b) {
  return (a >= 0) ? a / b : -((-a + b - 1) / b);
}

struct Mask {
  int q_offset, kv_len, causal, has_window, window;
  __device__ __forceinline__ bool operator()(int qpos, int kpos) const {
    bool ok = kpos < kv_len;
    if (causal) ok = ok && qpos >= kpos;
    if (has_window) ok = ok && (qpos - kpos) < window;
    return ok;
  }
};

// 64 rows of a (rows_total, dh) tensor from `src` into a k-major tile
// [DH][P]; rows past `rows` and columns past dh are zero.
template <typename T, int DH>
__device__ __forceinline__ void load_kmajor(float* dst, const T* src,
                                            int rows, int dh, int tid) {
  for (int idx = tid; idx < 64 * DH; idx += THREADS) {
    const int i = idx / DH, d = idx - i * DH;
    dst[d * P + i] =
        (i < rows && d < dh) ? to_f32(src[(size_t)i * dh + d]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// K5a: dq, q-major over the forward band.
// ---------------------------------------------------------------------------

template <int DH>
size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * DH * P + BK * P);
}

template <typename T, int DH, bool PAD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int hq, int hkv, int sq, int sk, int dh_in, Mask mask,
                    float scale) {
  constexpr int NC = DH / 16;
  const int dh = PAD ? dh_in : DH;  // a constant unless padded
  extern __shared__ float smem[];
  float* qt = smem;            // [DH][P] q tile, k-major
  float* dot = qt + DH * P;    // [DH][P] dO tile, k-major
  float* kt = dot + DH * P;    // [DH][P] k tile, k-major
  float* vt = kt + DH * P;     // [DH][P] v tile, k-major
  float* dst = vt + DH * P;    // [BK][P] ds tile, dst[j][i] = ds_ij

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = iq * BQ;
  const int qrows = min(BQ, sq - q0);
  const size_t qrow0 = (size_t)(b * hq + h) * sq + q0;
  const T* kb = k + (size_t)(b * hkv + g) * sk * dh;
  const T* vb = v + (size_t)(b * hkv + g) * sk * dh;

  load_kmajor<T, DH>(qt, q + qrow0 * dh, qrows, dh, tid);
  load_kmajor<T, DH>(dot, dout + qrow0 * dh, qrows, dh, tid);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    lse_r[r] = (i < qrows) ? lse[qrow0 + i] : 0.f;
    delta_r[r] = (i < qrows) ? delta[qrow0 + i] : 0.f;
  }

  int hi = (mask.kv_len + BK - 1) / BK - 1;
  if (mask.causal)
    hi = min(hi, floordiv(mask.q_offset + q0 + qrows - 1, BK));
  int lo = 0;
  if (mask.has_window)
    lo = max(0, floordiv(mask.q_offset + q0 - (mask.window - 1), BK));

  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int ik = lo; ik <= hi; ++ik) {
    const int k0 = ik * BK;
    const int krows = min(BK, sk - k0);
    __syncthreads();   // the last step's reads of kt, vt, dst are done
    load_kmajor<T, DH>(kt, kb + (size_t)k0 * dh, krows, dh, tid);
    load_kmajor<T, DH>(vt, vb + (size_t)k0 * dh, krows, dh, tid);
    __syncthreads();

    // s = q k^T and dp = dO v^T, one pass over dh
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float a[4], e[4], bk[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = qt[d * P + ty + 16 * r];
        e[r] = dot[d * P + ty + 16 * r];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        bk[c] = kt[d * P + tx + 16 * c];
        bv[c] = vt[d * P + tx + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(a[r], bk[c], s[r][c]);
          dp[r][c] = fmaf(e[r], bv[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = mask.q_offset + q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        const float p =
            mask(qpos, kpos) ? expf(s[r][c] * scale - lse_r[r]) : 0.f;
        dst[(tx + 16 * c) * P + ty + 16 * r] = p * (dp[r][c] - delta_r[r]);
      }
    }
    __syncthreads();

    // acc += ds k; k[j][d] is read from the k-major tile
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float a[4], bb[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = dst[j * P + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < NC; ++c) bb[c] = kt[(tx + 16 * c) * P + j];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(a[r], bb[c], acc[r][c]);
    }
  }

  T* dqb = dq + qrow0 * dh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    if (i < qrows) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (tx + 16 * c < dh)
          store(&dqb[(size_t)i * dh + tx + 16 * c], acc[r][c] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// K5b: dk and dv, kv-major over the transposed band, summed over the group.
// ---------------------------------------------------------------------------

template <int DH>
size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(4 * DH * P + 2 * BQ * P + 2 * BQ);
}

template <typename T, int DH, bool PAD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int hq, int hkv, int sq, int sk,
                     int dh_in, Mask mask, float scale) {
  constexpr int NC = DH / 16;
  const int dh = PAD ? dh_in : DH;  // a constant unless padded
  extern __shared__ float smem[];
  float* kt = smem;            // [DH][P] k tile, k-major (whole block)
  float* vt = kt + DH * P;     // [DH][P] v tile, k-major (whole block)
  float* qt = vt + DH * P;     // [DH][P] q tile, k-major
  float* dot = qt + DH * P;    // [DH][P] dO tile, k-major
  float* pt = dot + DH * P;    // [BQ][P] pt[i][j] = p_ij
  float* dst = pt + BQ * P;    // [BQ][P] dst[i][j] = ds_ij
  float* lse_s = dst + BQ * P; // [BQ]
  float* delta_s = lse_s + BQ; // [BQ]

  const int ik = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int rep = hq / hkv;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = ik * BK;
  const int krows = min(BK, sk - k0);
  const size_t krow0 = (size_t)(b * hkv + g) * sk + k0;

  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  // The transposed band of this kv tile (_q_band as run-time loop bounds):
  // q tiles holding a row that may see one of keys k0 .. klast.
  const int klast = min(k0 + krows, mask.kv_len) - 1;
  const int nq = (sq + BQ - 1) / BQ;
  int lo = 0, hi = -1;
  if (klast >= k0) {
    hi = nq - 1;
    if (mask.causal) lo = max(0, floordiv(k0 - mask.q_offset, BQ));
    if (mask.has_window)
      hi = min(hi, floordiv(klast + mask.window - 1 - mask.q_offset, BQ));
    load_kmajor<T, DH>(kt, k + krow0 * dh, krows, dh, tid);
    load_kmajor<T, DH>(vt, v + krow0 * dh, krows, dh, tid);
  }

  for (int hg = 0; hg < rep && lo <= hi; ++hg) {
    const int h = g * rep + hg;
    for (int iq = lo; iq <= hi; ++iq) {
      const int q0 = iq * BQ;
      const int qrows = min(BQ, sq - q0);
      const size_t qrow0 = (size_t)(b * hq + h) * sq + q0;
      __syncthreads();   // the last step's reads of qt, dot, pt, dst done
      load_kmajor<T, DH>(qt, q + qrow0 * dh, qrows, dh, tid);
      load_kmajor<T, DH>(dot, dout + qrow0 * dh, qrows, dh, tid);
      if (tid < BQ) {
        lse_s[tid] = (tid < qrows) ? lse[qrow0 + tid] : 0.f;
        delta_s[tid] = (tid < qrows) ? delta[qrow0 + tid] : 0.f;
      }
      __syncthreads();

      // s^T = k q^T and dp^T = v dO^T: rows j = ty + 16 r, columns
      // i = tx + 16 c
      float s[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        float ak[4], av[4], bq[4], bo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ak[r] = kt[d * P + ty + 16 * r];
          av[r] = vt[d * P + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          bq[c] = qt[d * P + tx + 16 * c];
          bo[c] = dot[d * P + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[r][c] = fmaf(ak[r], bq[c], s[r][c]);
            dp[r][c] = fmaf(av[r], bo[c], dp[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kpos = k0 + ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = tx + 16 * c;
          const int qpos = mask.q_offset + q0 + i;
          const float p = (i < qrows && mask(qpos, kpos))
                              ? expf(s[r][c] * scale - lse_s[i])
                              : 0.f;
          pt[i * P + ty + 16 * r] = p;
          dst[i * P + ty + 16 * r] = p * (dp[r][c] - delta_s[i]);
        }
      }
      __syncthreads();

      // dv += p^T dO and dk += ds^T q; dO[i][d], q[i][d] from the k-major
      // tiles
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float ap[4], as[4], bo[NC], bq[NC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ap[r] = pt[i * P + ty + 16 * r];
          as[r] = dst[i * P + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          bo[c] = dot[(tx + 16 * c) * P + i];
          bq[c] = qt[(tx + 16 * c) * P + i];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc_v[r][c] = fmaf(ap[r], bo[c], acc_v[r][c]);
            acc_k[r][c] = fmaf(as[r], bq[c], acc_k[r][c]);
          }
      }
    }
  }

  T* dkb = dk + krow0 * dh;
  T* dvb = dv + krow0 * dh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = ty + 16 * r;
    if (j < krows) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (tx + 16 * c >= dh) continue;
        store(&dkb[(size_t)j * dh + tx + 16 * c], acc_k[r][c] * scale);
        store(&dvb[(size_t)j * dh + tx + 16 * c], acc_v[r][c]);
      }
    }
  }
}

template <typename T, int DH, bool PAD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int b, int hq,
              int hkv, int sq, int sk, int dh, Mask mask, float scale,
              cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DH, PAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  flash_bwd_dq_kernel<T, DH, PAD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), hq, hkv, sq, sk, dh, mask, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH, bool PAD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int b,
               int hq, int hkv, int sq, int sk, int dh, Mask mask, float scale,
               cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, DH, PAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sk + BK - 1) / BK, hkv, b);
  flash_bwd_dkv_kernel<T, DH, PAD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), hq, hkv, sq, sk, dh, mask,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH, bool PAD>
int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, void* out0,
        void* out1, int b, int hq, int hkv, int sq, int sk, int dh, Mask mask,
        float scale, cudaStream_t st) {
  if (which == 0)
    return launch_dq<T, DH, PAD>(q, k, v, dout, lse, delta, out0, b, hq, hkv,
                                 sq, sk, dh, mask, scale, st);
  return launch_dkv<T, DH, PAD>(q, k, v, dout, lse, delta, out0, out1, b, hq,
                                hkv, sq, sk, dh, mask, scale, st);
}

// the smallest built width that holds dh, padded unless dh is that width
template <typename T>
int dispatch(int which, int dh, const void* q, const void* k, const void* v,
             const void* dout, const void* lse, const void* delta, void* out0,
             void* out1, int b, int hq, int hkv, int sq, int sk, Mask mask,
             float scale, cudaStream_t st) {
  auto go = [&](auto width) {
    constexpr int W = decltype(width)::value;
    if (dh == W)
      return run<T, W, false>(which, q, k, v, dout, lse, delta, out0, out1, b,
                              hq, hkv, sq, sk, dh, mask, scale, st);
    return run<T, W, true>(which, q, k, v, dout, lse, delta, out0, out1, b,
                           hq, hkv, sq, sk, dh, mask, scale, st);
  };
  if (dh < 1) return (int)cudaErrorInvalidValue;
  if (dh <= 16) return go(std::integral_constant<int, 16>());
  if (dh <= 32) return go(std::integral_constant<int, 32>());
  if (dh <= 64) return go(std::integral_constant<int, 64>());
  if (dh <= 128) return go(std::integral_constant<int, 128>());
  return (int)cudaErrorInvalidValue;
}

int entry(int which, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, const void* delta, void* out0,
          void* out1, int b, int hq, int hkv, int sq, int sk, int dh,
          int q_offset, int kv_len, int causal, int has_window, int window,
          int is_bf16, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Mask mask{q_offset, kv_len, causal, has_window, window};
  if (is_bf16)
    return dispatch<__nv_bfloat16>(which, dh, q, k, v, dout, lse, delta, out0,
                                   out1, b, hq, hkv, sq, sk, mask, scale, st);
  return dispatch<float>(which, dh, q, k, v, dout, lse, delta, out0, out1, b,
                         hq, hkv, sq, sk, mask, scale, st);
}

}  // namespace

// q, dout: (b, hq, sq, dh); k, v: (b, hkv, sk, dh), one dtype, bf16
// (is_bf16 = 1) or fp32; lse, delta: (b, hq, sq) fp32; dq like q. All
// contiguous. Needs 1 <= dh <= 128, hq % hkv == 0, 1 <= kv_len <= sk (the
// wrapper checks). Returns the launch's cudaGetLastError().
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int b, int hq, int hkv, int sq,
                                      int sk, int dh, int q_offset, int kv_len,
                                      int causal, int has_window, int window,
                                      int is_bf16, float scale, void* stream) {
  return entry(0, q, k, v, dout, lse, delta, dq, nullptr, b, hq, hkv, sq, sk,
               dh, q_offset, kv_len, causal, has_window, window, is_bf16,
               scale, stream);
}

// As above; dk, dv: (b, hkv, sk, dh) in k's dtype.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int b, int hq,
                                       int hkv, int sq, int sk, int dh,
                                       int q_offset, int kv_len, int causal,
                                       int has_window, int window, int is_bf16,
                                       float scale, void* stream) {
  return entry(1, q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, sq, sk, dh,
               q_offset, kv_len, causal, has_window, window, is_bf16, scale,
               stream);
}
