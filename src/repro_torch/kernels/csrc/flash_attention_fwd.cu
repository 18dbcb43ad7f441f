// GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_call` / `_fwd_kernel` in
// src/repro/kernels/flash_attention.py. Same function: for q (B, Hq, Sq, dh)
// and k, v (B, Hkv, Sk, dh) in bf16 or fp32, with query row i at global
// position q_offset + i and key row j at j,
//   valid_ij = j < kv_len [& i_pos >= j if causal]
//                         [& i_pos - j < window if a window is set],
//   s = (q k^T) * scale, masked to mask_value = finfo(fp32).min / 2,
//   online softmax over kv tiles: m, l, acc in fp32, p zeroed where invalid,
//   o = acc / max(l, 1e-30) (q's dtype), lse = m + log(max(l, 1e-30)) fp32.
// The kv head of query head h is h / (Hq / Hkv).
//
// What bounds it on this card: at the hybrid's train shape (B 4, H 16,
// S 2048, dh 128, bf16, causal) the two products over the causal half are
// ~69 GFLOP, ~0.07 ms at the bf16 tensor-core rate, against ~0.04 ms for
// the 134 MB it must move: the bound is operations. This first version does
// its products in fp32 on the CUDA cores out of shared memory (no mma, no
// TMA), so it runs far from that bound; PERF.md keeps its time beside it.
//
// Design. The Pallas grid (B, Hq, nq, band) walks the kv band on an ordered
// axis with (m, l, acc) in VMEM scratch. Here one thread block owns one
// (b, h, 64-row q tile) and the band is a loop inside it, its bounds worked
// out at run time from q_offset, window, causal and kv_len (the `_kv_band`
// of the reference as loop bounds), so the band is trimmed for any offset.
// (m, l) of a row live in the registers of the 16 threads that share the
// row (identical copies: xor-shuffle reductions give every lane the same
// value), acc in registers as a 4 x dh/16 tile per thread. A ragged q or kv
// tail is zero-filled and masked; rows >= Sq are not stored.
//
// Any head dim up to 128: the kernel is built at DH = 16, 32, 64 and 128
// and a dh in between runs at the next width up (PAD), its head columns
// past dh zero-filled on load (zeros add nothing to q·k or to p·v) and
// never stored; the scale comes from the true dh (the caller's). A dh
// equal to a built width runs the unpadded build, whose strides are
// compile-time constants: on the H100 the padded build at dh 128 (fp32,
// B 4 x 16 heads x 2048) took 6.06 ms where the unpadded one takes 3.96.
//
// Shared memory at dh = 128: the q and k tiles k-major (2 x 128 x 65 fp32),
// the v tile (64 x 128) and the probability tile (64 x 65): 116 KB, above
// the default 48 KB, so the entry raises the dynamic limit first. The odd
// row stride keeps the column reads of the k-major tiles off shared bank
// conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // key rows per band step
constexpr int P = 65;          // padded row of the k-major tiles
constexpr int THREADS = 256;   // 16 x 16
constexpr float NEG = -1.70141173319264429e38f;   // finfo(fp32).min / 2

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

template <int DH>
size_t smem_bytes() {
  return sizeof(float) * (size_t)(2 * DH * P + BK * DH + BK * P);
}

template <typename T, int DH, bool PAD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int hq, int hkv, int sq, int sk,
                 int dh_in, int q_offset, int kv_len, int causal,
                 int has_window, int window, float scale) {
  constexpr int NC = DH / 16;  // output columns per thread (DH >= dh)
  const int dh = PAD ? dh_in : DH;  // a constant unless padded
  extern __shared__ float smem[];
  float* qt = smem;            // [DH][P] q tile, k-major
  float* kt = qt + DH * P;     // [DH][P] k tile, k-major
  float* vs = kt + DH * P;     // [BK][DH] v tile
  float* pt = vs + BK * DH;    // [BK][P] probabilities, pt[j][i] = p_ij

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = iq * BQ;
  const int qrows = min(BQ, sq - q0);

  const T* qb = q + ((size_t)(b * hq + h) * sq + q0) * dh;
  const T* kb = k + (size_t)(b * hkv + g) * sk * dh;
  const T* vb = v + (size_t)(b * hkv + g) * sk * dh;

  for (int idx = tid; idx < BQ * DH; idx += THREADS) {
    const int i = idx / DH, d = idx - i * DH;
    qt[d * P + i] =
        (i < qrows && d < dh) ? to_f32(qb[(size_t)i * dh + d]) : 0.f;
  }

  // The kv band of this q tile: _kv_band as run-time loop bounds.
  int hi = (kv_len + BK - 1) / BK - 1;
  if (causal) hi = min(hi, floordiv(q_offset + q0 + qrows - 1, BK));
  int lo = 0;
  if (has_window) lo = max(0, floordiv(q_offset + q0 - (window - 1), BK));

  float m_i[4], l_i[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = NEG;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int ik = lo; ik <= hi; ++ik) {
    const int k0 = ik * BK;
    const int krows = min(BK, sk - k0);
    __syncthreads();   // the last step's reads of kt, vs, pt are done
    for (int idx = tid; idx < BK * DH; idx += THREADS) {
      const int j = idx / DH, d = idx - j * DH;
      float kv = 0.f, vv = 0.f;
      if (j < krows && d < dh) {
        kv = to_f32(kb[(size_t)(k0 + j) * dh + d]);
        vv = to_f32(vb[(size_t)(k0 + j) * dh + d]);
      }
      kt[d * P + j] = kv;
      vs[idx] = vv;
    }
    __syncthreads();

    // -- s = q k^T * scale, masked ------------------------------------------
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = qt[d * P + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bb[c] = kt[d * P + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], bb[c], s[r][c]);
    }
    unsigned valid = 0;        // bit 4 r + c: pair (ty + 16 r, tx + 16 c)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q_offset + q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        bool ok = kpos < kv_len;
        if (causal) ok = ok && qpos >= kpos;
        if (has_window) ok = ok && (qpos - kpos) < window;
        s[r][c] = ok ? s[r][c] * scale : NEG;
        if (ok) valid |= 1u << (4 * r + c);
      }
    }

    // -- online softmax: the 16 lanes of a row reduce by xor shuffles -------
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p =
            (valid >> (4 * r + c) & 1u) ? expf(s[r][c] - m_new) : 0.f;
        sum += p;
        pt[(tx + 16 * c) * P + ty + 16 * r] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m_i[r] - m_new);
      l_i[r] = l_i[r] * corr + sum;
      m_i[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

    // -- acc += p v -----------------------------------------------------------
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float a[4], bb[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = pt[j * P + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < NC; ++c) bb[c] = vs[j * DH + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(a[r], bb[c], acc[r][c]);
    }
  }

  T* ob = o + ((size_t)(b * hq + h) * sq + q0) * dh;
  float* lb = lse + (size_t)(b * hq + h) * sq + q0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    if (i < qrows) {
      const float l = fmaxf(l_i[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (tx + 16 * c < dh)
          store(&ob[(size_t)i * dh + tx + 16 * c], acc[r][c] / l);
      if (tx == 0) lb[i] = m_i[r] + logf(l);
    }
  }
}

template <typename T, int DH, bool PAD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int hq, int hkv, int sq, int sk, int dh, int q_offset,
           int kv_len, int causal, int has_window, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH, PAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  flash_fwd_kernel<T, DH, PAD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      hq, hkv, sq, sk, dh, q_offset, kv_len, causal, has_window, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v, void* o,
             void* lse, int b, int hq, int hkv, int sq, int sk, int q_offset,
             int kv_len, int causal, int has_window, int window, float scale,
             cudaStream_t st) {
  // the smallest built width that holds dh, padded unless dh is that width
  auto run = [&](auto width) {
    constexpr int W = decltype(width)::value;
    if (dh == W)
      return launch<T, W, false>(q, k, v, o, lse, b, hq, hkv, sq, sk, dh,
                                 q_offset, kv_len, causal, has_window, window,
                                 scale, st);
    return launch<T, W, true>(q, k, v, o, lse, b, hq, hkv, sq, sk, dh,
                              q_offset, kv_len, causal, has_window, window,
                              scale, st);
  };
  if (dh < 1) return (int)cudaErrorInvalidValue;
  if (dh <= 16) return run(std::integral_constant<int, 16>());
  if (dh <= 32) return run(std::integral_constant<int, 32>());
  if (dh <= 64) return run(std::integral_constant<int, 64>());
  if (dh <= 128) return run(std::integral_constant<int, 128>());
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o: (b, hq, sq, dh); k, v: (b, hkv, sk, dh), one dtype, bf16 (is_bf16 =
// 1) or fp32; lse: (b, hq, sq) fp32. All contiguous. Needs 1 <= dh <= 128,
// hq % hkv == 0, 1 <= kv_len <= sk (the wrapper checks). Returns the
// launch's cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int b, int hq, int hkv,
                                   int sq, int sk, int dh, int q_offset,
                                   int kv_len, int causal, int has_window,
                                   int window, int is_bf16, float scale,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(dh, q, k, v, o, lse, b, hq, hkv, sq, sk,
                                   q_offset, kv_len, causal, has_window,
                                   window, scale, st);
  return dispatch<float>(dh, q, k, v, o, lse, b, hq, hkv, sq, sk, q_offset,
                         kv_len, causal, has_window, window, scale, st);
}
