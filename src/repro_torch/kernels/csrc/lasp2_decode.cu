// One-token recurrent linear-attention decode step, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `lasp2_decode_step` / `_kernel` in
// src/repro/kernels/lasp2_decode.py. Same function, per batch·head:
//   M' = e^{log a} M + k^T v,   o = q M',   L' = L + log a,
// with q, k (BH, dk) and v (BH, dv) in the activation dtype (bf16 or
// fp32), the state M (BH, dk, dv) fp32, log a and L (BH,) fp32, and the
// math and o (BH, dv) in fp32.
//
// What bounds it on this card: bytes. Each launch reads and writes the
// fp32 state once, BH·dk·dv·4·2 bytes (8.4 MB at BH 64, dk = dv = 128,
// ~2.5 us at 3.35 TB/s); it does 4 flops per state element, far below the
// compute rate.
//
// Design. One thread owns column j of its bh's M and walks the dk rows:
// neighbouring threads read neighbouring addresses (M is (dk, dv)
// row-major), so every row is one coalesced read and one coalesced write.
// The thread forms M'_rj = a M_rj + k_r v_j and accumulates
// o_j = sum_r q_r M'_rj in a register: no cross-thread reduction. Rows go
// in groups of 16 loads issued before their stores, to keep many reads in
// flight per thread, then a tail of dk % 16 rows one at a time, so any dk
// is exact. q and k are staged in shared memory, read by all threads of
// the block as broadcasts: 2·dk fp32, 132 KB at the taylor feature map's
// dk 16513 (dh 128), so the entry raises the kernel's dynamic
// shared-memory limit above the default 48 KB where it needs to.
//
// In place: M' and L' overwrite M and L, which are the serving engine's
// decode cache. The JAX engine gets the same effect by donating the cache
// to the jitted step (src/repro/serve/engine.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 16;       // state rows loaded before they are stored

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void decode_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const float* __restrict__ la,
                              float* __restrict__ m,
                              float* __restrict__ log_decay,
                              float* __restrict__ o, int dk, int dv) {
  extern __shared__ float qk[];  // q[dk], k[dk] in fp32
  const int bh = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  for (int i = threadIdx.x; i < dk; i += blockDim.x) {
    qk[i] = to_f32(q[(size_t)bh * dk + i]);
    qk[dk + i] = to_f32(k[(size_t)bh * dk + i]);
  }
  __syncthreads();
  const float lav = la[bh];
  if (j < dv) {
    const float a = expf(lav);
    const float vj = to_f32(v[(size_t)bh * dv + j]);
    float* mb = m + (size_t)bh * dk * dv + j;
    float acc = 0.f;
    const int full = dk / ROWS * ROWS;
    for (int r0 = 0; r0 < full; r0 += ROWS) {
      float mv[ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) mv[u] = mb[(size_t)(r0 + u) * dv];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        const float mn = fmaf(a, mv[u], qk[dk + r0 + u] * vj);
        mb[(size_t)(r0 + u) * dv] = mn;
        acc = fmaf(qk[r0 + u], mn, acc);
      }
    }
    for (int r = full; r < dk; ++r) {
      const float mn = fmaf(a, mb[(size_t)r * dv], qk[dk + r] * vj);
      mb[(size_t)r * dv] = mn;
      acc = fmaf(qk[r], mn, acc);
    }
    o[(size_t)bh * dv + j] = acc;
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) log_decay[bh] += lav;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* la,
           void* m, void* log_decay, void* o, int bh, int dk, int dv,
           cudaStream_t stream) {
  const int threads = dv < 128 ? ((dv + 31) / 32) * 32 : 128;
  const dim3 grid(bh, (dv + threads - 1) / threads);
  const size_t smem = sizeof(float) * 2 * (size_t)dk;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(la),
      static_cast<float*>(m), static_cast<float*>(log_decay),
      static_cast<float*>(o), dk, dv);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k: (bh, dk); v: (bh, dv) in bf16 (is_bf16 = 1) or fp32; la: (bh,)
// fp32; m: (bh, dk, dv) fp32 and log_decay: (bh,) fp32, both updated in
// place; o: (bh, dv) fp32. All contiguous; any dk >= 1 whose q and k fit
// shared memory, 2·dk fp32 up to 227 KB (dk <= 29056; the wrapper checks).
// Returns the launch's cudaGetLastError().
extern "C" int lasp2_decode_step(const void* q, const void* k, const void* v,
                                 const void* la, void* m, void* log_decay,
                                 void* o, int bh, int dk, int dv, int is_bf16,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, la, m, log_decay, o, bh, dk, dv,
                                 st);
  return launch<float>(q, k, v, la, m, log_decay, o, bh, dk, dv, st);
}
