// One-token recurrent linear-attention decode step, redesigned for Hopper
// (sm_90a): the `sm90` route of K3.
//
// Replaces the Pallas TPU kernel `lasp2_decode_step` / `_kernel` in
// src/repro/kernels/lasp2_decode.py, as the CUDA-core kernel
// csrc/lasp2_decode.cu (the `simt` route) does. Same function, per
// batch·head:
//   M' = e^{log a} M + k^T v,   o = q M',   L' = L + log a,
// with q, k (BH, dk) and v (BH, dv) in bf16 or fp32, the state M
// (BH, dk, dv) fp32, log a and L (BH,) fp32, and the math and o (BH, dv) in
// fp32. M and L are updated in place (the serving engine's decode cache; the
// JAX engine donates the cache to its jitted step instead). A null log a
// means log a = 0: a = 1 and L is left as it is.
//
// What bounds it on this card: bytes. It does 4-5 flops per state element
// against 8 bytes (M read once, written once): 2 x 4.19 MB at BH 64,
// dk = dv = 128, 2.50 us at 3.35 TB/s. So the design is about one thing:
// having the whole state in flight at once across the 132 SMs, and nothing
// but that on the way from the launch to the last store.
//
// Design. The `simt` kernel gives a block all dk rows of 128 columns (64
// blocks at BH 64, ~0.5 MB in flight, where Little's law at 3.35 TB/s and
// ~0.7 us wants 2-3 MB). Here a block owns all dk rows of a 16-column slice
// of one bh's M: grid (BH, ceil(dv / 16)), 512 blocks of 8 KB at the
// serving shape, so o needs no sum across blocks. Its first act is to issue
// its whole dk x 16 box as 16-byte cp.async copies into shared memory (a
// row of the slice is one 64-byte segment, 16-byte aligned when
// dv % 4 == 0), completed on one mbarrier: each thread arrives once its
// copies have landed. While they fly each thread reads its q, k, v, log a
// and, in block (bh, 0), L, so that no dependent load waits at the end.
// Thread t owns columns 4(t % 4) .. 4(t % 4) + 3 and rows t / 4, t / 4 + R,
// ... (R = min(dk, 32) row groups): it forms M' in fp32, stores it over M
// as float4s and sums q_r M'_rj over its rows in row order. The row groups'
// sums are added in a fixed order: within a warp (eight groups) by
// shuffles, xor 4, 8 and 16 (pairs, then pairs of pairs, then the halves),
// then the warps' sums in shared memory in warp order. No atomics: two
// launches are bitwise equal. The last slice of a dv that is not a
// multiple of 16 is narrower; threads past it only take part in the
// barrier and the sums. No tensor map: nothing is encoded on the host per
// launch.
//
// Timed on the card against it while choosing (BH 64, 128 x 128, states
// rotating above the L2), all slower: 32-column and 8-column slices (the
// latter 32-byte segments), one bulk copy per row, and chunks of 32 whole
// rows, one bulk copy each, in a cluster that sums o through distributed
// shared memory; and a read-modify-write of L at the end, where the first
// designs had it, showed as a dependent load on the kernel's tail.
//
// Takes dk % 16 == 0 with dk <= 256 and dv % 4 == 0, M 16-byte aligned (the
// wrapper's route table and checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int COLS = 16;            // columns of M a block owns
constexpr int QUADS = COLS / 4;     // float4s of a slice row: threads a row
constexpr int MAX_GROUPS = 32;      // row groups: 128 threads
constexpr int THREADS = QUADS * MAX_GROUPS;
constexpr int MAX_DK = 256;
constexpr int MAX_ROWS = MAX_DK / MAX_GROUPS;  // rows a thread owns, at most

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes from global to shared memory, cached in L2 only (M is read once).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// One arrival on `bar` once every cp.async this thread issued has landed;
// counted in the barrier's init (noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ float4 shfl_xor_add(float4 x, int lane_mask) {
  x.x += __shfl_xor_sync(0xffffffffu, x.x, lane_mask);
  x.y += __shfl_xor_sync(0xffffffffu, x.y, lane_mask);
  x.z += __shfl_xor_sync(0xffffffffu, x.z, lane_mask);
  x.w += __shfl_xor_sync(0xffffffffu, x.w, lane_mask);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    lasp2_decode_sm90_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const float* __restrict__ la, float* m,
                             float* __restrict__ log_decay,
                             float* __restrict__ o, int dk, int dv) {
  __shared__ __align__(16) float box[MAX_DK * COLS];       // the slice of M
  __shared__ __align__(16) float part[THREADS / 32][COLS];  // warps' sums
  __shared__ __align__(8) uint64_t bar;

  const int bh = blockIdx.x;
  const int j0 = blockIdx.y * COLS;
  const int tid = threadIdx.x;
  const int quad = tid % QUADS;
  const int group = tid / QUADS;
  const int groups = blockDim.x / QUADS;
  const bool live = 4 * quad < dv - j0;            // columns inside dv
  const bool writes_l = la && blockIdx.y == 0 && tid == 0;

  // The box first: each thread's copies, before the barrier they report to
  // exists (the arrival comes after the init).
  float* mq = m + (size_t)bh * dk * dv + j0 + 4 * quad;  // row 0, this quad
  float* bq = box + 4 * quad;
  if (live)
    for (int r = group; r < dk; r += groups)
      cp_async16(sm90::smem_u32(bq + r * COLS), mq + (size_t)r * dv);
  const uint32_t bar_a = sm90::smem_u32(&bar);
  if (tid == 0) {
    sm90::mbar_init(bar_a, blockDim.x);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  cp_async_arrive(bar_a);

  // While the box lands: a, L, this thread's v columns and its rows' q, k.
  const float lav = la ? la[bh] : 0.f;
  const float l0 = writes_l ? log_decay[bh] : 0.f;
  float4 vj = make_float4(0.f, 0.f, 0.f, 0.f);
  float qr[MAX_ROWS], kr[MAX_ROWS];
  if (live) {
    const T* vp = v + (size_t)bh * dv + j0 + 4 * quad;
    vj = make_float4(to_f32(vp[0]), to_f32(vp[1]), to_f32(vp[2]),
                     to_f32(vp[3]));
#pragma unroll
    for (int i = 0; i < MAX_ROWS; ++i) {
      const int r = group + i * groups;
      if (r < dk) {
        qr[i] = to_f32(q[(size_t)bh * dk + r]);
        kr[i] = to_f32(k[(size_t)bh * dk + r]);
      }
    }
  }
  const float a = la ? expf(lav) : 1.f;
  sm90::mbar_wait(bar_a, 0);

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
#pragma unroll
    for (int i = 0; i < MAX_ROWS; ++i) {
      const int r = group + i * groups;
      if (r < dk) {
        float4 x = *reinterpret_cast<const float4*>(bq + r * COLS);
        x.x = fmaf(a, x.x, kr[i] * vj.x);
        x.y = fmaf(a, x.y, kr[i] * vj.y);
        x.z = fmaf(a, x.z, kr[i] * vj.z);
        x.w = fmaf(a, x.w, kr[i] * vj.w);
        *reinterpret_cast<float4*>(mq + (size_t)r * dv) = x;
        acc.x = fmaf(qr[i], x.x, acc.x);
        acc.y = fmaf(qr[i], x.y, acc.y);
        acc.z = fmaf(qr[i], x.z, acc.z);
        acc.w = fmaf(qr[i], x.w, acc.w);
      }
    }
  }
  if (writes_l) log_decay[bh] = l0 + lav;
  // A warp holds row groups 8w .. 8w + 7 of each quad, lanes l ^ 4s.
  for (int lane_mask = QUADS; lane_mask < 32; lane_mask *= 2)
    acc = shfl_xor_add(acc, lane_mask);
  const int warp = tid / 32, lane = tid % 32;
  if (lane < QUADS)
    *reinterpret_cast<float4*>(&part[warp][4 * lane]) = acc;
  __syncthreads();
  if (tid < QUADS && live) {
    float4 s = *reinterpret_cast<const float4*>(&part[0][4 * tid]);
    for (int w = 1; w < (int)blockDim.x / 32; ++w) {
      const float4 p = *reinterpret_cast<const float4*>(&part[w][4 * tid]);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    *reinterpret_cast<float4*>(o + (size_t)bh * dv + j0 + 4 * tid) = s;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* la,
           void* m, void* log_decay, void* o, int bh, int dk, int dv,
           cudaStream_t stream) {
  const int threads = QUADS * (dk < MAX_GROUPS ? dk : MAX_GROUPS);
  const dim3 grid(bh, (dv + COLS - 1) / COLS);
  lasp2_decode_sm90_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(la),
      static_cast<float*>(m), static_cast<float*>(log_decay),
      static_cast<float*>(o), dk, dv);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k: (bh, dk); v: (bh, dv) in bf16 (is_bf16 = 1) or fp32; la: (bh,) fp32
// or null (log a = 0); m: (bh, dk, dv) fp32 and log_decay: (bh,) fp32, both
// updated in place; o: (bh, dv) fp32. All contiguous, m and o 16-byte
// aligned. Needs dk % 16 == 0, dk <= 256 and dv % 4 == 0 (the wrapper's
// route table). Returns the launch's cudaGetLastError().
extern "C" int lasp2_decode_step_sm90(const void* q, const void* k,
                                      const void* v, const void* la, void* m,
                                      void* log_decay, void* o, int bh,
                                      int dk, int dv, int is_bf16,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, la, m, log_decay, o, bh, dk, dv,
                                 st);
  return launch<float>(q, k, v, la, m, log_decay, o, bh, dk, dv, st);
}
