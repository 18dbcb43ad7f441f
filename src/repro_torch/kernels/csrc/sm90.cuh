// Hopper (sm_90a) building blocks for the hand-written kernels under csrc/:
// mbarriers, TMA tensor loads, wgmma shared-memory descriptors and issue
// helpers, the accumulator -> A-register conversion, the pieces of the
// chunked linear-attention kernel of K1 and K2a (decay rows, causal decay,
// the carry of the state M and its bf16 terms), and the host-side
// creation of TMA tensor maps.
//
// Shared-memory tiles are bf16, stored as column blocks of 64 elements
// (128 bytes a row) with the 128-byte swizzle that both TMA
// (CU_TENSOR_MAP_SWIZZLE_128B) and wgmma (layout type 1) use; each block
// starts on a 1024-byte boundary. A row of dh = 128 is therefore two blocks,
// loaded by two TMA boxes of 64 columns. In such a block:
// * K-major operand (the contraction runs along the row): 8-row groups
//   1024 bytes apart (SBO), the leading offset unused; k-step kk of 16
//   elements starts 32·kk bytes into the row (block kk / 4 for dh 128).
// * MN-major operand (the contraction runs down the rows, the operand's N
//   along the row; the transpose bit is set): 8-row groups 1024 bytes
//   apart (SBO), the next 64 columns at the next block (LBO = the block's
//   size); k-step kk of 16 rows starts 16 rows = 2048 bytes further.
//
// The accumulator of wgmma m64nNk16 (f32) gives thread t of the warpgroup
// (warp w = t / 32, lane l) rows w·16 + l/4 and that + 8; register r holds
// row w·16 + l/4 + 8·((r / 2) % 2), column 8·(r / 4) + 2·(l % 4) + r % 2.
// The bf16 A operand from registers of m64nNk16 has the same layout for its
// 16 columns, so columns 16·kk .. 16·kk + 15 of an accumulator become the A
// fragment of k-step kk by packing registers 8·kk .. 8·kk + 7 in pairs
// (acc_to_a).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// ---------------------------------------------------------------------------
// Shared-memory addresses and mbarriers.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// After the inits, before any thread or the TMA unit uses the barriers
// (followed by a __syncthreads()).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed. A wait that
// outlasts 2^30 tries (seconds; every wait of these kernels is a few tiles
// of work) traps, so a broken protocol fails the launch instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 30)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Orders this thread's generic-proxy writes to shared memory before later
// reads by the async proxy (wgmma operands, TMA); each writer fences, then
// the block synchronises.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Four 8x8 bf16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8 (16 contiguous bytes) and receives
// in r[m] the elements (2·(l % 4), l / 4) and (2·(l % 4) + 1, l / 4) of
// matrix m. With matrices (k0, m0), (k0, m0 + 8), (k0 + 8, m0),
// (k0 + 8, m0 + 8) of a row-major [k][m] tile this is the A fragment of an
// m16k16 slice of its transpose, in the layout of acc_to_a.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// Thread block clusters: the address of the same shared variable in block
// `rank` of the cluster, a store there, and a barrier of every thread of
// the cluster (release / acquire: shared and global writes before it are
// seen after it).
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr,
                                                uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void cluster_store(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// ---------------------------------------------------------------------------
// TMA.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Box at (c0, c1, c2) of a 3-D map into shared memory at `dst`; completion
// counted in bytes on `bar`. Out-of-bounds elements arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Shared memory at `src` into the box at (c0, c1, c2) of a 3-D map, as one
// bulk group of this thread; rows out of bounds are not written. Before
// the source is rewritten, the issuing thread waits with
// tma_store_wait_read; the writers fence (fence_proxy_async) before it is
// issued.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until every committed store of this thread has read its source.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma.
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma fence, commit or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SM90_D8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_D32 SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24)
#define SM90_D64 SM90_D32, SM90_D8(32), SM90_D8(40), SM90_D8(48), SM90_D8(56)
#define SM90_R32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define SM90_R64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x N, f32) {=, +=} A (64 x 16, shared, K-major) · B (16 x N, shared;
// K-major for TB = 0, MN-major for TB = 1). `acc` = 0 overwrites d.
template <int N, int TB>
struct MmaSS;

template <int TB>
struct MmaSS<64, TB> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_R32
        ", %32, %33, p, 1, 1, 0, %35;\n"
        "}\n"
        : SM90_D32
        : "l"(a), "l"(b), "r"(acc), "n"(TB));
  }
};

template <int TB>
struct MmaSS<128, TB> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a,
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_R64
        ", %64, %65, p, 1, 1, 0, %67;\n"
        "}\n"
        : SM90_D64
        : "l"(a), "l"(b), "r"(acc), "n"(TB));
  }
};

// d (64 x N, f32) {=, +=} A (64 x 16, bf16 in registers: a[0..3], the
// layout of acc_to_a) · B (16 x N, shared; K-major for TB = 0, MN-major for
// TB = 1).
template <int N, int TB>
struct MmaRS;

template <int TB>
struct MmaRS<64, TB> {
  __device__ __forceinline__ static void run(float (&d)[32],
                                             const uint32_t* a, uint64_t b,
                                             int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : SM90_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  }
};

template <int TB>
struct MmaRS<128, TB> {
  __device__ __forceinline__ static void run(float (&d)[64],
                                             const uint32_t* a, uint64_t b,
                                             int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
        "}\n"
        : SM90_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  }
};

#undef SM90_D8
#undef SM90_D32
#undef SM90_D64
#undef SM90_R32
#undef SM90_R64

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An m64nNk16 f32 accumulator (NR = N / 2 registers) as bf16 A fragments of
// the next product, whose contraction runs over the accumulator's N
// columns: k-step kk is a[4·kk .. 4·kk + 3].
template <int NR>
__device__ __forceinline__ void acc_to_a(const float (&d)[NR],
                                         uint32_t (&a)[NR / 2]) {
#pragma unroll
  for (int i = 0; i < NR / 2; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

// The same accumulator as two bf16 A fragments whose sum carries about 16
// bits of each value: hi = bf16(x), lo = bf16(x - hi). Two products, one
// with each, into one f32 accumulator leave ~2^-16 of |x|·|B| where one
// rounding to bf16 leaves 2^-8.
template <int NR>
__device__ __forceinline__ void split_to_a(const float (&d)[NR],
                                           uint32_t (&hi)[NR / 2],
                                           uint32_t (&lo)[NR / 2]) {
#pragma unroll
  for (int i = 0; i < NR / 2; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(d[2 * i], d[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(d[2 * i] - hf.x, d[2 * i + 1] - hf.y);
  }
}

// Byte offset of element (row, col), col < 64, in a 64-column block with
// the 128-byte swizzle (the block starts on a 1024-byte boundary): the
// 16-byte chunk col / 8 of each 128-byte row is XORed with row % 8.
__host__ __device__ __forceinline__ uint32_t sw128_off(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// A barrier of `count` threads (a multiple of 32) on named barrier `id`
// (1 .. 15; __syncthreads takes 0): one warpgroup synchronises alone.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// Chunked decayed linear attention in 64-row chunks (the kernel of
// lasp2_chunk_sm90.cuh, which runs the forward, K1, and the backward's dq
// pass, K2a): the chunk's decay rows, the causal decay of a score tile,
// and the carried state M <- e^A M + (A ⊙ w)^T B.
// ---------------------------------------------------------------------------

// A chunk's decay rows from log a, by one warp: lane l holds log a of rows
// l and l + 32 in a0 and a1 (0 past the sequence's end, which adds
// nothing). Writes, for cb the inclusive cumsum over the chunk and A its
// last entry, rows[0, 64) = cb, rows[64, 128) = e^{cb}, rows[128, 192) =
// w = e^{A - cb} and rows[192] = e^A; returns A on every lane.
__device__ __forceinline__ float chunk_decay_rows(float a0, float a1,
                                                  float* rows) {
  const int lane = threadIdx.x % 32;
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
  rows[lane] = a0;
  rows[lane + 32] = a1;
  rows[64 + lane] = expf(a0);
  rows[96 + lane] = expf(a1);
  rows[128 + lane] = expf(A - a0);
  rows[160 + lane] = expf(A - a1);
  if (lane == 0) rows[192] = expf(A);
  return A;
}

// A 64 x 64 score accumulator (m64n64: rows i, columns j of the chunk) of
// the calling warpgroup times the decay D_ij = e^{cb_i - cb_j} for j <= i,
// 0 above the diagonal. __expf (ex2.approx) is within 2 + 1.16|x| ulp of
// e^x: far below the two-term operands' 2^-16 wherever the factor is not
// negligible.
__device__ __forceinline__ void causal_decay(float (&x)[32], const float* cb) {
  const int lane = threadIdx.x % 32;
  const int r0 = ((threadIdx.x % 128) / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const float cbi[2] = {cb[r0], cb[r0 + 8]};
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float2 cj = *reinterpret_cast<const float2*>(cb + 8 * jj + c0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 4 * jj + e, h = e >> 1, j = 8 * jj + c0 + (e & 1);
      const float d = __expf(cbi[h] - ((e & 1) ? cj.y : cj.x));
      x[r] = (j <= r0 + 8 * h) ? x[r] * d : 0.f;
    }
  }
}

// Issues the carry of 64 rows of a carried state M, held by the calling
// warpgroup as one fp32 m64nN accumulator: M <- e^A M + (A ⊙ w)^T B, where
// row r of M belongs to column r of the chunk's 64-column tile of A at
// `atile` (64 rows, swizzled), and B is the chunk's tile at `btile` (64
// rows, N columns in 64-column blocks of 64 · 128 bytes). (A ⊙ w)^T enters
// as hi and lo bf16 A fragments read from the A tile by ldmatrix.trans and
// scaled by w in fp32: one rounding to bf16 would leave 2^-9 of each row
// in the state. Every register is written before the one wgmma fence:
// ptxas serialises the wgmmas of a kernel in which a non-wgmma instruction
// writes an accumulator between the wgmmas of one stage. Only issues the
// wgmmas; the caller commits and waits.
template <int N>
__device__ __forceinline__ void carry_issue(float (&m)[N / 2], uint32_t atile,
                                            uint32_t btile, const float* w,
                                            float eA) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int c0 = 2 * (lane % 4);
  const int cw = 16 * (t / 32) + 8 * ((lane / 8) & 1);
  uint32_t hi[16], lo[16];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {   // 16 chunk rows j a k-step
    uint32_t f[4];
    ldmatrix_x4_trans(
        atile + sw128_off(16 * kk + 8 * (lane / 16) + lane % 8, cw), f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 16 * kk + 8 * (i >> 1) + c0;
      const float2 av = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&f[i]));
      const float y0 = av.x * w[j], y1 = av.y * w[j + 1];
      const __nv_bfloat162 yh = __floats2bfloat162_rn(y0, y1);
      const float2 hf = __bfloat1622float2(yh);
      hi[4 * kk + i] = *reinterpret_cast<const uint32_t*>(&yh);
      lo[4 * kk + i] = pack_bf16(y0 - hf.x, y1 - hf.y);
    }
  }
#pragma unroll
  for (int r = 0; r < N / 2; ++r) m[r] *= eA;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t b = desc_sw128(btile + kk * 16 * 128, 64 * 128, 1024);
    MmaRS<N, 1>::run(m, &hi[4 * kk], b, 1);
    MmaRS<N, 1>::run(m, &lo[4 * kk], b, 1);
  }
}

// The 64 rows of a carried state M (fp32 m64nN accumulator of the calling
// warpgroup) as bf16 hi and lo terms in two row-major swizzled 64-row tiles
// (generic pointers `hi`, `lo`) of 64-column blocks: the K-major B operand
// of the next chunk's product with M^T.
template <int N>
__device__ __forceinline__ void store_terms(const float (&m)[N / 2],
                                            uint8_t* hi, uint8_t* lo) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r = (t / 32) * 16 + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 8 * jj + c0;
      const uint32_t off =
          (col / 64) * 64 * 128 + sw128_off(r + 8 * h, col % 64);
      const float x0 = m[4 * jj + 2 * h], x1 = m[4 * jj + 2 * h + 1];
      const __nv_bfloat162 xh = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(xh);
      *reinterpret_cast<__nv_bfloat162*>(hi + off) = xh;
      *reinterpret_cast<__nv_bfloat162*>(lo + off) =
          __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
    }
}

// A 64 x 64 fp32 accumulator of the calling warpgroup in bf16 into a
// swizzled 64-column tile (generic pointer), the source of a TMA store.
__device__ __forceinline__ void stage_bf16(const float (&x)[32],
                                           uint8_t* tile) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r = (t / 32) * 16 + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(
          tile + sw128_off(r + 8 * h, 8 * jj + c0)) =
          __floats2bfloat162_rn(x[4 * jj + 2 * h], x[4 * jj + 2 * h + 1]);
}

// ---------------------------------------------------------------------------
// Host: TMA tensor maps. cuTensorMapEncodeTiled is a driver function; it is
// reached through the runtime's entry-point query, so the library needs no
// link against libcuda.
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A contiguous bf16 tensor (mats, rows, dh) as a 3-D map with boxes of 64
// columns x box_rows rows of one matrix, 128-byte swizzle, zeros out of
// bounds (a ragged tail never reads the next matrix). Needs dh a multiple of
// 64 and a 16-byte aligned base. Returns false if the driver refuses.
inline bool make_map(CUtensorMap* map, const void* base, int mats, int rows,
                     int dh, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)rows,
                              (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)rows * dh * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

__host__ __device__ __forceinline__ int floordiv(int a, int b) {
  return (a >= 0) ? a / b : -((-a + b - 1) / b);
}

}  // namespace sm90
