// Chunked decayed causal linear attention, the backward's dq pass, on
// Hopper's tensor cores (sm_90a, bf16).
//
// Replaces the Pallas TPU kernel `_bwd_dq_kernel` (pallas_call
// "lasp2_chunk_bwd_dq") in src/repro/kernels/lasp2_chunk.py (K2a), for bf16
// k, v, dO with dk and dv in {64, 128} (the `sm90` route of
// kernels/lasp2_chunk.py; fp32 and every other shape take the CUDA-core
// kernel of lasp2_chunk_bwd.cu, the `simt` route). Same function: per
// 64-row chunk, in order, re-carrying the forward's state M (dk x dv, from
// 0) with the forward's update,
//   dq = (dO V^T ⊙ D) K + e^{cb} ⊙ (dO M^T),   M <- e^A M + (K ⊙ w)^T V,
// with cb = inclusive cumsum(log a) over the chunk, A = cb_last,
// w = e^{A - cb}, D_ij = e^{cb_i - cb_j} (i >= j) else 0. dq in bf16.
//
// What bounds it on this card: at the training shape (BH 64, S 2048,
// dk = dv = 128) it must move ~135 MB (k, v, dO and log a read once, dq
// written once), 0.040 ms at 3.35 TB/s, against ~13 GFLOP of products
// (~24 with the two-term operands), ~0.013 ms at the bf16 tensor-core
// rate: bytes.
//
// Design: the kernel of lasp2_chunk_sm90.cuh, which is also K1's, with
// (A, B, X) = (k, v, dO), grid (BH, dk / 64) as the CUDA-core kernel's:
// the rows of M and the columns of dq are independent across k. dq is held
// to the fp32 plain version's 4e-2: K ⊙ w enters the carry as two bf16
// terms, as do M in dO M^T and the decayed score tile dsc in dsc K (with
// one term of M dq leaves its limit 4.5-fold, with one of dsc 2.5-fold, at
// S 2048 with resets).

#include "lasp2_chunk_sm90.cuh"

// k, dq: (bh, s, dk); v, dO: (bh, s, dv), all bf16, contiguous, 16-byte
// aligned; la: (bh, s) fp32. Needs dk, dv in {64, 128} and s >= 1 (the
// wrapper checks). Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it does not take or a tensor map the
// driver refuses.
extern "C" int lasp2_chunk_bwd_dq_sm90(const void* k, const void* v,
                                       const void* la, const void* dO,
                                       void* dq, int bh, int s, int dk,
                                       int dv, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dk != 64 && dk != 128) return (int)cudaErrorInvalidValue;
  if (dv == 64)
    return lasp2_chunk_sm90::launch<64, false>(k, v, dO, la, dq, nullptr,
                                               nullptr, bh, s, dk, st);
  if (dv == 128)
    return lasp2_chunk_sm90::launch<128, false>(k, v, dO, la, dq, nullptr,
                                                nullptr, bh, s, dk, st);
  return (int)cudaErrorInvalidValue;
}
