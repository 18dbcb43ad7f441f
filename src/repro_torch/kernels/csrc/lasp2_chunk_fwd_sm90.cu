// Chunked decayed causal linear attention, forward, on Hopper's tensor
// cores (sm_90a, bf16).
//
// Replaces the Pallas TPU kernel `lasp2_chunk_fwd` / `_kernel` in
// src/repro/kernels/lasp2_chunk.py (K1), for bf16 q, k, v with dk and dv in
// {64, 128} (the `sm90` route of kernels/lasp2_chunk.py; fp32 and every
// other shape take the CUDA-core kernel of lasp2_chunk_fwd.cu, the `simt`
// route). Same function: per 64-row chunk, in order, carrying the state M
// (dk x dv, from 0),
//   o = (Q K^T ⊙ D) V + e^{cb} ⊙ (Q M),   M <- e^A M + (K ⊙ w)^T V,
// with cb = inclusive cumsum(log a) over the chunk, A = cb_last,
// w = e^{A - cb}, D_ij = e^{cb_i - cb_j} (i >= j) else 0. o in bf16; the
// final M (BH, dk, dv) and sum(log a) (BH,) in fp32.
//
// What bounds it on this card: at the training shape (BH 64, S 2048,
// dk = dv = 128) it must move ~134 MB (q, k, v and log a read once, o
// written once), 0.040 ms at 3.35 TB/s, against ~13 GFLOP of products
// (~24 with the two-term operands), ~0.013 ms at the bf16 tensor-core
// rate: bytes.
//
// Design: the kernel of lasp2_chunk_sm90.cuh, which is also K2a's, with
// (A, B, X) = (v, k, q). Its carried state is M^T = sum (V ⊙ w)^T K, a
// block's 64 rows of which are 64 columns of M: its X M^T is Q M, its out
// is o, and with STATE it writes M^T transposed back into (BH, dk, dv). The
// grid is (BH, dv / 64), as the CUDA-core kernel's: the columns of o and M
// are independent across v. The state is held to the fp32 plain version's
// 1e-4 and o to 4e-2: V ⊙ w enters the carry as two bf16 terms, as do M in
// Q M and the decayed score tile in S V (the header's precision notes).

#include "lasp2_chunk_sm90.cuh"

// q, k: (bh, s, dk); v, o: (bh, s, dv), all bf16, contiguous, 16-byte
// aligned; la: (bh, s) fp32; state: (bh, dk, dv) and log_decay: (bh,) fp32
// out. Needs dk, dv in {64, 128} and s >= 1 (the wrapper checks). Returns
// the launch's cudaGetLastError(), or cudaErrorInvalidValue for a shape it
// does not take or a tensor map the driver refuses.
extern "C" int lasp2_chunk_fwd_sm90(const void* q, const void* k,
                                    const void* v, const void* la, void* o,
                                    void* state, void* log_decay, int bh,
                                    int s, int dk, int dv, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dv != 64 && dv != 128) return (int)cudaErrorInvalidValue;
  if (dk == 64)
    return lasp2_chunk_sm90::launch<64, true>(v, k, q, la, o, state,
                                              log_decay, bh, s, dv, st);
  if (dk == 128)
    return lasp2_chunk_sm90::launch<128, true>(v, k, q, la, o, state,
                                               log_decay, bh, s, dv, st);
  return (int)cudaErrorInvalidValue;
}
