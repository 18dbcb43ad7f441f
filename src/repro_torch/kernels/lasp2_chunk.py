"""Chunked decayed causal linear attention, forward: the Hopper kernel and
its plain PyTorch version.

Twin of ``lasp2_chunk_fwd`` in ``repro/kernels/lasp2_chunk.py``. On CUDA
tensors :func:`lasp2_chunk_fwd` launches ``csrc/lasp2_chunk_fwd.cu``
(design and bound in its header); on CPU tensors it runs the plain
version, :func:`lasp2_chunk_fwd_plain` (``chunk_scan``). There is no other
path: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.linear_attention import chunk_scan
from repro_torch.kernels import _build

DEFAULT_BLOCK = 128
_DTYPES = (torch.bfloat16, torch.float32)


def lasp2_chunk_fwd_plain(q, k, v, log_a, *, block_size: int = DEFAULT_BLOCK):
    """Plain PyTorch version: ``chunk_scan`` with ``block_size`` blocks."""
    out = chunk_scan(q, k, v, log_a, block_size=block_size)
    return out.o, out.state, out.log_decay


def _check(q, k, v, log_a):
    devices = {t.device for t in (q, k, v, log_a)}
    if len(devices) != 1:
        raise ValueError(f"lasp2_chunk_fwd: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    if q.ndim != 3 or k.shape != q.shape or v.ndim != 3 \
            or v.shape[:2] != q.shape[:2] or log_a.shape != q.shape[:2]:
        raise ValueError(
            f"lasp2_chunk_fwd: want q, k (BH,S,dk), v (BH,S,dv), log_a "
            f"(BH,S); got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}, {tuple(log_a.shape)}")


def lasp2_chunk_fwd(q, k, v, log_a, *, block_size: int = DEFAULT_BLOCK):
    """Chunked decayed causal linear attention (forward).

    q, k: (BH, S, dk); v: (BH, S, dv) in bf16 or fp32; log_a: (BH, S) fp32.
    Returns (o (BH, S, dv) in q's dtype, state (BH, dk, dv) fp32,
    log_decay (BH,) fp32).

    ``block_size`` is the plain version's block; the CUDA kernel runs its
    own 64-row chunks over any S (re-blocking is exact up to summation
    order).
    """
    _check(q, k, v, log_a)
    if q.device.type == "cpu":
        return lasp2_chunk_fwd_plain(q, k, v, log_a, block_size=block_size)
    if q.device.type != "cuda":
        raise ValueError(f"lasp2_chunk_fwd: no kernel for {q.device}")
    bh, s, dk = q.shape
    dv = v.shape[-1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"lasp2_chunk_fwd: q/k/v must share one dtype of "
                        f"{_DTYPES}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if log_a.dtype != torch.float32:
        raise TypeError(f"lasp2_chunk_fwd: log_a must be float32, got "
                        f"{log_a.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, log_a)):
        raise ValueError("lasp2_chunk_fwd: q, k, v, log_a must be contiguous")
    if s < 1 or bh < 1 or dk % 16 or not 16 <= dk <= 128 or dv % 64:
        raise ValueError(f"lasp2_chunk_fwd: kernel takes S >= 1, dk a "
                         f"multiple of 16 up to 128, dv a multiple of 64; "
                         f"got S={s}, dk={dk}, dv={dv}")
    o = torch.empty((bh, s, dv), dtype=q.dtype, device=q.device)
    state = torch.empty((bh, dk, dv), dtype=torch.float32, device=q.device)
    ld = torch.empty((bh,), dtype=torch.float32, device=q.device)
    fn = _build.entry("lasp2_chunk_fwd", "lasp2_chunk_fwd", 7, 5)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(),
                 o.data_ptr(), state.data_ptr(), ld.data_ptr(),
                 bh, s, dk, dv, int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"lasp2_chunk_fwd: kernel launch failed with CUDA "
                           f"error {err}")
    lasp2_chunk_fwd.launches += 1
    return o, state, ld


lasp2_chunk_fwd.launches = 0   # kernel launches (CUDA path only)
