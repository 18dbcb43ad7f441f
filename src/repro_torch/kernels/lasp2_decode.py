"""One-token recurrent linear-attention decode: the Hopper kernel and its
plain PyTorch version.

Twin of ``lasp2_decode_step`` in ``repro/kernels/lasp2_decode.py``. On CUDA
tensors :func:`lasp2_decode_step` launches ``csrc/lasp2_decode.cu``
(design and bound in its header), which updates ``state`` and
``log_decay`` in place; on CPU tensors it runs the plain version,
:func:`lasp2_decode_step_plain` (``recurrent_step``), which returns new
tensors. Callers use the returned tensors either way.
"""

from __future__ import annotations

import torch

from repro_torch.core.linear_attention import recurrent_step
from repro_torch.kernels import _build

_DTYPES = (torch.bfloat16, torch.float32)


def lasp2_decode_step_plain(q, k, v, log_a, state, log_decay):
    """Plain PyTorch version: ``recurrent_step``."""
    return recurrent_step(q, k, v, log_a, state=state, log_decay=log_decay)


def _check(q, k, v, log_a, state, log_decay):
    ts = (q, k, v, log_a, state, log_decay)
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"lasp2_decode_step: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    bh = q.shape[0]
    if q.ndim != 2 or k.shape != q.shape or v.ndim != 2 \
            or v.shape[0] != bh or log_a.shape != (bh,) \
            or state.shape != (bh, q.shape[1], v.shape[1]) \
            or log_decay.shape != (bh,):
        raise ValueError(
            "lasp2_decode_step: want q, k (BH,dk), v (BH,dv), log_a (BH,), "
            "state (BH,dk,dv), log_decay (BH,); got "
            + ", ".join(str(tuple(t.shape)) for t in ts))


def lasp2_decode_step(q, k, v, log_a, state, log_decay):
    """Batched single-token recurrent decode.

    q, k: (BH, dk); v: (BH, dv) in bf16 or fp32; log_a: (BH,) fp32;
    state: (BH, dk, dv) fp32; log_decay: (BH,) fp32.
    Returns (o (BH, dv) fp32, state', log_decay'). On CUDA, ``state'`` and
    ``log_decay'`` are ``state`` and ``log_decay`` themselves, updated in
    place.
    """
    _check(q, k, v, log_a, state, log_decay)
    if q.device.type == "cpu":
        return lasp2_decode_step_plain(q, k, v, log_a, state, log_decay)
    if q.device.type != "cuda":
        raise ValueError(f"lasp2_decode_step: no kernel for {q.device}")
    bh, dk = q.shape
    dv = v.shape[1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"lasp2_decode_step: q/k/v must share one dtype of "
                        f"{_DTYPES}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.dtype != torch.float32 for t in (log_a, state, log_decay)):
        raise TypeError("lasp2_decode_step: log_a, state and log_decay must "
                        "be float32")
    if not all(t.is_contiguous()
               for t in (q, k, v, log_a, state, log_decay)):
        raise ValueError("lasp2_decode_step: all inputs must be contiguous")
    if bh < 1 or dk < 16 or dk % 16 or dv < 1:
        raise ValueError(f"lasp2_decode_step: kernel takes dk a multiple of "
                         f"16; got dk={dk}, dv={dv}")
    o = torch.empty((bh, dv), dtype=torch.float32, device=q.device)
    fn = _build.entry("lasp2_decode", "lasp2_decode_step", 7, 4)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(),
                 state.data_ptr(), log_decay.data_ptr(), o.data_ptr(),
                 bh, dk, dv, int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"lasp2_decode_step: kernel launch failed with "
                           f"CUDA error {err}")
    lasp2_decode_step.launches += 1
    return o, state, log_decay


lasp2_decode_step.launches = 0   # kernel launches (CUDA path only)
