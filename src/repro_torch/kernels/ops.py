"""Dispatch for the attention ops (twin of ``repro/kernels/ops.py``).

Model code calls these wrappers. The backend follows the tensors: on CPU
tensors the kernel wrappers take their plain PyTorch versions (``torch``
backend), on CUDA tensors they launch the Hopper kernels (``cuda``
backend). Same signatures and semantics as the reference ops.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.linear_attention import pick_block
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import lasp2_chunk as _chunk
from repro_torch.kernels import lasp2_decode as _decode


def linear_attention_op(q, k, v, log_a=None, *, block_size: int = 128):
    """Local chunked decayed causal linear attention (differentiable).

    q, k: (..., S, dk); v: (..., S, dv); log_a: (..., S) or None.
    Returns (o, state (..., dk, dv) fp32, log_decay (...,) fp32). Autograd
    runs the two backward passes behind ``LASP2Chunk``; the padding path
    differentiates through ``F.pad`` and the slice.
    """
    *lead, s, dk = q.shape
    dv = v.shape[-1]
    if log_a is None:
        log_a = torch.zeros((*lead, s), dtype=torch.float32, device=q.device)
    # Block policy of the reference: the preferred block when it divides S,
    # else the largest aligned divisor; where no usable divisor exists,
    # right-pad to a block multiple. Zero k/v rows add nothing to the state
    # and log_a = 0 leaves the decay alone, so the outputs (sliced back to
    # S), final state and log decay are exact.
    bs = pick_block(s, block_size)
    if bs != s and bs % 32:
        bs = min(block_size, s)
    if s % bs:
        pad = bs - s % bs
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        log_a = F.pad(log_a, (0, pad))
        o, st, ld = linear_attention_op(q, k, v, log_a,
                                        block_size=block_size)
        return o[..., :s, :], st, ld
    bh = math.prod(lead)
    o, st, ld = _chunk.LASP2Chunk.apply(
        q.reshape(bh, s, dk).contiguous(), k.reshape(bh, s, dk).contiguous(),
        v.reshape(bh, s, dv).contiguous(),
        log_a.float().reshape(bh, s).contiguous(), bs)
    return (o.reshape(*lead, s, dv), st.reshape(*lead, dk, dv),
            ld.reshape(lead))


def linear_decode_op(q, k, v, log_a, state, log_decay):
    """Single-token recurrent linear-attention decode.

    q, k: (B, H, dk); v: (B, H, dv); log_a: (B, H) or None;
    state: (B, H, dk, dv) fp32; log_decay: (B, H) fp32.
    Returns (o (B, H, dv) fp32, state', log_decay'). On CUDA a contiguous
    ``state`` and ``log_decay`` are updated in place. A ``log_a`` of None
    goes through as None (no decay, ``log_decay`` unchanged): no zeros are
    made for it.
    """
    b, h, dk = q.shape
    dv = v.shape[-1]
    o, st, ld = _decode.lasp2_decode_step(
        q.reshape(b * h, dk).contiguous(), k.reshape(b * h, dk).contiguous(),
        v.reshape(b * h, dv).contiguous(),
        None if log_a is None
        else log_a.float().reshape(b * h).contiguous(),
        state.reshape(b * h, dk, dv), log_decay.reshape(b * h))
    return o.reshape(b, h, dv), st.reshape(b, h, dk, dv), ld.reshape(b, h)


def flash_attention_op(q, k, v, *, causal: bool = True, sliding_window=None,
                       scale=None, q_offset=None):
    """GQA softmax attention (differentiable). q: (B,Hq,S,dh); k/v:
    (B,Hkv,Sk,dh).

    Queries sit at global positions ``q_offset + i``, by default
    ``sk - sq`` (prefill-with-cache shapes). Any ``sq`` and ``sk`` go
    through unpadded: the kernels zero-fill ragged tiles and mask keys by
    ``kv_len = sk``, so the reference's pad-to-block policy would change
    nothing but the work. Runs ``FlashAttention``: the kernels on CUDA
    tensors, their plain versions on CPU tensors.
    """
    sq, sk = q.shape[2], k.shape[2]
    if q_offset is None:
        q_offset = sk - sq
    return _flash.FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), causal,
        sliding_window, scale, int(q_offset), sk)
