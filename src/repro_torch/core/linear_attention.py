"""Core linear-attention math in PyTorch: oracles and the chunked form.

Twin of ``repro/core/linear_attention.py``. These are the plain versions the
Hopper kernels are held against: ``chunk_scan`` for the chunk-forward
kernel, ``recurrent_step`` for the decode-step kernel.

Conventions
-----------
* Shapes: ``q, k: (..., S, dk)``, ``v: (..., S, dv)``; leading dims are
  batch/heads and broadcast.
* ``log_a: (..., S)`` is the per-token log decay (``log a_s <= 0``);
  ``log_a = 0`` everywhere is basic linear attention. ``RESET_LOG_A``
  resets the state (document packing, left-padded prefill).
* The recurrence: ``M_s = a_s M_{s-1} + k_s^T v_s``, ``o_s = q_s M_s``.
* All state/decay math is fp32; inputs may be bf16. Every reweighting
  factor is ``exp(cb_i - cb_j)`` with ``i >= j`` or ``exp(A - cb_i)``,
  so <= 1: no overflow.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Stand-in for log(0) used by state resets: exp(-60) ~ 1e-26 underflows any
# realistic state, while fp32 cumulative sums holding a few resets keep
# full relative precision (-1e9 would cancel every neighbouring decay).
RESET_LOG_A = -60.0

# Preferred block sizes, largest first (the reference's MXU-aligned set).
MXU_ALIGNED_BLOCKS = (256, 128, 64, 32)


def pick_block(s: int, preferred: int) -> int:
    """Chunk block size for a local sequence of length ``s``.

    ``preferred`` (capped at ``s``) when it divides ``s``; otherwise the
    largest aligned divisor (256/128/64/32); only when none exists, the
    largest divisor <= preferred. Same policy as the reference.
    """
    bs = min(preferred, s)
    if bs < 1:
        return 1
    if s % bs == 0:
        return bs
    for cand in MXU_ALIGNED_BLOCKS:
        if cand <= bs and s % cand == 0:
            return cand
    while s % bs:
        bs -= 1
    return max(bs, 1)


class ChunkOutputs(NamedTuple):
    """Outputs of a chunked linear-attention pass over a local sequence."""

    o: torch.Tensor          # (..., S, dv) attention output, q's dtype
    state: torch.Tensor      # (..., dk, dv) final memory state (fp32)
    log_decay: torch.Tensor  # (...,) total log decay (fp32)


def _zeros_log_a(q: torch.Tensor) -> torch.Tensor:
    return torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)


# ---------------------------------------------------------------------------
# Oracles (sequential scan): ground truth for tests.
# ---------------------------------------------------------------------------

def sequential_oracle(q, k, v, log_a=None, initial_state=None, causal=True):
    """Token-by-token recurrence; ground truth. O(S) loop, fp32.

    With ``causal=False`` every position reads the full-sequence state
    (paper Alg. 1 semantics).
    """
    *lead, s, dk = q.shape
    dv = v.shape[-1]
    if log_a is None:
        log_a = _zeros_log_a(q)
    qf, kf, vf = q.float(), k.float(), v.float()
    laf = log_a.float()
    m = (torch.zeros((*lead, dk, dv), dtype=torch.float32, device=q.device)
         if initial_state is None else initial_state.float())
    outs = []
    for t in range(s):
        a = torch.exp(laf[..., t])[..., None, None]
        m = a * m + kf[..., t, :, None] * vf[..., t, None, :]
        outs.append(torch.einsum("...k,...kv->...v", qf[..., t, :], m))
    o = torch.stack(outs, dim=-2)
    if not causal:
        o = torch.einsum("...sk,...kv->...sv", qf, m)
    return ChunkOutputs(o.to(q.dtype), m, laf.sum(-1))


def recurrent_step(q, k, v, log_a=None, *, state, log_decay=None):
    """One recurrent decode step (paper Eq. 4), the constant-memory path.

    ``q, k: (..., dk)``, ``v: (..., dv)``, ``log_a: (...,)`` against the
    fp32 ``state: (..., dk, dv)`` and cumulative ``log_decay: (...,)``:

        M' = a * M + k^T v,      o = q M',      L' = L + log a

    Returns ``(o (..., dv) fp32, state' fp32, log_decay' fp32)`` as new
    tensors (the plain version of the decode-step kernel, which instead
    updates the state in place).
    """
    qf, kf, vf = q.float(), k.float(), v.float()
    m = state.float()
    if log_decay is None:
        log_decay = torch.zeros(m.shape[:-2], dtype=torch.float32,
                                device=m.device)
    if log_a is not None:
        laf = log_a.float()
        m = torch.exp(laf)[..., None, None] * m
        log_decay = log_decay + laf
    m = m + kf[..., :, None] * vf[..., None, :]
    o = torch.einsum("...k,...kv->...v", qf, m)
    return o, m, log_decay


# ---------------------------------------------------------------------------
# Block-local (intra-chunk) primitives.
# ---------------------------------------------------------------------------

def _block_terms(q, k, v, log_a):
    """Per-block quantities, fp32. Block length C is the last-but-one dim.

    Returns:
      o_intra: (..., C, dv)  masked intra-block output (zero initial state)
      m_blk:   (..., dk, dv) end-of-block state contribution
                             ``sum_i exp(cb_C - cb_i) k_i^T v_i``
      b:       (..., C)      inclusive cumulative decay ``exp(cb_i)``
      a_blk:   (...,)        total block log decay ``cb_C``
    """
    qf, kf, vf = q.float(), k.float(), v.float()
    cb = torch.cumsum(log_a.float(), dim=-1)           # (..., C) inclusive
    a_blk = cb[..., -1]
    # D_ij = exp(cb_i - cb_j) for i >= j else 0 (i: query, j: key); the
    # exponent is neutralised on the masked region, as in the reference.
    diff = cb[..., :, None] - cb[..., None, :]
    c = cb.shape[-1]
    mask = torch.ones((c, c), dtype=torch.bool, device=cb.device).tril()
    zero = torch.zeros((), dtype=torch.float32, device=cb.device)
    decay_mat = torch.where(mask, torch.exp(torch.where(mask, diff, zero)),
                            zero)
    scores = (qf @ kf.transpose(-1, -2)) * decay_mat
    o_intra = scores @ vf
    w = torch.exp(a_blk[..., None] - cb)               # (..., C), <= 1
    m_blk = (kf * w[..., None]).transpose(-1, -2) @ vf
    return o_intra, m_blk, torch.exp(cb), a_blk


def block_summary(k, v, log_a):
    """State contribution and total log decay of a block (no output).

    Cheaper than ``_block_terms``: skips the intra-block score matrix.
    Returns ``(m_blk (..., dk, dv) fp32, a_blk (...,) fp32)``.
    """
    kf, vf = k.float(), v.float()
    cb = torch.cumsum(log_a.float(), dim=-1)
    a_blk = cb[..., -1]
    w = torch.exp(a_blk[..., None] - cb)               # <= 1
    return (kf * w[..., None]).transpose(-1, -2) @ vf, a_blk


def chunk_summaries(k, v, log_a=None, *, block_size=128):
    """``(M_local, A_local)`` of a local sequence without its outputs: the
    final fp32 state and total log decay, carried block by block."""
    *lead, s, dk = k.shape
    dv = v.shape[-1]
    if log_a is None:
        log_a = _zeros_log_a(k)
    if s % block_size:
        raise ValueError(f"S={s} not divisible by block_size={block_size}")
    nb = s // block_size
    m_blk, a_blk = block_summary(
        k.reshape(*lead, nb, block_size, dk),
        v.reshape(*lead, nb, block_size, dv),
        log_a.float().reshape(*lead, nb, block_size))
    m = torch.zeros((*lead, dk, dv), dtype=torch.float32, device=k.device)
    ld = torch.zeros(tuple(lead), dtype=torch.float32, device=k.device)
    for i in range(nb):
        m = torch.exp(a_blk[..., i])[..., None, None] * m + m_blk[..., i, :, :]
        ld = ld + a_blk[..., i]
    return m, ld


def chunk_scan(q, k, v, log_a=None, *, initial_state=None, block_size=128):
    """Chunked causal linear attention over a local sequence (plain path).

    Splits S into blocks of ``block_size``, forms every block's local terms
    at once, then carries the fp32 state across blocks in order. Equal to
    :func:`sequential_oracle` up to summation order; the plain version of
    the chunk-forward kernel.
    """
    *lead, s, dk = q.shape
    dv = v.shape[-1]
    if log_a is None:
        log_a = _zeros_log_a(q)
    if s % block_size:
        raise ValueError(f"S={s} not divisible by block_size={block_size}")
    nb = s // block_size
    qb = q.reshape(*lead, nb, block_size, dk)
    kb = k.reshape(*lead, nb, block_size, dk)
    vb = v.reshape(*lead, nb, block_size, dv)
    lab = log_a.float().reshape(*lead, nb, block_size)
    o_intra, m_blk, b, a_blk = _block_terms(qb, kb, vb, lab)
    qw = qb.float() * b[..., None]                     # q_i e^{cb_i}
    m = (torch.zeros((*lead, dk, dv), dtype=torch.float32, device=q.device)
         if initial_state is None else initial_state.float())
    ld = torch.zeros(tuple(lead), dtype=torch.float32, device=q.device)
    outs = []
    for i in range(nb):
        outs.append(o_intra[..., i, :, :] + qw[..., i, :, :] @ m)
        m = torch.exp(a_blk[..., i])[..., None, None] * m + m_blk[..., i, :, :]
        ld = ld + a_blk[..., i]
    o = torch.stack(outs, dim=-3).reshape(*lead, s, dv)
    return ChunkOutputs(o.to(q.dtype), m, ld)


# ---------------------------------------------------------------------------
# Gathered-state combines (the local math around an SP exchange).
# ---------------------------------------------------------------------------

def _chunk_weights(logw, mask):
    """``exp(logw)`` where ``mask`` (over the leading W axis), else 0; the
    exponent is neutralised where masked (not min-clamped), as in
    :func:`_block_terms`."""
    m = mask.reshape((-1,) + (1,) * (logw.ndim - 1)).expand_as(logw)
    zero = torch.zeros((), dtype=logw.dtype, device=logw.device)
    return torch.where(m, torch.exp(torch.where(m, logw, zero)), zero)


def prefix_state_combine(ms, cum, t: int):
    """Decayed prefix-combine of gathered chunk states (paper Alg. 2 line 9).

    ms: (W, ..., dk, dv) gathered chunk states (fp32); cum: (W, ...)
    inclusive cumulative chunk log decays along axis 0; t: my chunk index.
    Returns M_{1:t-1} decayed to the start of chunk t:
    ``sum_{j < t} exp(cum[t-1] - cum[j]) * ms[j]``.
    """
    w_idx = torch.arange(ms.shape[0], device=ms.device)
    logw = cum[max(t - 1, 0)][None] - cum               # <= 0 for j <= t-1
    w = _chunk_weights(logw, w_idx < t)
    return torch.einsum("w...,w...kv->...kv", w, ms)


def suffix_grad_combine(dms, cum, t: int):
    """Decayed suffix-combine of gathered state grads (paper Alg. 4 line 9):
    ``dM_t^loc = sum_{t' > t} exp(cum[t'-1] - cum[t]) * dms[t']``."""
    w_idx = torch.arange(dms.shape[0], device=dms.device)
    cum_prev = torch.cat([torch.zeros_like(cum[:1]), cum[:-1]], dim=0)
    logw = cum_prev - cum[t][None]                       # <= 0 for t' > t
    w = _chunk_weights(logw, w_idx > t)
    return torch.einsum("w...,w...kv->...kv", w, dms)


# ---------------------------------------------------------------------------
# Feature maps and decays (paper §4 variants).
# ---------------------------------------------------------------------------

def feature_map(x, kind: str):
    """Kernel feature maps applied to q and k before the recurrence."""
    if kind in ("identity", "none"):
        return x
    if kind == "elu1":         # Katharopoulos et al. basic linear attention
        return torch.nn.functional.elu(x) + 1.0
    if kind == "silu":         # Lightning attention
        return torch.nn.functional.silu(x)
    if kind == "relu":
        return torch.relu(x)
    if kind == "taylor":       # Based: 1 + x + x^2/sqrt(2) second-order terms
        d = x.shape[-1]
        x2 = torch.einsum("...i,...j->...ij", x, x) / (2.0 ** 0.5)
        x2 = x2.reshape(*x.shape[:-1], d * d)
        ones = torch.ones((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)
        return torch.cat([ones, x, x2], dim=-1)
    raise ValueError(f"unknown feature map {kind!r}")


def decay_log_a(kind: str, *, heads: int, s: int, gate=None,
                dtype=torch.float32, device=None):
    """Per-token log decays ``(heads, s)`` for the supported variants.

    kind: ``none`` (log a = 0), ``retention`` (RetNet 1 - 2^{-5-h}),
    ``lightning`` (per-head ALiBi-like slope), or the data-dependent kind,
    where the caller passes ``gate`` = log a directly.
    """
    if kind == "none":
        return torch.zeros((heads, s), dtype=dtype, device=device)
    h = torch.arange(heads, dtype=torch.float32, device=device)
    if kind == "retention":
        a = 1.0 - torch.exp2(-5.0 - h)
        return torch.log(a)[:, None].expand(heads, s).to(dtype)
    if kind == "lightning":
        slope = torch.exp2(-8.0 * (h + 1) / heads)
        return (-slope)[:, None].expand(heads, s).to(dtype)
    if kind == "data":
        if gate is None:
            raise ValueError("data-dependent decay needs a gate")
        return gate
    raise ValueError(f"unknown decay kind {kind!r}")
