"""Chunked decayed causal linear attention, forward and backward: the Hopper
kernels and their plain PyTorch versions.

Twin of ``repro/kernels/lasp2_chunk.py``. On CUDA tensors the wrappers
launch the kernels under ``csrc/`` (design and bound in each header), each
on one of two routes fixed by :func:`_route`:

* :func:`lasp2_chunk_fwd` (K1) — ``sm90``: ``csrc/lasp2_chunk_fwd_sm90.cu``;
  ``simt``: ``csrc/lasp2_chunk_fwd.cu``;
* :func:`lasp2_chunk_bwd_dq` (K2a), the forward-order dq pass — ``sm90``:
  ``csrc/lasp2_chunk_bwd_dq_sm90.cu``; ``simt``: ``csrc/lasp2_chunk_bwd.cu``;
* :func:`lasp2_chunk_bwd_dkv` (K2b), the reverse-order dk/dv/dlog_a pass —
  ``sm90``: ``csrc/lasp2_chunk_bwd_sm90.cu``; ``simt``:
  ``csrc/lasp2_chunk_bwd.cu``.

``sm90`` is the tensor-core route (wgmma, TMA) for bf16 with dk and dv in
{64, 128}: its kernels feed every fp32 operand to their products as two
bf16 terms, so that they meet the fp32 plain versions' limits. K1's and
K2a's ``sm90`` entries launch one kernel body,
``csrc/lasp2_chunk_sm90.cuh`` (K1 with its operands swapped). ``simt`` is
the CUDA-core route, for fp32 and every other shape.

On CPU tensors each runs its plain version. There is no other path: a CUDA
tensor the kernel does not take raises. :class:`LASP2Chunk` is the
``torch.autograd.Function`` over the forward and both backward passes (the
reference's ``custom_vjp``), what ``ops.linear_attention_op`` calls.
"""

from __future__ import annotations

import torch

from repro_torch.core.linear_attention import chunk_scan
from repro_torch.kernels import _build

DEFAULT_BLOCK = 128
_DTYPES = (torch.bfloat16, torch.float32)
ROUTES = ("sm90", "simt")
_SM90_DIMS = (64, 128)


def _route(dtype, dk, dv) -> str:
    """The kernel route of K1, K2a and K2b for inputs of ``dtype`` with key
    width ``dk`` and value width ``dv``, a fixed table: bf16 with dk and dv
    in {64, 128} go to the tensor-core kernels (``sm90``), fp32 and every
    other shape to the CUDA-core kernels (``simt``)."""
    return "sm90" if dtype == torch.bfloat16 and dk in _SM90_DIMS \
        and dv in _SM90_DIMS else "simt"


def lasp2_chunk_fwd_plain(q, k, v, log_a, *, block_size: int = DEFAULT_BLOCK):
    """Plain PyTorch version: ``chunk_scan`` with ``block_size`` blocks."""
    out = chunk_scan(q, k, v, log_a, block_size=block_size)
    return out.o, out.state, out.log_decay


def _check_devices(name, *ts):
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices "
                         f"{sorted(map(str, devices))}")


def _check(q, k, v, log_a, name="lasp2_chunk_fwd"):
    _check_devices(name, q, k, v, log_a)
    if q.ndim != 3 or k.shape != q.shape or v.ndim != 3 \
            or v.shape[:2] != q.shape[:2] or log_a.shape != q.shape[:2]:
        raise ValueError(
            f"{name}: want q, k (BH,S,dk), v (BH,S,dv), log_a "
            f"(BH,S); got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}, {tuple(log_a.shape)}")


def _check_cuda(name, ts, f32s):
    """What every kernel of this module takes on the card: one dtype of
    ``_DTYPES`` for the activations ``ts``, fp32 for ``f32s``, contiguous
    tensors, S >= 1, dk a multiple of 16 up to 128, dv a multiple of 64.
    ``ts`` starts with a (BH, S, dk) and ends with a (BH, S, dv) tensor."""
    if ts[0].device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {ts[0].device}")
    dtype = ts[0].dtype
    if dtype not in _DTYPES or any(t.dtype != dtype for t in ts):
        raise TypeError(f"{name}: q/k/v (and o, dO) must share one dtype of "
                        f"{_DTYPES}; got {[t.dtype for t in ts]}")
    if any(t.dtype != torch.float32 for t in f32s):
        raise TypeError(f"{name}: log_a (and dstate) must be float32, got "
                        f"{[t.dtype for t in f32s]}")
    if not all(t.is_contiguous() for t in (*ts, *f32s)):
        raise ValueError(f"{name}: inputs must be contiguous")
    bh, s, dk = ts[0].shape
    dv = ts[-1].shape[-1]
    if s < 1 or bh < 1 or dk % 16 or not 16 <= dk <= 128 or dv % 64:
        raise ValueError(f"{name}: kernel takes S >= 1, dk a "
                         f"multiple of 16 up to 128, dv a multiple of 64; "
                         f"got S={s}, dk={dk}, dv={dv}")
    return bh, s, dk, dv


def _check_sm90(name, ts):
    """TMA reads each tensor from a 16-byte aligned base."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: the sm90 route needs 16-byte aligned "
                         f"inputs")


def _launch(name, fn, *args):
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    device = args[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


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
    name = "lasp2_chunk_fwd"
    bh, s, dk, dv = _check_cuda(name, (q, k, v), (log_a,))
    route = _route(q.dtype, dk, dv)
    o = torch.empty((bh, s, dv), dtype=q.dtype, device=q.device)
    state = torch.empty((bh, dk, dv), dtype=torch.float32, device=q.device)
    ld = torch.empty((bh,), dtype=torch.float32, device=q.device)
    if route == "sm90":
        _check_sm90(name, (q, k, v))
    fwd_entry(route, q, k, v, log_a, o, state, ld)
    lasp2_chunk_fwd.launches += 1
    lasp2_chunk_fwd.route_launches[route] += 1
    return o, state, ld


def fwd_entry(route, q, k, v, log_a, o, state, ld):
    """Launch K1's C entry on ``route`` into the given outputs (checked
    inputs; the wrapper's launch, and the guard-band battery's)."""
    bh, s, dk = q.shape
    dv = v.shape[-1]
    if route == "sm90":
        fn = _build.entry("lasp2_chunk_fwd_sm90", "lasp2_chunk_fwd_sm90", 7,
                          4)
        _launch("lasp2_chunk_fwd", fn, q, k, v, log_a, o, state, ld, bh, s,
                dk, dv)
    else:
        fn = _build.entry("lasp2_chunk_fwd", "lasp2_chunk_fwd", 7, 5)
        _launch("lasp2_chunk_fwd", fn, q, k, v, log_a, o, state, ld, bh, s,
                dk, dv, int(q.dtype == torch.bfloat16))


# kernel launches (CUDA path only), in all and per route
lasp2_chunk_fwd.launches = 0
lasp2_chunk_fwd.route_launches = dict.fromkeys(ROUTES, 0)


# ---------------------------------------------------------------------------
# Backward: the two passes of the reference's ``lasp2_chunk_bwd``.
# ---------------------------------------------------------------------------

def _decay_mat(cb):
    """D_ij = exp(cb_i - cb_j) for i >= j else 0, over the last dim of
    ``cb`` (..., C); the exponent is neutralised where masked."""
    c = cb.shape[-1]
    mask = torch.ones((c, c), dtype=torch.bool, device=cb.device).tril()
    zero = torch.zeros((), dtype=torch.float32, device=cb.device)
    diff = cb[..., :, None] - cb[..., None, :]
    return torch.where(mask, torch.exp(torch.where(mask, diff, zero)), zero)


def _blocks(x, block_size):
    """(BH, S, ...) fp32 -> list of (BH, C, ...) blocks along S."""
    return list(torch.split(x.float(), block_size, dim=1))


def lasp2_chunk_bwd_dq_plain(k, v, log_a, do, *,
                             block_size: int = DEFAULT_BLOCK):
    """Plain version of the dq pass, block by block in forward order,
    re-carrying the prefix state M:

        dq_i = Σ_{j<=i} e^{cb_i-cb_j} (dO_i·v_j) k_j + e^{cb_i} dO_i Mᵀ
        M <- e^A M + (K ⊙ e^{A-cb})ᵀ V

    Returns dq (BH, S, dk) in k's dtype."""
    bh, s, dk = k.shape
    if s % block_size:
        raise ValueError(f"S={s} not divisible by block_size={block_size}")
    m = torch.zeros((bh, dk, v.shape[-1]), dtype=torch.float32,
                    device=k.device)
    out = []
    for kb, vb, lab, dob in zip(*(_blocks(x, block_size)
                                  for x in (k, v, log_a, do))):
        cb = torch.cumsum(lab, dim=-1)
        a_blk = cb[:, -1]
        dsc = (dob @ vb.transpose(1, 2)) * _decay_mat(cb)
        out.append(dsc @ kb
                   + torch.exp(cb)[..., None] * (dob @ m.transpose(1, 2)))
        w = torch.exp(a_blk[:, None] - cb)
        m = torch.exp(a_blk)[:, None, None] * m \
            + (kb * w[..., None]).transpose(1, 2) @ vb
    return torch.cat(out, dim=1).to(k.dtype)


def lasp2_chunk_bwd_dkv_plain(q, k, v, log_a, o, do, dstate, *,
                              block_size: int = DEFAULT_BLOCK):
    """Plain version of the dk/dv/dlog_a pass, block by block in reverse
    order, carrying the suffix state gradient N (seeded with ``dstate``)
    and the running sum of r:

        dk = (dO Vᵀ ⊙ D)ᵀ Q + w ⊙ (V Nᵀ),  dv = (Q Kᵀ ⊙ D)ᵀ dO + w ⊙ (K N)
        r  = rowsum(dO ⊙ o) - rowsum(K ⊙ dk),  dla_m = Σ_{i>=m} r_i
        N <- e^A N + (Q ⊙ e^{cb})ᵀ dO,         w = e^{A - cb}

    Returns (dk in k's dtype, dv in v's dtype, dla (BH, S) fp32) — dla
    without the constant ⟨state, dM⟩ + dA term."""
    s = q.shape[1]
    if s % block_size:
        raise ValueError(f"S={s} not divisible by block_size={block_size}")
    n = dstate.float()
    rsum = torch.zeros((q.shape[0], 1), dtype=torch.float32, device=q.device)
    dks, dvs, dlas = [], [], []
    blocks = list(zip(*(_blocks(x, block_size)
                        for x in (q, k, v, log_a, o, do))))
    for qb, kb, vb, lab, ob, dob in reversed(blocks):
        cb = torch.cumsum(lab, dim=-1)
        a_blk = cb[:, -1]
        dmat = _decay_mat(cb)
        w = torch.exp(a_blk[:, None] - cb)[..., None]
        dsc = (dob @ vb.transpose(1, 2)) * dmat
        dkb = dsc.transpose(1, 2) @ qb + w * (vb @ n.transpose(1, 2))
        sc = (qb @ kb.transpose(1, 2)) * dmat
        dvb = sc.transpose(1, 2) @ dob + w * (kb @ n)
        r = (dob * ob).sum(-1) - (kb * dkb).sum(-1)
        suffix = r.sum(-1, keepdim=True) - torch.cumsum(r, dim=-1) + r
        dlas.append(suffix + rsum)
        rsum = rsum + r.sum(-1, keepdim=True)
        n = torch.exp(a_blk)[:, None, None] * n \
            + (qb * torch.exp(cb)[..., None]).transpose(1, 2) @ dob
        dks.append(dkb)
        dvs.append(dvb)
    return (torch.cat(dks[::-1], dim=1).to(k.dtype),
            torch.cat(dvs[::-1], dim=1).to(v.dtype),
            torch.cat(dlas[::-1], dim=1))


def lasp2_chunk_bwd_plain(q, k, v, log_a, o, do, dstate, *,
                          block_size: int = DEFAULT_BLOCK):
    """Plain version of :func:`lasp2_chunk_bwd`: the two passes above."""
    dq = lasp2_chunk_bwd_dq_plain(k, v, log_a, do, block_size=block_size)
    return (dq, *lasp2_chunk_bwd_dkv_plain(q, k, v, log_a, o, do, dstate,
                                           block_size=block_size))


def _check_bwd(q, k, v, log_a, o, do, dstate):
    _check(q, k, v, log_a, "lasp2_chunk_bwd_dkv")
    _check_devices("lasp2_chunk_bwd_dkv", q, o, do, dstate)
    bh, s, dk = q.shape
    dv = v.shape[-1]
    if o.shape != v.shape or do.shape != v.shape \
            or dstate.shape != (bh, dk, dv):
        raise ValueError(
            f"lasp2_chunk_bwd_dkv: want o, dO (BH,S,dv), dstate "
            f"(BH,dk,dv); got {tuple(o.shape)}, {tuple(do.shape)}, "
            f"{tuple(dstate.shape)}")


def lasp2_chunk_bwd_dq(k, v, log_a, do, *, block_size: int = DEFAULT_BLOCK):
    """The dq pass (K2a). k: (BH, S, dk); v, do: (BH, S, dv) in one dtype;
    log_a: (BH, S) fp32. Returns dq (BH, S, dk) in k's dtype."""
    _check(k, k, v, log_a, "lasp2_chunk_bwd_dq")
    _check_devices("lasp2_chunk_bwd_dq", k, do)
    if do.shape != v.shape:
        raise ValueError(f"lasp2_chunk_bwd_dq: want dO {tuple(v.shape)}, "
                         f"got {tuple(do.shape)}")
    if k.device.type == "cpu":
        return lasp2_chunk_bwd_dq_plain(k, v, log_a, do,
                                        block_size=block_size)
    name = "lasp2_chunk_bwd_dq"
    bh, s, dk, dv = _check_cuda(name, (k, v, do), (log_a,))
    route = _route(k.dtype, dk, dv)
    dq = torch.empty((bh, s, dk), dtype=k.dtype, device=k.device)
    if route == "sm90":
        _check_sm90(name, (k, v, do))
    bwd_dq_entry(route, k, v, log_a, do, dq)
    lasp2_chunk_bwd_dq.launches += 1
    lasp2_chunk_bwd_dq.route_launches[route] += 1
    return dq


def bwd_dq_entry(route, k, v, log_a, do, dq):
    """Launch K2a's C entry on ``route`` into ``dq``."""
    name = "lasp2_chunk_bwd_dq"
    bh, s, dk = k.shape
    dv = v.shape[-1]
    if route == "sm90":
        fn = _build.entry("lasp2_chunk_bwd_dq_sm90", "lasp2_chunk_bwd_dq_sm90",
                          5, 4)
        _launch(name, fn, k, v, log_a, do, dq, bh, s, dk, dv)
    else:
        m_scratch = torch.empty((bh, dk, dv), dtype=torch.float32,
                                device=k.device)
        fn = _build.entry("lasp2_chunk_bwd", name, 6, 5)
        _launch(name, fn, k, v, log_a, do, dq, m_scratch, bh, s, dk, dv,
                int(k.dtype == torch.bfloat16))


# kernel launches (CUDA path only), in all and per route
lasp2_chunk_bwd_dq.launches = 0
lasp2_chunk_bwd_dq.route_launches = dict.fromkeys(ROUTES, 0)


def lasp2_chunk_bwd_dkv(q, k, v, log_a, o, do, dstate, *,
                        block_size: int = DEFAULT_BLOCK):
    """The dk/dv/dlog_a pass (K2b). q, k: (BH, S, dk); v, o, do: (BH, S,
    dv) in one dtype; log_a: (BH, S) and dstate (BH, dk, dv) fp32.
    Returns (dk, dv in the input dtype, dla (BH, S) fp32 without the
    constant term)."""
    _check_bwd(q, k, v, log_a, o, do, dstate)
    if q.device.type == "cpu":
        return lasp2_chunk_bwd_dkv_plain(q, k, v, log_a, o, do, dstate,
                                         block_size=block_size)
    name = "lasp2_chunk_bwd_dkv"
    bh, s, dk, dv = _check_cuda(name, (q, k, v, o, do), (log_a, dstate))
    route = _route(q.dtype, dk, dv)
    dk_out = torch.empty((bh, s, dk), dtype=k.dtype, device=k.device)
    dv_out = torch.empty((bh, s, dv), dtype=v.dtype, device=v.device)
    dla = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    if route == "sm90":
        _check_sm90(name, (q, k, v, o, do))
    bwd_dkv_entry(route, q, k, v, log_a, o, do, dstate, dk_out, dv_out, dla)
    lasp2_chunk_bwd_dkv.launches += 1
    lasp2_chunk_bwd_dkv.route_launches[route] += 1
    return dk_out, dv_out, dla


def bwd_dkv_entry(route, q, k, v, log_a, o, do, dstate, dk_out, dv_out, dla):
    """Launch K2b's C entry on ``route`` into ``dk_out``, ``dv_out`` and
    ``dla``."""
    name = "lasp2_chunk_bwd_dkv"
    bh, s, dk = q.shape
    dv = v.shape[-1]
    if route == "sm90":
        fn = _build.entry("lasp2_chunk_bwd_sm90", "lasp2_chunk_bwd_dkv_sm90",
                          10, 4)
        _launch(name, fn, q, k, v, log_a, o, do, dstate, dk_out, dv_out, dla,
                bh, s, dk, dv)
    else:
        n_scratch = torch.empty((bh, dk, dv), dtype=torch.float32,
                                device=q.device)
        fn = _build.entry("lasp2_chunk_bwd", name, 11, 5)
        _launch(name, fn, q, k, v, log_a, o, do, dstate, dk_out, dv_out, dla,
                n_scratch, bh, s, dk, dv, int(q.dtype == torch.bfloat16))


# kernel launches (CUDA path only), in all and per route
lasp2_chunk_bwd_dkv.launches = 0
lasp2_chunk_bwd_dkv.route_launches = dict.fromkeys(ROUTES, 0)


def lasp2_chunk_bwd(q, k, v, log_a, o, do, dstate, *,
                    block_size: int = DEFAULT_BLOCK):
    """Backward of :func:`lasp2_chunk_fwd` wrt (q, k, v, log_a).

    ``o`` is the saved forward output; ``do`` (o's dtype) and ``dstate``
    (fp32) are the cotangents of the output and the end-of-chunk state.
    Returns ``(dq, dk, dv, dla_partial)``: dq, dk, dv in the input dtype,
    ``dla_partial`` (BH, S) fp32 still without the constant ⟨state, dM⟩ +
    dA term, which :class:`LASP2Chunk` adds. On CUDA tensors both passes
    launch their kernels (``block_size`` is then the plain version's only).
    """
    _check_bwd(q, k, v, log_a, o, do, dstate)
    dq = lasp2_chunk_bwd_dq(k, v, log_a, do, block_size=block_size)
    return (dq, *lasp2_chunk_bwd_dkv(q, k, v, log_a, o, do, dstate,
                                     block_size=block_size))


class LASP2Chunk(torch.autograd.Function):
    """Trainable chunked linear attention: :func:`lasp2_chunk_fwd` forward,
    :func:`lasp2_chunk_bwd` backward (the reference's ``lasp2_chunk``
    ``custom_vjp``). All three outputs ``(o, state, log_decay)`` take
    cotangents; one that the caller does not use arrives as zeros.

    ``LASP2Chunk.apply(q, k, v, log_a, block_size)`` with (BH, S, d)
    tensors and fp32 ``log_a``.
    """

    @staticmethod
    def forward(ctx, q, k, v, log_a, block_size):
        o, state, ld = lasp2_chunk_fwd(q, k, v, log_a, block_size=block_size)
        ctx.save_for_backward(q, k, v, log_a, o, state)
        ctx.block_size = block_size
        return o, state, ld

    @staticmethod
    def backward(ctx, do, dstate, dld):
        q, k, v, log_a, o, state = ctx.saved_tensors
        dstate = dstate.float().contiguous()
        dq, dk, dv, dla = lasp2_chunk_bwd(
            q, k, v, log_a, o, do.contiguous(), dstate,
            block_size=ctx.block_size)
        # ∂L/∂log_a_m also carries the end-of-chunk terms ⟨state, dM⟩ + dA,
        # the same for every position m (they sit behind the whole decay
        # chain).
        const = (state * dstate).sum(dim=(1, 2)) + dld.float()
        return dq, dk, dv, (dla + const[:, None]).to(log_a.dtype), None
