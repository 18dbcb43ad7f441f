"""GQA flash attention, forward and both backward passes: the Hopper kernels
and their plain PyTorch versions.

Twin of ``repro/kernels/flash_attention.py``. On CUDA tensors the wrappers
launch the kernels under ``csrc/`` (design and bound in each header):

* :func:`flash_attention_fwd` — o and lse = m + log l (K4);
* :func:`flash_attention_bwd_dq` — the q-major dq pass (K5a);
* :func:`flash_attention_bwd_dkv` — the kv-major dk/dv pass over the
  transposed band, summed over the GQA group (K5b).

Each has two routes, fixed by the inputs' dtype and head dim
(:func:`_route`): ``sm90``, tensor-core kernels (wgmma, TMA, mbarrier
rings) for bf16 at dh 64 and 128, in ``csrc/flash_attention_fwd_sm90.cu``,
``csrc/flash_attention_bwd_dq_sm90.cu`` and
``csrc/flash_attention_bwd_dkv_sm90.cu``; and ``simt``, the CUDA-core
kernels of ``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``
for fp32 at any dh and bf16 at dh 16. The tensor cores have no fp32 product
that holds fp32's 3e-4, so fp32 stays on the CUDA cores. The ``sm90``
kernels round P (and dS) to bf16 inside their products where the reference
keeps fp32; :func:`sm90_rounding_bound` is the limit of that rounding.

On CPU tensors each runs its plain version, the direct form of the same
formulas. There is no other path: a CUDA tensor the kernel does not take
raises. :class:`FlashAttention` is the ``torch.autograd.Function`` over the
three (the reference's ``custom_vjp``), what ``ops.flash_attention_op``
calls.

Masking is in global coordinates: query row i sits at ``q_offset + i``
(default ``sk - sq``), key j at j; a pair is valid when ``j < kv_len``,
``i_pos >= j`` if ``causal`` and ``i_pos - j < window`` if a window is set.
``q_offset``, ``kv_len``, ``window``, ``causal`` and ``scale`` are plain
launch arguments: the kernels trim the band for any offset.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lasp2_chunk import (ROUTES, _check_devices,
                                             _check_sm90, _launch)

_DTYPES = (torch.bfloat16, torch.float32)
_HEAD_DIMS = (16, 64, 128)
_SOURCE_BWD = "flash_attention_bwd"
_SM90 = {(torch.bfloat16, 64), (torch.bfloat16, 128)}


def _route(dtype, dh) -> str:
    """The kernel route of K4, K5a and K5b for inputs of ``dtype`` and
    head dim ``dh``, a fixed table: bf16 at dh 64 and 128 go to the
    tensor-core kernels (``sm90``), fp32 at any dh and bf16 at dh 16 to the
    CUDA-core kernels (``simt``)."""
    return "sm90" if (dtype, dh) in _SM90 else "simt"


def mask_value(dtype) -> float:
    """Finite large-negative for masked logits, ``finfo(dtype).min / 2``."""
    return float(torch.finfo(dtype).min) * 0.5


def _resolve(q, k, scale, q_offset, kv_len):
    sq, sk = q.shape[2], k.shape[2]
    return (q.shape[-1] ** -0.5 if scale is None else float(scale),
            sk - sq if q_offset is None else int(q_offset),
            sk if kv_len is None else int(kv_len))


def _check(name, q, k, v, window, kv_len, *extra):
    _check_devices(name, q, k, v, *extra)
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[-1] != q.shape[-1] \
            or k.shape[1] < 1 or q.shape[1] % k.shape[1]:
        raise ValueError(
            f"{name}: want q (B,Hq,Sq,dh), k, v (B,Hkv,Sk,dh) with Hkv "
            f"dividing Hq; got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if not 1 <= kv_len <= k.shape[2]:
        raise ValueError(f"{name}: kv_len={kv_len} outside 1..{k.shape[2]}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window={window} must be >= 1")


def _mask(sq, sk, q_offset, kv_len, causal, window, device):
    """(Sq, Sk) validity in global coordinates."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos < kv_len
    if causal:
        m = m & (qpos >= kpos)
    if window is not None:
        m = m & ((qpos - kpos) < window)
    return m


def _expand(x, rep):
    """(B, Hkv, S, dh) → (B, Hq, S, dh) fp32: query head h reads kv head
    h // rep."""
    return torch.repeat_interleave(x, rep, dim=1).float()


def _probs(q, k, lse, mask, scale):
    """p = exp(s − lse) where valid, else 0 (the backward's recomputation)."""
    rep = q.shape[1] // k.shape[1]
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), _expand(k, rep)) * scale
    return torch.where(mask, torch.exp(s - lse[..., None]),
                       torch.zeros((), device=q.device))


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------

def flash_attention_fwd_plain(q, k, v, *, causal=True, window=None,
                              scale=None, q_offset=None, kv_len=None):
    """Plain version of K4: the masked softmax in direct form, with the
    kernel's fill (``mask_value``), zeroed invalid p and ``max(l, 1e-30)``.
    Returns (o in q's dtype, lse (B, Hq, Sq) fp32)."""
    scale, q_offset, kv_len = _resolve(q, k, scale, q_offset, kv_len)
    rep = q.shape[1] // k.shape[1]
    mask = _mask(q.shape[2], k.shape[2], q_offset, kv_len, causal, window,
                 q.device)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), _expand(k, rep)) * scale
    s = torch.where(mask, s, torch.full((), mask_value(torch.float32),
                                        device=q.device))
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]),
                    torch.zeros((), device=q.device))
    l = p.sum(dim=-1).clamp(min=1e-30)
    o = torch.einsum("bhst,bhtd->bhsd", p, _expand(v, rep)) / l[..., None]
    return o.to(q.dtype), m + torch.log(l)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, *, causal=True,
                                 window=None, scale=None, q_offset=None,
                                 kv_len=None):
    """Plain version of K5a: ds = p (dO vᵀ − delta), dq = scale·ds k.
    Returns dq in q's dtype."""
    scale, q_offset, kv_len = _resolve(q, k, scale, q_offset, kv_len)
    rep = q.shape[1] // k.shape[1]
    mask = _mask(q.shape[2], k.shape[2], q_offset, kv_len, causal, window,
                 q.device)
    p = _probs(q, k, lse, mask, scale)
    dp = torch.einsum("bhsd,bhtd->bhst", do.float(), _expand(v, rep))
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhst,bhtd->bhsd", ds, _expand(k, rep)) * scale
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal=True,
                                  window=None, scale=None, q_offset=None,
                                  kv_len=None):
    """Plain version of K5b: dv = Σ_group pᵀ dO, dk = scale·Σ_group dsᵀ q.
    Returns (dk in k's dtype, dv in v's dtype), (B, Hkv, Sk, dh)."""
    scale, q_offset, kv_len = _resolve(q, k, scale, q_offset, kv_len)
    b, hkv, sk, dh = k.shape
    rep = q.shape[1] // hkv
    mask = _mask(q.shape[2], sk, q_offset, kv_len, causal, window, q.device)
    p = _probs(q, k, lse, mask, scale)
    dp = torch.einsum("bhsd,bhtd->bhst", do.float(), _expand(v, rep))
    ds = p * (dp - delta[..., None])
    dv = torch.einsum("bhst,bhsd->bhtd", p, do.float())
    dk = torch.einsum("bhst,bhsd->bhtd", ds, q.float()) * scale
    dk = dk.reshape(b, hkv, rep, sk, dh).sum(dim=2)
    dv = dv.reshape(b, hkv, rep, sk, dh).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def sm90_rounding_bound(q, k, v, do, lse, delta, *, causal=True,
                        window=None, scale=None, q_offset=None, kv_len=None):
    """How far rounding P and dS to bf16 inside the ``sm90`` kernels'
    products may move o, dq, dk and dv: 2^-8 (bf16's unit roundoff) times
    the same products over absolute values, o: (P·|V|)/l = exp(s − lse)·|V|,
    dq: scale·|dS|·|K| over the band, dv: Σ_group Pᵀ·|dO|, dk:
    scale·Σ_group |dS|ᵀ·|Q|, from the plain formulas with this ``lse`` and
    ``delta``. Returns (o, dq, dk, dv) bounds in fp32, shaped like o, q, k
    and v."""
    scale, q_offset, kv_len = _resolve(q, k, scale, q_offset, kv_len)
    b, hkv, sk, dh = k.shape
    rep = q.shape[1] // hkv
    mask = _mask(q.shape[2], sk, q_offset, kv_len, causal, window, q.device)
    p = _probs(q, k, lse, mask, scale)
    a_o = torch.einsum("bhst,bhtd->bhsd", p, _expand(v, rep).abs())
    dp = torch.einsum("bhsd,bhtd->bhst", do.float(), _expand(v, rep))
    ds = (p * (dp - delta[..., None])).abs()
    del dp
    a_dq = torch.einsum("bhst,bhtd->bhsd", ds, _expand(k, rep).abs()) * scale
    a_dv = torch.einsum("bhst,bhsd->bhtd", p, do.float().abs())
    a_dk = torch.einsum("bhst,bhsd->bhtd", ds, q.float().abs()) * scale
    a_dk = a_dk.reshape(b, hkv, rep, sk, dh).sum(dim=2)
    a_dv = a_dv.reshape(b, hkv, rep, sk, dh).sum(dim=2)
    u = 2.0 ** -8
    return a_o * u, a_dq * u, a_dk * u, a_dv * u


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _check_cuda(name, ts, f32s):
    """What the kernels take on the card: q, k, v (and dO) in one dtype of
    ``_DTYPES``, lse and delta fp32, contiguous, dh in ``_HEAD_DIMS``."""
    if ts[0].device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {ts[0].device}")
    dtype = ts[0].dtype
    if dtype not in _DTYPES or any(t.dtype != dtype for t in ts):
        raise TypeError(f"{name}: q/k/v (and dO) must share one dtype of "
                        f"{_DTYPES}; got {[t.dtype for t in ts]}")
    if any(t.dtype != torch.float32 for t in f32s):
        raise TypeError(f"{name}: lse and delta must be float32, got "
                        f"{[t.dtype for t in f32s]}")
    if not all(t.is_contiguous() for t in (*ts, *f32s)):
        raise ValueError(f"{name}: inputs must be contiguous")
    dh = ts[0].shape[-1]
    if dh not in _HEAD_DIMS or ts[0].shape[2] < 1:
        raise ValueError(f"{name}: kernel takes dh in {_HEAD_DIMS} and "
                         f"Sq >= 1; got dh={dh}, Sq={ts[0].shape[2]}")


def _ints(q, k, q_offset, kv_len, causal, window):
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    return (b, hq, hkv, sq, sk, dh, q_offset, kv_len, int(causal),
            int(window is not None), int(window or 0),
            int(q.dtype == torch.bfloat16))


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, scale=None,
                        q_offset: Optional[int] = None,
                        kv_len: Optional[int] = None):
    """GQA flash attention forward (K4). q: (B, Hq, Sq, dh); k, v: (B, Hkv,
    Sk, dh), one dtype. Returns (o (B, Hq, Sq, dh) in q's dtype, lse (B,
    Hq, Sq) fp32). ``scale`` defaults to dh^-1/2, ``q_offset`` to Sk − Sq,
    ``kv_len`` to Sk."""
    scale, q_offset, kv_len = _resolve(q, k, scale, q_offset, kv_len)
    _check("flash_attention_fwd", q, k, v, window, kv_len)
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset,
              kv_len=kv_len)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, **kw)
    _check_cuda("flash_attention_fwd", (q, k, v), ())
    route = _route(q.dtype, q.shape[-1])
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if route == "sm90":
        _check_sm90("flash_attention_fwd", (q, k, v, o))
    fwd_entry(route, q, k, v, o, lse, **kw)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.route_launches[route] += 1
    return o, lse


def fwd_entry(route, q, k, v, o, lse, *, causal, window, scale, q_offset,
              kv_len):
    """Launch K4's C entry on ``route`` into ``o`` and ``lse`` (checked
    inputs, resolved ``scale``, ``q_offset`` and ``kv_len``; the wrapper's
    launch, and the guard-band battery's)."""
    src = "flash_attention_fwd_sm90" if route == "sm90" \
        else "flash_attention_fwd"
    fn = _build.entry(src, src, 5, 12, 1)
    _launch("flash_attention_fwd", fn, q, k, v, o, lse,
            *_ints(q, k, q_offset, kv_len, causal, window), scale)


# kernel launches (CUDA path only), in all and per route
flash_attention_fwd.launches = 0
flash_attention_fwd.route_launches = dict.fromkeys(ROUTES, 0)


def _check_bwd(name, q, k, v, do, lse, delta, window, kv_len):
    _check(name, q, k, v, window, kv_len, do, lse, delta)
    if do.shape != q.shape or lse.shape != q.shape[:3] \
            or delta.shape != q.shape[:3]:
        raise ValueError(f"{name}: want dO {tuple(q.shape)}, lse and delta "
                         f"{tuple(q.shape[:3])}; got {tuple(do.shape)}, "
                         f"{tuple(lse.shape)}, {tuple(delta.shape)}")


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           window: Optional[int] = None, scale=None,
                           q_offset: Optional[int] = None,
                           kv_len: Optional[int] = None):
    """The dq pass (K5a). ``do`` like q, ``lse`` and ``delta`` (B, Hq, Sq)
    fp32. Returns dq in q's dtype."""
    name = "flash_attention_bwd_dq"
    scale, q_offset, kv_len = _resolve(q, k, scale, q_offset, kv_len)
    _check_bwd(name, q, k, v, do, lse, delta, window, kv_len)
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset,
              kv_len=kv_len)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    _check_cuda(name, (q, k, v, do), (lse, delta))
    route = _route(q.dtype, q.shape[-1])
    dq = torch.empty_like(q)
    if route == "sm90":
        _check_sm90(name, (q, k, v, do, dq))
    bwd_dq_entry(route, q, k, v, do, lse, delta, dq, **kw)
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.route_launches[route] += 1
    return dq


def bwd_dq_entry(route, q, k, v, do, lse, delta, dq, *, causal, window,
                 scale, q_offset, kv_len):
    """Launch K5a's C entry on ``route`` into ``dq``."""
    name = "flash_attention_bwd_dq"
    fn = _build.entry("flash_attention_bwd_dq_sm90",
                      "flash_attention_bwd_dq_sm90", 7, 12, 1) \
        if route == "sm90" else _build.entry(_SOURCE_BWD, name, 7, 12, 1)
    _launch(name, fn, q, k, v, do, lse, delta, dq,
            *_ints(q, k, q_offset, kv_len, causal, window), scale)


# kernel launches (CUDA path only), in all and per route
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.route_launches = dict.fromkeys(ROUTES, 0)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                            window: Optional[int] = None, scale=None,
                            q_offset: Optional[int] = None,
                            kv_len: Optional[int] = None):
    """The dk/dv pass (K5b), summed over each GQA group. Returns (dk, dv)
    (B, Hkv, Sk, dh) in k's dtype."""
    name = "flash_attention_bwd_dkv"
    scale, q_offset, kv_len = _resolve(q, k, scale, q_offset, kv_len)
    _check_bwd(name, q, k, v, do, lse, delta, window, kv_len)
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset,
              kv_len=kv_len)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    _check_cuda(name, (q, k, v, do), (lse, delta))
    route = _route(q.dtype, q.shape[-1])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if route == "sm90":
        _check_sm90(name, (q, k, v, do))
    bwd_dkv_entry(route, q, k, v, do, lse, delta, dk, dv, **kw)
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.route_launches[route] += 1
    return dk, dv


def bwd_dkv_entry(route, q, k, v, do, lse, delta, dk, dv, *, causal, window,
                  scale, q_offset, kv_len):
    """Launch K5b's C entry on ``route`` into ``dk`` and ``dv``."""
    name = "flash_attention_bwd_dkv"
    fn = _build.entry("flash_attention_bwd_dkv_sm90",
                      "flash_attention_bwd_dkv_sm90", 8, 12, 1) \
        if route == "sm90" else _build.entry(_SOURCE_BWD, name, 8, 12, 1)
    _launch(name, fn, q, k, v, do, lse, delta, dk, dv,
            *_ints(q, k, q_offset, kv_len, causal, window), scale)


# kernel launches (CUDA path only), in all and per route
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.route_launches = dict.fromkeys(ROUTES, 0)


class FlashAttention(torch.autograd.Function):
    """Trainable flash attention: :func:`flash_attention_fwd` forward,
    delta = rowsum(dO ⊙ o) in fp32, then :func:`flash_attention_bwd_dq` and
    :func:`flash_attention_bwd_dkv` backward (the reference's ``_flash``
    ``custom_vjp``). Saves q, k, v, o and lse.

    ``FlashAttention.apply(q, k, v, causal, window, scale, q_offset,
    kv_len)`` with the keyword meanings of :func:`flash_attention_fwd`.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset, kv_len):
        kw = dict(causal=causal, window=window, scale=scale,
                  q_offset=q_offset, kv_len=kv_len)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **ctx.kw)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None
