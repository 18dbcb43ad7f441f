"""Transformer-layer bodies: the softmax (GQA) and linear-attention mixers
and the layer glue, with full-sequence (forward, prefill) and single-token
(decode) entry points. The linear mixer runs the paper's variants (§4):
any feature map, the fixed decays and GLA's data-dependent gate (``wdt``),
causal or bidirectional.

Twin of the softmax, linear and dense parts of ``repro/models/blocks.py``.
Mixers consume and produce ``(B, S, d)``; inside, activations are ``(B, H,
S, dh)``. Under sequence parallelism (``Ctx.sp``) ``S`` is this rank's
chunk: linear layers run LASP-2 (``core.lasp2``, the exchange of
``sp.comm``), softmax layers the K/V all-gather of LASP-2H or, under the
"ulysses" strategy, its two all-to-alls (``core.lasp2h``). Mamba2, hymba, cross-attention
and MoE layers are ported in later slices and raise
``NotImplementedError`` here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core import linear_attention as la_core
from repro_torch.core.lasp2 import lasp2
from repro_torch.core.lasp2h import (allgather_context_attention,
                                     ring_decode_attention,
                                     ulysses_context_attention)
from repro_torch.kernels import ops
from repro_torch.models.layers import (dense_init, mlp_apply, mlp_init,
                                       rmsnorm, rmsnorm_init, rope)


@dataclass
class Ctx:
    cfg: ModelConfig
    positions: Any = None          # (S,) or (B, S) global positions
    causal: bool = True
    decode_pos: Any = None         # (B,) int positions during decode
    resets: Any = None             # (B, S) bool: state resets (doc starts)
    sp: Any = None                 # core.lasp2.SPConfig: S is a chunk


def _unported(spec: LayerSpec):
    if spec.mixer not in ("linear", "softmax") or spec.mlp != "dense":
        raise NotImplementedError(
            f"layer mixer={spec.mixer!r} mlp={spec.mlp!r} is ported in a "
            f"later slice; the port runs mixer='linear' or 'softmax', "
            f"mlp='dense'")


def _heads_split(x, n_heads, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim).transpose(1, 2)


def _heads_merge(x):
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def _qkv(p, x, cfg: ModelConfig, positions=None):
    dt = x.dtype
    q = _heads_split(x @ p["wq"].to(dt), cfg.n_heads, cfg.head_dim)
    k = _heads_split(x @ p["wk"].to(dt), cfg.n_kv_heads, cfg.head_dim)
    v = _heads_split(x @ p["wv"].to(dt), cfg.n_kv_heads, cfg.head_dim)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


# ===========================================================================
# Softmax (GQA) attention mixer
# ===========================================================================

def softmax_init(generator, cfg: ModelConfig, dtype, device):
    if cfg.qkv_bias:
        raise NotImplementedError("qkv biases are ported in a later slice")
    d, dh = cfg.d_model, cfg.head_dim
    return {"wq": dense_init(generator, d, cfg.n_heads * dh, dtype, device),
            "wk": dense_init(generator, d, cfg.n_kv_heads * dh, dtype,
                             device),
            "wv": dense_init(generator, d, cfg.n_kv_heads * dh, dtype,
                             device),
            "wo": dense_init(generator, cfg.n_heads * dh, d, dtype, device)}


def _softmax_out(params, x, q, k, v, ctx: Ctx, window):
    attend = ulysses_context_attention if ctx.sp is not None and \
        ctx.sp.comm.strategy == "ulysses" else allgather_context_attention
    o = attend(q, k, v, sp=ctx.sp, causal=ctx.causal, sliding_window=window)
    return _heads_merge(o) @ params["wo"].to(x.dtype)


def softmax_apply(params, x, ctx: Ctx, *, window=None):
    """Full-sequence GQA attention through ``ops.flash_attention_op`` (the
    flash kernels on the card); under sequence parallelism the K/V
    all-gather of LASP-2H first, or under the "ulysses" strategy the two
    all-to-alls of ``ulysses_context_attention``. The reference takes its
    banded XLA form when ``S % window == 0`` (never inside its DP×SP
    step); it computes the same function, and the kernels' run-time band
    skips the same blocks. Softmax layers ignore ``ctx.resets``: on
    packed rows they attend across documents, as in the reference."""
    q, k, v = _qkv(params, x, ctx.cfg, ctx.positions)
    return _softmax_out(params, x, q, k, v, ctx, window)


def softmax_ring_len(spec: LayerSpec, max_len: int) -> int:
    """Ring-buffer length of a softmax layer's decode KV cache: the window
    for sliding-window layers (constant in context length), else
    ``max_len``."""
    if spec.sliding_window:
        return min(max_len, spec.sliding_window)
    return max_len


def softmax_cache(cfg: ModelConfig, spec: LayerSpec, batch, max_len, device):
    """Empty ring cache: bf16 K/V (B, Hkv, R, dh) whatever ``cfg.dtype``,
    and the absolute position of each slot (-1 = never written)."""
    r = softmax_ring_len(spec, max_len)
    shape = (batch, cfg.n_kv_heads, r, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "kpos": torch.full((batch, r), -1, dtype=torch.int32,
                               device=device)}


def softmax_prefill_cache(k, v, positions, ring: int):
    """Place the prompt's K/V (B, Hkv, S, dh) in a fresh ring of ``ring``
    slots.

    Slot ``i`` receives the prompt token at the highest position ``p <=
    last`` with ``p % ring == i`` (the ``slot = pos % ring`` rule decode
    uses), tagged with its absolute position in ``kpos``; slots no token
    reached hold -1. K/V are stored in bf16, as the reference's cache.
    """
    b, hkv, s, dh = k.shape
    pos2d = torch.broadcast_to(torch.atleast_2d(positions),
                               (b, s)).to(torch.int64)
    last = pos2d[:, -1:]                                      # (B, 1)
    i = torch.arange(ring, device=k.device)[None, :]          # (1, R)
    p_i = last - torch.remainder(last - i, ring)              # (B, R)
    col = torch.clamp(p_i - pos2d[:, :1], 0, s - 1)
    idx = col[:, None, :, None].expand(b, hkv, ring, dh)
    return {"k": torch.gather(k, 2, idx).to(torch.bfloat16),
            "v": torch.gather(v, 2, idx).to(torch.bfloat16),
            "kpos": torch.where(p_i >= 0, p_i,
                                torch.full_like(p_i, -1)).to(torch.int32)}


def softmax_decode(params, x, cache, ctx: Ctx, *, window=None):
    """One token per row at position ``ctx.decode_pos`` (B,): write its K/V
    in place into slot ``pos % R`` of the ring (rounded to the cache's
    bf16), then attend to the ring."""
    cfg = ctx.cfg
    posv = ctx.decode_pos.to(device=x.device, dtype=torch.int32)
    q, k, v = _qkv(params, x, cfg, None)
    q = rope(q, posv[:, None], cfg.rope_theta)
    k = rope(k, posv[:, None], cfg.rope_theta)
    rows = torch.arange(x.shape[0], device=x.device)
    slot = torch.remainder(posv, cache["k"].shape[2]).long()
    cache["k"][rows, :, slot] = k[:, :, 0].to(cache["k"].dtype)
    cache["v"][rows, :, slot] = v[:, :, 0].to(cache["v"].dtype)
    cache["kpos"][rows, slot] = posv.to(cache["kpos"].dtype)
    o = ring_decode_attention(q, cache["k"], cache["v"], cache["kpos"], posv,
                              sliding_window=window)
    y = _heads_merge(o) @ params["wo"].to(x.dtype)
    return y, cache


def _softmax_prefill(params, x, ctx: Ctx, spec: LayerSpec, max_len):
    """Prompt attention and its ring cache from one K/V projection."""
    q, k, v = _qkv(params, x, ctx.cfg, ctx.positions)
    y = _softmax_out(params, x, q, k, v, ctx, spec.sliding_window)
    return y, softmax_prefill_cache(k, v, ctx.positions,
                                    softmax_ring_len(spec, max_len))


# ===========================================================================
# Linear attention mixer (the paper's module)
# ===========================================================================

def linear_init(generator, cfg: ModelConfig, dtype, device):
    p = softmax_init(generator, cfg, dtype, device)
    if cfg.linear_attn.decay == "data":
        # GLA's gate: log a = logsigmoid(x @ wdt), one value a head a token
        p["wdt"] = dense_init(generator, cfg.d_model, cfg.n_heads, dtype,
                              device, scale=0.01)
    return p


def _linear_qkv(params, x, ctx: Ctx):
    """q, k, v (B, H, S, dh) and log_a (B, H, S) fp32 or None."""
    cfg = ctx.cfg
    lac = cfg.linear_attn
    q, k, v = _qkv(params, x, cfg,
                   ctx.positions if lac.feature_map != "taylor" else None)
    # GQA → full heads for the linear recurrence (state is per q-head)
    rep = cfg.n_heads // cfg.n_kv_heads
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    q = la_core.feature_map(q, lac.feature_map)
    k = la_core.feature_map(k, lac.feature_map)
    q = q * (q.shape[-1] ** -0.5)
    b, _, s, _ = q.shape
    if lac.decay == "data":
        gate = (x @ params["wdt"].to(x.dtype)).float()
        log_a = torch.nn.functional.logsigmoid(gate).transpose(1, 2)
    elif lac.decay == "none":
        log_a = None
    else:
        log_a = la_core.decay_log_a(lac.decay, heads=cfg.n_heads, s=s,
                                    device=x.device)[None].expand(
                                        b, cfg.n_heads, s)
    if ctx.resets is not None:
        # Zero the state at document starts and at the first real token of
        # a left-padded prefill row.
        base = log_a if log_a is not None else torch.zeros(
            (b, cfg.n_heads, s), dtype=torch.float32, device=x.device)
        log_a = torch.where(ctx.resets[:, None, :],
                            torch.full((), la_core.RESET_LOG_A,
                                       device=x.device), base)
    return q, k, v, log_a


def linear_apply(params, x, ctx: Ctx):
    """Causal: the chunk kernels (``ops.linear_attention_op``), or LASP-2
    under sequence parallelism. Bidirectional (``ctx.causal`` False):
    paper Alg. 1, every position reads the whole sequence's state; like
    the reference it ignores log a and resets there."""
    lac = ctx.cfg.linear_attn
    q, k, v, log_a = _linear_qkv(params, x, ctx)
    if ctx.sp is None and ctx.causal:
        o, _, _ = ops.linear_attention_op(q, k, v, log_a,
                                          block_size=lac.block_size)
    else:
        # Resets (packed documents) and data decay give log_a a role the
        # faithful backward treats as constant: autodiff, as the reference.
        o = lasp2(q, k, v, log_a, sp=ctx.sp, causal=ctx.causal,
                  block_size=lac.block_size,
                  backward="autodiff" if lac.decay == "data"
                  or ctx.resets is not None else lac.backward)
    return _heads_merge(o.to(x.dtype)) @ params["wo"].to(x.dtype)


def linear_cache(cfg: ModelConfig, batch, device):
    # Constant-size memory state, no KV cache; the cumulative log decay
    # rides along so decode continues the chunked scan exactly. Its rows
    # are the feature map's width: 1 + dh + dh² for taylor.
    dk = cfg.head_dim
    if cfg.linear_attn.feature_map == "taylor":
        dk = 1 + dk + dk * dk
    return {"m": torch.zeros((batch, cfg.n_heads, dk, cfg.head_dim),
                             dtype=torch.float32, device=device),
            "log_decay": torch.zeros((batch, cfg.n_heads),
                                     dtype=torch.float32, device=device)}


def linear_decode(params, x, cache, ctx: Ctx):
    # ctx.positions carries the decode positions (B, 1) → RoPE in _qkv.
    q, k, v, log_a = _linear_qkv(params, x, ctx)   # S == 1
    o, m, ld = ops.linear_decode_op(
        q[..., 0, :], k[..., 0, :], v[..., 0, :],
        log_a[..., 0] if log_a is not None else None,
        cache["m"], cache["log_decay"])
    o = _heads_merge(o[:, :, None, :].to(x.dtype))
    return o @ params["wo"].to(x.dtype), {"m": m, "log_decay": ld}


def _linear_prefill(params, x, ctx: Ctx):
    cfg = ctx.cfg
    q, k, v, log_a = _linear_qkv(params, x, ctx)
    b, h = q.shape[0], q.shape[1]
    o, m, _ = ops.linear_attention_op(q, k, v, log_a,
                                      block_size=cfg.linear_attn.block_size)
    y = _heads_merge(o.to(x.dtype)) @ params["wo"].to(x.dtype)
    # The cache's log decay is the sum of every log a, resets included.
    ld = (log_a.float().sum(-1) if log_a is not None
          else torch.zeros((b, h), dtype=torch.float32, device=x.device))
    return y, {"m": m, "log_decay": ld}


# ===========================================================================
# Layer glue
# ===========================================================================

def layer_init(generator, cfg: ModelConfig, spec: LayerSpec, dtype, device):
    _unported(spec)
    mix_init = {"softmax": softmax_init, "linear": linear_init}[spec.mixer]
    return {"ln1": rmsnorm_init(cfg.d_model, device),
            "mixer": mix_init(generator, cfg, dtype, device),
            "ln2": rmsnorm_init(cfg.d_model, device),
            "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, device,
                            act=cfg.mlp_act)}


def _mlp_residual(params, x, cfg: ModelConfig):
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + mlp_apply(params["mlp"], h, act=cfg.mlp_act)


def layer_apply(params, x, ctx: Ctx, spec: LayerSpec):
    _unported(spec)
    h = rmsnorm(params["ln1"], x, ctx.cfg.norm_eps)
    if spec.mixer == "softmax":
        y = softmax_apply(params["mixer"], h, ctx, window=spec.sliding_window)
    else:
        y = linear_apply(params["mixer"], h, ctx)
    return _mlp_residual(params, x + y, ctx.cfg)


def layer_cache(cfg: ModelConfig, spec: LayerSpec, batch, max_len, device):
    _unported(spec)
    if spec.mixer == "softmax":
        return {"mixer": softmax_cache(cfg, spec, batch, max_len, device)}
    return {"mixer": linear_cache(cfg, batch, device)}


def layer_prefill(params, x, ctx: Ctx, spec: LayerSpec, max_len):
    _unported(spec)
    h = rmsnorm(params["ln1"], x, ctx.cfg.norm_eps)
    if spec.mixer == "softmax":
        y, mc = _softmax_prefill(params["mixer"], h, ctx, spec, max_len)
    else:
        y, mc = _linear_prefill(params["mixer"], h, ctx)
    return _mlp_residual(params, x + y, ctx.cfg), {"mixer": mc}


def layer_decode(params, x, cache, ctx: Ctx, spec: LayerSpec):
    _unported(spec)
    h = rmsnorm(params["ln1"], x, ctx.cfg.norm_eps)
    if spec.mixer == "softmax":
        y, mc = softmax_decode(params["mixer"], h, cache["mixer"], ctx,
                               window=spec.sliding_window)
    else:
        y, mc = linear_decode(params["mixer"], h, cache["mixer"], ctx)
    return _mlp_residual(params, x + y, ctx.cfg), {"mixer": mc}
