"""Transformer-layer bodies: the linear-attention mixer and the layer glue,
with full-sequence (forward, prefill) and single-token (decode) entry
points.

Twin of the linear and dense parts of ``repro/models/blocks.py``. Mixers
consume and produce ``(B, S, d)``; inside, activations are ``(B, H, S,
dh)``. Softmax, mamba2, hymba, cross-attention and MoE layers are ported
in later slices and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core import linear_attention as la_core
from repro_torch.kernels import ops
from repro_torch.models.layers import (dense_init, mlp_apply, mlp_init,
                                       rmsnorm, rmsnorm_init, rope)


@dataclass
class Ctx:
    cfg: ModelConfig
    positions: Any = None          # (S,) or (B, S) global positions
    causal: bool = True
    resets: Any = None             # (B, S) bool: state resets (doc starts)


def _unported(spec: LayerSpec):
    if spec.mixer != "linear" or spec.mlp != "dense":
        raise NotImplementedError(
            f"layer mixer={spec.mixer!r} mlp={spec.mlp!r} is ported in a "
            f"later slice; this slice runs mixer='linear', mlp='dense'")


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
# Linear attention mixer (the paper's module)
# ===========================================================================

def linear_init(generator, cfg: ModelConfig, dtype, device):
    if cfg.qkv_bias or cfg.linear_attn.decay == "data":
        raise NotImplementedError("qkv biases and data-dependent decay are "
                                  "ported in a later slice")
    d, dh = cfg.d_model, cfg.head_dim
    return {"wq": dense_init(generator, d, cfg.n_heads * dh, dtype, device),
            "wk": dense_init(generator, d, cfg.n_kv_heads * dh, dtype,
                             device),
            "wv": dense_init(generator, d, cfg.n_kv_heads * dh, dtype,
                             device),
            "wo": dense_init(generator, cfg.n_heads * dh, d, dtype, device)}


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
    if lac.decay == "none":
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
    if not ctx.causal:
        raise NotImplementedError("bidirectional linear attention is ported "
                                  "in a later slice")
    q, k, v, log_a = _linear_qkv(params, x, ctx)
    o, _, _ = ops.linear_attention_op(
        q, k, v, log_a, block_size=ctx.cfg.linear_attn.block_size)
    return _heads_merge(o.to(x.dtype)) @ params["wo"].to(x.dtype)


def linear_cache(cfg: ModelConfig, batch, device):
    # Constant-size memory state, no KV cache; the cumulative log decay
    # rides along so decode continues the chunked scan exactly.
    return {"m": torch.zeros((batch, cfg.n_heads, cfg.head_dim,
                              cfg.head_dim), dtype=torch.float32,
                             device=device),
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
    return {"ln1": rmsnorm_init(cfg.d_model, device),
            "mixer": linear_init(generator, cfg, dtype, device),
            "ln2": rmsnorm_init(cfg.d_model, device),
            "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, device,
                            act=cfg.mlp_act)}


def _mlp_residual(params, x, cfg: ModelConfig):
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + mlp_apply(params["mlp"], h, act=cfg.mlp_act)


def layer_apply(params, x, ctx: Ctx, spec: LayerSpec):
    _unported(spec)
    h = rmsnorm(params["ln1"], x, ctx.cfg.norm_eps)
    x = x + linear_apply(params["mixer"], h, ctx)
    return _mlp_residual(params, x, ctx.cfg)


def layer_cache(cfg: ModelConfig, spec: LayerSpec, batch, device):
    _unported(spec)
    return {"mixer": linear_cache(cfg, batch, device)}


def layer_prefill(params, x, ctx: Ctx, spec: LayerSpec):
    _unported(spec)
    h = rmsnorm(params["ln1"], x, ctx.cfg.norm_eps)
    y, mc = _linear_prefill(params["mixer"], h, ctx)
    return _mlp_residual(params, x + y, ctx.cfg), {"mixer": mc}


def layer_decode(params, x, cache, ctx: Ctx, spec: LayerSpec):
    _unported(spec)
    h = rmsnorm(params["ln1"], x, ctx.cfg.norm_eps)
    y, mc = linear_decode(params["mixer"], h, cache["mixer"], ctx)
    return _mlp_residual(params, x + y, ctx.cfg), {"mixer": mc}
