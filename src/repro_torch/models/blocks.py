"""Transformer-layer bodies: the softmax (GQA), linear-attention, mamba2
(SSD), hymba and cross-attention mixers, the dense and MoE MLPs and the
layer glue, with full-sequence (forward, prefill) and single-token
(decode) entry points.
The linear mixer runs the paper's variants (§4): any feature map, the
fixed decays and GLA's data-dependent gate (``wdt``), causal or
bidirectional.

Twin of ``repro/models/blocks.py``. Mixers consume and produce ``(B, S, d)``;
inside, activations are ``(B, H, S, dh)``. Under sequence parallelism
(``Ctx.sp``) ``S`` is this rank's chunk: linear and mamba2 layers run
LASP-2 (``core.lasp2``, the exchange of ``sp.comm``), softmax layers the
K/V all-gather of LASP-2H or, under the "ulysses" strategy, its two
all-to-alls (``core.lasp2h``); hymba layers do both. Under a serving
plan (``Ctx.plan``, ``sharding.rules``) prefill runs the same exchanges
(LASP-2's through ``core.lasp2.lasp2_prefill``), mamba2's causal conv
takes the previous chunk's inputs (GSPMD computes the reference's conv
over the whole sequence), and a softmax ring whose slot dim the plan
places over an axis is sliced over that axis's group and read back
through ``ring_decode_attention(sp=)``. Under a plan's tensor
parallelism (``sharding.rules``; the caller, ``models.model``, hands each
layer its weights with the fsdp dims gathered) linear and softmax mixers
run on the rank's heads and close with one all-reduce after the
row-parallel ``wo`` (``tp.mixer``), dense MLPs on its ff columns
(``tp.mlp``), as each layer's ``sharding.rules.LayerSplit``
(``Ctx.split``) says; mamba2, hymba and cross mixers (and MoE MLPs) get
their weights gathered whole over model and compute every head, their
caches stored per ``sharding.rules.cache_specs`` and gathered over model
at use (``tp.cache.<leaf>``). MoE layers run on one device only (the
reference's manual DP×SP step refuses them too;
``train.step.ShardedStep``). Cross-attention layers (the VLM's image
layers, Whisper's decoder cross) attend a memory (``Ctx.img_emb`` or
``Ctx.enc_out``) with no RoPE and no SP path, as in the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.comm import primitives
from repro_torch.configs.base import LayerSpec, MambaConfig, ModelConfig
from repro_torch.core import linear_attention as la_core
from repro_torch.core.lasp2 import lasp2, lasp2_prefill
from repro_torch.core.lasp2h import (_gather_seq,
                                     allgather_context_attention,
                                     ring_decode_attention,
                                     sharded_decode_attention,
                                     ulysses_context_attention)
from repro_torch.core.tree import leaves_with_paths
from repro_torch.kernels import ops
from repro_torch.models.layers import (dense_init, mlp_apply, mlp_init,
                                       normal, rmsnorm, rmsnorm_init,
                                       rope, row_parallel)
from repro_torch.sharding.rules import LayerSplit, cache_specs, shard_tree


@dataclass
class Ctx:
    cfg: ModelConfig
    positions: Any = None          # (S,) or (B, S) global positions
    causal: bool = True
    decode_pos: Any = None         # (B,) int positions during decode
    resets: Any = None             # (B, S) bool: state resets (doc starts)
    sp: Any = None                 # core.lasp2.SPConfig: S is a chunk
    is_global: Any = None          # hymba: this layer attends unwindowed
    img_emb: Any = None            # (B, n_img, d) stub patch embeddings
    enc_out: Any = None            # (B, n_frames, d) encoder output
    plan: Any = None               # sharding.rules.Parallelism (serving)
    split: Any = None              # sharding.rules.LayerSplit (this layer)


# The decode caches' K/V rings and SSD conv inputs are bf16 whatever
# ``cfg.dtype``, as the reference's; recurrent states stay fp32.
CACHE_DTYPE = torch.bfloat16


def _unported(spec: LayerSpec):
    if spec.mixer not in _MIXERS or spec.mlp not in ("dense", "moe", "none"):
        raise NotImplementedError(
            f"unknown layer mixer={spec.mixer!r} mlp={spec.mlp!r}; the port "
            f"runs mixer in {sorted(_MIXERS)}, mlp='dense', 'moe' or 'none'")


def _heads_split(x, n_heads, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim).transpose(1, 2)


def _heads_merge(x):
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


_NO_SPLIT = LayerSplit()


def _split(ctx: Ctx) -> LayerSplit:
    """The layer's ``LayerSplit`` under a serving plan (``models.model``
    sets it a layer), else one that splits nothing."""
    return ctx.split or _NO_SPLIT


def _qkv(p, x, ctx: Ctx, positions=None):
    """q (B, Hq, S, dh), k, v (B, Hkv, S, dh): the projections plus, with
    ``qkv_bias``, the biases added in the compute dtype, then RoPE. Hq and
    Hkv are this rank's heads (``LayerSplit.heads``): the weights' columns
    are then the rank's, and the biases (whole) are sliced to them."""
    cfg, s = ctx.cfg, _split(ctx)
    dt, dh = x.dtype, cfg.head_dim
    hq, q0 = s.heads(cfg.n_heads, s.q)
    hkv, k0 = s.heads(cfg.n_kv_heads, s.kv)
    q, k, v = (x @ p[w].to(dt) for w in ("wq", "wk", "wv"))
    if "bq" in p:
        q = q + p["bq"][q0 * dh:(q0 + hq) * dh].to(dt)
        k = k + p["bk"][k0 * dh:(k0 + hkv) * dh].to(dt)
        v = v + p["bv"][k0 * dh:(k0 + hkv) * dh].to(dt)
    q = _heads_split(q, hq, dh)
    k = _heads_split(k, hkv, dh)
    v = _heads_split(v, hkv, dh)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(o, w, ctx: Ctx, all_heads=False):
    """``o`` (B, S, n) through the output projection ``w``. Where ``w``
    holds this rank's rows (``LayerSplit.wo``: row-parallel over model),
    the rank multiplies its block of ``o``'s columns (``o`` holds every
    head where ``all_heads`` or the q heads do not split; else only the
    rank's) and one all-reduce over the model group sums the fp32
    partials (``layers.row_parallel``, tag ``tp.mixer``)."""
    s = _split(ctx)
    w = w.to(o.dtype)
    if not s.wo:
        return o @ w
    if all_heads or not s.q:
        n = w.shape[0]
        o = o[..., s.tp.index * n:(s.tp.index + 1) * n]
    return row_parallel(o, w, s.tp, "tp.mixer")


# ===========================================================================
# Softmax (GQA) attention mixer
# ===========================================================================

def softmax_init(generator, cfg: ModelConfig, dtype, device):
    """wq, wk, wv, wo; with ``qkv_bias`` also ``bq``, ``bk``, ``bv``, fp32
    zeros whatever ``dtype`` (1-D leaves, as the norm scales)."""
    d, dh = cfg.d_model, cfg.head_dim
    p = {"wq": dense_init(generator, d, cfg.n_heads * dh, dtype, device),
         "wk": dense_init(generator, d, cfg.n_kv_heads * dh, dtype, device),
         "wv": dense_init(generator, d, cfg.n_kv_heads * dh, dtype, device),
         "wo": dense_init(generator, cfg.n_heads * dh, d, dtype, device)}
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((width * dh,), dtype=torch.float32,
                                  device=device)
    return p


def _softmax_out(params, x, q, k, v, ctx: Ctx, window):
    attend = ulysses_context_attention if ctx.sp is not None and \
        ctx.sp.comm.strategy == "ulysses" else allgather_context_attention
    o = attend(q, k, v, sp=ctx.sp, causal=ctx.causal, sliding_window=window)
    return _out(_heads_merge(o), params["wo"], ctx)


def softmax_apply(params, x, ctx: Ctx, *, window=None):
    """Full-sequence GQA attention through ``ops.flash_attention_op`` (the
    flash kernels on the card); under sequence parallelism the K/V
    all-gather of LASP-2H first, or under the "ulysses" strategy the two
    all-to-alls of ``ulysses_context_attention``. The reference takes its
    banded XLA form when ``S % window == 0`` (never inside its DP×SP
    step); it computes the same function, and the kernels' run-time band
    skips the same blocks. Softmax layers ignore ``ctx.resets``: on
    packed rows they attend across documents, as in the reference."""
    q, k, v = _qkv(params, x, ctx, ctx.positions)
    return _softmax_out(params, x, q, k, v, ctx, window)


def softmax_ring_len(spec: LayerSpec, max_len: int) -> int:
    """Ring-buffer length of a softmax layer's decode KV cache: the window
    for sliding-window layers (constant in context length), else
    ``max_len``."""
    if spec.sliding_window:
        return min(max_len, spec.sliding_window)
    return max_len


def softmax_cache(cfg: ModelConfig, spec: LayerSpec, batch, max_len, device,
                  ring=None):
    """Empty ring cache: K/V (B, Hkv, R, dh) in ``CACHE_DTYPE``,
    and the absolute position of each slot (-1 = never written). ``R`` is
    ``ring``, by default ``softmax_ring_len(spec, max_len)``."""
    r = ring if ring is not None else softmax_ring_len(spec, max_len)
    shape = (batch, cfg.n_kv_heads, r, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
            "kpos": torch.full((batch, r), -1, dtype=torch.int32,
                               device=device)}


def softmax_prefill_cache(k, v, positions, ring: int):
    """Place the prompt's K/V (B, Hkv, S, dh) in a fresh ring of ``ring``
    slots.

    Slot ``i`` receives the prompt token at the highest position ``p <=
    last`` with ``p % ring == i`` (the ``slot = pos % ring`` rule decode
    uses), tagged with its absolute position in ``kpos``; slots no token
    reached hold -1. K/V are stored in ``CACHE_DTYPE``.
    """
    b, hkv, s, dh = k.shape
    pos2d = torch.broadcast_to(torch.atleast_2d(positions),
                               (b, s)).to(torch.int64)
    last = pos2d[:, -1:]                                      # (B, 1)
    i = torch.arange(ring, device=k.device)[None, :]          # (1, R)
    p_i = last - torch.remainder(last - i, ring)              # (B, R)
    col = torch.clamp(p_i - pos2d[:, :1], 0, s - 1)
    idx = col[:, None, :, None].expand(b, hkv, ring, dh)
    return {"k": torch.gather(k, 2, idx).to(CACHE_DTYPE),
            "v": torch.gather(v, 2, idx).to(CACHE_DTYPE),
            "kpos": torch.where(p_i >= 0, p_i,
                                torch.full_like(p_i, -1)).to(torch.int32)}


def _ring_sp(ctx: Ctx):
    """The ``SPConfig`` over the axis the plan places ring slots on, or
    None (no plan, no such axis, or no ranks; or a mixer computing every
    head whose ring slots lie on the model axis: its cache is sliced after
    the step, ``layer_prefill``)."""
    if ctx.plan is None or (_split(ctx).whole and ctx.plan.rules.get(
            "cache_seq") == ctx.plan.tp_axis):
        return None
    return ctx.plan.cache_sp()


def shard_ring(cache, ctx: Ctx):
    """Slice a ring cache's K/V slot dim over the plan's ``cache_seq``
    group: rank ``t`` keeps slots ``t·c … t·c + c − 1`` (``c = R / W``);
    ``kpos`` stays whole on every rank, as the reference places it (batch
    only). A ring whose length ``W`` does not divide stays whole
    (``fit_spec``'s rule)."""
    sp = _ring_sp(ctx)
    r = cache["k"].shape[2]
    if sp is None or r % sp.degree:
        return cache
    c, t = r // sp.degree, sp.chunk_index
    return {"k": cache["k"][:, :, t * c:(t + 1) * c].contiguous(),
            "v": cache["v"][:, :, t * c:(t + 1) * c].contiguous(),
            "kpos": cache["kpos"]}


def softmax_decode(params, x, cache, ctx: Ctx, *, window=None):
    """One token per row at position ``ctx.decode_pos`` (B,): write its K/V
    in place into slot ``pos % R`` of the ring (rounded to the cache's
    dtype), then attend to the ring. A ring sliced over the plan's group
    (K/V hold ``c`` of ``kpos``'s ``R`` slots) is written by the rank that
    owns the slot, its ``kpos`` by every rank, and attended through the
    flash-decoding merge over that group. Where that group is the model
    axis (the decode plan's ``cache_seq`` when the kv heads do not divide
    it) the slots and the heads want the same axis: the rank gathers every
    q head over model (tag ``tp.q``), merges them all, and its ``wo`` rows
    take their block of the merged ``o`` (``_out``)."""
    cfg = ctx.cfg
    posv = ctx.decode_pos.to(device=x.device, dtype=torch.int32)
    q, k, v = _qkv(params, x, ctx, None)
    q = rope(q, posv[:, None], cfg.rope_theta)
    k = rope(k, posv[:, None], cfg.rope_theta)
    rows = torch.arange(x.shape[0], device=x.device)
    r, c = cache["kpos"].shape[1], cache["k"].shape[2]
    slot = torch.remainder(posv, r).long()
    cache["kpos"][rows, slot] = posv.to(cache["kpos"].dtype)
    sp, lo, gathered = None, 0, False
    if c != r:
        sp = _ring_sp(ctx)
        lo = sp.chunk_index * c
        own = (slot >= lo) & (slot < lo + c)
        rows, slot, k, v = rows[own], slot[own] - lo, k[own], v[own]
        s = _split(ctx)
        if s.q and ctx.plan.rules.get("cache_seq") == ctx.plan.tp_axis:
            q = primitives.allgather_states(q.contiguous(), s.tp.group,
                                            gather_axis=1, tiled=True,
                                            tag="tp.q")
            gathered = True
    cache["k"][rows, :, slot] = k[:, :, 0].to(cache["k"].dtype)
    cache["v"][rows, :, slot] = v[:, :, 0].to(cache["v"].dtype)
    o = ring_decode_attention(q, cache["k"], cache["v"],
                              cache["kpos"][:, lo:lo + c], posv,
                              sliding_window=window, sp=sp)
    return _out(_heads_merge(o), params["wo"], ctx, gathered), cache


def _attn_prefill(params, x, ctx: Ctx, window, ring):
    """Prompt attention and its ring cache of ``ring`` slots from one K/V
    projection. Under SP the ring comes from the whole sequence's K/V:
    the K/V all-gather's (or, under "ulysses", a gather of its own, tags
    ``ring.k``, ``ring.v``), at positions ``0 … S − 1``; then it is
    sliced per the plan (``shard_ring``)."""
    q, k, v = _qkv(params, x, ctx, ctx.positions)
    positions = ctx.positions
    if ctx.sp is None or ctx.sp.comm.strategy != "ulysses":
        o, k, v = allgather_context_attention(
            q, k, v, sp=ctx.sp, causal=ctx.causal, sliding_window=window,
            return_kv=True)
    else:
        o = ulysses_context_attention(q, k, v, sp=ctx.sp, causal=ctx.causal,
                                      sliding_window=window)
        k, v = (_gather_seq(t, ctx.sp.group, tag, ctx.sp.comm.dtype)
                for t, tag in ((k, "ring.k"), (v, "ring.v")))
    if ctx.sp is not None:
        positions = torch.arange(k.shape[2], device=x.device)
    y = _out(_heads_merge(o), params["wo"], ctx)
    return y, shard_ring(softmax_prefill_cache(k, v, positions, ring), ctx)


def _softmax_prefill(params, x, ctx: Ctx, spec: LayerSpec, max_len):
    """Prompt attention and its ring cache from one K/V projection."""
    return _attn_prefill(params, x, ctx, spec.sliding_window,
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
    """q, k, v (B, H, S, dh) and log_a (B, H, S) fp32 or None; H this
    rank's q heads (``LayerSplit.heads``), k and v repeated to them."""
    cfg, sp = ctx.cfg, _split(ctx)
    lac = cfg.linear_attn
    q, k, v = _qkv(params, x, ctx,
                   ctx.positions if lac.feature_map != "taylor" else None)
    hq, q0 = sp.heads(cfg.n_heads, sp.q)
    # GQA → full heads for the linear recurrence (state is per q-head);
    # the rank's kv heads cover its q heads' block, or are all of them
    rep = cfg.n_heads // cfg.n_kv_heads
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    if sp.q and not sp.kv:
        k, v = k[:, q0:q0 + hq], v[:, q0:q0 + hq]
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
                                    device=x.device)[q0:q0 + hq][None]\
            .expand(b, hq, s)
    if ctx.resets is not None:
        # Zero the state at document starts and at the first real token of
        # a left-padded prefill row.
        base = log_a if log_a is not None else torch.zeros(
            (b, hq, s), dtype=torch.float32, device=x.device)
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
    return _out(_heads_merge(o.to(x.dtype)), params["wo"], ctx)


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
    return _out(o, params["wo"], ctx), {"m": m, "log_decay": ld}


def _linear_prefill(params, x, ctx: Ctx):
    """The prompt through K1, or under SP through LASP-2's prefill (one
    state all-gather, whose chunk decays also sum to the whole prompt's
    log decay on every rank)."""
    cfg = ctx.cfg
    q, k, v, log_a = _linear_qkv(params, x, ctx)
    b, h = q.shape[0], q.shape[1]
    bs = cfg.linear_attn.block_size
    if ctx.sp is not None:
        o, m, ld = lasp2_prefill(q, k, v, log_a, sp=ctx.sp, block_size=bs)
    else:
        o, m, _ = ops.linear_attention_op(q, k, v, log_a, block_size=bs)
        # The cache's log decay is the sum of every log a, resets included.
        ld = (log_a.float().sum(-1) if log_a is not None
              else torch.zeros((b, h), dtype=torch.float32, device=x.device))
    y = _out(_heads_merge(o.to(x.dtype)), params["wo"], ctx)
    return y, {"m": m, "log_decay": ld}


# ===========================================================================
# Mamba-2 (SSD) mixer: chunked decayed linear attention under the hood
# ===========================================================================

def _mamba_dims(cfg: ModelConfig, spec: LayerSpec):
    """(MambaConfig, inner width, SSD heads): the inner width is
    ``expand·d_model`` for mamba2, ``d_model`` for hymba's SSM heads."""
    mb = cfg.mamba or MambaConfig()
    d_in = mb.expand * cfg.d_model if spec.mixer == "mamba2" \
        else cfg.d_model
    return mb, d_in, d_in // mb.headdim


def mamba2_init(generator, cfg: ModelConfig, spec: LayerSpec, dtype, device):
    """The reference's shapes and scales. ``dt_bias`` is softplus⁻¹ of a
    step drawn log-uniform in [1e-3, 0.1], ``a_log`` = log(1..nh): head h
    decays by −h·dt a token. The 1-D leaves (``dt_bias``, ``a_log``,
    ``d_skip``) and the norm scale are fp32 whatever ``dtype``."""
    mb, d_in, nh = _mamba_dims(cfg, spec)
    d, gd = cfg.d_model, mb.ngroups * mb.d_state
    f32 = torch.float32
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * torch.rand(
        (nh,), generator=generator, dtype=f32, device=device))
    return {
        "wx": dense_init(generator, d, d_in, dtype, device),
        "wz": dense_init(generator, d, d_in, dtype, device),
        "wb": dense_init(generator, d, gd, dtype, device),
        "wc": dense_init(generator, d, gd, dtype, device),
        "wdt": dense_init(generator, d, nh, dtype, device, scale=0.01),
        "dt_bias": torch.log(torch.expm1(dt)),
        "a_log": torch.log(torch.arange(1, nh + 1, dtype=f32,
                                        device=device)),
        "d_skip": torch.ones((nh,), dtype=f32, device=device),
        "conv_x": normal(generator, (mb.d_conv, d_in), 0.2, dtype, device),
        "conv_b": normal(generator, (mb.d_conv, gd), 0.2, dtype, device),
        "conv_c": normal(generator, (mb.d_conv, gd), 0.2, dtype, device),
        "gnorm": rmsnorm_init(d_in, device),
        "wo": dense_init(generator, d_in, d, dtype, device),
    }


def _causal_conv(x, w, cache=None):
    """Depthwise causal conv then silu. x: (B, S, C); w: (K, C); ``cache``
    (B, K−1, C): the K−1 inputs before ``x`` (zeros when None, as at a
    sequence start, and under sequence parallelism at every chunk start,
    as in the reference). Returns (y (B, S, C), the last K−1 inputs)."""
    k, s = w.shape[0], x.shape[1]
    pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                      device=x.device) if cache is None else cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    w = w.to(x.dtype)
    y = sum(xp[:, i:i + s, :] * w[i] for i in range(k))
    return F.silu(y), (xp[:, -(k - 1):, :] if k > 1 else None)


def _conv_halo(pre, k, sp):
    """Under a serving plan's SP: one all-gather (tag ``mamba2.conv``) of
    every rank's last K−1 inputs of the three convs. Returns the conv
    caches this chunk starts from (the previous rank's tails, zeros on
    rank 0) and the whole sequence's last K−1 inputs (the last rank's
    tails), each as ``{"x", "b", "c"}``."""
    widths = [t.shape[-1] for t in pre]
    tails = primitives.allgather_states(
        torch.cat([t[:, -(k - 1):] for t in pre], dim=-1), sp.group,
        tag="mamba2.conv")
    t = sp.chunk_index
    halo = tails[t - 1] if t > 0 else torch.zeros_like(tails[0])
    split = lambda z: dict(zip("xbc", torch.split(z, widths, dim=-1)))
    return split(halo), split(tails[-1])


def _mamba_core(p, x, ctx: Ctx, spec: LayerSpec, conv_caches=None):
    """The SSD projections as linear attention: q = C, k = B (both
    (B, nh, S, d_state), the groups repeated over heads), v = x·dt
    (B, nh, S, headdim), log a = −exp(a_log)·dt (B, nh, S) fp32 with the
    resets; also the skip input xh and the conv caches. dt = softplus(x
    @ wdt + dt_bias) is fp32, as in the reference. Under a serving plan's
    SP the convs start from the previous chunk's inputs and the conv
    caches are the whole sequence's (``_conv_halo``); under the train
    step's SP (no plan) each chunk starts from zeros, as the reference's
    manual step does."""
    mb, _, nh = _mamba_dims(ctx.cfg, spec)
    dt_ = x.dtype
    pre = [x @ p[w].to(dt_) for w in ("wx", "wb", "wc")]
    last = None
    if conv_caches is None and ctx.sp is not None and \
            ctx.plan is not None and not ctx.plan.sp_manual:
        conv_caches, last = _conv_halo(pre, p["conv_x"].shape[0], ctx.sp)
    cc = conv_caches or {"x": None, "b": None, "c": None}
    xs, ccx = _causal_conv(pre[0], p["conv_x"], cc["x"])
    bs, ccb = _causal_conv(pre[1], p["conv_b"], cc["b"])
    cs, ccc = _causal_conv(pre[2], p["conv_c"], cc["c"])
    if last is not None:
        ccx, ccb, ccc = last["x"], last["b"], last["c"]
    dt = F.softplus((x @ p["wdt"].to(dt_)).float() + p["dt_bias"])
    log_a = (-torch.exp(p["a_log"]) * dt).transpose(1, 2)      # (B, nh, S)
    if ctx.resets is not None:
        log_a = torch.where(ctx.resets[:, None, :],
                            torch.full((), la_core.RESET_LOG_A,
                                       device=x.device), log_a)
    xh = _heads_split(xs, nh, mb.headdim)                      # (B,nh,S,hd)
    v = xh * dt.transpose(1, 2)[..., None].to(dt_)
    rep = nh // mb.ngroups
    k = torch.repeat_interleave(_heads_split(bs, mb.ngroups, mb.d_state),
                                rep, dim=1)
    q = torch.repeat_interleave(_heads_split(cs, mb.ngroups, mb.d_state),
                                rep, dim=1)
    return q, k, v, log_a, xh, {"x": ccx, "b": ccb, "c": ccc}


def _mamba_out(params, x, y, xh, cfg: ModelConfig):
    """y + D·x, gated by silu(x @ wz), group-normed, projected out."""
    y = y + params["d_skip"][None, :, None, None].to(y.dtype) * xh
    y = _heads_merge(y.to(x.dtype))
    y = y * F.silu(x @ params["wz"].to(x.dtype))
    y = rmsnorm(params["gnorm"], y, cfg.norm_eps)
    return y @ params["wo"].to(x.dtype)


def mamba2_apply(params, x, ctx: Ctx, spec: LayerSpec):
    """SSD through the chunk kernels (``ops.linear_attention_op``), or
    under sequence parallelism LASP-2 with the autodiff backward, as the
    reference: SSD is decayed linear attention, so LASP-2 applies as it
    is. The causal conv runs on this rank's chunk alone."""
    q, k, v, log_a, xh, _ = _mamba_core(params, x, ctx, spec)
    bs = ctx.cfg.linear_attn.block_size
    if ctx.sp is None:
        y, _, _ = ops.linear_attention_op(q, k, v, log_a, block_size=bs)
    else:
        y = lasp2(q, k, v, log_a, sp=ctx.sp, block_size=bs,
                  backward="autodiff")
    return _mamba_out(params, x, y, xh, ctx.cfg)


def mamba2_cache(cfg: ModelConfig, spec: LayerSpec, batch, device):
    """The SSD state (B, nh, d_state, headdim) and its cumulative log decay
    in fp32, and the last d_conv − 1 conv inputs of x, B and C in
    ``CACHE_DTYPE``: constant in context length."""
    mb, d_in, nh = _mamba_dims(cfg, spec)
    gd = mb.ngroups * mb.d_state
    conv = lambda c: torch.zeros((batch, mb.d_conv - 1, c),
                                 dtype=CACHE_DTYPE, device=device)
    return {"m": torch.zeros((batch, nh, mb.d_state, mb.headdim),
                             dtype=torch.float32, device=device),
            "log_decay": torch.zeros((batch, nh), dtype=torch.float32,
                                     device=device),
            "conv_x": conv(d_in), "conv_b": conv(gd), "conv_c": conv(gd)}


def _conv_cache(cc):
    return {f"conv_{n}": t.to(CACHE_DTYPE) for n, t in cc.items()}


def mamba2_decode(params, x, cache, ctx: Ctx, spec: LayerSpec):
    """One token: the conv continues from the cached inputs, the state
    takes one recurrent step (K3 on the card, in place)."""
    conv = {n: cache[f"conv_{n}"] for n in "xbc"}
    q, k, v, log_a, xh, cc = _mamba_core(params, x, ctx, spec, conv)
    y, m, ld = ops.linear_decode_op(
        q[..., 0, :], k[..., 0, :], v[..., 0, :], log_a[..., 0],
        cache["m"], cache["log_decay"])
    # the reference rounds o to the activations' dtype before the skip
    y = y[:, :, None, :].to(x.dtype)
    return _mamba_out(params, x, y, xh, ctx.cfg), \
        {"m": m, "log_decay": ld, **_conv_cache(cc)}


def _mamba2_prefill(params, x, ctx: Ctx, spec: LayerSpec):
    """The prompt through K1 (under SP LASP-2's prefill); the cache is its
    end state, the sum of every log a (resets included) and the last
    d_conv − 1 conv inputs (the real ones: left-padding sits before
    them)."""
    q, k, v, log_a, xh, cc = _mamba_core(params, x, ctx, spec)
    y, m, ld = lasp2_prefill(q, k, v, log_a, sp=ctx.sp,
                             block_size=ctx.cfg.linear_attn.block_size)
    return _mamba_out(params, x, y, xh, ctx.cfg), \
        {"m": m, "log_decay": ld, **_conv_cache(cc)}


# ===========================================================================
# Hymba: parallel softmax-attention + SSM heads in one mixer
# ===========================================================================

def hymba_init(generator, cfg: ModelConfig, spec: LayerSpec, dtype, device):
    return {"attn": softmax_init(generator, cfg, dtype, device),
            "ssm": mamba2_init(generator, cfg, spec, dtype, device)}


def hymba_window(spec: LayerSpec, ctx: Ctx):
    """The attention window of a hymba layer: none on global layers
    (``ctx.is_global``, from ``model.hymba_global_flags``; the reference's
    traced ``1 << 30`` means the same), else ``spec.sliding_window`` or
    2048."""
    return None if ctx.is_global else (spec.sliding_window or 2048)


def hymba_apply(params, x, ctx: Ctx, spec: LayerSpec):
    a = softmax_apply(params["attn"], x, ctx, window=hymba_window(spec, ctx))
    s = mamba2_apply(params["ssm"], x, ctx, spec)
    return 0.5 * (a + s)


def hymba_cache(cfg: ModelConfig, spec: LayerSpec, batch, max_len, device):
    """The attention ring is ``max_len`` long on every layer, windowed ones
    included, as in the reference (its global flag may be traced); the
    window is applied by the mask."""
    return {"attn": softmax_cache(cfg, spec, batch, max_len, device,
                                  ring=max_len),
            "ssm": mamba2_cache(cfg, spec, batch, device)}


def _hymba_prefill(params, x, ctx: Ctx, spec: LayerSpec, max_len):
    a, ca = _attn_prefill(params["attn"], x, ctx, hymba_window(spec, ctx),
                          max_len)
    s, cs = _mamba2_prefill(params["ssm"], x, ctx, spec)
    return 0.5 * (a + s), {"attn": ca, "ssm": cs}


def hymba_decode(params, x, cache, ctx: Ctx, spec: LayerSpec):
    a, ca = softmax_decode(params["attn"], x, cache["attn"], ctx,
                           window=hymba_window(spec, ctx))
    s, cs = mamba2_decode(params["ssm"], x, cache["ssm"], ctx, spec)
    return 0.5 * (a + s), {"attn": ca, "ssm": cs}


# ===========================================================================
# Cross-attention mixer (VLM image layers, Whisper decoder cross)
# ===========================================================================

def cross_init(generator, cfg: ModelConfig, dtype, device):
    """Softmax's projections plus ``gate``, a 0-d fp32 zero: at init every
    cross layer outputs tanh(0)·y = 0, as in the reference."""
    p = softmax_init(generator, cfg, dtype, device)
    p["gate"] = torch.zeros((), dtype=torch.float32, device=device)
    return p


def _cross_kv(params, memory, cfg: ModelConfig):
    """k, v (B, Hkv, n_mem, dh) of the memory, in its dtype."""
    dt = memory.dtype
    k = _heads_split(memory @ params["wk"].to(dt), cfg.n_kv_heads,
                     cfg.head_dim)
    v = _heads_split(memory @ params["wv"].to(dt), cfg.n_kv_heads,
                     cfg.head_dim)
    return k, v


def _cross_q(params, x, cfg: ModelConfig):
    return _heads_split(x @ params["wq"].to(x.dtype), cfg.n_heads,
                        cfg.head_dim)


def _cross_y(params, o, dt):
    """tanh(gate) · the attention output projected out, in ``dt``."""
    y = _heads_merge(o.to(dt)) @ params["wo"].to(dt)
    return torch.tanh(params["gate"]).to(dt) * y


def _cross_attend(params, x, ctx: Ctx):
    """``(y, k, v)``: x's queries over the memory (``ctx.img_emb``, else
    ``ctx.enc_out``) cast to the compute dtype, through
    ``ops.flash_attention_op(causal=False)`` (K4/K5 on the card) with
    Sq ≠ Sk; the default query offset Sk − Sq may be negative, which the
    unmasked form never reads. Each rank of a sequence split would attend
    its own query chunk to the whole memory, with no exchange."""
    memory = ctx.img_emb if ctx.img_emb is not None else ctx.enc_out
    k, v = _cross_kv(params, memory.to(x.dtype), ctx.cfg)
    o = ops.flash_attention_op(_cross_q(params, x, ctx.cfg), k, v,
                               causal=False)
    return _cross_y(params, o, x.dtype), k, v


def cross_apply(params, x, ctx: Ctx):
    return _cross_attend(params, x, ctx)[0]


def cross_cache(cfg: ModelConfig, batch, device):
    """The memory's K/V (B, Hkv, max(n_mem, 1), dh) in ``CACHE_DTYPE``;
    n_mem is ``n_image_tokens`` or the encoder's ``n_frames``."""
    n_mem = cfg.n_image_tokens or (cfg.encoder.n_frames if cfg.encoder
                                   else 0)
    shape = (batch, cfg.n_kv_heads, max(n_mem, 1), cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=CACHE_DTYPE, device=device)}


def _cross_prefill(params, x, ctx: Ctx):
    """The prompt's cross attention and the memory's K/V cache, from one
    projection of the memory."""
    y, k, v = _cross_attend(params, x, ctx)
    return y, {"k": k.to(CACHE_DTYPE), "v": v.to(CACHE_DTYPE)}


def cross_decode(params, x, cache, ctx: Ctx):
    """One token's query against the whole memory cache (plain fp32
    scores, ``sharded_decode_attention``); the cache does not change."""
    q = _cross_q(params, x, ctx.cfg)
    o = sharded_decode_attention(q, cache["k"], cache["v"],
                                 cache["k"].shape[2])
    return _cross_y(params, o, x.dtype), cache


# ===========================================================================
# MoE MLP: token-choice top-k routing with capacity (drop on overflow)
# ===========================================================================

def moe_init(generator, cfg: ModelConfig, dtype, device):
    """The router (d, E), the experts' SwiGLU weights ``w1``, ``w3`` (E, d,
    d_ff) and ``w2`` (E, d_ff, d), and with ``n_shared_experts`` a dense
    SwiGLU ``shared`` MLP of width ``d_ff · n_shared_experts`` (SwiGLU
    whatever ``cfg.mlp_act``, as the reference's)."""
    moe = cfg.moe
    d, ff, e = cfg.d_model, cfg.d_ff, moe.num_experts
    p = {"router": dense_init(generator, d, e, dtype, device, scale=0.02),
         "experts": {
             "w1": normal(generator, (e, d, ff), d ** -0.5, dtype, device),
             "w3": normal(generator, (e, d, ff), d ** -0.5, dtype, device),
             "w2": normal(generator, (e, ff, d), ff ** -0.5, dtype, device)}}
    if moe.n_shared_experts:
        p["shared"] = mlp_init(generator, d, ff * moe.n_shared_experts,
                               dtype, device)
    return p


def moe_capacity(moe, tokens: int) -> int:
    """Slots per expert for a call of ``tokens`` tokens (the whole batch):
    ``max(int(capacity_factor · tokens · top_k / E), top_k)``."""
    return max(int(moe.capacity_factor * tokens * moe.top_k
                   / moe.num_experts), moe.top_k)


def moe_route(probs, k: int):
    """The top ``k`` experts of each token, (gates, indices), highest
    first; among equal probabilities the lower expert index first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` does not promise it)."""
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return gate[:, :k], idx[:, :k]


def moe_apply(params, x, cfg: ModelConfig):
    """``(y, aux)`` of the reference's one-device dispatch
    (``_moe_dispatch``). Items (token, choice) run token-major; each takes
    the next free slot of its expert and items past the capacity
    (``moe_capacity`` of the whole call's tokens) go to a sink row and
    contribute nothing. The experts run as batched products over (E, cap,
    d); each kept item's output is scaled by its renormalised gate and the
    ``k`` contributions summed in the compute dtype. ``aux`` (fp32) is the
    load-balance term E·Σ me·ce (``me`` counts every top-k pick, dropped
    ones too) plus ``router_z_coef`` times the mean squared logsumexp of
    the router logits."""
    moe = cfg.moe
    b, s, d = x.shape
    t, e, k = b * s, moe.num_experts, moe.top_k
    cap = moe_capacity(moe, t)
    dt = x.dtype
    xf = x.reshape(t, d)
    logits = (xf @ params["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = moe_route(probs, k)                        # (t, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = idx.reshape(-1)                               # (t·k,)
    onehot = F.one_hot(flat_e, e)                          # (t·k, e)
    slot = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)
    keep = slot < cap
    dest = torch.where(keep, flat_e * cap + slot,
                       torch.full_like(slot, e * cap))
    items = torch.repeat_interleave(xf, k, dim=0)          # (t·k, d)
    buf = torch.zeros((e * cap + 1, d), dtype=dt, device=x.device)
    buf = buf.index_add(0, dest, items)[:e * cap].reshape(e, cap, d)
    ex = params["experts"]
    h = F.silu(torch.bmm(buf, ex["w1"].to(dt))) * torch.bmm(buf,
                                                            ex["w3"].to(dt))
    out = torch.bmm(h, ex["w2"].to(dt)).reshape(e * cap, d)
    out = torch.cat([out, torch.zeros((1, d), dtype=dt, device=x.device)])
    y = out[dest] * (gate.reshape(-1, 1).to(dt) * keep[:, None].to(dt))
    y = y.reshape(t, k, d).sum(dim=1).reshape(b, s, d)
    me = F.one_hot(idx, e).float().mean(dim=(0, 1))
    ce = probs.mean(dim=0)
    aux = e * torch.sum(me * ce) + moe.router_z_coef * torch.mean(
        torch.logsumexp(logits, dim=-1) ** 2)
    if "shared" in params:
        y = y + mlp_apply(params["shared"], x)
    return y, aux


# ===========================================================================
# Layer glue
# ===========================================================================

class _Mixer(NamedTuple):
    """One mixer's entry points, each under one signature for all mixers."""
    init: Callable      # (generator, cfg, spec, dtype, device) -> params
    apply: Callable     # (params, h, ctx, spec) -> y
    prefill: Callable   # (params, h, ctx, spec, max_len) -> (y, cache)
    decode: Callable    # (params, h, cache, ctx, spec) -> (y, cache)
    cache: Callable     # (cfg, spec, batch, max_len, device) -> cache


_MIXERS = {
    "softmax": _Mixer(
        lambda g, cfg, spec, dt, dev: softmax_init(g, cfg, dt, dev),
        lambda p, h, ctx, spec: softmax_apply(p, h, ctx,
                                              window=spec.sliding_window),
        _softmax_prefill,
        lambda p, h, c, ctx, spec: softmax_decode(
            p, h, c, ctx, window=spec.sliding_window),
        softmax_cache),
    "linear": _Mixer(
        lambda g, cfg, spec, dt, dev: linear_init(g, cfg, dt, dev),
        lambda p, h, ctx, spec: linear_apply(p, h, ctx),
        lambda p, h, ctx, spec, max_len: _linear_prefill(p, h, ctx),
        lambda p, h, c, ctx, spec: linear_decode(p, h, c, ctx),
        lambda cfg, spec, b, max_len, dev: linear_cache(cfg, b, dev)),
    "mamba2": _Mixer(
        mamba2_init, mamba2_apply,
        lambda p, h, ctx, spec, max_len: _mamba2_prefill(p, h, ctx, spec),
        mamba2_decode,
        lambda cfg, spec, b, max_len, dev: mamba2_cache(cfg, spec, b, dev)),
    "hymba": _Mixer(hymba_init, hymba_apply, _hymba_prefill, hymba_decode,
                    hymba_cache),
    "cross": _Mixer(
        lambda g, cfg, spec, dt, dev: cross_init(g, cfg, dt, dev),
        lambda p, h, ctx, spec: cross_apply(p, h, ctx),
        lambda p, h, ctx, spec, max_len: _cross_prefill(p, h, ctx),
        lambda p, h, c, ctx, spec: cross_decode(p, h, c, ctx),
        lambda cfg, spec, b, max_len, dev: cross_cache(cfg, b, dev)),
}


def layer_init(generator, cfg: ModelConfig, spec: LayerSpec, dtype, device):
    """``ln1`` and the mixer; ``ln2`` and the dense or MoE MLP unless
    ``mlp="none"`` (mamba2)."""
    _unported(spec)
    p = {"ln1": rmsnorm_init(cfg.d_model, device),
         "mixer": _MIXERS[spec.mixer].init(generator, cfg, spec, dtype,
                                           device)}
    if spec.mlp == "dense":
        p["ln2"] = rmsnorm_init(cfg.d_model, device)
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, device,
                            act=cfg.mlp_act)
    elif spec.mlp == "moe":
        p["ln2"] = rmsnorm_init(cfg.d_model, device)
        p["mlp"] = moe_init(generator, cfg, dtype, device)
    return p


def _mlp_residual(params, x, ctx: Ctx, spec: LayerSpec):
    """``(x + MLP(norm(x)), aux)``: aux is the MoE layer's router loss, 0.0
    for a dense MLP or none. A dense MLP whose ``w1`` holds the rank's ff
    columns (``LayerSplit.mlp``) runs column- then row-parallel
    (``layers.mlp_apply(tp=)``)."""
    cfg = ctx.cfg
    if "mlp" not in params:                  # mlp="none"
        return x, 0.0
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    if spec.mlp == "moe":
        y, aux = moe_apply(params["mlp"], h, cfg)
        return x + y, aux
    s = _split(ctx)
    return x + mlp_apply(params["mlp"], h, act=cfg.mlp_act,
                         tp=s.tp if s.mlp else None), 0.0


def _cache_axes(ctx: Ctx, spec: LayerSpec) -> tuple:
    """The axes a gather-at-use mixer's cache is gathered over and sliced
    back on: the model axis, and for a cross layer also its memory slots'
    (``cache_seq``) axis."""
    plan = ctx.plan
    axes = [plan.tp_axis]
    if spec.mixer == "cross":
        axes.append(plan.rules.get("cache_seq"))
    return tuple(a for a in axes if plan.place(a) is not None)


def _whole_specs(cache, ctx: Ctx, spec: LayerSpec):
    """``cache_specs`` of a mixer cache at its whole shapes (its rows and
    ring length as ``cache`` holds them)."""
    leaves = leaves_with_paths(cache)
    ring = next((t.shape[1] for path, t in leaves if path[-1] == "kpos"), 1)
    whole = _MIXERS[spec.mixer].cache(ctx.cfg, spec, leaves[0][1].shape[0],
                                      ring, torch.device("meta"))
    return cache_specs(whole, ctx.plan)


def _gather_cache(cache, specs, ctx: Ctx, axes):
    """A cache gathered whole over ``axes`` (tags ``tp.cache.<leaf>`` over
    model, ``cache_seq.<leaf>`` over the slots' axis)."""
    if isinstance(cache, dict):
        return {k: _gather_cache(v, specs[k], ctx, axes) if isinstance(
            v, dict) else _gather_leaf(k, v, specs[k], ctx, axes)
                for k, v in cache.items()}
    return cache


def _gather_leaf(name, t, spec, ctx: Ctx, axes):
    for dim, entry in enumerate(spec):
        if entry in axes:
            tag = ("tp.cache." if entry == ctx.plan.tp_axis
                   else "cache_seq.") + name
            t = primitives.allgather_states(
                t.contiguous(), ctx.plan.place(entry).group,
                gather_axis=dim, tiled=True, tag=tag)
    return t


def _own_cache(cache, ctx: Ctx, spec: LayerSpec, axes):
    """This rank's slices, over ``axes``, of a cache computed whole."""
    return shard_tree(cache, _whole_specs(cache, ctx, spec),
                      ctx.plan.layout, axes=axes)


def layer_apply(params, x, ctx: Ctx, spec: LayerSpec):
    """One layer over the full sequence: ``(x, aux)``."""
    _unported(spec)
    h = rmsnorm(params["ln1"], x, ctx.cfg.norm_eps)
    y = _MIXERS[spec.mixer].apply(params["mixer"], h, ctx, spec)
    return _mlp_residual(params, x + y, ctx, spec)


def layer_cache(cfg: ModelConfig, spec: LayerSpec, batch, max_len, device):
    _unported(spec)
    return {"mixer": _MIXERS[spec.mixer].cache(cfg, spec, batch, max_len,
                                               device)}


def layer_prefill(params, x, ctx: Ctx, spec: LayerSpec, max_len):
    """One layer over the prompt: ``(x, its cache)``; a gather-at-use
    mixer's cache, computed whole over model, keeps this rank's slices."""
    _unported(spec)
    h = rmsnorm(params["ln1"], x, ctx.cfg.norm_eps)
    y, mc = _MIXERS[spec.mixer].prefill(params["mixer"], h, ctx, spec,
                                        max_len)
    if _split(ctx).whole:
        axes = _cache_axes(ctx, spec)
        if axes:
            mc = _own_cache(mc, ctx, spec, axes)
    return _mlp_residual(params, x + y, ctx, spec)[0], {"mixer": mc}


def layer_decode(params, x, cache, ctx: Ctx, spec: LayerSpec):
    """One token through one layer: ``(x, its cache)``; a gather-at-use
    mixer's cache is gathered whole over model for the step and sliced
    back after it."""
    _unported(spec)
    h = rmsnorm(params["ln1"], x, ctx.cfg.norm_eps)
    mc, axes = cache["mixer"], ()
    if _split(ctx).whole:
        axes = _cache_axes(ctx, spec)
        if axes:
            mc = _gather_cache(mc, _whole_specs(mc, ctx, spec), ctx, axes)
    y, mc = _MIXERS[spec.mixer].decode(params["mixer"], h, mc, ctx, spec)
    if axes:
        mc = _own_cache(mc, ctx, spec, axes)
    return _mlp_residual(params, x + y, ctx, spec)[0], {"mixer": mc}
