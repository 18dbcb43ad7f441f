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
layer its weights with the fsdp dims gathered) each layer computes on
the rank's shard as its ``sharding.rules.LayerSplit`` (``Ctx.split``)
says: linear, softmax and cross mixers on the rank's heads, closed by one
all-reduce after the row-parallel ``wo`` (``tp.mixer``); SSD mixers
(mamba2, hymba's SSM half) on its SSD heads, the group norm's statistic
summed over model (``tp.gnorm``); hymba's two halves summed before one
all-reduce; dense MLPs on its ff columns (``tp.mlp``); MoE MLPs on its
experts, the experts' and shared experts' partials in one all-reduce
(``tp.experts``). What does not divide is gathered whole over model at
use (``tp.cols.<leaf>``; an SSD cache ``tp.cache.<leaf>``). MoE layers
take the reference's global capacity under a plan that sets
``fsdp_axis`` (``moe_apply``); the train step's DP×SP runs them on one
device only (the reference's manual step refuses them too;
``train.step.ShardedStep``). Cross-attention layers (the VLM's image
layers, Whisper's decoder cross) attend a memory (``Ctx.img_emb`` or
``Ctx.enc_out``) with no RoPE and no SP path, as in the reference.
"""

from __future__ import annotations

import dataclasses
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
from repro_torch.kernels import ops
from repro_torch.models.layers import (dense_init, mlp_apply, mlp_init,
                                       mlp_partial, normal, rmsnorm,
                                       rmsnorm_init, rope, row_parallel,
                                       row_partial)
from repro_torch.sharding.rules import (LayerSplit, Place, cache_specs,
                                        shard_leaf)


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
    rows: Any = None               # sharding.rules.Place: the call's rows
    #                                split over an axis, this rank's block
    defer: bool = False            # hymba's halves: leave row-parallel
    #                                outputs unsummed (``Partial``)


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


class Partial(NamedTuple):
    """A row-parallel output not yet summed over the model group: this
    rank's fp32 ``part``, to be all-reduced over ``tp``'s group and
    rounded to ``dtype`` (:func:`_finish`)."""
    part: torch.Tensor
    tp: Any
    dtype: torch.dtype


def _finish(y):
    """``y`` itself, or a :class:`Partial` summed (tag ``tp.mixer``)."""
    if not isinstance(y, Partial):
        return y
    return primitives.allreduce_sum(y.part, y.tp.group,
                                    tag="tp.mixer").to(y.dtype)


def _row_out(o, w, tp, ctx: Ctx):
    """``o @ w``, ``w`` this rank's rows and ``o`` its columns: summed over
    the model group in one all-reduce of the fp32 partials
    (``layers.row_parallel``, tag ``tp.mixer``), or under ``ctx.defer``
    left as a :class:`Partial`."""
    if ctx.defer:
        return Partial(row_partial(o, w), tp, o.dtype)
    return row_parallel(o, w, tp, "tp.mixer")


def _rows_block(o, n, tp):
    """The rank's block of ``n`` of ``o``'s last-dim columns."""
    return o[..., tp.index * n:(tp.index + 1) * n]


def _out(o, w, ctx: Ctx, all_heads=False):
    """``o`` (B, S, n) through the output projection ``w``. Where ``w``
    holds this rank's rows (``LayerSplit.wo``: row-parallel over model),
    the rank multiplies its block of ``o``'s columns (``o`` holds every
    head where ``all_heads`` or the q heads do not split; else only the
    rank's), closed by one all-reduce (:func:`_row_out`)."""
    s = _split(ctx)
    w = w.to(o.dtype)
    if not s.wo:
        return o @ w
    if all_heads or not s.q:
        o = _rows_block(o, w.shape[0], s.tp)
    return _row_out(o, w, s.tp, ctx)


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
    """The ``SPConfig`` over the axis the plan places ring (and cross
    memory) slots on, or None (no plan, no such axis, or no ranks)."""
    if ctx.plan is None:
        return None
    return ctx.plan.cache_sp()


def _q_for_slots_on_model(q, ctx: Ctx):
    """``(q, gathered)``: where the slots a decode step merges lie on the
    model axis (the decode plan's ``cache_seq`` when the kv heads do not
    divide it) and the rank holds only its q heads, every q head gathered
    over model (tag ``tp.q``): the slots and the heads want the same
    axis, so the rank merges them all and its ``wo`` rows take their
    block of the merged ``o`` (``_out``)."""
    s = _split(ctx)
    if s.q and ctx.plan.rules.get("cache_seq") == ctx.plan.tp_axis:
        return primitives.allgather_states(q.contiguous(), s.tp.group,
                                           gather_axis=1, tiled=True,
                                           tag="tp.q"), True
    return q, False


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
    flash-decoding merge over that group; where that group is the model
    axis every q head is gathered first (``_q_for_slots_on_model``)."""
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
        q, gathered = _q_for_slots_on_model(q, ctx)
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
    manual step does. Where the SSD heads split over model
    (``LayerSplit.ssd``) nh is this rank's block of heads: ``wx``,
    ``wdt``, ``conv_x``, ``a_log``, ``dt_bias`` hold its columns and
    heads, while B and C (``wb``, ``wc``, ``conv_b``, ``conv_c``: whole on
    every rank) are computed whole and their group repeat taken at the
    rank's heads."""
    mb, _, nh = _mamba_dims(ctx.cfg, spec)
    s = _split(ctx)
    nh_l, h0 = s.heads(nh, s.ssd)
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
    xh = _heads_split(xs, nh_l, mb.headdim)                    # (B,nh,S,hd)
    v = xh * dt.transpose(1, 2)[..., None].to(dt_)
    rep = nh // mb.ngroups
    k, q = (torch.repeat_interleave(_heads_split(t, mb.ngroups, mb.d_state),
                                    rep, dim=1) for t in (bs, cs))
    if nh_l != nh:
        k, q = k[:, h0:h0 + nh_l], q[:, h0:h0 + nh_l]
    return q, k, v, log_a, xh, {"x": ccx, "b": ccb, "c": ccc}


def _group_norm(params, y, ctx: Ctx, width: int):
    """The gated output's RMS norm over the whole inner width ``width``.
    ``y`` holds this rank's columns where the SSD heads split: the sum of
    squares (B, S, 1) in fp32 is summed over the model group in one
    all-reduce (tag ``tp.gnorm``) and the rank scales its columns."""
    s = _split(ctx)
    if not s.ssd or s.tp is None:
        return rmsnorm(params, y, ctx.cfg.norm_eps)
    yf = y.float()
    ss = primitives.allreduce_sum((yf * yf).sum(-1, keepdim=True),
                                  s.tp.group, tag="tp.gnorm")
    scale = _rows_block(params["scale"], y.shape[-1], s.tp)
    return (yf * torch.rsqrt(ss / width + ctx.cfg.norm_eps)
            * scale).to(y.dtype)


def _mamba_out(params, x, y, xh, ctx: Ctx, spec: LayerSpec):
    """y + D·x, gated by silu(x @ wz), group-normed, projected out; on the
    rank's SSD heads (``LayerSplit.ssd``) the norm's statistic is summed
    over model and ``wo`` is row-parallel (``_row_out``; every head's ``y``
    takes its block where only ``wo`` splits)."""
    s = _split(ctx)
    y = y + params["d_skip"][None, :, None, None].to(y.dtype) * xh
    y = _heads_merge(y.to(x.dtype))
    y = y * F.silu(x @ params["wz"].to(x.dtype))
    y = _group_norm(params["gnorm"], y, ctx, _mamba_dims(ctx.cfg, spec)[1])
    w = params["wo"].to(x.dtype)
    if not s.ssd_wo:
        return y @ w
    if not s.ssd:
        y = _rows_block(y, w.shape[0], s.tp)
    return _row_out(y, w, s.tp, ctx)


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
    return _mamba_out(params, x, y, xh, ctx, spec)


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


def _ssd_cache_specs(cache, ctx: Ctx, spec: LayerSpec):
    """``(cache_specs, shapes)`` of an SSD cache at its whole shapes (its
    rows as ``cache`` holds them)."""
    whole = mamba2_cache(ctx.cfg, spec, cache["m"].shape[0],
                         torch.device("meta"))
    return cache_specs(whole, ctx.plan), whole


def _tp_dim(spec, axis):
    return next((d for d, e in enumerate(spec) if e == axis), None)


def _ssd_cache_in(cache, ctx: Ctx, spec: LayerSpec):
    """The SSD cache as this rank's decode step reads it. Under tensor
    parallelism the conv inputs of B and C (whole on every rank, their
    cache split over model on its channels by ``cache_specs``) are
    gathered in one all-gather (tag ``tp.conv``: d_conv − 1 rows a step);
    where the rank computes every SSD head, every leaf the specs split
    over model is gathered whole (``tp.cache.<leaf>``)."""
    s = _split(ctx)
    if s.tp is None:
        return cache
    specs, _ = _ssd_cache_specs(cache, ctx, spec)
    axis = ctx.plan.tp_axis
    split = [n for n in cache if _tp_dim(specs[n], axis) is not None]
    out = dict(cache)
    if not s.ssd:
        for n in split:
            out[n] = primitives.allgather_states(
                cache[n].contiguous(), s.tp.group,
                gather_axis=_tp_dim(specs[n], axis), tiled=True,
                tag="tp.cache." + n)
        return out
    bc = [n for n in ("conv_b", "conv_c") if n in split]
    if bc:
        both = primitives.allgather_states(
            torch.stack([cache[n] for n in bc]), s.tp.group,
            gather_axis=1 + _tp_dim(specs[bc[0]], axis), tiled=True,
            tag="tp.conv")
        out.update(zip(bc, both.unbind(0)))
    return out


def _ssd_cache_out(cache, ctx: Ctx, spec: LayerSpec):
    """This rank's slices over model, per ``cache_specs``, of the SSD cache
    leaves its step or prefill computed whole (the conv inputs of B and
    C; every split leaf where the rank computes every SSD head)."""
    s = _split(ctx)
    if s.tp is None:
        return cache
    specs, whole = _ssd_cache_specs(cache, ctx, spec)
    axis, layout = ctx.plan.tp_axis, ctx.plan.layout
    out = {}
    for n, t in cache.items():
        d = _tp_dim(specs[n], axis)
        if d is not None and t.shape[d] == whole[n].shape[d]:
            t = shard_leaf(t, specs[n], layout, axes=(axis,)).contiguous()
        out[n] = t
    return out


def mamba2_decode(params, x, cache, ctx: Ctx, spec: LayerSpec):
    """One token: the conv continues from the cached inputs, the state
    takes one recurrent step (K3 on the card, in place) on the rank's SSD
    heads."""
    c = _ssd_cache_in(cache, ctx, spec)
    conv = {n: c[f"conv_{n}"] for n in "xbc"}
    q, k, v, log_a, xh, cc = _mamba_core(params, x, ctx, spec, conv)
    y, m, ld = ops.linear_decode_op(
        q[..., 0, :], k[..., 0, :], v[..., 0, :], log_a[..., 0],
        c["m"], c["log_decay"])
    # the reference rounds o to the activations' dtype before the skip
    y = y[:, :, None, :].to(x.dtype)
    return _mamba_out(params, x, y, xh, ctx, spec), _ssd_cache_out(
        {"m": m, "log_decay": ld, **_conv_cache(cc)}, ctx, spec)


def _mamba2_prefill(params, x, ctx: Ctx, spec: LayerSpec):
    """The prompt through K1 (under SP LASP-2's prefill); the cache is its
    end state, the sum of every log a (resets included) and the last
    d_conv − 1 conv inputs (the real ones: left-padding sits before
    them), each the rank's slice over model."""
    q, k, v, log_a, xh, cc = _mamba_core(params, x, ctx, spec)
    y, m, ld = lasp2_prefill(q, k, v, log_a, sp=ctx.sp,
                             block_size=ctx.cfg.linear_attn.block_size)
    return _mamba_out(params, x, y, xh, ctx, spec), _ssd_cache_out(
        {"m": m, "log_decay": ld, **_conv_cache(cc)}, ctx, spec)


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


def _halves(ctx: Ctx, attn, ssm):
    """``(0.5·(a + s), caches)`` of hymba's halves, each ``half(hctx)``
    run with ``ctx.defer`` so that a row-parallel ``wo`` returns its
    :class:`Partial`: two partials are summed first and closed by one
    all-reduce (tag ``tp.mixer``); a half computed whole adds its output
    to the other's sum."""
    hctx = dataclasses.replace(ctx, defer=True)
    a, ca = attn(hctx)
    s, cs = ssm(hctx)
    if isinstance(a, Partial) and isinstance(s, Partial):
        y = primitives.allreduce_sum(0.5 * (a.part + s.part), a.tp.group,
                                     tag="tp.mixer").to(a.dtype)
    else:
        y = 0.5 * (_finish(a) + _finish(s))
    return y, ca, cs


def hymba_apply(params, x, ctx: Ctx, spec: LayerSpec):
    w = hymba_window(spec, ctx)
    return _halves(
        ctx, lambda c: (softmax_apply(params["attn"], x, c, window=w), None),
        lambda c: (mamba2_apply(params["ssm"], x, c, spec), None))[0]


def hymba_cache(cfg: ModelConfig, spec: LayerSpec, batch, max_len, device):
    """The attention ring is ``max_len`` long on every layer, windowed ones
    included, as in the reference (its global flag may be traced); the
    window is applied by the mask."""
    return {"attn": softmax_cache(cfg, spec, batch, max_len, device,
                                  ring=max_len),
            "ssm": mamba2_cache(cfg, spec, batch, device)}


def _hymba_prefill(params, x, ctx: Ctx, spec: LayerSpec, max_len):
    w = hymba_window(spec, ctx)
    y, ca, cs = _halves(
        ctx, lambda c: _attn_prefill(params["attn"], x, c, w, max_len),
        lambda c: _mamba2_prefill(params["ssm"], x, c, spec))
    return y, {"attn": ca, "ssm": cs}


def hymba_decode(params, x, cache, ctx: Ctx, spec: LayerSpec):
    w = hymba_window(spec, ctx)
    y, ca, cs = _halves(
        ctx, lambda c: softmax_decode(params["attn"], x, cache["attn"], c,
                                      window=w),
        lambda c: mamba2_decode(params["ssm"], x, cache["ssm"], c, spec))
    return y, {"attn": ca, "ssm": cs}


# ===========================================================================
# Cross-attention mixer (VLM image layers, Whisper decoder cross)
# ===========================================================================

def cross_init(generator, cfg: ModelConfig, dtype, device):
    """Softmax's projections plus ``gate``, a 0-d fp32 zero: at init every
    cross layer outputs tanh(0)·y = 0, as in the reference."""
    p = softmax_init(generator, cfg, dtype, device)
    p["gate"] = torch.zeros((), dtype=torch.float32, device=device)
    return p


def _cross_kv(params, memory, ctx: Ctx):
    """k, v (B, Hkv, n_mem, dh) of the memory, in its dtype; Hkv the
    rank's kv heads (``LayerSplit.heads``)."""
    cfg, s = ctx.cfg, _split(ctx)
    hkv, _ = s.heads(cfg.n_kv_heads, s.kv)
    dt = memory.dtype
    return tuple(_heads_split(memory @ params[w].to(dt), hkv, cfg.head_dim)
                 for w in ("wk", "wv"))


def _cross_q(params, x, ctx: Ctx):
    cfg, s = ctx.cfg, _split(ctx)
    hq, _ = s.heads(cfg.n_heads, s.q)
    return _heads_split(x @ params["wq"].to(x.dtype), hq, cfg.head_dim)


def _cross_y(params, o, dt, ctx: Ctx, all_heads=False):
    """tanh(gate) · the attention output projected out (``_out``: the
    rank's ``wo`` rows where they split), in ``dt``."""
    y = _out(_heads_merge(o.to(dt)), params["wo"], ctx, all_heads)
    return torch.tanh(params["gate"]).to(dt) * y


def _cross_attend(params, x, ctx: Ctx):
    """``(y, k, v)``: x's queries over the memory (``ctx.img_emb``, else
    ``ctx.enc_out``) cast to the compute dtype, through
    ``ops.flash_attention_op(causal=False)`` (K4/K5 on the card) with
    Sq ≠ Sk, on the rank's heads; the default query offset Sk − Sq may be
    negative, which the unmasked form never reads. Each rank of a
    sequence split would attend its own query chunk to the whole memory,
    with no exchange."""
    memory = ctx.img_emb if ctx.img_emb is not None else ctx.enc_out
    k, v = _cross_kv(params, memory.to(x.dtype), ctx)
    o = ops.flash_attention_op(_cross_q(params, x, ctx), k, v, causal=False)
    return _cross_y(params, o, x.dtype, ctx), k, v


def cross_apply(params, x, ctx: Ctx):
    return _cross_attend(params, x, ctx)[0]


def cross_len(cfg: ModelConfig) -> int:
    """The memory length a cross layer serves: ``n_image_tokens`` or the
    encoder's ``n_frames`` (at least 1)."""
    return max(cfg.n_image_tokens or (cfg.encoder.n_frames if cfg.encoder
                                      else 0), 1)


def cross_cache(cfg: ModelConfig, batch, device):
    """The memory's K/V (B, Hkv, ``cross_len``, dh) in ``CACHE_DTYPE``."""
    shape = (batch, cfg.n_kv_heads, cross_len(cfg), cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=CACHE_DTYPE, device=device)}


def _memory_sp(ctx: Ctx, n: int):
    """The ``SPConfig`` of the axis the plan places ``n`` memory slots on
    (the ``cache_seq`` rule, where its size divides ``n``), or None."""
    sp = _ring_sp(ctx)
    return sp if sp is not None and n % sp.degree == 0 else None


def _cross_prefill(params, x, ctx: Ctx):
    """The prompt's cross attention and the memory's K/V cache, from one
    projection of the memory: the rank's kv heads, its block of the
    memory slots where the plan places them over an axis."""
    y, k, v = _cross_attend(params, x, ctx)
    sp = _memory_sp(ctx, k.shape[2])
    if sp is not None:
        c, t = k.shape[2] // sp.degree, sp.chunk_index
        k, v = (z[:, :, t * c:(t + 1) * c] for z in (k, v))
    return y, {"k": k.to(CACHE_DTYPE).contiguous(),
               "v": v.to(CACHE_DTYPE).contiguous()}


def cross_decode(params, x, cache, ctx: Ctx):
    """One token's query against the whole memory cache (plain fp32
    scores, ``sharded_decode_attention``); the cache does not change.
    Memory slots sliced over the plan's ``cache_seq`` group are read
    through its flash-decoding merge (``decode.o``, ``.m``, ``.l``),
    every q head gathered first where that group is the model axis."""
    q = _cross_q(params, x, ctx)
    sp, n, gathered = _memory_sp(ctx, cross_len(ctx.cfg)), \
        cache["k"].shape[2], False
    if sp is not None:
        n *= sp.degree
        q, gathered = _q_for_slots_on_model(q, ctx)
    o = sharded_decode_attention(q, cache["k"], cache["v"], n, sp=sp)
    return _cross_y(params, o, x.dtype, ctx, gathered), cache


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


def _moe_places(ctx: Ctx):
    """``(rows, seq)``: the ``Place`` of each axis that splits the call's
    tokens where the dispatch is the reference's global one
    (``Parallelism.moe_global``), else None each: the rows' (``ctx.rows``)
    and the sequence's (a serving plan's ``ctx.sp``)."""
    plan = ctx.plan
    if plan is None or not plan.moe_global:
        return None, None
    seq = None
    if ctx.sp is not None and ctx.sp.degree > 1 and not plan.sp_manual:
        seq = Place(ctx.sp.degree, ctx.sp.chunk_index, ctx.sp.group)
    return ctx.rows, seq


def _moe_offsets(onehot, b: int, rows, seq):
    """Each local item's count of the call's earlier items for its expert
    that other ranks hold (or that lie in this rank's earlier rows), in
    the reference's token-major (row, position) order: the rows ahead of
    this rank's block (``rows``: lower indices hold earlier rows, as
    ``shard_leaf`` slices them) and, in each row, the chunks ahead of this
    rank's (``seq``). Each rank counts its items per (row, expert); one
    int32 all-gather over each splitting axis (tag ``moe.counts``) gives
    every rank the whole table. Returns ``(t·k,)`` int64 offsets to add
    to the local slots, less each item's earlier local rows (those the
    local slot counts already)."""
    e = onehot.shape[-1]
    counts = onehot.reshape(b, -1, e).sum(1).to(torch.int32)   # (b, E)
    table = counts[None]                                        # (Ws, b, E)
    if seq is not None:
        table = primitives.allgather_states(counts, seq.group,
                                            tag="moe.counts")
    table = table[None]                                     # (Wr, Ws, b, E)
    if rows is not None:
        table = primitives.allgather_states(table[0].contiguous(),
                                            rows.group, tag="moe.counts")
    table = table.long()
    r = rows.index if rows is not None else 0
    t = seq.index if seq is not None else 0
    per_row = table.sum(1).reshape(-1, e)                   # (Wr·b, E)
    ahead = (torch.cumsum(per_row, 0) - per_row)[r * b:(r + 1) * b]
    ahead = ahead + table[r, :t].sum(0)
    local = torch.cumsum(counts.long(), 0) - counts.long()  # local rows
    per_item = (ahead - local).repeat_interleave(onehot.shape[0] // b, 0)
    return (per_item * onehot).sum(-1)


def moe_apply(params, x, ctx):
    """``(y, aux)`` of the reference's dispatch (``_moe_dispatch``);
    ``ctx`` a ``Ctx`` (a ``ModelConfig`` alone is the one-device call).
    Items (token, choice) run token-major; each takes the next free slot
    of its expert and items past the capacity (``moe_capacity`` of the
    call's tokens) go to a sink row and contribute nothing. The experts
    run as batched products over (E, cap, d); each kept item's output is
    scaled by its renormalised gate and the ``k`` contributions summed in
    the compute dtype. ``aux`` (fp32) is the load-balance term E·Σ me·ce
    (``me`` counts every top-k pick, dropped ones too) plus
    ``router_z_coef`` times the mean squared logsumexp of the router
    logits, over this rank's tokens.

    Under a serving plan whose ``fsdp_axis`` is set the dispatch is the
    reference's global one over the whole call: the capacity counts every
    rank's tokens and each item's slot its rank among all the call's
    earlier items for its expert (``_moe_offsets``); without it, each
    token shard's own (the reference's ``shard_map`` branch). Where the
    experts split over model (``LayerSplit.experts``) each rank routes
    every token of its model group, which holds the same tokens: the
    router reads ``x``, bitwise equal on every rank of the group (it
    follows the mixer's all-reduce, or a mixer each rank computes whole
    from the same bits), so every rank picks the same experts and slots.
    The rank fills and runs only its experts' slots; its gate-scaled
    items, summed over ``k`` in fp32, and the shared experts' partial on
    their ff columns (``LayerSplit.shared``) are summed over the model
    group in one fp32 all-reduce (tag ``tp.experts``), rounded once."""
    if not isinstance(ctx, Ctx):
        ctx = Ctx(cfg=ctx)
    cfg, sp = ctx.cfg, _split(ctx)
    moe = cfg.moe
    b, s, d = x.shape
    t, e, k = b * s, moe.num_experts, moe.top_k
    rows, seq = _moe_places(ctx)
    cap = moe_capacity(moe, t * (rows.size if rows else 1)
                       * (seq.size if seq else 1))
    dt = x.dtype
    xf = x.reshape(t, d)
    logits = (xf @ params["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = moe_route(probs, k)                        # (t, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = idx.reshape(-1)                               # (t·k,)
    onehot = F.one_hot(flat_e, e)                          # (t·k, e)
    slot = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)
    if rows is not None or seq is not None:
        slot = slot + _moe_offsets(onehot, b, rows, seq)
    keep = slot < cap
    e_l, e0 = sp.heads(e, sp.experts)
    if e_l != e:
        keep = keep & (flat_e >= e0) & (flat_e < e0 + e_l)
    dest = torch.where(keep, (flat_e - e0) * cap + slot,
                       torch.full_like(slot, e_l * cap))
    items = torch.repeat_interleave(xf, k, dim=0)          # (t·k, d)
    buf = torch.zeros((e_l * cap + 1, d), dtype=dt, device=x.device)
    buf = buf.index_add(0, dest, items)[:e_l * cap].reshape(e_l, cap, d)
    ex = params["experts"]
    h = F.silu(torch.bmm(buf, ex["w1"].to(dt))) * torch.bmm(buf,
                                                            ex["w3"].to(dt))
    out = torch.bmm(h, ex["w2"].to(dt)).reshape(e_l * cap, d)
    out = torch.cat([out, torch.zeros((1, d), dtype=dt, device=x.device)])
    y = out[dest] * (gate.reshape(-1, 1).to(dt) * keep[:, None].to(dt))
    shared = "shared" in params
    if sp.experts:
        part = y.float().reshape(t, k, d).sum(dim=1)
        if shared and sp.shared:
            part = part + mlp_partial(params["shared"], xf)
            shared = False
        y = primitives.allreduce_sum(part, sp.tp.group,
                                     tag="tp.experts").to(dt)
    else:
        y = y.reshape(t, k, d).sum(dim=1)
    y = y.reshape(b, s, d)
    me = F.one_hot(idx, e).float().mean(dim=(0, 1))
    ce = probs.mean(dim=0)
    aux = e * torch.sum(me * ce) + moe.router_z_coef * torch.mean(
        torch.logsumexp(logits, dim=-1) ** 2)
    if shared:
        y = y + mlp_apply(params["shared"], x,
                          tp=sp.tp if sp.shared else None)
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
        y, aux = moe_apply(params["mlp"], h, ctx)
        return x + y, aux
    s = _split(ctx)
    return x + mlp_apply(params["mlp"], h, act=cfg.mlp_act,
                         tp=s.tp if s.mlp else None), 0.0


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
    """One layer over the prompt: ``(x, its cache)``, the cache this
    rank's slice per ``sharding.rules.cache_specs``."""
    _unported(spec)
    h = rmsnorm(params["ln1"], x, ctx.cfg.norm_eps)
    y, mc = _MIXERS[spec.mixer].prefill(params["mixer"], h, ctx, spec,
                                        max_len)
    return _mlp_residual(params, x + y, ctx, spec)[0], {"mixer": mc}


def layer_decode(params, x, cache, ctx: Ctx, spec: LayerSpec):
    """One token through one layer: ``(x, its cache)``."""
    _unported(spec)
    h = rmsnorm(params["ln1"], x, ctx.cfg.norm_eps)
    y, mc = _MIXERS[spec.mixer].decode(params["mixer"], h, cache["mixer"],
                                       ctx, spec)
    return _mlp_residual(params, x + y, ctx, spec)[0], {"mixer": mc}
