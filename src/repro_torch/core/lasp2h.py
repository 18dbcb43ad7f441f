"""LASP-2H: the standard-attention half of the hybrid models.

Twin of ``repro/core/lasp2h.py``: the plain softmax attention with its
mask, the decode-time attention of one token against a ring-buffer KV
cache (both plain tensor code, as the reference computes them in XLA),
the AllGather context attention of paper Alg. 7, the softmax layers'
sequence parallelism, and its DeepSpeed-Ulysses alternative (two
all-to-alls around full-sequence attention on a subset of the heads),
in its 2D form and in the 3D (USP) form of a DP×SP×TP layout; the
sliding-window attention whose sequence is split over ranks by a halo
exchange (``windowed_context_attention``); and the decode attention of
one token against a cache whose slots are sharded over ranks, merged as
flash decoding merges (``sharded_decode_attention``,
``ring_decode_attention``; serving under a plan, ``sharding.rules``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.comm import primitives
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import mask_value

# Masked-logit fill for fp32 score tensors (the kernels' fill).
NEG_INF = mask_value(torch.float32)


def _softmax_attend(q, k, v, *, scale, mask=None):
    """Plain fp32-softmax attention on local tensors.

    q: (B, Hq, Sq, dh); k, v: (B, Hkv, Sk, dh). GQA via head repeat.
    mask: broadcastable to (B, 1|Hq, Sq, Sk), True = attend.
    """
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, v.float()).to(q.dtype)


def causal_mask(sq, sk, q_offset, *, sliding_window: Optional[int] = None,
                device=None):
    """(sq, sk) boolean mask. Query global position = q_offset + row index."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = qpos >= kpos
    if sliding_window is not None:
        m = m & ((qpos - kpos) < sliding_window)
    return m


def _narrow(x, comm_dtype):
    """``comm_dtype`` only narrows the wire payload: bf16 activations under
    the default "fp32" keep their own dtype on the wire."""
    wire = primitives.wire_dtype(comm_dtype)
    return x.to(wire) if wire.itemsize < x.element_size() else x


def _gather_seq(x, group, tag, comm_dtype):
    """All-gather ``x`` (B, H, C, dh) along the sequence over ``group``
    (tag ``tag``), narrowed to ``comm_dtype`` on the wire and upcast back
    on arrival; the backward is the mirrored reduce-scatter."""
    return primitives.upcast_gathered(primitives.allgather_states(
        _narrow(x, comm_dtype), group, gather_axis=2, tiled=True, tag=tag),
        x.dtype)


def allgather_context_attention(q, k, v, *, sp=None, causal: bool = True,
                                sliding_window: Optional[int] = None,
                                scale: Optional[float] = None,
                                return_kv: bool = False):
    """Paper Algorithm 7: AllGather-based context parallelism.

    q: (B, Hq, C, dh), k, v: (B, Hkv, C, dh): this rank's chunk of the
    sequence (``sp``: a ``core.lasp2.SPConfig``; None or degree 1 → local
    attention over the whole sequence). One all-gather each of K and V
    along the sequence (``lasp2h.k``, ``lasp2h.v``; in ``sp.comm.dtype``,
    upcast back on arrival), whose backward is the mirrored reduce-scatter
    of dK and dV; then the flash op for this rank's queries at global
    positions ``t·C + i`` over the ``W·C`` gathered keys. ``return_kv``:
    return ``(o, K, V)`` with the whole sequence's K and V (what a prefill
    builds its ring cache from).
    """
    if sp is None or sp.degree == 1:
        o = ops.flash_attention_op(q, k, v, causal=causal,
                                   sliding_window=sliding_window, scale=scale)
        return (o, k, v) if return_kv else o
    c = q.shape[-2]
    kg, vg = (_gather_seq(x, sp.group, tag, sp.comm.dtype)
              for x, tag in ((k, "lasp2h.k"), (v, "lasp2h.v")))
    o = ops.flash_attention_op(q, kg, vg, causal=causal,
                               sliding_window=sliding_window, scale=scale,
                               q_offset=sp.chunk_index * c)
    return (o, kg, vg) if return_kv else o


# ---------------------------------------------------------------------------
# Ulysses head-parallel context attention (DeepSpeed-Ulysses).
# ---------------------------------------------------------------------------

def check_ulysses_heads(hq: int, hkv: int, degree: int,
                        group: str = "?") -> None:
    """Raise unless both head counts split over the ``degree`` ranks of
    the head-parallel group (``group``: "sp", the SP group of a 2D
    layout, or "tp", the tp group of a 3D one; the port's twin of the
    reference's mesh axis; under GQA the kv heads are the binding
    constraint)."""
    if hq % degree or hkv % degree:
        raise ValueError(
            f"ulysses head-parallelism needs n_heads and n_kv_heads "
            f"divisible by the head-parallel group size: n_heads={hq}, "
            f"n_kv_heads={hkv}, {group} group size {degree}. Pick a "
            f"degree dividing both (GQA: kv heads are the binding "
            f"constraint) or use comm_strategy='allgather'.")


def pack_ulysses(q, k, v, degree: int):
    """q (B, Hq, C, dh), k, v (B, Hkv, C, dh) → one (B, Hq + 2·Hkv, C, dh)
    tensor whose head axis splits into ``degree`` equal blocks, block i
    being ``q_i ‖ k_i ‖ v_i``: the heads destination rank i attends with.
    A plain q ‖ k ‖ v concat would send rank 0 query heads only."""
    b, hq, c, dh = q.shape
    hkv = k.shape[1]
    check_ulysses_heads(hq, hkv, degree)
    blocks = [x.to(q.dtype).reshape(b, degree, x.shape[1] // degree, c, dh)
              for x in (q, k, v)]
    return torch.cat(blocks, dim=2).reshape(b, hq + 2 * hkv, c, dh)


def unpack_ulysses(block, hq: int, hkv: int, degree: int):
    """One received head block (B, (Hq + 2·Hkv)/g, S, dh) → its (q, k, v)
    heads: the inverse of one block of :func:`pack_ulysses`."""
    nq, nkv = hq // degree, hkv // degree
    return (block[:, :nq], block[:, nq:nq + nkv],
            block[:, nq + nkv:nq + 2 * nkv])


def ulysses_context_attention(q, k, v, *, sp=None, causal: bool = True,
                              sliding_window: Optional[int] = None,
                              scale: Optional[float] = None):
    """DeepSpeed-Ulysses context attention for LASP-2H softmax layers
    (comm strategy "ulysses").

    q: (B, Hq, C, dh), k, v: (B, Hkv, C, dh): this rank's chunk (``sp``
    None or degree 1 → local attention). One all-to-all of the packed
    q‖k‖v over the head-parallel group takes the sequence-sharded layout
    to a head-sharded one (``ulysses.in``, narrowed to ``sp.comm.dtype``);
    the flash op attends this rank's heads; a second all-to-all takes the
    output back (``ulysses.out``). Backward: the mirrored pair.

    2D (``sp.tp_group`` None): the head-parallel group is the SP group
    itself, and each head subset sees the whole sequence (``q_offset``
    0). 3D (the USP form): the all-to-alls run over ``sp.tp_group``; the
    received chunks ``s·tp … s·tp + tp − 1`` are contiguous, this
    sequence index's S/sp tokens; K and V then all-gather over the
    residual ``sp.seq_group`` when sp > 1 (``ulysses.k``, ``ulysses.v``:
    heads ÷ tp cancels tokens × tp, the bytes of a width-sp 2D gather),
    and the flash op runs at ``q_offset = s · C · tp``.
    """
    if sp is None or sp.degree == 1:
        return ops.flash_attention_op(q, k, v, causal=causal,
                                      sliding_window=sliding_window,
                                      scale=scale)
    group = sp.group if sp.tp_group is None else sp.tp_group
    g = dist.get_world_size(group)
    hq, hkv = q.shape[1], k.shape[1]
    check_ulysses_heads(hq, hkv, g, "sp" if sp.tp_group is None else "tp")
    blk = primitives.alltoall(
        _narrow(pack_ulysses(q, k, v, g), sp.comm.dtype), group,
        split_axis=1, concat_axis=2, tag="ulysses.in")
    ql, kl, vl = unpack_ulysses(primitives.upcast_gathered(blk, q.dtype),
                                hq, hkv, g)
    q_offset = 0            # 2D: every head subset sees the whole sequence
    if sp.seq_group is not None and dist.get_world_size(sp.seq_group) > 1:
        kl, vl = (_gather_seq(x, sp.seq_group, tag, sp.comm.dtype)
                  for x, tag in ((kl, "ulysses.k"), (vl, "ulysses.v")))
        q_offset = primitives.group_index(sp.seq_group) * q.shape[-2] * g
    o = ops.flash_attention_op(ql, kl, vl, causal=causal,
                               sliding_window=sliding_window, scale=scale,
                               q_offset=q_offset)
    return primitives.alltoall(o, group, split_axis=2, concat_axis=1,
                               tag="ulysses.out")


# ---------------------------------------------------------------------------
# Sliding-window attention under SP: the halo exchange.
# ---------------------------------------------------------------------------

HALO_MODES = ("ppermute", "gather")


def windowed_context_attention(q, k, v, window: int, *, sp=None,
                               scale: Optional[float] = None,
                               halo_mode: Optional[str] = None):
    """Causal sliding-window attention whose sequence is split over the
    ranks of ``sp.group``: each rank receives the previous rank's last
    ``window`` K/V tokens (the halo) instead of gathering the whole K/V,
    so the traffic is O(window · dh) a rank, not O(S · dh).

    q: (B, Hq, C, dh), k, v: (B, Hkv, C, dh): this rank's chunk (``sp``
    None or degree 1 → local windowed attention). Needs ``window <= C``:
    the halo comes from one neighbour. ``halo_mode``:

    * "ppermute" (the default): one ring hop each of K's and V's last
      ``window`` tokens to the next rank (``halo.k``, ``halo.v``); the
      backward is the hop back;
    * "gather": an all-gather of every rank's halo (``halo.k``,
      ``halo.v``), of which rank t keeps rank t − 1's: W× the halo
      traffic; the backward is the reduce-scatter.

    The local step is one flash call over ``halo ‖ k`` at ``q_offset =
    window``, the kernels' band mask doing the windowing (the reference
    computes it with its XLA banded attention, which needs ``C % window
    == 0``; this needs only ``window <= C``). Rank 0 has no halo: it
    drops what it received (the ring's wrap-around from the last rank)
    from the keys and attends at ``q_offset`` 0. Its received halo stays
    in the autograd graph, so every rank runs every collective's backward
    in the same order.
    """
    if halo_mode is None:
        halo_mode = "ppermute"
    if halo_mode not in HALO_MODES:
        raise ValueError(f"halo_mode must be one of {HALO_MODES}, got "
                         f"{halo_mode!r}")
    if sp is None or sp.degree == 1:
        return ops.flash_attention_op(q, k, v, causal=True,
                                      sliding_window=window, scale=scale)
    c = q.shape[-2]
    if not 0 < window <= c:
        raise ValueError(f"window {window} must be in (0, C = {c}]: the "
                         f"halo comes from the previous rank alone")
    t = sp.chunk_index

    def halo(x, tag):
        edge = x[:, :, -window:]
        if halo_mode == "ppermute":
            return primitives.ring_sendrecv(edge, sp.group, tag=tag)
        return primitives.allgather_states(edge, sp.group,
                                           tag=tag)[max(t - 1, 0)]

    kx = torch.cat([halo(k, "halo.k"), k], dim=2)
    vx = torch.cat([halo(v, "halo.v"), v], dim=2)
    lo = window if t == 0 else 0
    return ops.flash_attention_op(q, kx[:, :, lo:], vx[:, :, lo:],
                                  causal=True, sliding_window=window,
                                  scale=scale, q_offset=window - lo)


def _partial_attend(q, k, v, valid, scale):
    """One shard's online-softmax partials of a one-token query: ``(o
    (B, Hq, dh), m (B, Hq), l (B, Hq))`` in fp32, o unnormalised. A fully
    masked shard has zero weight: m is the mask fill, l and o are 0."""
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    s = torch.einsum("bhd,bhtd->bht", q[:, :, 0].float(), k.float()) * scale
    s = torch.where(valid[:, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1)
    p = torch.where(valid[:, None, :], torch.exp(s - m[..., None]),
                    torch.zeros((), device=q.device))
    return torch.einsum("bht,bhtd->bhd", p, v.float()), m, p.sum(dim=-1)


def _merged(q, o, m, l, sp, tag):
    """Normalise one shard's partials, or with ``sp`` of degree > 1 merge
    every shard's: three all-gathers (``<tag>.o``, ``.m``, ``.l``) of
    O(B·Hq·dh) bytes whatever the cache length, then the max-corrected
    combine. Returns (B, Hq, 1, dh) in q's dtype."""
    if sp is not None and sp.degree > 1:
        og, mg, lg = (primitives.allgather_states(x, sp.group,
                                                  tag=f"{tag}.{name}")
                      for x, name in ((o, "o"), (m, "m"), (l, "l")))
        m = mg.amax(dim=0)
        corr = torch.exp(mg - m[None])
        l = (lg * corr).sum(dim=0)
        o = (og * corr[..., None]).sum(dim=0)
    o = o / l.clamp(min=1e-30)[..., None]
    return o[:, :, None, :].to(q.dtype)


def ring_decode_attention(q, k_cache, v_cache, key_pos, q_pos, *,
                          sliding_window=None, scale: Optional[float] = None,
                          sp=None):
    """One-token attention against a ring-buffer KV cache.

    Slot ``i`` of the ring holds the key/value written at absolute position
    ``key_pos[b, i]`` (``-1`` = never written). Softmax attention is
    permutation invariant given the mask, so slots are attended in storage
    order with validity from the stored positions:

        valid = key_pos >= 0  &  key_pos <= q_pos
                [&  q_pos - key_pos < sliding_window]

    q: (B, Hq, 1, dh); k_cache, v_cache: (B, Hkv, R, dh); key_pos: (B, R)
    int; q_pos: (B,) int per-row query positions (continuous batching).
    With ``sp`` (a ``core.lasp2.SPConfig``) of degree > 1 the ring's slots
    are sharded over ``sp.group``: ``k_cache``, ``v_cache`` and
    ``key_pos`` are this rank's slots, q and q_pos every rank's, and the
    shards' partials merge as flash decoding does (tags
    ``ring_decode.o``, ``.m``, ``.l``). Returns (B, Hq, 1, dh) in q's
    dtype, the same on every rank.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    valid = (key_pos >= 0) & (key_pos <= q_pos[:, None])
    if sliding_window is not None:
        valid = valid & ((q_pos[:, None] - key_pos) < sliding_window)
    return _merged(q, *_partial_attend(q, k_cache, v_cache, valid, scale),
                   sp, "ring_decode")


def sharded_decode_attention(q, k_cache, v_cache, cache_len, *, sp=None,
                             scale: Optional[float] = None,
                             sliding_window=None):
    """One-token attention against a KV cache of ``cache_len`` valid
    positions (the first ones), the query at ``cache_len - 1``.

    q: (B, Hq, 1, dh); k_cache, v_cache: (B, Hkv, S, dh); ``cache_len``
    an int or 0-d tensor. With ``sp`` of degree > 1 the cache's sequence
    is sharded over ``sp.group``: this rank holds positions ``t·c + i``
    (``t = sp.chunk_index``, ``c`` its slots), each shard computes its
    online-softmax partials and the shards merge (tags ``decode.o``,
    ``.m``, ``.l``: O(B·Hq·dh)·W bytes, independent of S). Returns (B,
    Hq, 1, dh) in q's dtype, the same on every rank.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, c = q.shape[0], k_cache.shape[2]
    t = sp.chunk_index if sp is not None and sp.degree > 1 else 0
    pos = t * c + torch.arange(c, device=q.device)
    cache_len = torch.as_tensor(cache_len, device=q.device)
    valid = pos < cache_len
    if sliding_window is not None:
        valid = valid & ((cache_len - 1 - pos) < sliding_window)
    valid = valid[None].expand(b, c)
    return _merged(q, *_partial_attend(q, k_cache, v_cache, valid, scale),
                   sp, "decode")
