"""AdamW and the cosine schedule (twin of ``repro/optim/adamw.py``).

Paper hyperparameters (§4.1): Adam β1 = 0.9, β2 = 0.95, weight decay 0.1,
grad clip 1.0, cosine schedule with linear warmup down to min_lr = 1e-6.

Same elementwise math as the reference, in the same order (bias
correction of both moments, then eps, then decoupled weight decay), with
the scalar factors formed in fp32 as the reference forms them. Unlike the
reference, which returns new arrays, :func:`update` and
:func:`clip_by_global_norm` work **in place** under ``torch.no_grad()``:
at full width the params, moments and gradients are 21 GB, and a second
copy of each would not fit beside the activations.

ZeRO-1 (the DP×SP step): the params raveled in tree order into one flat
fp32 vector, padded to a multiple of the data degree, each data rank
holding the moments of one contiguous slice. The reference keeps the
full-length moments under a jit-level sharding; here each rank holds only
its slice, and never materialises the full flat params or decay mask.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.tree import leaves_with_paths, tree_map

_NO_DECAY = ("scale", "bias", "bq", "bk", "bv", "gate", "dt_bias", "a_log",
             "d_skip")


class AdamState(NamedTuple):
    m: object        # fp32 first moments, the params' tree
    v: object        # fp32 second moments, the params' tree
    count: int       # updates applied


def init(params) -> AdamState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                     count=0)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, fp32 (a 0-d tensor)."""
    leaves = [leaf for _, leaf in leaves_with_paths(tree)]
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in leaves))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm):
    """Scale ``grads`` in place by min(1, max_norm / norm); returns
    ``(grads, norm)`` with the norm before clipping."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for _, g in leaves_with_paths(grads):
        g.mul_(scale)
    return grads, norm


def _decayable(path) -> bool:
    """Weight decay applies to matrices, not norms, biases or scalars."""
    return path[-1] not in _NO_DECAY


def _f32(x) -> np.float32:
    return np.float32(x)


# Elements per piece of a leaf in ``update``: its temporaries are a few
# pieces, not a few leaves (a 152064 x 8192 embedding is 5 GB in fp32).
UPDATE_PIECE = 1 << 26


@torch.no_grad()
def update(grads, state: AdamState, params, *, lr, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.1) -> AdamState:
    """One AdamW step, in place on ``params`` and on the moments of
    ``state``, each leaf in pieces of ``UPDATE_PIECE`` elements (the same
    elementwise math, so the same bits). Returns the new state (the same
    moment tensors, ``count`` advanced by one)."""
    count = state.count + 1
    bc1 = float(_f32(1.0) - _f32(b1) ** _f32(count))
    bc2 = float(_f32(1.0) - _f32(b2) ** _f32(count))
    lr = float(_f32(lr))
    flat = zip(leaves_with_paths(params), leaves_with_paths(grads),
               leaves_with_paths(state.m), leaves_with_paths(state.v))
    for (path, p_leaf), (_, g_leaf), (_, m_leaf), (_, v_leaf) in flat:
        decay = weight_decay and _decayable(path)
        # params and moments in place (views); the gradient is only read
        pieces = zip(*(t.view(-1).split(UPDATE_PIECE)
                       for t in (p_leaf, m_leaf, v_leaf)),
                     g_leaf.reshape(-1).split(UPDATE_PIECE))
        for p, m, v, g in pieces:
            gf = g.float()
            m.mul_(b1).add_((1 - b1) * gf)
            v.mul_(b2).add_((1 - b2) * gf * gf)
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if decay:
                step = step + weight_decay * p.float()
            p.copy_(p.float() - lr * step)
    return AdamState(state.m, state.v, count)


# ---------------------------------------------------------------------------
# ZeRO-1: flat, data-rank-sharded optimizer state.
# ---------------------------------------------------------------------------

class Zero1AdamState(NamedTuple):
    """Flat fp32 Adam moments of this rank's slice of the raveled params
    (``zero1_padded_size / n_shards`` long)."""

    m: torch.Tensor
    v: torch.Tensor
    count: int


def zero1_padded_size(params, n_shards: int) -> int:
    """Total parameter count rounded up to a multiple of ``n_shards``."""
    n = sum(p.numel() for _, p in leaves_with_paths(params))
    return ((n + n_shards - 1) // n_shards) * n_shards


def zero1_init(params, n_shards: int) -> Zero1AdamState:
    """Zero moments for one rank's slice."""
    size = zero1_padded_size(params, n_shards) // n_shards
    device = leaves_with_paths(params)[0][1].device
    zeros = lambda: torch.zeros((size,), dtype=torch.float32, device=device)
    return Zero1AdamState(m=zeros(), v=zeros(), count=0)


def _raveled(params, lo, hi, piece):
    """Elements ``[lo, hi)`` of the params raveled in tree order, as a new
    fp32 vector (zero past the end, the padding): for each leaf whose
    raveled elements ``[a, b)`` fall in the range, ``piece(path, leaf, a,
    b)`` gives their values."""
    leaves = leaves_with_paths(params)
    out = torch.zeros((hi - lo,), dtype=torch.float32,
                      device=leaves[0][1].device)
    off = 0
    with torch.no_grad():
        for path, p in leaves:
            a, b = max(lo - off, 0), min(hi - off, p.numel())
            if a < b:
                out[off + a - lo:off + b - lo] = piece(path, p, a, b)
            off += p.numel()
    return out


def flat_slice(params, lo: int, hi: int) -> torch.Tensor:
    """Elements ``[lo, hi)`` of the raveled params, fp32."""
    return _raveled(params, lo, hi,
                    lambda path, p, a, b: p.reshape(-1)[a:b])


def decay_mask(params, lo: int = 0, hi=None) -> torch.Tensor:
    """Flat fp32 mask over elements ``[lo, hi)`` of the raveled params
    (default all, unpadded), 1.0 where weight decay applies
    (:func:`_decayable` by leaf path, the rule of :func:`update`)."""
    if hi is None:
        hi = sum(p.numel() for _, p in leaves_with_paths(params))
    return _raveled(params, lo, hi,
                    lambda path, p, a, b: float(_decayable(path)))


@torch.no_grad()
def zero1_update_shard(grad_shard, m_shard, v_shard, param_shard,
                       decay_shard, count, *, lr, b1=0.9, b2=0.95,
                       eps=1e-8, weight_decay=0.1):
    """One AdamW step on one rank's flat fp32 slice, the moments in place.

    ``count`` is the post-increment step count. Returns the new param
    slice: the same elementwise math as :func:`update`, so the gathered
    result is the replicated optimizer's."""
    bc1 = float(_f32(1.0) - _f32(b1) ** _f32(count))
    bc2 = float(_f32(1.0) - _f32(b2) ** _f32(count))
    lr = float(_f32(lr))
    gf = grad_shard.float()
    m_shard.mul_(b1).add_((1 - b1) * gf)
    v_shard.mul_(b2).add_((1 - b2) * gf * gf)
    step = (m_shard / bc1) / (torch.sqrt(v_shard / bc2) + eps)
    if weight_decay:
        step = step + weight_decay * decay_shard * param_shard
    return param_shard - lr * step


def cosine_schedule(step, *, base_lr, warmup_steps, total_steps,
                    min_lr=1e-6) -> float:
    """Linear warmup to ``base_lr`` over ``warmup_steps``, then a cosine
    down to ``min_lr`` at ``total_steps``; fp32 arithmetic, as the
    reference's."""
    sf = _f32(step)
    if sf < warmup_steps:
        return float(_f32(base_lr) * sf / _f32(max(warmup_steps, 1)))
    prog = (sf - _f32(warmup_steps)) / _f32(max(total_steps - warmup_steps,
                                                1))
    prog = np.clip(prog, _f32(0.0), _f32(1.0))
    cos = _f32(min_lr) + _f32(0.5) * _f32(base_lr - min_lr) * (
        _f32(1.0) + np.cos(_f32(math.pi) * prog))
    return float(cos)
