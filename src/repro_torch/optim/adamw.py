"""AdamW and the cosine schedule (twin of ``repro/optim/adamw.py``).

Paper hyperparameters (§4.1): Adam β1 = 0.9, β2 = 0.95, weight decay 0.1,
grad clip 1.0, cosine schedule with linear warmup down to min_lr = 1e-6.

Same elementwise math as the reference, in the same order (bias
correction of both moments, then eps, then decoupled weight decay), with
the scalar factors formed in fp32 as the reference forms them. Unlike the
reference, which returns new arrays, :func:`update` and
:func:`clip_by_global_norm` work **in place** under ``torch.no_grad()``:
at full width the params, moments and gradients are 21 GB, and a second
copy of each would not fit beside the activations. ZeRO-1 (the flat,
sharded state of the DP×SP step) comes with the multi-GPU slice.
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


@torch.no_grad()
def update(grads, state: AdamState, params, *, lr, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.1) -> AdamState:
    """One AdamW step, in place on ``params`` and on the moments of
    ``state``. Returns the new state (the same moment tensors, ``count``
    advanced by one)."""
    count = state.count + 1
    bc1 = float(_f32(1.0) - _f32(b1) ** _f32(count))
    bc2 = float(_f32(1.0) - _f32(b2) ** _f32(count))
    lr = float(_f32(lr))
    flat = zip(leaves_with_paths(params), leaves_with_paths(grads),
               leaves_with_paths(state.m), leaves_with_paths(state.v))
    for (path, p), (_, g), (_, m), (_, v) in flat:
        gf = g.float()
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * gf * gf)
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay and _decayable(path):
            step = step + weight_decay * p.float()
        p.copy_(p.float() - lr * step)
    return AdamState(state.m, state.v, count)


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
