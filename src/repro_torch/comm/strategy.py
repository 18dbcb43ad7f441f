"""The inter-chunk state exchanges of LASP-2 layers and their registry
(twin of ``repro/comm/strategy.py`` and the overlap scheduler of
``repro/comm/overlap.py``).

Given each rank's local chunk state ``M_t`` and total chunk log decay
``A_t``, a strategy gives rank t the decayed prefix state ``M_{1:t-1}``:

=============  ===========================  =====  ======================
strategy       forward collectives          steps  backward (autodiff)
=============  ===========================  =====  ======================
"allgather"    1 all-gather (packed M‖A)    1      1 reduce-scatter
"ring"         W-1 collective-permutes      W-1    W-1 permutes
"pipelined"    k(W-1) permutes (1/k size)   W-1    k(W-1) permutes
"ulysses"      as "allgather"               1      1 reduce-scatter
=============  ===========================  =====  ======================

"allgather" is the paper's LASP-2 and the only exchange compatible with
the faithful Alg. 3/4 backward, which needs the gathered cumulative
decays; "ring" is LASP-1's sequential pattern inside the LASP-2 layer,
"pipelined" the ring split along dv into independent chains (ZeCO's
all-scan at chunk granularity: the same volume). "ulysses" changes the
softmax layers only (``core.lasp2h.ulysses_context_attention``); its
linear layers exchange as "allgather".

Every strategy is ``fn(m_loc, a_loc, group, t, overlap, compute, wire)
-> (m_prev, intra, cum, states)``: the decayed prefix state (..., dk, dv)
fp32, what ``compute`` returned, and under "allgather" the inclusive
cumulative chunk decays (W, ...) and the gathered chunk states (W, ...,
dk, dv), else None for both.

Overlap. The reference shapes XLA's dependency graph; eager PyTorch
orders work by issue. ``overlap="overlap"`` is paper Alg. 2's line order:
the exchange is issued before the intra-chunk kernel (``compute``) and
waited on after it, so the kernel runs while the exchange is in flight
(with NCCL on its own stream beside the kernel; with gloo on a
background thread, after the device operand's copy to the host, which
waits for the device). The all-gather is in flight whole; a ring chain
has its first hop in flight (at W 2 its only one), and its later hops
each wait for the one before. ``overlap="none"`` runs the kernel first
and only then the exchange: the A/B baseline. Both give the same values.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.comm import primitives
from repro_torch.core.linear_attention import prefix_state_combine

OVERLAP_MODES = ("overlap", "none")


def _ordered(start, overlap, compute):
    """``(start().wait(), compute())`` with the exchange ``start`` issued
    before ``compute`` under "overlap" and after it under "none"."""
    if overlap == "none":
        intra = compute()
        return start().wait(), intra
    pending = start()                   # issued first → in flight …
    intra = compute()                   # … while the intra kernel runs
    return pending.wait(), intra


def prefix_allgather(m_loc, a_loc, group, t: int, overlap: str, compute,
                     wire: torch.dtype = torch.float32):
    """One all-gather (tag ``lasp2.states``) of this rank's packed
    ``M_t‖A_t`` ((..., dk, dv) ‖ (...,) -> (..., dk·dv + 1), cast to
    ``wire``), ordered against ``compute`` by ``overlap``."""
    dk, dv = m_loc.shape[-2:]
    lead = m_loc.shape[:-2]
    packed = torch.cat([m_loc.reshape(*lead, -1), a_loc[..., None]],
                       dim=-1).to(wire)
    gathered, intra = _ordered(lambda: primitives.allgather_states(
        packed, group, tag="lasp2.states", async_op=True), overlap, compute)
    gathered = primitives.upcast_gathered(gathered)
    states = gathered[..., :-1].reshape(*gathered.shape[:-1], dk, dv)
    cum = torch.cumsum(gathered[..., -1], dim=0)
    return prefix_state_combine(states, cum, t), intra, cum, states


def _ring(m_loc, a_loc, group, overlap, compute, wire, n_slices, tag):
    m_prev, intra = _ordered(lambda: primitives.pipelined_prefix_exchange(
        m_loc, a_loc, group, n_slices=n_slices, wire=wire, tag=tag,
        async_op=True), overlap, compute)
    return m_prev, intra, None, None


def prefix_ring(m_loc, a_loc, group, t: int, overlap: str, compute,
                wire: torch.dtype = torch.float32):
    """LASP-1's pattern: W-1 sequential hops of the full state (tag
    ``lasp2.ring``)."""
    return _ring(m_loc, a_loc, group, overlap, compute, wire, 1,
                 "lasp2.ring")


def prefix_pipelined(m_loc, a_loc, group, t: int, overlap: str, compute,
                     wire: torch.dtype = torch.float32):
    """The ring split along dv into ``auto_slices(dv)`` independent chains
    (tags ``lasp2.pipelined[i]``)."""
    return _ring(m_loc, a_loc, group, overlap, compute, wire, None,
                 "lasp2.pipelined")


# The one dispatch point for strategy names.
_STRATEGIES = {"allgather": prefix_allgather, "ring": prefix_ring,
               "pipelined": prefix_pipelined, "ulysses": prefix_allgather}


def registered_strategies() -> tuple:
    """The strategy names, in the reference's order."""
    return tuple(_STRATEGIES)


def get_strategy(name: str) -> Callable:
    try:
        return _STRATEGIES[name]
    except KeyError:
        raise ValueError(f"unknown comm strategy {name!r}; expected one of "
                         f"{registered_strategies()}") from None
