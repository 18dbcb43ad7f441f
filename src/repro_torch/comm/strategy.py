"""The inter-chunk state exchange of LASP-2 layers (twin of the
"allgather" strategy of ``repro/comm/strategy.py`` and the overlap
scheduler of ``repro/comm/overlap.py``).

Given each rank's local chunk state ``M_t`` and total chunk log decay
``A_t``, rank t obtains the decayed prefix state ``M_{1:t-1}`` by the
paper's LASP-2: one all-gather of the packed ``M‖A``, the same size
whatever the sequence length, whose autograd backward is one
reduce-scatter. It is the only exchange compatible with the faithful
Alg. 3/4 backward, which needs the gathered cumulative decays. The ring,
pipelined and Ulysses strategies, and a registry to choose among them,
come with M8.

Overlap. The reference shapes XLA's dependency graph; eager PyTorch
orders work by issue. ``overlap="overlap"`` is paper Alg. 2's line order:
the gather is issued asynchronously, the intra-chunk kernel runs while it
is in flight, then the gather is waited on. With NCCL the collective runs
on its own stream beside the kernel; with gloo on a background thread (a
device operand is first copied to the host, which waits for the device).
``overlap="none"`` runs the compute first and only then the gather: the
A/B baseline the overlap is measured against. Both give the same values.
"""

from __future__ import annotations

import torch

from repro_torch.comm import primitives
from repro_torch.core.linear_attention import prefix_state_combine

OVERLAP_MODES = ("overlap", "none")


def prefix_allgather(m_loc, a_loc, group, t: int, overlap: str, compute,
                     wire: torch.dtype = torch.float32):
    """One all-gather (tag ``lasp2.states``) of this rank's packed
    ``M_t‖A_t`` ((..., dk, dv) ‖ (...,) -> (..., dk·dv + 1), cast to
    ``wire``), ordered against ``compute`` (() -> anything independent of
    the gather: the intra-chunk kernel) by ``overlap`` (one of
    ``OVERLAP_MODES``, checked by ``core.lasp2.SPConfig``).

    Returns ``(m_prev, intra, cum, states)``: the decayed prefix state
    (..., dk, dv) fp32, what ``compute`` returned, the inclusive cumulative
    chunk decays (W, ...) and the gathered chunk states (W, ..., dk, dv).
    """
    dk, dv = m_loc.shape[-2:]
    lead = m_loc.shape[:-2]
    packed = torch.cat([m_loc.reshape(*lead, -1), a_loc[..., None]],
                       dim=-1).to(wire)
    gather = lambda: primitives.allgather_states(
        packed, group, tag="lasp2.states", async_op=True)
    if overlap == "none":
        intra = compute()
        gathered = gather().wait()
    else:
        pending = gather()              # issued first → in flight …
        intra = compute()               # … while the intra kernel runs
        gathered = pending.wait()
    gathered = primitives.upcast_gathered(gathered)
    states = gathered[..., :-1].reshape(*gathered.shape[:-1], dk, dv)
    cum = torch.cumsum(gathered[..., -1], dim=0)
    return prefix_state_combine(states, cum, t), intra, cum, states
