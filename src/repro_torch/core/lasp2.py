"""LASP-2: sequence parallelism for linear attention (paper Algorithms 1–4).

Twin of ``repro/core/lasp2.py``. :func:`lasp2` is chunked (decayed)
linear attention whose sequence is split over the ranks of an SP process
group, one contiguous chunk a rank (rank ``t`` of the group holds chunk
``t``). The only communication is

  * forward:  one all-gather of the per-chunk memory states
              ``M_t in R^{dk x dv}`` packed with the chunk log decays
              ``A_t`` (``comm.strategy.prefix_allgather``),
  * backward: one all-gather of the state gradients ``dM_t`` (the faithful
              Alg. 3/4 backward), or the gather's reduce-scatter (autodiff),

both independent of sequence length: the paper's central claim. The
exchange is chosen by ``SPConfig.comm`` (``comm.spec.CommSpec``): the
paper's all-gather, or the ring and pipelined exchanges of LASP-1's
pattern (``comm.strategy``), which differentiate by autodiff.

Two backward modes:

* ``backward="faithful"``: a ``torch.autograd.Function`` implementing the
  paper's Algorithm 3/4 communication literally (AllGather of ``dM_t``,
  local decayed suffix sums). The decay is a constant: its gradient is
  zero. For basic, Retention and Lightning (non-learned) decays.
* ``backward="autodiff"``: autograd through the forward; the all-gather's
  backward is a reduce-scatter (``comm.primitives.allgather_states``).
  Needed whenever ``log_a`` carries a gradient or resets (the model picks
  it for packed documents and data-dependent decay).

Unlike the reference, there is no ``shard_map``: the caller passes each
rank's chunk, and the ranks are processes (``launch.mesh``). The
intra-chunk pass is ``ops.linear_attention_op``: K1 forward and K2a/K2b
backward on the card, their plain versions on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.comm import primitives
from repro_torch.comm.spec import CommSpec
from repro_torch.comm.strategy import get_strategy, prefix_allgather
from repro_torch.core.linear_attention import (chunk_summaries, pick_block,
                                               suffix_grad_combine)
from repro_torch.kernels import ops


@dataclass(frozen=True)
class SPConfig:
    """How the sequence is split for LASP-2 style layers: ``group`` is the
    process group of the ranks that share one row's sequence, in chunk
    order. ``comm`` is the exchange strategy, the order of the exchange
    and the intra-chunk kernel, and the wire dtype, validated as one
    value (``comm.spec.CommSpec``).

    On a 3D layout (``launch.mesh.TrainingGroups`` with tp > 1) ``group``
    is the token group, the sp·tp ranks over which tokens split
    sequence-major (rank ``s·tp + m`` holds chunk ``s·tp + m``): every
    linear layer's state exchange and the K/V all-gather span it.
    ``tp_group`` is Ulysses' head-parallel group (the tp ranks of this
    sequence index) and ``seq_group`` the residual sequence group (the sp
    ranks of this model index); both are None on 2D layouts."""

    group: Any
    comm: CommSpec = field(default_factory=CommSpec)
    tp_group: Any = None
    seq_group: Any = None

    @property
    def degree(self) -> int:
        """Number of sequence chunks (ranks of the group)."""
        return dist.get_world_size(self.group)

    @property
    def chunk_index(self) -> int:
        """This rank's sequence-chunk index ``t``."""
        return primitives.group_index(self.group)


def _cumulative_decay(log_a):
    """Inclusive in-chunk cumulative decay b_i = exp(sum_{j<=i} log_a_j)."""
    return torch.exp(torch.cumsum(log_a.float(), dim=-1))


def _intra_chunk(q, k, v, log_a, block_size):
    """The intra-chunk pass: ``(o, end state, log decay)`` of the chunk
    from a zero state, through the chunk kernels."""
    return ops.linear_attention_op(q, k, v, log_a, block_size=block_size)


# ---------------------------------------------------------------------------
# Local (per-rank) forward bodies.
# ---------------------------------------------------------------------------

def _exchange(q, k, v, log_a, sp: SPConfig, block_size, exchange):
    """Alg. 2 in line order: the chunk summaries (plain tensor code, as the
    reference's XLA pass) form the payload; the strategy function
    ``exchange`` is issued around the intra-chunk kernel. Returns
    ``(m_prev, (o, end state, log decay) of the chunk, cum, states)``
    (``comm.strategy``).
    """
    m_loc, a_loc = chunk_summaries(
        k, v, log_a, block_size=pick_block(q.shape[-2], block_size))
    return exchange(
        m_loc, a_loc, sp.group, sp.chunk_index, sp.comm.overlap,
        lambda: _intra_chunk(q, k, v, log_a, block_size),
        primitives.wire_dtype(sp.comm.dtype))


def _inter_chunk(q, log_a, m_prev):
    """The prefix state's contribution: (q ⊙ b) M_{1:t-1}, fp32."""
    b = _cumulative_decay(log_a)
    return (q.float() * b[..., None]) @ m_prev


def _causal_fwd_local(q, k, v, log_a, sp: SPConfig, block_size):
    """One rank's chunk: returns the output and the residuals of the
    faithful backward ``(m_prev, cum)``."""
    m_prev, intra, cum, _ = _exchange(q, k, v, log_a, sp, block_size,
                                      get_strategy(sp.comm.strategy))
    o = intra[0].float() + _inter_chunk(q, log_a, m_prev)
    return o.to(q.dtype), (m_prev, cum)


def _noncausal_fwd_local(q, k, v, sp: SPConfig):
    """Paper Alg. 1: no mask, every position reads the full-sequence
    state (no decay)."""
    m_loc = k.float().transpose(-1, -2) @ v.float()
    ms = primitives.allgather_states(
        m_loc.to(primitives.wire_dtype(sp.comm.dtype)), sp.group,
        tag="lasp2.noncausal")
    m_tot = primitives.upcast_gathered(ms).sum(0)
    return (q.float() @ m_tot).to(q.dtype), m_tot


# ---------------------------------------------------------------------------
# Paper-faithful backwards (Algorithms 3/4).
# ---------------------------------------------------------------------------

class _CausalFaithful(torch.autograd.Function):
    """Alg. 2 forward, Alg. 4 backward: one all-gather of dM, a local
    decayed suffix sum, and the intra-chunk pull with cotangents
    ``(dO, dM_loc)`` through the chunk kernels (K2a, K2b with a nonzero
    state cotangent)."""

    @staticmethod
    def forward(ctx, q, k, v, log_a, sp, block_size):
        o, (m_prev, cum) = _causal_fwd_local(q, k, v, log_a, sp, block_size)
        ctx.save_for_backward(q, k, v, log_a, m_prev, cum)
        ctx.sp, ctx.block_size = sp, block_size
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, log_a, m_prev, cum = ctx.saved_tensors
        sp = ctx.sp
        dof = do.float()
        b = _cumulative_decay(log_a)[..., None]
        # Alg. 4 line 3: dM_t = (Q_t ⊙ b)^T dO_t
        dm_up = (q.float() * b).transpose(-1, -2) @ dof
        # line 4: the single backward AllGather (comm_dtype on the wire)
        dms = primitives.upcast_gathered(primitives.allgather_states(
            dm_up.to(primitives.wire_dtype(sp.comm.dtype)), sp.group,
            tag="lasp2.dstates"))
        # line 9: decayed suffix sum, local
        dm_loc = suffix_grad_combine(dms, cum, sp.chunk_index)
        # lines 5–7, 10–11: re-run the local chunk pass and pull on both
        # of its outputs (the recompute is the paper's checkpointing)
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
            o_i, st, _ = _intra_chunk(*xs, log_a, ctx.block_size)
            dq_i, dk, dv = torch.autograd.grad((o_i, st), xs, (do, dm_loc))
        # line 8: dQ_inter = dO_t M_{1:t-1}^T (decay-weighted)
        dq = dq_i.float() + (dof @ m_prev.transpose(-1, -2)) * b
        # the decay is a non-learned constant: zero cotangent
        return (dq.to(q.dtype), dk, dv, torch.zeros_like(log_a), None,
                None)


class _NoncausalFaithful(torch.autograd.Function):
    """Alg. 1 forward, Alg. 3 backward: one all-gather of dM = Qᵀ dO."""

    @staticmethod
    def forward(ctx, q, k, v, sp):
        o, m_tot = _noncausal_fwd_local(q, k, v, sp)
        ctx.save_for_backward(q, k, v, m_tot)
        ctx.sp = sp
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, m_tot = ctx.saved_tensors
        sp = ctx.sp
        dof = do.float()
        dm_up = q.float().transpose(-1, -2) @ dof
        dms = primitives.upcast_gathered(primitives.allgather_states(
            dm_up.to(primitives.wire_dtype(sp.comm.dtype)), sp.group,
            tag="lasp2.nc.dstates"))
        # Alg. 3 line 5 writes a suffix sum; without the mask every chunk's
        # state feeds every output, so the cotangent is the full sum (as
        # the reference computes it).
        dm_tot = dms.sum(0)
        dq = dof @ m_tot.transpose(-1, -2)
        dk = v.float() @ dm_tot.transpose(-1, -2)
        dv = k.float() @ dm_tot
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


# ---------------------------------------------------------------------------
# Public API.
# ---------------------------------------------------------------------------

def _zero_log_a(q):
    return torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)


def lasp2_with_state(q, k, v, log_a=None, *, sp: SPConfig = None,
                     block_size: int = 128):
    """Causal LASP-2 forward that also returns the end-of-sequence memory
    state (prefill seeds the decode cache with it; inference only, no
    custom backward). The end state needs every chunk's contribution,
    which the gather provides: the exchange is "allgather" whatever
    ``sp.comm.strategy`` is."""
    return lasp2_prefill(q, k, v, log_a, sp=sp, block_size=block_size)[:2]


def lasp2_prefill(q, k, v, log_a=None, *, sp: SPConfig = None,
                  block_size: int = 128):
    """:func:`lasp2_with_state` and the whole sequence's summed log decay
    (B..., fp32): ``(o, end state, log decay)``, what a prefill caches.
    Under SP the log decay is the sum of the gathered chunk decays, so no
    rank needs another exchange for it."""
    if log_a is None:
        log_a = _zero_log_a(q)
    if sp is None or sp.degree == 1:
        o, state, _ = _intra_chunk(q, k, v, log_a, block_size)
        return o, state, log_a.float().sum(-1)
    m_prev, intra, cum, states = _exchange(q, k, v, log_a, sp, block_size,
                                           prefix_allgather)
    o = intra[0].float() + _inter_chunk(q, log_a, m_prev)
    # global end state: decayed combine of all chunks (same on all ranks)
    logw = torch.clamp(cum[-1][None] - cum, max=0.0)
    m_end = torch.einsum("w...,w...kv->...kv", torch.exp(logw), states)
    return o.to(q.dtype), m_end, cum[-1]


def lasp2(q, k, v, log_a=None, *, sp: SPConfig = None, causal: bool = True,
          block_size: int = 128, backward: str = "faithful"):
    """Chunked linear attention with LASP-2 sequence parallelism.

    Args:
      q, k: ``(..., C, dk)``; v: ``(..., C, dv)``: this rank's chunk of the
        sequence (the whole sequence when ``sp`` is None).
      log_a: optional per-token log decays ``(..., C)``; None = basic
        linear attention.
      sp: the sequence split; None or degree 1 → the local chunked scan,
        no communication.
      causal: causal (Alg. 2) or bidirectional (Alg. 1, no decay).
      backward: "faithful" (Alg. 3/4) or "autodiff". A learned or
        data-dependent ``log_a`` needs "autodiff".

    The exchange is ``sp.comm.strategy``. "ulysses" is "allgather" here
    (its all-to-alls are the softmax layers'); the faithful backward is
    the all-gather's Alg. 4, so any other strategy differentiates by
    autodiff (each hop's backward is a hop); "ring" and "pipelined" are
    causal only, and span one sequence group: on a 3D split (``sp.tp_group``
    set) they raise, as the reference's do.
    """
    if backward not in ("faithful", "autodiff"):
        raise ValueError(f"backward must be 'faithful' or 'autodiff', got "
                         f"{backward!r}")
    if log_a is None:
        log_a = _zero_log_a(q)
    if sp is None or sp.degree == 1:
        if causal:
            return _intra_chunk(q, k, v, log_a, block_size)[0]
        m_tot, _ = chunk_summaries(
            k, v, None, block_size=pick_block(q.shape[-2], block_size))
        return (q.float() @ m_tot).to(q.dtype)
    if sp.comm.strategy not in ("allgather", "ulysses"):
        if sp.tp_group is not None:
            raise ValueError(
                f"comm_strategy={sp.comm.strategy!r} does not support the "
                f"combined (sequence, model) exchange of a 3D mesh — use "
                f"'allgather' or 'ulysses'")
        if not causal:
            raise ValueError(
                f"comm strategy {sp.comm.strategy!r} is causal-only; the "
                f"bidirectional path uses the allgather exchange")
        backward = "autodiff"
    if causal:
        if backward == "faithful":
            return _CausalFaithful.apply(q, k, v, log_a, sp, block_size)
        return _causal_fwd_local(q, k, v, log_a, sp, block_size)[0]
    if backward == "faithful":
        return _NoncausalFaithful.apply(q, k, v, sp)
    return _noncausal_fwd_local(q, k, v, sp)[0]
