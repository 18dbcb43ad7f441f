"""The sequence-parallel baselines the paper compares LASP-2 against
(paper §4.2, Appendix A.2/A.3; twin of ``repro/core/baselines.py``).

* :func:`lasp1`: LASP-1 (paper Alg. 5/6), the memory state passed round
  the ring: W-1 sequential hops forward (``comm.primitives``'s
  prefix-scan exchange with one slice), each hop's backward a hop.
* :func:`ring_attention`: Ring Attention (Liu et al. 2023), K/V chunks
  rotating round the ring under an online softmax.
* :func:`megatron_sp_attention`: Megatron-SP, every rank gathers all of
  q, k and v along the sequence: traffic O(S·d) a layer against
  LASP-2's O(d²) (paper §3.4).

Each takes this rank's chunk of the sequence and a ``core.lasp2.SPConfig``
(None or degree 1: local). They exist for comparisons and parity tests;
the models run ``core.lasp2`` and ``core.lasp2h``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.comm import primitives
from repro_torch.core.lasp2h import NEG_INF, _softmax_attend, causal_mask
from repro_torch.core.linear_attention import chunk_summaries, pick_block
from repro_torch.kernels import ops


def lasp1(q, k, v, log_a=None, *, sp=None, block_size: int = 128):
    """LASP-1 (paper Alg. 6, with decay): the intra-chunk pass through
    ``ops.linear_attention_op`` (K1 and K2a/K2b on the card), then the
    ring prefix-scan of the chunk states (tag ``lasp1``), then the
    inter-chunk term. q, k: (..., C, dk), v: (..., C, dv), log_a: (...,
    C) or None."""
    if log_a is None:
        log_a = torch.zeros(q.shape[:-1], dtype=torch.float32,
                            device=q.device)
    o_intra = ops.linear_attention_op(q, k, v, log_a,
                                      block_size=block_size)[0]
    if sp is None or sp.degree == 1:
        return o_intra
    m_loc, a_loc = chunk_summaries(
        k, v, log_a, block_size=pick_block(q.shape[-2], block_size))
    m_prev = primitives.pipelined_prefix_exchange(m_loc, a_loc, sp.group,
                                                  n_slices=1, tag="lasp1")
    b = torch.exp(torch.cumsum(log_a.float(), dim=-1))
    o = o_intra.float() + (q.float() * b[..., None]) @ m_prev
    return o.to(q.dtype)


def ring_attention(q, k, v, *, sp=None, causal: bool = True,
                   scale: Optional[float] = None):
    """Ring Attention: W steps, each attending this rank's queries to the
    K/V chunk it holds (from rank ``(t - step) % W``) under an fp32 online
    softmax, then passing that chunk on (tags ``ring_attn.k``,
    ``ring_attn.v``). Plain tensor code, as the reference's einsums. The
    reference's W trips are kept, the last one's hops wasted, so that the
    tapes agree. q: (B, Hq, C, dh); k, v: (B, Hkv, C, dh)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if sp is None or sp.degree == 1:
        mask = causal_mask(q.shape[-2], k.shape[-2], 0,
                           device=q.device)[None, None] if causal else None
        return _softmax_attend(q, k, v, scale=scale, mask=mask)
    w, t = sp.degree, sp.chunk_index
    b, hq, c, dh = q.shape
    rep = hq // k.shape[1]
    qf = q.float()
    pos = torch.arange(c, device=q.device)
    o = torch.zeros((b, hq, c, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, hq, c), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hq, c), dtype=torch.float32, device=q.device)
    kc, vc = k, v
    for step in range(w):
        src = (t - step) % w
        kf = torch.repeat_interleave(kc, rep, dim=1).float()
        vf = torch.repeat_interleave(vc, rep, dim=1).float()
        s = torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale
        if causal:
            keep = (t * c + pos[:, None]) >= (src * c + pos[None, :])
            s = torch.where(keep[None, None], s,
                            torch.full((), NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhst,bhtd->bhsd", p, vf)
        m = m_new
        kc = primitives.ring_sendrecv(kc, sp.group, tag="ring_attn.k")
        vc = primitives.ring_sendrecv(vc, sp.group, tag="ring_attn.v")
    return (o / l.clamp(min=1e-30)[..., None]).to(q.dtype)


def megatron_sp_attention(q, k, v, *, sp=None, causal: bool = True,
                          scale: Optional[float] = None):
    """Megatron-SP: three tiled all-gathers of q, k and v along the
    sequence (tags ``megatron.q``, ``.k``, ``.v``; their backwards
    reduce-scatter), attention over the whole sequence through
    ``ops.flash_attention_op`` (K4, K5a/K5b on the card; the reference's
    masked softmax without S² scores), then this rank's slice."""
    if sp is None or sp.degree == 1:
        return ops.flash_attention_op(q, k, v, causal=causal, scale=scale)
    c, t = q.shape[-2], sp.chunk_index
    qg, kg, vg = (primitives.allgather_states(
        x, sp.group, gather_axis=2, tiled=True, tag=f"megatron.{n}")
        for x, n in ((q, "q"), (k, "k"), (v, "v")))
    o = ops.flash_attention_op(qg, kg, vg, causal=causal, scale=scale,
                               q_offset=0)
    return o[:, :, t * c:(t + 1) * c]
