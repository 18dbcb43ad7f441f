"""Direct-form oracle for the linear-attention kernels (twin of
``repro/kernels/ref.py``): an independent O(S²) derivation used by the
parity tests."""

from __future__ import annotations

import torch


def linear_attention_ref(q, k, v, log_a=None):
    """Decayed causal linear attention, O(S²) direct form. fp32 math.

    q, k: (BH, S, dk); v: (BH, S, dv); log_a: (BH, S) or None.
    Returns (o (BH, S, dv) in q's dtype, final_state (BH, dk, dv) fp32).
    """
    bh, s, _ = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    if log_a is None:
        log_a = torch.zeros((bh, s), dtype=torch.float32, device=q.device)
    cb = torch.cumsum(log_a.float(), dim=-1)
    diff = cb[:, :, None] - cb[:, None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    d = torch.where(mask[None], torch.exp(torch.clamp(diff, max=0.0)),
                    torch.zeros((), device=q.device))
    scores = torch.einsum("bik,bjk->bij", qf, kf) * d
    o = torch.einsum("bij,bjv->biv", scores, vf)
    w = torch.exp(cb[:, -1:] - cb)                    # decay i -> end
    state = torch.einsum("bsk,bsv->bkv", kf * w[..., None], vf)
    return o.to(q.dtype), state
