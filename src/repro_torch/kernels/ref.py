"""Direct-form oracles for the kernels (twin of ``repro/kernels/ref.py``):
independent O(S²) derivations used by the parity tests."""

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


def flash_attention_ref(q, k, v, *, causal=True, sliding_window=None,
                        scale=None):
    """GQA softmax attention, direct form. q: (B,Hq,Sq,dh), k/v:
    (B,Hkv,Sk,dh). Query row i sits at global position (sk - sq) + i."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    sq, sk = q.shape[2], k.shape[2]
    rep = q.shape[1] // k.shape[1]
    kf = torch.repeat_interleave(k, rep, dim=1).float()
    vf = torch.repeat_interleave(v, rep, dim=1).float()
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kf) * scale
    if causal or sliding_window is not None:
        qpos = (sk - sq) + torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        m = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        if causal:
            m &= qpos >= kpos
        if sliding_window is not None:
            m &= (qpos - kpos) < sliding_window
        s = torch.where(m, s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, vf).to(q.dtype)
