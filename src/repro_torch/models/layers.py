"""Primitive layers (plain functions over param dicts of tensors).

Twin of ``repro/models/layers.py``. Leaf names match the reference (wq/wk/
wv/wo, w1/w2/w3, table/lm_head, scale) so ``models/weights.py`` maps a JAX
tree one to one. Each matrix is cast to the activation dtype at its use,
as in the reference: a no-op on the bf16 serving params, the bf16 compute
copy of the fp32 masters in training. Norm scales stay fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def normal(generator, shape, scale, dtype, device):
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


def dense_init(generator, d_in, d_out, dtype, device, scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    return normal(generator, (d_in, d_out), scale, dtype, device)


# --- norms -----------------------------------------------------------------

def rmsnorm_init(d, device):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x, eps=1e-5):
    """fp32 math with the fp32 scale, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"]
    return y.to(x.dtype)


# --- rotary ----------------------------------------------------------------

def rope(x, positions, theta=10000.0):
    """x: (B, H, S, dh); positions: (S,) or (B, S) global token positions
    (negative for left-padding filler). Half-split rotation, freqs
    theta^(-i/half), math in fp32 then cast back."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    pos = positions.to(device=x.device, dtype=torch.float32)
    if pos.ndim == 1:
        ang = (pos[:, None] * freqs[None, :])[None, None]   # (1,1,S,half)
    else:
        ang = (pos[..., None] * freqs)[:, None]             # (B,1,S,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    xr = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return xr.to(x.dtype)


# --- MLPs ------------------------------------------------------------------

def mlp_init(generator, d, d_ff, dtype, device, act="swiglu"):
    p = {"w1": dense_init(generator, d, d_ff, dtype, device),
         "w2": dense_init(generator, d_ff, d, dtype, device)}
    if act == "swiglu":
        p["w3"] = dense_init(generator, d, d_ff, dtype, device)
    return p


def mlp_apply(params, x, act="swiglu"):
    dt = x.dtype
    h = x @ params["w1"].to(dt)
    if act == "swiglu":
        h = F.silu(h) * (x @ params["w3"].to(dt))
    else:
        h = F.gelu(h, approximate="tanh")    # jax.nn.gelu's default form
    return h @ params["w2"].to(dt)


# --- embeddings ------------------------------------------------------------

def embed_init(generator, vocab, d, dtype, device, tie=False):
    p = {"table": normal(generator, (vocab, d), 0.02, dtype, device)}
    if not tie:
        p["lm_head"] = normal(generator, (vocab, d), 0.02, dtype, device)
    return p


def embed_lookup(params, tokens, dtype):
    """tokens: int tensor of any shape → (..., d) in ``dtype``."""
    return F.embedding(tokens.long(), params["table"]).to(dtype)


def logits_out(params, x, vocab_size):
    """x @ table^T over the padded vocab; padded columns are -1e30."""
    table = params.get("lm_head", params["table"])
    logits = x @ table.to(x.dtype).T
    if logits.shape[-1] > vocab_size:
        logits[..., vocab_size:] = -1e30
    return logits


def sinusoidal_positions(n, d, device=None):
    """(n, d) fp32 sinusoid table: sin at even columns, cos at odd ones,
    angle ``pos / 10000^(2i/d)``."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang[:, : d // 2])
    return pe
