"""Primitive layers (plain functions over param dicts of tensors).

Twin of ``repro/models/layers.py``. Leaf names match the reference (wq/wk/
wv/wo, w1/w2/w3, table/lm_head, scale) so ``models/weights.py`` maps a JAX
tree one to one. Each matrix is cast to the activation dtype at its use,
as in the reference: a no-op on the bf16 serving params, the bf16 compute
copy of the fp32 masters in training. Norm scales stay fp32.

Under a serving plan's tensor parallelism (``tp``, a
``sharding.rules.Place`` of the model axis, passed where the weights are
this rank's slices) the MLP is column-parallel in ``w1``/``w3`` and
row-parallel in ``w2``, the embedding and ``lm_head`` hold this rank's
vocab rows; each closes with one recorded collective.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.comm import primitives


def normal(generator, shape, scale, dtype, device):
    if torch.device(device).type == "meta":       # shapes alone, no draw
        return torch.empty(shape, dtype=dtype, device=device)
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


def row_partial(x, w):
    """``x @ w`` where ``w`` holds this rank's rows of a weight split over
    the model group (``x`` the matching columns): the rank's partial
    product in fp32, for one all-reduce to sum (:func:`row_parallel`)."""
    return x.float() @ w.float()


def row_parallel(x, w, tp, tag):
    """``x @ w`` where ``w`` holds this rank's rows of a weight split over
    the model group (``x`` the matching columns): the partial product in
    fp32, summed over the group in one all-reduce (``tag``) and rounded
    to ``x``'s dtype once, as one device's product is."""
    y = primitives.allreduce_sum(row_partial(x, w), tp.group, tag=tag)
    return y.to(x.dtype)


def _mlp_hidden(params, x, act):
    dt = x.dtype
    h = x @ params["w1"].to(dt)
    if act == "swiglu":
        return F.silu(h) * (x @ params["w3"].to(dt))
    return F.gelu(h, approximate="tanh")     # jax.nn.gelu's default form


def mlp_partial(params, x, act="swiglu"):
    """The MLP's fp32 partial output on this rank's ff columns (``w1``,
    ``w3``) and rows (``w2``), for an all-reduce to sum."""
    return row_partial(_mlp_hidden(params, x, act), params["w2"].to(x.dtype))


def mlp_apply(params, x, act="swiglu", tp=None):
    """The MLP; with ``tp`` the weights are this rank's ff columns
    (``w1``, ``w3``) and rows (``w2``): its partial output is summed over
    the model group in one all-reduce (tag ``tp.mlp``)."""
    h = _mlp_hidden(params, x, act)
    if tp is not None:
        return row_parallel(h, params["w2"].to(x.dtype), tp, "tp.mlp")
    return h @ params["w2"].to(x.dtype)


# --- embeddings ------------------------------------------------------------

def embed_init(generator, vocab, d, dtype, device, tie=False):
    p = {"table": normal(generator, (vocab, d), 0.02, dtype, device)}
    if not tie:
        p["lm_head"] = normal(generator, (vocab, d), 0.02, dtype, device)
    return p


def embed_lookup(params, tokens, dtype, tp=None):
    """tokens: int tensor of any shape → (..., d) in ``dtype``. With
    ``tp`` the table holds this rank's vocab rows: ids outside them look
    up zeros, and one all-reduce over the model group (tag ``tp.embed``)
    sums the ranks' rows, exact, since one rank holds each id."""
    tokens = tokens.long()
    table = params["table"]
    if tp is None:
        return F.embedding(tokens, table).to(dtype)
    lo = tp.index * table.shape[0]
    local = tokens - lo
    mine = (local >= 0) & (local < table.shape[0])
    x = F.embedding(torch.where(mine, local, torch.zeros_like(local)),
                    table).to(dtype)
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=dtype,
                                                    device=x.device))
    return primitives.allreduce_sum(x, tp.group, tag="tp.embed")


def logits_out(params, x, vocab_size, tp=None):
    """x @ table^T over the padded vocab; padded columns are -1e30. With
    ``tp`` the head holds this rank's vocab rows (columns ``index·V_l …``
    of the logits, padding set by their global index), gathered over the
    model group in vocab order (tag ``tp.logits``)."""
    table = params.get("lm_head", params["table"])
    logits = x @ table.to(x.dtype).T
    lo = 0 if tp is None else tp.index * table.shape[0]
    if lo + logits.shape[-1] > vocab_size:
        logits[..., max(vocab_size - lo, 0):] = -1e30
    if tp is not None:
        logits = primitives.allgather_states(
            logits.contiguous(), tp.group, gather_axis=logits.dim() - 1,
            tiled=True, tag="tp.logits")
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
