"""Model FLOPs and the H100's peaks: the denominators of the port's MFU
(the role of the reference's ``launch/hlo_analysis.model_flops`` and its
peak constants, which are a TPU's and do not apply to the card).

The peaks are NVIDIA's H100 SXM data-sheet figures: dense (not sparse)
tensor-core bf16, fp32 outside the tensor cores, and the HBM3 rate.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
# NVLink 4 on the H100 SXM: 900 GB/s in all (NVIDIA data sheet), 450 GB/s
# a direction, the rate a ring collective's sends see
NVLINK_BYTES_PER_S = 450e9
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # fp32 outside the tensor cores


def peak_flops(dtype: str = "bfloat16") -> float:
    """The card's peak FLOP/s for a compute dtype (``cfg.dtype``)."""
    try:
        return PEAK_FLOPS[dtype]
    except KeyError:
        raise ValueError(f"no H100 peak for dtype {dtype!r}; known: "
                         f"{sorted(PEAK_FLOPS)}") from None


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS of one step: 6·N_active·D (train), 2·N_active·D
    (prefill), 2·N_active·B (decode: one token a row), with D the step's
    tokens (``shape.global_batch × shape.seq_len``) and N_active
    ``cfg.active_param_count()``."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "decode":
        return 2.0 * n * shape.global_batch
    raise ValueError(f"unknown shape kind {shape.kind!r}")


# ---------------------------------------------------------------------------
# The kernels' own work: one count for the kernel table's bounds
# (chip_smoke.py) and the roofline (launch.roofline).
# ---------------------------------------------------------------------------

CHUNK_ROWS = 64                    # rows per chunk of the K1/K2 kernels


def _itemsize(dtype) -> int:
    return dtype.itemsize


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def bound(flops: float, nbytes: float, peak: float):
    """``(ms, by)``: the least time of work that moves ``nbytes`` at the
    HBM rate and does ``flops`` at ``peak``, the larger of the two, and
    which of them it is (``"bytes"`` or ``"operations"``)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def chunk_fwd_work(bh, s, dk, dv, el):
    """``(flops, bytes)`` of K1 over (BH, S) rows: every input read once
    and every output written once (``el`` bytes an activation element),
    against the products of the 64-row chunked algorithm (causal half of
    QK^T and SV, full QM and K^T V)."""
    nbytes = el * bh * s * (2 * dk + 2 * dv) + 4 * bh * s \
        + 4 * bh * dk * dv + 4 * bh
    c, nch = CHUNK_ROWS, -(-s // CHUNK_ROWS)
    return bh * nch * (c * c * dk + c * c * dv + 4 * c * dk * dv), nbytes


def chunk_bwd_work(bh, s, dk, dv, el):
    """``((flops, bytes) of K2a, (flops, bytes) of K2b)``, counted as
    :func:`chunk_fwd_work`: the causal halves of the C x C score
    products and the full products with the carried state."""
    c, nch = CHUNK_ROWS, -(-s // CHUNK_ROWS)
    rows = bh * s
    # K2a reads k, v, dO, log a; writes dq. Products: dO V^T, dsc K,
    # dO M^T, the carried M.
    a = (bh * nch * (c * c * dv + c * c * dk + 4 * c * dk * dv),
         el * rows * (2 * dk + 2 * dv) + 4 * rows)
    # K2b reads q, k, v, o, dO, log a, dM; writes dk, dv, dlog a. Products:
    # Q K^T, dO V^T, dsc^T Q, sc^T dO, V N^T, K N, the carried N, and r.
    b = (bh * nch * (2 * c * c * dk + 2 * c * c * dv + 6 * c * dk * dv
                     + 2 * c * (dk + dv)),
         el * rows * (3 * dk + 4 * dv) + 8 * rows + 4 * bh * dk * dv)
    return a, b


def decode_work(bh, dk, dv, el):
    """``(fp32 flops, bytes)`` of K3: the fp32 state read once and written
    once, q, k, v (``el`` bytes an element), log a and L read, o and L
    written, against 5 flops a state element (a·M, k·v, the sum, q·M'
    and its sum)."""
    nbytes = 2 * 4 * bh * dk * dv + el * bh * (2 * dk + dv) + 4 * bh * dv \
        + 3 * 4 * bh
    return 5 * bh * dk * dv, nbytes


def flash_pairs(sq, sk, q_offset, kv_len, causal, window) -> int:
    """Valid (query, key) pairs of one head's mask: query row i at
    ``q_offset + i`` sees keys j < ``kv_len``, j <= its position if
    ``causal``, and its position − j < ``window`` if a window is set."""
    total = 0
    for i in range(sq):
        pos = q_offset + i
        hi = min(kv_len, pos + 1) if causal else kv_len
        lo = max(0, pos - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def flash_work(b, hq, hkv, sq, sk, dh, el, pairs):
    """``[(flops, bytes)]`` of K4, K5a and K5b: inputs read once and
    outputs written once, against 2, 3 and 4 products of 2·dh flops over
    ``pairs`` valid (query, key) pairs (all heads)."""
    nq, nkv, rows = b * hq * sq * dh, b * hkv * sk * dh, b * hq * sq
    return [(2 * 2 * dh * pairs, el * (2 * nq + 2 * nkv) + 4 * rows),
            (3 * 2 * dh * pairs, el * (3 * nq + 2 * nkv) + 8 * rows),
            (4 * 2 * dh * pairs, el * (2 * nq + 4 * nkv) + 8 * rows)]


def chunk_bound(bh, s, dk, dv, dtype):
    """K1's least time, ``(ms, by)``, at the peak rate for ``dtype``."""
    return bound(*chunk_fwd_work(bh, s, dk, dv, _itemsize(dtype)),
                 peak_flops(_dtype_name(dtype)))


def bwd_bounds(bh, s, dk, dv, dtype):
    """K2a's and K2b's least times, ``((ms, by), (ms, by))``."""
    peak = peak_flops(_dtype_name(dtype))
    return [bound(f, n, peak)
            for f, n in chunk_bwd_work(bh, s, dk, dv, _itemsize(dtype))]


def decode_bound(bh, dk, dv, el):
    """K3's least time, ``(ms, by)``, its flops at the fp32 rate."""
    return bound(*decode_work(bh, dk, dv, el), peak_flops("float32"))


def flash_bounds(b, hq, hkv, sq, sk, dh, dtype, pairs):
    """K4's, K5a's and K5b's least times, ``[(ms, by)] * 3``."""
    peak = peak_flops(_dtype_name(dtype))
    return [bound(f, n, peak) for f, n in
            flash_work(b, hq, hkv, sq, sk, dh, _itemsize(dtype), pairs)]
