"""Model FLOPs and the H100's peaks: the denominators of the port's MFU
(the role of the reference's ``launch/hlo_analysis.model_flops`` and its
peak constants, which are a TPU's and do not apply to the card).

The peaks are NVIDIA's H100 SXM data-sheet figures: dense (not sparse)
tensor-core bf16, fp32 outside the tensor cores, and the HBM3 rate.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
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
