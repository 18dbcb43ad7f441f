"""Architecture registry of the port: ``get_config`` / ``get_smoke`` /
``get_variant``.

The port runs every architecture of the reference's registry:
``linear-llama3-1b`` (its ``CONFIG`` and its named variants, ``HYBRID``
among them), ``mamba2-2.7b``, ``hymba-1.5b``, the dense decoders
``codeqwen1.5-7b``, ``qwen1.5-110b``, ``granite-34b``, ``starcoder2-15b``,
the MoE pair ``moonshot-v1-16b-a3b``, ``phi3.5-moe-42b-a6.6b``, and the
cross-attention pair ``llama-3.2-vision-90b`` (image tokens) and
``whisper-base`` (an encoder over audio frames).
"""

from __future__ import annotations

from repro_torch.configs import (codeqwen1_5_7b, granite_34b, hymba_1_5b,
                                 linear_llama3_1b, llama3_2_vision_90b,
                                 mamba2_2_7b, moonshot_v1_16b_a3b,
                                 phi3_5_moe_42b_a6_6b, qwen1_5_110b,
                                 starcoder2_15b, whisper_base)
from repro_torch.configs.base import (EncoderConfig,  # noqa: F401
                                      LayerSpec, LinearAttnConfig,
                                      MambaConfig, ModelConfig, MoEConfig)

_MODULES = {"codeqwen1.5-7b": codeqwen1_5_7b, "qwen1.5-110b": qwen1_5_110b,
            "granite-34b": granite_34b, "starcoder2-15b": starcoder2_15b,
            "hymba-1.5b": hymba_1_5b, "mamba2-2.7b": mamba2_2_7b,
            "llama-3.2-vision-90b": llama3_2_vision_90b,
            "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
            "phi3.5-moe-42b-a6.6b": phi3_5_moe_42b_a6_6b,
            "whisper-base": whisper_base,
            "linear-llama3-1b": linear_llama3_1b}

# The reference's registry lists: the ten assigned architectures (the dry
# run's ``--all``), and those plus the paper's Linear-Llama3.
ARCH_IDS = [k for k in _MODULES if k != "linear-llama3-1b"]
ALL_IDS = list(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return _MODULES[arch_id]


def get_config(arch_id: str, *, linearize: int | None = None) -> ModelConfig:
    """``linearize``: None = native stack; 0 = pure linear attention;
    k>0 = 1/k hybrid (every k-th layer stays softmax)."""
    cfg = _module(arch_id).CONFIG
    if linearize is not None:
        cfg = cfg.linearize(hybrid_every=linearize)
    return cfg


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE


def get_variant(arch_id: str, variant: str) -> ModelConfig:
    """Named variants exported by a config module (e.g. ``HYBRID``,
    ``DENSE``). ``get_config(arch, linearize=4)`` does not reach the hybrid:
    ``CONFIG`` is already all-linear, and linearizing keeps it so."""
    return getattr(_module(arch_id), variant)
