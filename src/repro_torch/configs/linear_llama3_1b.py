"""Linear-Llama3-1B, the paper's own evaluation model (paper §4).

Llama3-style 1B: 16 layers, d_model 2048, 16 heads of 128, SwiGLU d_ff
5504, vocab 128256, untied embeddings. ``CONFIG`` is the pure-linear basic
variant (identity feature map, no decay); ``HYBRID`` the paper's 1/4
LASP-2H hybrid (every 4th layer softmax attention with a 2048-token
window); ``DENSE`` the softmax baseline; ``SMOKE`` is the reduced config
the CPU tests run. Same values as ``repro/configs/linear_llama3_1b.py``.
"""

import dataclasses

from repro_torch.configs.base import LayerSpec, LinearAttnConfig, ModelConfig

DENSE = ModelConfig(
    name="llama3-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=5504, vocab_size=128256,
    rope_theta=500000.0, norm_eps=1e-5,
    pattern=(LayerSpec(mixer="softmax", mlp="dense"),),
    source="[paper §4 Linear-Llama3; arXiv Llama-3 herd]",
)

CONFIG = dataclasses.replace(
    DENSE.linearize(), name="linear-llama3-1b",
    linear_attn=LinearAttnConfig(feature_map="identity", decay="none",
                                 backward="faithful"))

HYBRID = dataclasses.replace(
    DENSE.linearize(hybrid_every=4), name="linear-llama3-1b-hybrid4",
    linear_attn=LinearAttnConfig(feature_map="identity", decay="none",
                                 backward="faithful"))

SMOKE = ModelConfig(
    name="linear-llama3-1b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
    vocab_size=512,
    pattern=(LayerSpec(mixer="linear", mlp="dense"),),
    linear_attn=LinearAttnConfig(feature_map="identity", decay="none"),
)
