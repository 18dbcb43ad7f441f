"""starcoder2-15b — GQA, RoPE [arXiv:2402.19173; hf].

Same values as ``repro/configs/starcoder2_15b.py``.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab_size=49152,
    rope_theta=100000.0, norm_eps=1e-5, mlp_act="gelu",
    pattern=(LayerSpec(mixer="softmax", mlp="dense"),),
    source="[arXiv:2402.19173; hf]",
)

SMOKE = ModelConfig(
    name="starcoder2-15b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=512, rope_theta=100000.0,
    pattern=(LayerSpec(mixer="softmax", mlp="dense"),),
)
