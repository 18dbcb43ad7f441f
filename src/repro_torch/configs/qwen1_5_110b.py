"""qwen1.5-110b — QKV bias [hf:Qwen/Qwen1.5-0.5B (family); hf].

Same values as ``repro/configs/qwen1_5_110b.py``.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab_size=152064,
    qkv_bias=True, rope_theta=1_000_000.0, norm_eps=1e-6,
    pattern=(LayerSpec(mixer="softmax", mlp="dense"),),
    source="[hf:Qwen/Qwen1.5-110B (dims); hf]",
)

SMOKE = ModelConfig(
    name="qwen1.5-110b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=192,
    vocab_size=512, qkv_bias=True, rope_theta=1_000_000.0, norm_eps=1e-6,
    pattern=(LayerSpec(mixer="softmax", mlp="dense"),),
)
