"""codeqwen1.5-7b — qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B; hf].

Same values as ``repro/configs/codeqwen1_5_7b.py``.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab_size=92416,
    qkv_bias=True, rope_theta=1_000_000.0, norm_eps=1e-6,
    pattern=(LayerSpec(mixer="softmax", mlp="dense"),),
    source="[hf:Qwen/CodeQwen1.5-7B; hf]",
)

SMOKE = ModelConfig(
    name="codeqwen1.5-7b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
    vocab_size=512, qkv_bias=True, rope_theta=1_000_000.0, norm_eps=1e-6,
    pattern=(LayerSpec(mixer="softmax", mlp="dense"),),
)
