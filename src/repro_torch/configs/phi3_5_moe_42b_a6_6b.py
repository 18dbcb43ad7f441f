"""phi3.5-moe-42b-a6.6b — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct; hf].

Same values as ``repro/configs/phi3_5_moe_42b_a6_6b.py``.
"""
from repro_torch.configs.base import LayerSpec, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab_size=32064,
    rope_theta=10000.0, norm_eps=1e-5,
    pattern=(LayerSpec(mixer="softmax", mlp="moe"),),
    moe=MoEConfig(num_experts=16, top_k=2, capacity_factor=1.25),
    source="[hf:microsoft/Phi-3.5-MoE-instruct; hf]",
)

SMOKE = ModelConfig(
    name="phi3.5-moe-42b-a6.6b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=512,
    pattern=(LayerSpec(mixer="softmax", mlp="moe"),),
    moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=2.0),
)
