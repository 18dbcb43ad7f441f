"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B; hf].

Deviation kept from the reference: Moonlight's first layer is dense; all
48 layers are modelled as MoE (+2 shared experts) so the stack is one
repeated layer.

Same values as ``repro/configs/moonshot_v1_16b_a3b.py``.
"""
from repro_torch.configs.base import LayerSpec, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=163840,
    rope_theta=50000.0, norm_eps=1e-5,
    pattern=(LayerSpec(mixer="softmax", mlp="moe"),),
    moe=MoEConfig(num_experts=64, top_k=6, capacity_factor=1.25,
                  n_shared_experts=2),
    source="[hf:moonshotai/Moonlight-16B-A3B; hf]",
)

SMOKE = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
    vocab_size=512,
    pattern=(LayerSpec(mixer="softmax", mlp="moe"),),
    # capacity_factor = E/k ⇒ cap == T: drop-free routing, so smoke
    # parity tests (prefill+decode == forward) are exact.
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=4.0,
                  n_shared_experts=2),
)
