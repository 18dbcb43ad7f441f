"""llama-3.2-vision-90b — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision (arch); unverified].

Same values as ``repro/configs/llama3_2_vision_90b.py``: 100 layers = 20 x
(4 self-attention + 1 image cross-attention). The vision frontend is a
stub: the model takes (B, 1601, d_model) patch embeddings (one 560px
tile).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab_size=128256,
    rope_theta=500000.0, norm_eps=1e-5,
    pattern=(
        LayerSpec(mixer="softmax", mlp="dense"),
        LayerSpec(mixer="softmax", mlp="dense"),
        LayerSpec(mixer="softmax", mlp="dense"),
        LayerSpec(mixer="softmax", mlp="dense"),
        LayerSpec(mixer="cross", mlp="dense"),
    ),
    n_image_tokens=1601,
    source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-90b-smoke", family="vlm",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=512,
    pattern=(
        LayerSpec(mixer="softmax", mlp="dense"),
        LayerSpec(mixer="softmax", mlp="dense"),
        LayerSpec(mixer="softmax", mlp="dense"),
        LayerSpec(mixer="softmax", mlp="dense"),
        LayerSpec(mixer="cross", mlp="dense"),
    ),
    n_image_tokens=8,
)
