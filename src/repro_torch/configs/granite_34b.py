"""granite-34b — llama-arch, code, MQA (kv=1) [arXiv:2405.04324; hf].

Same values as ``repro/configs/granite_34b.py``.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152,
    rope_theta=10000.0, norm_eps=1e-5, mlp_act="gelu",
    pattern=(LayerSpec(mixer="softmax", mlp="dense"),),
    source="[arXiv:2405.04324; hf]",
)

SMOKE = ModelConfig(
    name="granite-34b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=160,
    vocab_size=512, rope_theta=10000.0,
    pattern=(LayerSpec(mixer="softmax", mlp="dense"),),
)
