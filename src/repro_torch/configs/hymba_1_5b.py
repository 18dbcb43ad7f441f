"""hymba-1.5b — parallel attention + SSM heads [arXiv:2411.13676; hf].

Every layer runs GQA attention (25 query heads, 5 KV heads of 64) and SSD
heads (d_state 16, headdim 64) side by side and averages them. ``CONFIG``
marks its global (unwindowed) layers statically in an 8-position pattern
(layers 0, 8, 16, 24); the other layers attend a 1024-token window.
``SMOKE`` is a single-position pattern, whose global layers are the
first, middle and last (``models.model.hymba_global_flags``). Same
values as ``repro/configs/hymba_1_5b.py``.
"""
from repro_torch.configs.base import LayerSpec, MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    rope_theta=10000.0, norm_eps=1e-5,
    pattern=(LayerSpec(mixer="hymba", mlp="dense", is_global=True),)
    + tuple(LayerSpec(mixer="hymba", mlp="dense", sliding_window=1024,
                      is_global=False) for _ in range(7)),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=1, headdim=64, ngroups=1),
    source="[arXiv:2411.13676; hf]",
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=512, head_dim=16,
    pattern=(LayerSpec(mixer="hymba", mlp="dense", sliding_window=16),),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=1, headdim=16, ngroups=1),
)
