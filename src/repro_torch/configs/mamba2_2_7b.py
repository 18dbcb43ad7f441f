"""mamba2-2.7b — SSD (state-space duality) [arXiv:2405.21060; unverified].

d_inner = 2*2560 = 5120, 80 SSD heads of headdim 64, d_state 128, no MLP.
SSD is chunked decayed linear attention (q = C, k = B, v = x·dt, log a =
−exp(a_log)·dt), so the chunk kernels and LASP-2 apply as they are. Same
values as ``repro/configs/mamba2_2_7b.py``.
"""
from repro_torch.configs.base import LayerSpec, MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=80, n_kv_heads=80,
    d_ff=0, vocab_size=50280, head_dim=64,
    norm_eps=1e-5,
    pattern=(LayerSpec(mixer="mamba2", mlp="none"),),
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, headdim=64,
                      ngroups=1),
    source="[arXiv:2405.21060; unverified]",
)

SMOKE = ModelConfig(
    name="mamba2-2.7b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=8, d_ff=0,
    vocab_size=512, head_dim=16,
    pattern=(LayerSpec(mixer="mamba2", mlp="none"),),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, headdim=16,
                      ngroups=1),
)
