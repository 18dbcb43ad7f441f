"""whisper-base — enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified].

Same values as ``repro/configs/whisper_base.py``: 6 encoder layers
(bidirectional) + 6 decoder layers; one decoder layer = (self-attn,
cross-attn + MLP) = two pattern entries, so n_layers=12 with a length-2
pattern. The audio conv frontend is a stub: the model takes (B, 1500,
d_model) frame embeddings. RMSNorm instead of biased LayerNorm, RoPE
instead of learned positions, as in the reference.
"""
from repro_torch.configs.base import EncoderConfig, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=12, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51865,
    rope_theta=10000.0, norm_eps=1e-5, mlp_act="gelu",
    tie_embeddings=True,
    pattern=(LayerSpec(mixer="softmax", mlp="none"),
             LayerSpec(mixer="cross", mlp="dense")),
    encoder=EncoderConfig(n_layers=6, n_frames=1500),
    source="[arXiv:2212.04356; unverified]",
)

SMOKE = ModelConfig(
    name="whisper-base-smoke", family="audio",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
    vocab_size=512, mlp_act="gelu",
    pattern=(LayerSpec(mixer="softmax", mlp="none"),
             LayerSpec(mixer="cross", mlp="dense")),
    encoder=EncoderConfig(n_layers=2, n_frames=16),
)
