"""whisper-medium [audio]: 24L enc + 24L dec, d=1024 16H MHA kv=16 ff=4096
V=51865.  Conv/mel frontend STUBBED — input_specs() provides precomputed
frame embeddings.  Absolute positions (no RoPE), LayerNorm, GELU.
[arXiv:2212.04356]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,  # decoder layers
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    use_rope=False,
    attn_bias=True,
    mlp_bias=True,
    activation="gelu",
    norm="layernorm",
    subquadratic=False,
)
