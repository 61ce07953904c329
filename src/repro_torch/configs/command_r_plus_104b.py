"""command-r-plus-104b [dense]: 64L d=12288 96H GQA kv=8 ff=33792 V=256000.

GQA, no biases, large vocabulary.  [hf:CohereForAI/c4ai-command-r-v01]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256000,
    rope_theta=75e5,
    attn_bias=False,
    mlp_bias=False,
    activation="silu",
    norm="layernorm",
    subquadratic=False,
)
