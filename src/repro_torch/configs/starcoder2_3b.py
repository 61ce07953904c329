"""starcoder2-3b [dense]: 30L d=3072 24H GQA kv=2 ff=12288 V=49152.

GQA + RoPE, learned biases on attention/MLP (StarCoder2 uses biases),
gelu MLP.  [arXiv:2402.19173; hf]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    rope_theta=1e5,
    attn_bias=True,
    mlp_bias=True,
    activation="gelu",
    norm="layernorm",
    subquadratic=False,
)
