"""yi-34b [dense]: 60L d=7168 56H GQA kv=8 ff=20480 V=64000.

llama-architecture GQA, RMSNorm, SwiGLU.  [arXiv:2403.04652; hf]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    rope_theta=5e6,
    activation="silu",
    norm="rmsnorm",
    subquadratic=False,
)
