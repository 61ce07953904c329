"""granite-8b [dense]: 36L d=4096 32H GQA kv=8 ff=14336 V=49152.

llama-architecture code model.  [arXiv:2405.04324; hf]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    rope_theta=1e4,
    activation="silu",
    norm="rmsnorm",
    subquadratic=False,
)
