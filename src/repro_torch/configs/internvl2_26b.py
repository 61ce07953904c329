"""internvl2-26b [vlm]: 48L d=6144 48H GQA kv=8 ff=16384 V=92553.

InternLM2-style dense decoder backbone; the InternViT vision frontend is a
STUB — ``input_specs()`` provides precomputed patch embeddings that are
prepended to the token stream.  [arXiv:2404.16821; hf]
"""

from repro_torch.models.config import ArchConfig

NUM_PATCH_TOKENS = 256  # one tile of InternViT-6B output after pixel-shuffle

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    rope_theta=1e6,
    activation="silu",
    norm="rmsnorm",
    num_patch_tokens=NUM_PATCH_TOKENS,
    subquadratic=False,
)
