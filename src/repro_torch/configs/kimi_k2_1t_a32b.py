"""kimi-k2-1t-a32b [moe]: 61L d=7168 64H GQA kv=8 ff_expert=2048 V=163840.

Trillion-parameter MoE: 384 routed experts top-8 + 1 shared expert; first
layer dense.  The assigned table specifies GQA kv=8 (the released K2 uses
MLA; assigned numbers win — noted in DESIGN.md).  head_dim = d/H = 112.
[arXiv:2501.kimi2 (paper-table)]
"""

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    rope_theta=5e7,
    activation="silu",
    norm="rmsnorm",
    moe=MoEConfig(
        num_experts=384,
        top_k=8,
        num_shared=1,
        d_ff_expert=2048,
        capacity_factor=1.25,
        first_dense_layers=1,
        d_ff_dense=11264,
    ),
    # 1T-scale: bf16 optimizer moments keep state per chip inside HBM on the
    # multi-pod mesh (see EXPERIMENTS.md §Dry-run memory table).
    optimizer_dtype="bfloat16",
    subquadratic=False,
)
