"""deepseek-v2-lite-16b [moe]: 27L d=2048 16H ff_expert=1408 V=102400.

MLA (kv_lora=512, decoupled-RoPE head 64, nope 128, v 128); MoE with 64
routed experts top-6 + 2 shared experts; first layer dense (ff=10944).

Assigned-table note: the table reads "MoE 64e top-6 … 2 shared+160 routed";
160 routed is the *full* DeepSeek-V2 — per instructions the assigned numbers
(64 experts, top-6) win, recorded in DESIGN.md.  [arXiv:2405.04434; hf]
"""

from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    rope_theta=1e4,
    activation="silu",
    norm="rmsnorm",
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        num_shared=2,
        d_ff_expert=1408,
        capacity_factor=1.25,
        first_dense_layers=1,
        d_ff_dense=10944,
    ),
    mla=MLAConfig(
        kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128, v_head_dim=128
    ),
    subquadratic=False,
)
