"""recurrentgemma-2b [hybrid]: 26L d=2560 10H MQA kv=1 ff=7680 V=256000.

RG-LRU + local attention (window 2048), pattern (rec, rec, attn) — 8 triples
+ 2 remainder recurrent layers = 26.  Runs long_500k (O(window) decode
state).  [arXiv:2402.19427; hf]
"""

from repro_torch.models.config import ArchConfig, HybridConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    rope_theta=1e4,
    activation="gelu",
    norm="rmsnorm",
    hybrid=HybridConfig(
        pattern=("recurrent", "recurrent", "attention"),
        window=2048,
        conv_width=4,
    ),
    subquadratic=True,
)
