"""xlstm-350m [ssm]: 24L d=1024 4H V=50304, d_ff=0 (no MLP; block-internal
projections only).  Alternating mLSTM/sLSTM blocks (12 pairs), per the
assigned table's "sLSTM + mLSTM blocks".  Runs long_500k (O(1)-state
decode).  [arXiv:2405.04517]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    use_rope=False,
    activation="silu",
    norm="rmsnorm",
    subquadratic=True,
)
