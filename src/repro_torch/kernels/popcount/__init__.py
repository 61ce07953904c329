from repro_torch.kernels.popcount.ops import popcount
from repro_torch.kernels.popcount.ref import popcount_ref

__all__ = ["popcount", "popcount_ref"]
