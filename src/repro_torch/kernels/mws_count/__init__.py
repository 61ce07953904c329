from repro_torch.kernels.mws_count.ops import mws_count
from repro_torch.kernels.mws_count.ref import mws_count_ref

__all__ = ["mws_count", "mws_count_ref"]
