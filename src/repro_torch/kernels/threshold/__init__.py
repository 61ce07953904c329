from repro_torch.kernels.threshold.ops import threshold_reduce
from repro_torch.kernels.threshold.ref import bitslice_threshold, threshold_ref

__all__ = ["threshold_reduce", "bitslice_threshold", "threshold_ref"]
