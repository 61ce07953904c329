from repro_torch.kernels.mws.ops import mws_gather, mws_reduce, parabit_reduce
from repro_torch.kernels.mws.ref import mws_gather_ref, mws_reduce_ref

__all__ = ["mws_gather", "mws_reduce", "parabit_reduce", "mws_gather_ref", "mws_reduce_ref"]
