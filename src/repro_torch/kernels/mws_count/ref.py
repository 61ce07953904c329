"""Plain PyTorch version of the one-pass reduce + count (the kernel's oracle)."""

from __future__ import annotations

import torch

from repro_torch.core.bitops import BitOp
from repro_torch.kernels.mws.ref import mws_reduce_ref
from repro_torch.kernels.popcount.ref import swar_popcount


def mws_count_ref(stack: torch.Tensor, op: BitOp) -> torch.Tensor:
    """Bit count of the ``op``-reduction over the operand axis: (N, W)
    int32 words -> () int32.  Summed in int64; the wrapper refuses widths
    whose count could pass 2^31."""
    reduced = mws_reduce_ref(stack, op)
    return swar_popcount(reduced).sum(dtype=torch.int64).to(torch.int32)
