"""Wrapper of the one-pass reduce + count kernel (``csrc/mws_count.cu``).

The paper's BMI query ("how many users were active on every one of the
last d days") in one pass: the ``op``-reduction of an (N, W) day stack
and its population count, with only a scalar leaving the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core.bitops import BitOp
from repro_torch.kernels import _build
from repro_torch.kernels.mws_count.ref import mws_count_ref

_OP_CODES = {BitOp.AND: 0, BitOp.OR: 1, BitOp.XOR: 2}


def mws_count(stack: torch.Tensor, op: BitOp) -> torch.Tensor:
    """Population count of the ``op``-reduction of an (N, W) word stack
    -> () int32, for every :class:`BitOp` (inverted ops complement the
    reduced words before counting).

    Any N >= 1 and W: the kernel reads exactly N * W words, so there is no
    padding and no correction.  The count is kept in 64 bits and returned
    as int32, as the reference returns it; a row width whose count could
    reach 2^31 (32 * W >= 2^31) raises instead of wrapping.
    """
    if stack.dim() != 2 or stack.shape[0] == 0:
        raise ValueError(f"expected a non-empty (N, W) stack, got {tuple(stack.shape)}")
    N, W = stack.shape
    if 32 * W >= 2**31:
        raise ValueError(f"{W} words per row overflow an int32 count")
    if _build.on_cpu(stack):
        return mws_count_ref(stack, op)
    _build.check_words(stack, "stack", 2)
    out = torch.zeros((1,), dtype=torch.int64, device=stack.device)
    if W:
        _build.launch(
            "mws_count_launch",
            stack.data_ptr(),
            out.data_ptr(),
            N,
            W,
            _OP_CODES[op.base],
            int(op.inverted),
            _build.vec_width(W, stack),
        )
        mws_count.launches += 1
    return out[0].to(torch.int32)


mws_count.launches = 0
