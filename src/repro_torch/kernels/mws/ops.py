"""Wrappers of the MWS gather-reduce kernel (``csrc/mws.cu``).

``mws_gather`` is the form the serving path launches: it reads the store
snapshot's rows by index, so the gathered (B, K, N, W) cube of the
reference never exists.  ``mws_reduce`` keeps the reference's
``(N, W) -> (W,)`` contract on the same kernel (identity indices, K = 1).
"""

from __future__ import annotations

import torch

from repro_torch.core.bitops import BitOp
from repro_torch.kernels import _build
from repro_torch.kernels.mws.ref import mws_gather_ref

_OP_CODES = {BitOp.AND: 0, BitOp.OR: 1, BitOp.XOR: 2}
_MAX_GRID_Y = 65535


def mws_gather(
    src: torch.Tensor,
    idx: torch.Tensor,
    op: BitOp = BitOp.AND,
    *,
    outer_or: bool = True,
    invert: bool = False,
    ext: torch.Tensor | None = None,
    shr: torch.Tensor | None = None,
) -> torch.Tensor:
    """Gather-reduce rows of ``src`` (S, W) by ``idx`` (B, K, N) int32.

    ``out[b] = post(OR_k (op_n row(idx[b, k, n])))``, or (B, K, W) per
    block when ``outer_or`` is False; ``post`` complements when
    ``invert``.  A negative index ``-1 - j`` names substituted row ``j``:
    ``ext[b, j]`` (ext is (B, M, W)) for ``j < M``, else ``shr[j - M]``.
    Indices are not range-checked here; callers build them from store
    slots (see :func:`repro_torch.query.device.encode_idx`).
    """
    if op not in _OP_CODES:
        raise ValueError(f"inner op must be AND/OR/XOR, got {op}")
    if src.dim() != 2 or idx.dim() != 3:
        raise ValueError(
            f"expected src (S, W) and idx (B, K, N), got {tuple(src.shape)} "
            f"and {tuple(idx.shape)}"
        )
    if src.device.type == "cpu":
        return mws_gather_ref(
            src, idx, op, outer_or=outer_or, invert=invert, ext=ext, shr=shr
        )
    _build.check_words(src, "src", 2)
    _build.check_words(idx, "idx", 3)
    B, K, N = idx.shape
    W = src.shape[1]
    if ext is not None:
        _build.check_words(ext, "ext", 3)
        if ext.shape[0] != B or ext.shape[2] != W:
            raise ValueError(f"ext must be ({B}, M, {W}), got {tuple(ext.shape)}")
    if shr is not None:
        _build.check_words(shr, "shr", 2)
        if shr.shape[1] != W:
            raise ValueError(f"shr must be (M, {W}), got {tuple(shr.shape)}")
    if N == 0 or K == 0:
        raise ValueError("idx needs at least one block and one wordline")
    out = torch.empty(
        (B, W) if outer_or else (B, K, W), dtype=torch.int32, device=src.device
    )
    if B == 0 or W == 0:
        return out
    if (B if outer_or else B * K) > _MAX_GRID_Y:
        raise ValueError(f"batch {B} x blocks {K} exceeds the launch grid")
    _build.launch(
        "mws_gather_launch",
        src.data_ptr(),
        None if ext is None else ext.data_ptr(),
        None if shr is None else shr.data_ptr(),
        idx.data_ptr(),
        out.data_ptr(),
        B,
        K,
        N,
        W,
        0 if ext is None else ext.shape[1],
        _OP_CODES[op],
        int(outer_or),
        int(invert),
        _build.vec_width(W, src, ext, shr, out),
    )
    mws_gather.launches += 1
    return out


mws_gather.launches = 0


def mws_reduce(stack: torch.Tensor, op: BitOp) -> torch.Tensor:
    """Bitwise ``op``-reduce over axis 0 of an (N, W) word stack -> (W,).

    Any N >= 1 and W: the kernel takes ragged shapes as they are, so
    there is no identity padding to slice back.
    """
    if stack.dim() != 2 or stack.shape[0] == 0:
        raise ValueError(f"expected a non-empty (N, W) stack, got {tuple(stack.shape)}")
    idx = torch.arange(stack.shape[0], dtype=torch.int32, device=stack.device)
    return mws_gather(
        stack, idx.reshape(1, 1, -1), op.base, invert=op.inverted
    )[0]
