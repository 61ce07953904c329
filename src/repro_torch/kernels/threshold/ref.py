"""The bit-sliced k-of-n counter, shared by the plain version of the
threshold kernel and the expression oracle (``core.engine.eval_expr``)."""

from __future__ import annotations

import torch

MAX_COUNT_BITS = 4  # bit-sliced counter planes; holds counts <= 15


def bitslice_threshold(anded: torch.Tensor, k: int, n_blocks: int) -> torch.Tensor:
    """``count >= k`` per bit over the rows of ``anded`` (axis -2).

    ``anded`` is a ``(..., rows, W)`` int32 stack (rows beyond
    ``n_blocks`` are ignored); returns the ``(..., 1, W)`` threshold
    bitmap.  A 4-plane ripple-carry counter and an unrolled equality
    comparator, exactly as the Pallas kernel's body; explicit loops only.
    """
    c = [torch.zeros_like(anded[..., :1, :]) for _ in range(MAX_COUNT_BITS)]
    for r in range(n_blocks):
        carry = anded[..., r : r + 1, :]
        for j in range(MAX_COUNT_BITS):
            t = c[j] & carry
            c[j] = c[j] ^ carry
            carry = t
    out = torch.zeros_like(anded[..., :1, :])
    for v in range(k, n_blocks + 1):
        term = None
        for j in range(MAX_COUNT_BITS):
            plane = c[j] if (v >> j) & 1 else ~c[j]
            term = plane if term is None else term & plane
        out = out | term
    return out


def threshold_ref(x: torch.Tensor, k: int, *, invert: bool = False) -> torch.Tensor:
    """(..., n, W) -> (..., W): bit set iff at least ``k`` of the n rows
    have it set; complemented after the comparison when ``invert``."""
    out = bitslice_threshold(x, k, x.shape[-2]).squeeze(-2)
    return ~out if invert else out
