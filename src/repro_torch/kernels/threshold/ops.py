"""Wrapper of the k-of-n threshold kernel (``csrc/threshold.cu``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.threshold.ref import threshold_ref

MAX_ROWS = 8  # THRESHOLD_MAX_BLOCKS: one sensing activates <= 8 blocks
_MAX_GRID_Y = 65535


def threshold_reduce(
    x: torch.Tensor, k: int, *, invert: bool = False
) -> torch.Tensor:
    """Per-bit ``count-of-set-rows >= k``: (n, W) -> (W,) or, batched,
    (B, n, W) -> (B, W); complemented after the comparison when
    ``invert``.  Needs 1 <= k <= n <= 8."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    if x.dim() != 3:
        raise ValueError(f"expected (n, W) or (B, n, W) words, got {tuple(x.shape)}")
    B, n, W = x.shape
    if not 1 <= n <= MAX_ROWS:
        raise ValueError(f"threshold over {n} rows: 1..{MAX_ROWS} supported")
    if not 1 <= k <= n:
        raise ValueError(f"threshold k={k} outside 1..{n} rows")
    if _build.on_cpu(x):
        out = threshold_ref(x, k, invert=invert)
        return out[0] if squeeze else out
    _build.check_words(x, "x", 3)
    if B > _MAX_GRID_Y:
        raise ValueError(f"batch {B} exceeds the launch grid")
    out = torch.empty((B, W), dtype=torch.int32, device=x.device)
    if B and W:
        _build.launch(
            "threshold_launch",
            x.data_ptr(),
            out.data_ptr(),
            B,
            n,
            W,
            k,
            int(invert),
            _build.vec_width(W, x, out),
        )
        threshold_reduce.launches += 1
    return out[0] if squeeze else out


threshold_reduce.launches = 0
