"""Wrapper of the popcount kernel (``csrc/popcount.cu``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.popcount.ref import popcount_ref

_MAX_GRID_Y = 65535


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Population count per row: (W,) -> () or (R, W) -> (R,) int32."""
    squeeze = words.dim() == 1
    if squeeze:
        words = words[None]
    if words.dim() != 2:
        raise ValueError(f"expected (W,) or (R, W) words, got {tuple(words.shape)}")
    if _build.on_cpu(words):
        out = popcount_ref(words)
        return out[0] if squeeze else out
    _build.check_words(words, "words", 2)
    R, W = words.shape
    if 32 * W >= 2**31:
        raise ValueError(f"{W} words per row overflow an int32 count")
    if R > _MAX_GRID_Y:
        raise ValueError(f"{R} rows exceed the launch grid")
    out = torch.empty((R,), dtype=torch.int32, device=words.device)
    if R and W:
        _build.launch(
            "popcount_launch",
            words.data_ptr(),
            out.data_ptr(),
            R,
            W,
            _build.vec_width(W, words),
        )
        popcount.launches += 1
    else:
        out.zero_()
    return out[0] if squeeze else out


popcount.launches = 0
