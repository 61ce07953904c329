"""Plain PyTorch popcount (the kernel's oracle)."""

from __future__ import annotations

import torch

# SWAR masks (Hacker's Delight §5-1); all below 2^31, so valid int32
_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F
_H01 = 0x01010101


def swar_popcount(v: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 words.  Every arithmetic right shift is
    followed by a mask with bit 31 clear, and the byte sum in the top byte
    of ``v * H01`` is at most 32, so the signed arithmetic is exact."""
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    return (v * _H01) >> 24


def popcount_ref(words: torch.Tensor) -> torch.Tensor:
    """Per-row population count: (R, W) int32 words -> (R,) int32."""
    return swar_popcount(words).sum(dim=-1, dtype=torch.int32)
