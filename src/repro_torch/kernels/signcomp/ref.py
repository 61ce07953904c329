"""Plain PyTorch sign compression (the kernels' oracles).

Packing layout, as in the reference: bit ``b`` of ``words[r, c]`` is the
sign (1 = non-negative) of ``x[32*r + b, c]`` — packing runs down the row
axis, so the lane axis is never reshaped.  The sign test is ``x >= 0``
as the reference computes it: XLA (on the CPU and the TPU) flushes
subnormal inputs to zero, so a negative subnormal reads as ``-0.0``.
Hence ``x > -FLT_MIN``: ``-0.0`` and ``-1e-45`` pack to 1, NaN to 0.
Words are ``torch.int32`` bit patterns; every word is assembled with an
OR fold, so no sum is promoted.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

WORD_BITS = 32
_NEG_MIN_NORMAL = -torch.finfo(torch.float32).tiny


def sign_bits(x: torch.Tensor) -> torch.Tensor:
    """1 where ``x >= 0`` once subnormals are flushed to zero, else 0."""
    return (x.float() > _NEG_MIN_NORMAL).to(torch.int32)


def pack_signs_ref(x: torch.Tensor) -> torch.Tensor:
    """(32*R, W) float -> (R, W) int32 words of :func:`sign_bits`."""
    m, w = x.shape
    if m % WORD_BITS:
        raise ValueError(f"rows {m} are not a multiple of {WORD_BITS}")
    bits = sign_bits(x).reshape(m // WORD_BITS, WORD_BITS, w)
    out = bits[:, 0]
    for b in range(1, WORD_BITS):
        out = out | (bits[:, b] << b)
    return out


def unpack_signs_ref(words: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(R, W) int32 words -> (32*R, W) of ±1 in ``dtype``."""
    r, w = words.shape
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    # arithmetic >> is safe here: the & 1 keeps only bit 0 of each shift
    bits = (words[:, None, :] >> shifts[None, :, None]) & 1
    return (bits * 2 - 1).reshape(r * WORD_BITS, w).to(dtype)


def majority_ref(stacks: torch.Tensor) -> torch.Tensor:
    """(K, R, W) int32 words -> (R, W) words of the per-bit majority.

    Ties (possible only for even K) vote positive: bit = (2*sum >= K).
    """
    k = stacks.shape[0]
    if k < 1:
        raise ValueError("majority of no planes")
    acc = torch.zeros(stacks.shape[1:], dtype=torch.int32, device=stacks.device)
    for b in range(WORD_BITS):
        sb = ((stacks >> b) & 1).sum(dim=0, dtype=torch.int32)
        acc = acc | ((2 * sb >= k).to(torch.int32) << b)
    return acc


def compress_signs_ref(flat: torch.Tensor, lanes: int) -> torch.Tensor:
    """Flat (n,) -> (R, lanes) words: zero-pad to 32*lanes*R, then pack."""
    rows = -(-flat.shape[0] // (WORD_BITS * lanes))
    padded = F.pad(flat, (0, rows * WORD_BITS * lanes - flat.shape[0]))
    return pack_signs_ref(padded.reshape(rows * WORD_BITS, lanes))


def decompress_signs_ref(words: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """(R, W) words -> the first n of the unpacked ±1 values, flat."""
    return unpack_signs_ref(words, dtype).reshape(-1)[:n]
