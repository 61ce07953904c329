"""Wrappers of the sign-compression kernels (``csrc/signcomp.cu``).

``compress_signs(flat)`` -> packed (R, lanes) int32 sign planes,
``decompress_signs(words, n)`` -> flat ±1 vector,
``majority_vote(stacks)`` -> packed per-bit majority across K planes.

The flat vector is read as a (32*R, lanes) matrix, zero-padded to a
multiple of 32*lanes elements; padded elements pack to 1 (0.0 >= 0) and
are dropped again by ``decompress_signs``.  On the card the kernels take
``n`` and treat indices past it as 0.0, so no padded copy is made.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.signcomp.ref import (
    WORD_BITS,
    compress_signs_ref,
    decompress_signs_ref,
    majority_ref,
)

LANES = 512  # words per packed row; rows of 32*512 = 16384 elements
MAX_VOTERS = 65535  # the kernel's widest bit-sliced counter: 16 planes count to 2^16 - 1


@dataclass(frozen=True)
class SignLayout:
    n: int  # original flat length
    rows: int  # packed rows R
    words: int  # words per row W


def sign_layout(n: int, lanes: int = LANES) -> SignLayout:
    elems_per_row = WORD_BITS * lanes
    padded = -(-n // elems_per_row) * elems_per_row
    return SignLayout(n=n, rows=padded // elems_per_row, words=lanes)


def _check_flat(flat: torch.Tensor) -> None:
    if flat.dim() != 1:
        raise ValueError(f"expected a flat vector, got {tuple(flat.shape)}")
    if flat.shape[0] == 0:
        raise ValueError("cannot compress an empty vector")


def compress_signs(flat: torch.Tensor, *, lanes: int = LANES) -> torch.Tensor:
    """Flat float vector (n,) -> packed (R, lanes) int32 sign planes."""
    _check_flat(flat)
    layout = sign_layout(flat.shape[0], lanes)
    if _build.on_cpu(flat):
        return compress_signs_ref(flat, lanes)
    if flat.dtype != torch.float32:
        raise TypeError(f"the pack kernel takes float32, got {flat.dtype}")
    if not flat.is_contiguous():
        raise ValueError("flat must be contiguous")
    out = torch.empty((layout.rows, lanes), dtype=torch.int32, device=flat.device)
    _build.launch(
        "pack_signs_launch",
        flat.data_ptr(),
        out.data_ptr(),
        layout.n,
        layout.rows,
        lanes,
        _build.vec_width(lanes, flat, out),
    )
    compress_signs.launches += 1
    return out


compress_signs.launches = 0


def decompress_signs(
    words: torch.Tensor, n: int, *, dtype=torch.float32
) -> torch.Tensor:
    """Packed (R, W) int32 words -> flat (n,) of ±1 in ``dtype``."""
    if words.dim() != 2:
        raise ValueError(f"expected (R, W) words, got {tuple(words.shape)}")
    R, W = words.shape
    if not 0 < n <= R * WORD_BITS * W:
        raise ValueError(f"n={n} outside 1..{R * WORD_BITS * W} for {R}x{W} words")
    if _build.on_cpu(words):
        return decompress_signs_ref(words, n, dtype)
    _build.check_words(words, "words", 2)
    out = torch.empty((n,), dtype=torch.float32, device=words.device)
    _build.launch(
        "unpack_signs_launch",
        words.data_ptr(),
        out.data_ptr(),
        n,
        R,
        W,
        _build.vec_width(W, words, out),
    )
    decompress_signs.launches += 1
    return out if dtype == torch.float32 else out.to(dtype)  # ±1 is exact


decompress_signs.launches = 0


def majority_vote(stacks: torch.Tensor) -> torch.Tensor:
    """(K, R, W) packed sign planes -> (R, W) packed majority (ties vote 1)."""
    if stacks.dim() != 3:
        raise ValueError(f"expected (K, R, W) words, got {tuple(stacks.shape)}")
    K, R, W = stacks.shape
    if K < 1:
        raise ValueError("majority of no planes")
    if _build.on_cpu(stacks):
        return majority_ref(stacks)
    _build.check_words(stacks, "stacks", 3)
    if K > MAX_VOTERS:
        raise ValueError(f"{K} planes exceed the kernel's {MAX_VOTERS} voters")
    out = torch.empty((R, W), dtype=torch.int32, device=stacks.device)
    if R and W:
        _build.launch(
            "majority_launch",
            stacks.data_ptr(),
            out.data_ptr(),
            K,
            R * W,
            _build.vec_width(R * W, stacks, out),
        )
        majority_vote.launches += 1
    return out


majority_vote.launches = 0
