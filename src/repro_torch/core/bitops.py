"""Packed bit-plane tensors and the bulk bitwise op algebra.

The data model of the PyTorch port: a "page" (one NAND wordline's worth of
data in the paper) is one packed row of 32-bit words.  A stack of operands
is a ``(num_operands, num_words)`` tensor, the layout analogue of
co-locating operands in one NAND block so one MWS sensing covers them all.

Words are ``torch.int32`` bit patterns: on the CPU, torch has no ``~``,
``>>``, ``-`` or comparisons for ``torch.uint32``, while ``int32`` has all
of them.  Host-side numpy keeps ``uint32``; :func:`to_words` and
:func:`to_uint32` convert by reinterpreting the bits, never the values.

Bit ``i`` of the logical vector lives at word ``i // 32``, bit ``i % 32``
(LSB-first), matching ``numpy.packbits(..., bitorder='little')`` on a
uint32 view.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

WORD_BITS = 32
WORD_DTYPE = torch.int32
_FULL = np.uint32(0xFFFFFFFF)


class BitOp(enum.Enum):
    """Bulk bitwise ops supported by Flash-Cosmos (paper §4.1, §6.1)."""

    AND = "and"
    OR = "or"
    XOR = "xor"
    NAND = "nand"
    NOR = "nor"
    XNOR = "xnor"

    @property
    def base(self) -> "BitOp":
        """The non-inverted reduction this op is built on (inverse read)."""
        return {
            BitOp.AND: BitOp.AND,
            BitOp.NAND: BitOp.AND,
            BitOp.OR: BitOp.OR,
            BitOp.NOR: BitOp.OR,
            BitOp.XOR: BitOp.XOR,
            BitOp.XNOR: BitOp.XOR,
        }[self]

    @property
    def inverted(self) -> bool:
        """Whether the result is complemented (paper: inverse-read mode)."""
        return self in (BitOp.NAND, BitOp.NOR, BitOp.XNOR)

    @property
    def identity_word(self) -> np.uint32:
        """Reduction identity for the *base* op, as a packed word."""
        return _FULL if self.base is BitOp.AND else np.uint32(0)


def num_words(num_bits: int) -> int:
    return -(-num_bits // WORD_BITS)


def to_words(words, device=None) -> torch.Tensor:
    """Host ``uint32`` words -> an ``int32`` tensor with the same bits."""
    arr = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(device)


def to_uint32(words: torch.Tensor) -> np.ndarray:
    """An ``int32`` word tensor -> host ``uint32`` words with the same bits."""
    return words.detach().cpu().numpy().view(np.uint32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a {0,1} tensor of shape (..., L) into (..., ceil(L/32)) int32.

    Padding bits (when L % 32 != 0) are packed as 0; callers that reduce with
    AND must mask with :func:`valid_mask` (the engine does this).  The words
    are assembled with an OR fold, so no sum is promoted past 32 bits.
    """
    L = bits.shape[-1]
    W = num_words(L)
    pad = W * WORD_BITS - L
    b = bits.to(WORD_DTYPE)
    if pad:
        b = torch.cat([b, b.new_zeros(b.shape[:-1] + (pad,))], dim=-1)
    b = b.reshape(b.shape[:-1] + (W, WORD_BITS))
    out = b[..., 0]
    for s in range(1, WORD_BITS):
        out = out | (b[..., s] << s)
    return out


def unpack_bits(words: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (..., W) int32 -> (..., num_bits) uint8."""
    shifts = torch.arange(WORD_BITS, dtype=WORD_DTYPE, device=words.device)
    # arithmetic >> is safe here: the & 1 keeps only bit 0 of each shift
    bits = (words[..., None] >> shifts) & 1
    bits = bits.reshape(words.shape[:-1] + (words.shape[-1] * WORD_BITS,))
    return bits[..., :num_bits].to(torch.uint8)


def valid_mask(num_bits: int) -> np.ndarray:
    """Per-word mask with 1s at valid bit positions for a length-num_bits vector."""
    W = num_words(num_bits)
    mask = np.full((W,), _FULL, dtype=np.uint32)
    rem = num_bits % WORD_BITS
    if rem:
        mask[-1] = np.uint32((1 << rem) - 1)
    return mask


@dataclass(frozen=True)
class BitVector:
    """A logical bit vector backed by packed words.

    ``words``: (..., W) packed words (an int32 tensor, or host uint32
    words as a query result returns them); ``length``: valid bits.
    """

    words: object
    length: int

    @classmethod
    def from_bits(cls, bits: torch.Tensor) -> "BitVector":
        return cls(pack_bits(bits), bits.shape[-1])

    def _tensor(self) -> torch.Tensor:
        w = self.words
        return w if isinstance(w, torch.Tensor) else to_words(w)

    def to_bits(self) -> torch.Tensor:
        return unpack_bits(self._tensor(), self.length)

    @property
    def num_words(self) -> int:
        return self.words.shape[-1]

    def masked(self) -> "BitVector":
        """Zero the padding bits (needed before popcount / after NOT-like ops)."""
        w = self._tensor()
        mask = to_words(valid_mask(self.length), w.device)
        return BitVector(w & mask, self.length)


_FOLDS = {
    BitOp.AND: torch.bitwise_and,
    BitOp.OR: torch.bitwise_or,
    BitOp.XOR: torch.bitwise_xor,
}


def reduce_words(stack: torch.Tensor, op: BitOp) -> torch.Tensor:
    """Plain word-level reduction over the operand axis (axis 0).

    This is the *semantic* definition of an MWS operation; the CUDA kernel
    in ``repro_torch.kernels.mws`` must match it bit-exactly (see tests).
    Folds explicitly, one operand at a time.
    """
    fn = _FOLDS[op.base]
    out = stack[0]
    for i in range(1, stack.shape[0]):
        out = fn(out, stack[i])
    if op.inverted:
        out = ~out
    return out
