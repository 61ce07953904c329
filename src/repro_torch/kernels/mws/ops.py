"""Wrappers of the MWS gather-reduce kernel (``csrc/mws.cu``).

``mws_gather`` is the form the serving path launches: it reads the store
snapshot's rows by index, so the gathered (B, K, N, W) cube of the
reference never exists.  ``mws_reduce`` keeps the reference's
``(N, W) -> (W,)`` contract on the same kernel (identity indices, K = 1).

The kernel has two variants, chosen by :func:`choose_variant` from
shapes alone: ``streaming`` reads every named row once per output row;
``staged`` has each CTA stage a column tile of the launch's distinct rows
in shared memory once and compute every output row from it.
"""

from __future__ import annotations

import torch

from repro_torch.core.bitops import BitOp, reduce_words
from repro_torch.kernels import _build
from repro_torch.kernels.mws.ref import mws_gather_ref

_OP_CODES = {BitOp.AND: 0, BitOp.OR: 1, BitOp.XOR: 2}
_MAX_GRID_Y = 65535
VARIANTS = {"streaming": 0, "staged": 1}

# The staged variant's shared memory (csrc/mws.cu: staged_smem_bytes): a
# 128-byte header, two stages of at least 128 words for every row a launch
# could stage, a table of 2,048 entries, and two ints per stageable row,
# within one block's 227 KB.
_STAGE_HEADER = 128
_TILE_QUANTUM = 128
_STAGE_WORDS = 12288
_TABLE_ENTRIES = 2048
_MAX_SMEM = 232448


def staged_fits(S: int, m_shr: int, entries: int, per_out: int) -> bool:
    """Whether a launch fits the staged variant: its stageable rows (the
    S snapshot slots and m_shr shared rows, or its entries if fewer) at
    the narrowest tile, and one output's ``per_out`` entries in the table."""
    rows = min(S, entries) + m_shr
    words = max(rows * _TILE_QUANTUM, _STAGE_WORDS)
    smem = _STAGE_HEADER + 8 * words + 4 * _TABLE_ENTRIES + 8 * (S + m_shr)
    return smem <= _MAX_SMEM and per_out <= _TABLE_ENTRIES


def choose_variant(
    S: int,
    B: int,
    K: int,
    N: int,
    m_ext: int,
    m_shr: int,
    outer_or: bool = True,
    vec: int = 4,
) -> str:
    """The kernel variant for a launch, from shapes alone (and ``vec``,
    the access width :func:`repro_torch.kernels._build.vec_width` gives).

    A row named by several output rows costs the streaming kernel one
    HBM read per output row that names it, unless the L2 still holds it;
    the staged kernel reads each distinct row once per column tile.  So
    the staged kernel runs where rows can repeat — the launch has more
    than one output row, or names more rows (B·K·N) than there are
    distinct rows it could name — and where its rows fit the two
    stages.  Its stages fill with 16-byte bulk copies, so it also needs
    ``vec`` 4 (W a multiple of 4, aligned bases; the serving path's
    pages always are).  Otherwise the streaming kernel runs: a single
    output row (one plan, or ``mws_reduce``'s identity indices), a store
    too wide to stage, a ragged W, or outputs that each fold one row of
    their own plan's spill scratch (K·N = 1 beside ext rows: nothing
    repeats, and a spill row is read from global memory either way).
    The choice never looks at idx's values, so it needs no host sync.
    """
    n_out = B if outer_or else B * K
    spill_only = K * N == 1 and m_ext > 0
    repeats = (n_out > 1 and not spill_only) or B * K * N > S + B * m_ext + m_shr
    per_out = (K if outer_or else 1) * N
    if vec == 4 and repeats and staged_fits(S, m_shr, B * K * N, per_out):
        return "staged"
    return "streaming"


def _launch(src, idx, op, outer_or, invert, ext, shr, out, vec: int, variant: int) -> None:
    B, K, N = idx.shape
    _build.launch(
        "mws_gather_launch",
        src.data_ptr(),
        None if ext is None else ext.data_ptr(),
        None if shr is None else shr.data_ptr(),
        idx.data_ptr(),
        out.data_ptr(),
        src.shape[0],
        B,
        K,
        N,
        src.shape[1],
        0 if ext is None else ext.shape[1],
        0 if shr is None else shr.shape[0],
        _OP_CODES[op],
        int(outer_or),
        int(invert),
        vec,
        variant,
    )


def mws_gather(
    src: torch.Tensor,
    idx: torch.Tensor,
    op: BitOp = BitOp.AND,
    *,
    outer_or: bool = True,
    invert: bool = False,
    ext: torch.Tensor | None = None,
    shr: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Gather-reduce rows of ``src`` (S, W) by ``idx`` (B, K, N) int32.

    ``out[b] = post(OR_k (op_n row(idx[b, k, n])))``, or (B, K, W) per
    block when ``outer_or`` is False; ``post`` complements when
    ``invert``.  A negative index ``-1 - j`` names substituted row ``j``:
    ``ext[b, j]`` (ext is (B, M, W)) for ``j < M``, else ``shr[j - M]``.
    Indices are not range-checked here; callers build them from store
    slots (see :func:`repro_torch.query.device.encode_idx`).  ``out``, if
    given, receives the result (a contiguous int32 tensor of its shape on
    ``src``'s device, such as rows of a larger stack) and is returned.
    """
    if op not in _OP_CODES:
        raise ValueError(f"inner op must be AND/OR/XOR, got {op}")
    if src.dim() != 2 or idx.dim() != 3:
        raise ValueError(
            f"expected src (S, W) and idx (B, K, N), got {tuple(src.shape)} "
            f"and {tuple(idx.shape)}"
        )
    B, K, N = idx.shape
    W = src.shape[1]
    shape = (B, W) if outer_or else (B, K, W)
    if out is not None and (
        tuple(out.shape) != shape
        or out.dtype != torch.int32
        or out.device != src.device
        or not out.is_contiguous()
    ):
        raise ValueError(
            f"out must be a contiguous int32 {shape} tensor on {src.device}"
        )
    if _build.on_cpu(src):
        if out is None:
            return mws_gather_ref(
                src, idx, op, outer_or=outer_or, invert=invert, ext=ext, shr=shr
            )
        # rows of a stack, one batch row at a time: a plain gather of many
        # rows at once runs parallel and stalls when processes share cores
        for b in range(B):
            out[b : b + 1] = mws_gather_ref(
                src,
                idx[b : b + 1],
                op,
                outer_or=outer_or,
                invert=invert,
                ext=None if ext is None else ext[b : b + 1],
                shr=shr,
            )
        return out
    _build.check_words(src, "src", 2)
    _build.check_words(idx, "idx", 3)
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
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=src.device)
    if B == 0 or W == 0:
        return out
    if (B if outer_or else B * K) > _MAX_GRID_Y:
        raise ValueError(f"batch {B} x blocks {K} exceeds the launch grid")
    vec = _build.vec_width(W, src, ext, shr, out)
    variant = choose_variant(
        src.shape[0],
        B,
        K,
        N,
        0 if ext is None else ext.shape[1],
        0 if shr is None else shr.shape[0],
        outer_or,
        vec,
    )
    _launch(src, idx, op, outer_or, invert, ext, shr, out, vec, VARIANTS[variant])
    mws_gather.launches += 1
    mws_gather.variant_launches[variant] += 1
    return out


mws_gather.launches = 0  # every launch, of either variant
mws_gather.variant_launches = dict.fromkeys(VARIANTS, 0)


def parabit_reduce(stack: torch.Tensor, op: BitOp) -> torch.Tensor:
    """The ParaBit baseline: a serial pairwise ``op``-fold over axis 0 of
    an (N, W) word stack -> (W,), one operation per operand.

    Each step reads the whole running result and one operand and writes
    the result back, as ParaBit senses one operand at a time; it computes
    what :func:`mws_reduce` does in one pass.  Plain torch on any device
    (:func:`repro_torch.core.bitops.reduce_words`).
    """
    if stack.dim() != 2 or stack.shape[0] == 0:
        raise ValueError(f"expected a non-empty (N, W) stack, got {tuple(stack.shape)}")
    return reduce_words(stack, op)


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
