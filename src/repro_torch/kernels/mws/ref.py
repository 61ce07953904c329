"""Plain PyTorch versions of the MWS gather-reduce (the kernel's oracle)."""

from __future__ import annotations

import torch

from repro_torch.core.bitops import _FOLDS, BitOp, reduce_words


def _gathered_rows(src, r, ext, shr):
    """Rows ``row(r[b])`` for one (k, n) position of every batch row:
    ``src[r]`` for r >= 0, else substituted row j = -1 - r from ``ext[b]``
    (j < ext rows) or ``shr`` (see the kernel's header)."""
    rows = src[r.clamp(min=0).long()]
    neg = r < 0
    if bool(neg.any()):
        j = (-1 - r).long()
        m_ext = 0 if ext is None else ext.shape[1]
        b = (neg & (j < m_ext)).nonzero().squeeze(1)
        if b.numel():
            rows[b] = ext[b, j[b]]
        b = (neg & (j >= m_ext)).nonzero().squeeze(1)
        if b.numel():
            rows[b] = shr[j[b] - m_ext]
    return rows


def mws_gather_ref(
    src: torch.Tensor,
    idx: torch.Tensor,
    op: BitOp = BitOp.AND,
    *,
    outer_or: bool = True,
    invert: bool = False,
    ext: torch.Tensor | None = None,
    shr: torch.Tensor | None = None,
) -> torch.Tensor:
    """``post(OR_k (INNER_n row(idx[b, k, n])))`` per batch row ``b``.

    ``src`` (S, W), ``idx`` (B, K, N); returns (B, W), or (B, K, W) per
    block without the outer OR.  Folds one operand at a time, as
    :func:`repro_torch.core.bitops.reduce_words` does.
    """
    fold = _FOLDS[op]
    B, K, N = idx.shape
    per = []
    for k in range(K):
        acc = _gathered_rows(src, idx[:, k, 0], ext, shr)
        for n in range(1, N):
            acc = fold(acc, _gathered_rows(src, idx[:, k, n], ext, shr))
        per.append(acc)
    if outer_or:
        out = per[0]
        for p in per[1:]:
            out = out | p
    else:
        out = torch.stack(per, dim=1)
    return ~out if invert else out


def mws_reduce_ref(stack: torch.Tensor, op: BitOp) -> torch.Tensor:
    """Reference semantics of one Multi-Wordline Sensing operation:
    (N, W) words -> (W,) ``op``-reduction over the operand axis,
    complemented for the inverse-read ops (NAND/NOR/XNOR)."""
    return reduce_words(stack, op)
