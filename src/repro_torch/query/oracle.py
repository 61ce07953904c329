"""Reference numpy oracle for FlashQL predicates.

One implementation of predicate semantics on raw columns, shared by the
test suites and benchmarks (four hand-rolled copies had grown, each
covering a different predicate subset).  This is NOT on any serving path
— it exists so every differential check validates against the same,
complete oracle.
"""

from __future__ import annotations

import numpy as np

from repro_torch.query.ast import And, AtLeast, Eq, In, Not, Or, Pred, Range


def np_select(pred: Pred, table: dict, n: int) -> np.ndarray:
    """Boolean row-selection mask of ``pred`` over raw column arrays."""
    if isinstance(pred, Eq):
        return np.asarray(table[pred.column]) == pred.value
    if isinstance(pred, In):
        return np.isin(np.asarray(table[pred.column]), pred.values)
    if isinstance(pred, Range):
        m = np.ones(n, bool)
        if pred.lo is not None:
            m &= np.asarray(table[pred.column]) >= pred.lo
        if pred.hi is not None:
            m &= np.asarray(table[pred.column]) <= pred.hi
        return m
    if isinstance(pred, Not):
        return ~np_select(pred.child, table, n)
    if isinstance(pred, And):
        m = np.ones(n, bool)
        for c in pred.children:
            m &= np_select(c, table, n)
        return m
    if isinstance(pred, Or):
        m = np.zeros(n, bool)
        for c in pred.children:
            m |= np_select(c, table, n)
        return m
    if isinstance(pred, AtLeast):
        # a duplicated child counts twice toward k, matching the sensed
        # semantics (its wordline group conducts once per block slot)
        count = np.zeros(n, np.int32)
        for c in pred.children:
            count += np_select(c, table, n)
        return count >= pred.k
    raise TypeError(f"not a FlashQL predicate: {pred!r}")
