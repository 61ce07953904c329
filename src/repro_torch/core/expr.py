"""Bitwise-expression IR for bulk operations on stored pages.

Users (and the BMI/IMS/KCS workloads) build expressions over *named pages*;
the planner (``repro_torch.core.planner``) compiles them into MWS/XOR command
sequences against a physical layout (``repro_torch.core.placement``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Union

from repro_torch.core.bitops import BitOp


@dataclass(frozen=True)
class Page:
    """A stored operand page (one wordline's worth of packed bits)."""

    name: str

    def __and__(self, other):
        return and_(self, other)

    def __or__(self, other):
        return or_(self, other)

    def __xor__(self, other):
        return xor_(self, other)

    def __invert__(self):
        return not_(self)


@dataclass(frozen=True)
class Node:
    op: BitOp
    children: tuple["Expr", ...] = field(default_factory=tuple)

    __and__ = Page.__and__
    __or__ = Page.__or__
    __xor__ = Page.__xor__
    __invert__ = Page.__invert__


@dataclass(frozen=True)
class Threshold:
    """k-of-N threshold node: bit j is set iff >= k children are set at j.

    ``k == 1`` is OR and ``k == len(children)`` is AND — callers should
    build those as plain Nodes (the query layer canonicalizes degenerate
    thresholds away); this node exists for the strict-majority interior,
    which the planner lowers to one ThresholdCommand sensing.
    """

    k: int
    children: tuple["Expr", ...]

    __and__ = Page.__and__
    __or__ = Page.__or__
    __xor__ = Page.__xor__
    __invert__ = Page.__invert__


Expr = Union[Page, Node, Threshold]


def _flatten(op: BitOp, items) -> tuple[Expr, ...]:
    out = []
    for it in items:
        if isinstance(it, Node) and it.op is op:
            out.extend(it.children)
        else:
            out.append(it)
    return tuple(out)


def and_(*items: Expr) -> Node:
    return Node(BitOp.AND, _flatten(BitOp.AND, items))


def or_(*items: Expr) -> Node:
    return Node(BitOp.OR, _flatten(BitOp.OR, items))


def xor_(*items: Expr) -> Node:
    return Node(BitOp.XOR, _flatten(BitOp.XOR, items))


def not_(item: Expr) -> Node:
    # NOT == single-operand NAND (inverse read of one wordline).
    return Node(BitOp.NAND, (item,))


def nand_(*items: Expr) -> Node:
    return Node(BitOp.NAND, _flatten(BitOp.AND, items))


def nor_(*items: Expr) -> Node:
    return Node(BitOp.NOR, _flatten(BitOp.OR, items))


def xnor_(*items: Expr) -> Node:
    return Node(BitOp.XNOR, _flatten(BitOp.XOR, items))


def leaves(e: Expr) -> list[Page]:
    if isinstance(e, Page):
        return [e]
    out: list[Page] = []
    for c in e.children:
        out.extend(leaves(c))
    return out
