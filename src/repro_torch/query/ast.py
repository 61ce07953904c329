"""FlashQL predicate AST and aggregate specs.

A deliberately small relational-predicate language over one columnar table:
leaf predicates select rows by column value (``Eq``, ``In``, ``Range``) and
compose with ``And`` / ``Or`` / ``Not``; a :class:`Query` pairs a predicate
with an *aggregate spec* describing what to compute over the selected rows:

* ``Count()`` / ``Mask()`` — the BMI bit-count / the raw result bitmap;
* ``Sum(col)`` / ``Avg(col)`` / ``Min(col)`` / ``Max(col)`` — bit-sliced
  arithmetic over the column's BSI slices (weighted popcounts);
* ``TopK(col, k)`` — the k most frequent values of ``col`` among selected
  rows (per-value popcounts over the equality bitmaps);
* ``GroupBy(key, value)`` — per-group aggregation (``Count``/``Sum``/
  ``Avg``) keyed on a low-cardinality column's equality bitmaps.

The legacy ``Agg.COUNT`` / ``Agg.MASK`` enum members keep working and
normalize to ``Count()`` / ``Mask()`` (see :func:`normalize_agg`); the
execution semantics of every spec live in :mod:`repro_torch.query.aggregate`.
Predicates support ``&``, ``|``, ``~`` like the core expression IR.

Every node is frozen and hashable: the structural identity of a predicate
(and of its aggregate spec) is its plan-cache key (``repro_torch.query.compile``).
A composite predicate (and an ``In``) computes its hash and the set of
columns it reads (:func:`pred_columns`) in one walk on first use and keeps
both, so a query served again costs O(1) in its leaves to hash and to
validate.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, fields


def _kept(cls):
    """Class decorator, over ``@dataclass(frozen=True)``, for the nodes
    whose hash walks a subtree or a list of values: replace the generated
    hash, which walks it again on every call, by the one kept after the
    first walk.  The hash covers the fields that ``==`` compares, as
    before.  ``Eq`` and ``Range`` hash in O(1) and keep nothing."""
    cls._hash_fields = tuple(f.name for f in fields(cls) if f.compare)
    cls.__hash__ = _kept_hash
    return cls


def _kept_hash(node) -> int:
    d = node._digest
    return (d if d is not None else _walk(node))[0]


class _PredOps:
    # ``(hash, columns read)``, kept by the nodes that ``_kept`` marks.  An
    # instance attribute over this class's None, not a field: ``==``,
    # ``repr``, ``dataclasses.fields`` and ``replace`` see only the
    # fields.  It is left out of the pickled or copied state, because
    # string hashes are salted per process: a node unpickled or copied
    # computes its own.
    _digest = None

    def __getstate__(self) -> dict:
        state = dict(self.__dict__)
        state.pop("_digest", None)
        return state

    def __and__(self, other: "Pred") -> "And":
        return And(_flatten(And, (self, other)))

    def __or__(self, other: "Pred") -> "Or":
        return Or(_flatten(Or, (self, other)))

    def __invert__(self) -> "Pred":
        if isinstance(self, Not):
            return self.child
        return Not(self)


@dataclass(frozen=True)
class Eq(_PredOps):
    """Rows where ``column == value``."""

    column: str
    value: int


@_kept
@dataclass(frozen=True)
class In(_PredOps):
    """Rows where ``column`` is any of ``values``."""

    column: str
    values: tuple[int, ...]

    def __init__(self, column: str, values) -> None:
        object.__setattr__(self, "column", column)
        object.__setattr__(self, "values", tuple(sorted(set(values))))


@dataclass(frozen=True)
class Range(_PredOps):
    """Rows where ``lo <= column <= hi`` (either bound may be None)."""

    column: str
    lo: int | None = None
    hi: int | None = None

    def __post_init__(self):
        if self.lo is None and self.hi is None:
            raise ValueError("Range needs at least one bound")


@_kept
@dataclass(frozen=True)
class And(_PredOps):
    children: tuple["Pred", ...]

    def __init__(self, children) -> None:
        object.__setattr__(self, "children", _flatten(And, children))


@_kept
@dataclass(frozen=True)
class Or(_PredOps):
    children: tuple["Pred", ...]

    def __init__(self, children) -> None:
        object.__setattr__(self, "children", _flatten(Or, children))


@_kept
@dataclass(frozen=True)
class Not(_PredOps):
    child: "Pred"


@_kept
@dataclass(frozen=True)
class AtLeast(_PredOps):
    """Fuzzy predicate: rows matching at least ``k`` of the ``children``.

    ``k == len(children)`` is And and ``k == 1`` is Or — canonicalization
    rewrites those onto the existing nodes so they share plan-cache and
    CSE entries with equivalent And/Or queries.  The strict interior
    lowers to ONE threshold sensing when every child is a single
    co-located wordline group, and to an Or-of-And-combinations chain
    otherwise (the cost model picks whichever is cheaper).

    Unlike And/Or, children do NOT dedupe: a duplicated child
    legitimately counts twice toward ``k``.
    """

    k: int
    children: tuple["Pred", ...]

    def __init__(self, k: int, children) -> None:
        # validation lives here, not __post_init__: defining __init__ on a
        # dataclass means the generated one (and its __post_init__ hook)
        # never runs
        from repro_torch.core.commands import THRESHOLD_MAX_BLOCKS

        k = int(k)
        children = tuple(children)
        n = len(children)
        if not 1 <= k <= n:
            raise ValueError(
                f"AtLeast(k={k}) needs 1 <= k <= {n} children"
            )
        if n > THRESHOLD_MAX_BLOCKS:
            raise ValueError(
                f"AtLeast supports at most {THRESHOLD_MAX_BLOCKS} children "
                "(dynamic-sensing power envelope)"
            )
        object.__setattr__(self, "k", k)
        object.__setattr__(self, "children", children)


def Majority(children) -> AtLeast:
    """Strict-majority sugar: ``AtLeast(len(children)//2 + 1, children)``."""
    children = tuple(children)
    return AtLeast(len(children) // 2 + 1, children)


Pred = Eq | In | Range | And | Or | Not | AtLeast


def _flatten(cls, items) -> tuple["Pred", ...]:
    out: list[Pred] = []
    for it in items:
        if isinstance(it, cls):
            out.extend(it.children)
        else:
            out.append(it)
    return tuple(out)


def pred_key(pred: Pred) -> tuple:
    """Total-order-comparable structural key of a predicate.

    Two predicates are structurally equal iff their keys are equal, and
    keys of sibling predicates always compare (same-kind keys share a
    tuple shape; cross-kind comparison resolves on the leading tag), so
    :func:`canonicalize` can sort And/Or children deterministically.
    """
    if isinstance(pred, Eq):
        return ("eq", pred.column, int(pred.value))
    if isinstance(pred, In):
        return ("in", pred.column) + tuple(int(v) for v in pred.values)
    if isinstance(pred, Range):
        return (
            "range",
            pred.column,
            (1, int(pred.lo)) if pred.lo is not None else (0, 0),
            (1, int(pred.hi)) if pred.hi is not None else (0, 0),
        )
    if isinstance(pred, Not):
        return ("not", pred_key(pred.child))
    if isinstance(pred, AtLeast):
        return ("atleast", pred.k) + tuple(
            pred_key(c) for c in pred.children
        )
    if isinstance(pred, (And, Or)):
        tag = "and" if isinstance(pred, And) else "or"
        return (tag,) + tuple(pred_key(c) for c in pred.children)
    raise TypeError(f"not a FlashQL predicate: {pred!r}")


def pred_size(pred: Pred) -> int:
    """Approximate lowered size of a predicate (CSE candidate ordering).

    ``Range``/``In`` leaves weigh more than ``Eq``: they lower to
    multi-page expressions (BSI comparison networks / member-page ORs),
    so a shared ``Range`` is worth more than its single AST node suggests.
    """
    if isinstance(pred, Not):
        return 1 + pred_size(pred.child)
    if isinstance(pred, (And, Or, AtLeast)):
        return 1 + sum(pred_size(c) for c in pred.children)
    if isinstance(pred, Range):
        return 3
    if isinstance(pred, In):
        return 2
    return 1


def iter_subtrees(pred: Pred):
    """Yield ``pred`` and every nested predicate subtree (pre-order)."""
    yield pred
    if isinstance(pred, Not):
        yield from iter_subtrees(pred.child)
    elif isinstance(pred, (And, Or, AtLeast)):
        for c in pred.children:
            yield from iter_subtrees(c)


def canonicalize(pred: Pred) -> Pred:
    """Canonical form: structurally equal-modulo-commutativity predicates
    become *identical* (equal ``pred_key``, equal hash).

    Bit-exact rewrites only — And/Or are commutative, associative, and
    idempotent over row sets, and every rule below is one of those:

    * And/Or chains flatten (constructors already do) and their children
      sort by :func:`pred_key`;
    * duplicate children dedupe (``a & a`` -> ``a``);
    * double negation collapses (``~~a`` -> ``a``);
    * single-child And/Or unwrap to the child;
    * sibling ``Eq``/``In`` literals on one column inside an ``Or`` merge
      into one ``In`` (plain member-page OR either way), and a one-value
      ``In`` is an ``Eq``.

    The compiler keys its plan cache on the canonicalized predicate, so
    ``Eq(a) & Eq(b)`` and ``Eq(b) & Eq(a)`` share one cache entry — and
    one sensing when they meet in a flush.
    """
    if isinstance(pred, Eq):
        return pred
    if isinstance(pred, In):
        if len(pred.values) == 1:
            return Eq(pred.column, pred.values[0])
        return pred
    if isinstance(pred, Range):
        return pred
    if isinstance(pred, Not):
        c = canonicalize(pred.child)
        if isinstance(c, Not):
            return c.child
        return Not(c)
    if isinstance(pred, AtLeast):
        # degenerate thresholds ARE the existing nodes — rewriting here
        # means they share plan-cache entries and CSE with equivalent
        # And/Or queries (satellite of the threshold-sensing work)
        if pred.k == len(pred.children):
            return canonicalize(And(pred.children))
        if pred.k == 1:
            return canonicalize(Or(pred.children))
        # children sort for commutativity but NEVER dedupe: unlike
        # And/Or, a duplicated child counts twice toward k
        kids = sorted(
            (canonicalize(c) for c in pred.children), key=pred_key
        )
        return AtLeast(pred.k, kids)
    if not isinstance(pred, (And, Or)):
        raise TypeError(f"not a FlashQL predicate: {pred!r}")
    cls = type(pred)
    kids: list[Pred] = []
    for ch in pred.children:
        cc = canonicalize(ch)
        if isinstance(cc, cls):
            kids.extend(cc.children)  # Not-collapse can surface same-class
        else:
            kids.append(cc)
    if cls is Or:
        # merge per-column value literals: Eq(c,1) | Eq(c,2) == In(c,(1,2))
        by_col: dict[str, set[int]] = {}
        rest: list[Pred] = []
        for k in kids:
            if isinstance(k, Eq):
                by_col.setdefault(k.column, set()).add(k.value)
            elif isinstance(k, In):
                by_col.setdefault(k.column, set()).update(k.values)
            else:
                rest.append(k)
        for col, vals in by_col.items():
            rest.append(
                Eq(col, next(iter(vals)))
                if len(vals) == 1
                else In(col, vals)
            )
        kids = rest
    seen: dict[tuple, Pred] = {}
    for k in kids:
        seen.setdefault(pred_key(k), k)
    ordered = [seen[key] for key in sorted(seen)]
    if not ordered:
        return pred
    if len(ordered) == 1:
        return ordered[0]
    return cls(tuple(ordered))


def columns_of(pred: Pred):
    """Yield every column name a predicate references (with repeats)."""
    if isinstance(pred, (Eq, In, Range)):
        yield pred.column
    elif isinstance(pred, Not):
        yield from columns_of(pred.child)
    elif isinstance(pred, (And, Or, AtLeast)):
        for c in pred.children:
            yield from columns_of(c)
    else:
        raise TypeError(f"not a FlashQL predicate: {pred!r}")


def _walk(node) -> tuple[int, frozenset]:
    """``(hash, columns read)`` of a kept node, computed once, children
    first; raises ``TypeError`` on a tree that holds something that is
    not a predicate."""
    d = node._digest
    if d is not None:
        return d
    if isinstance(node, In):
        cols = frozenset((node.column,))
    elif isinstance(node, Not):
        cols = pred_columns(node.child)
    else:  # And, Or, AtLeast
        found: set[str] = set()
        for c in node.children:
            if isinstance(c, (Eq, Range)):
                found.add(c.column)
            else:
                found.update(pred_columns(c))
        cols = frozenset(found)
    d = (hash(tuple([getattr(node, f) for f in node._hash_fields])), cols)
    object.__setattr__(node, "_digest", d)
    return d


def pred_columns(pred: Pred) -> frozenset[str]:
    """The set of column names a predicate reads.  A node that keeps its
    hash builds the set in the same walk, once, and keeps it."""
    if isinstance(pred, (Eq, Range)):
        return frozenset((pred.column,))
    if isinstance(pred, _PredOps):
        return _walk(pred)[1]
    raise TypeError(f"not a FlashQL predicate: {pred!r}")


def walked(pred: Pred) -> bool:
    """Whether hashing ``pred`` or reading its column set is O(1): it
    keeps both already, or it is a leaf that needs no walk."""
    if isinstance(pred, (Eq, Range)):
        return True
    return getattr(pred, "_digest", None) is not None


class Agg(enum.Enum):
    """Legacy aggregation enum; normalizes to ``Count()`` / ``Mask()``."""

    COUNT = "count"
    MASK = "mask"


@dataclass(frozen=True)
class Count:
    """Number of selected rows (the BMI bit-count)."""


@dataclass(frozen=True)
class Mask:
    """The selected-row bitmap itself, as a :class:`BitVector`."""


@dataclass(frozen=True)
class Sum:
    """Exact integer ``sum(column)`` over selected rows, computed as the
    weighted popcount Σ_b 2^b · popcount(mask ∧ slice_b) over BSI slices."""

    column: str


@dataclass(frozen=True)
class Avg:
    """``sum(column) / count`` over selected rows (None if none selected);
    the numerator is the exact-integer :class:`Sum`."""

    column: str


@dataclass(frozen=True)
class Min:
    """Minimum ``column`` value among selected rows (None if empty); walks
    the BSI slices MSB→LSB narrowing a candidate mask."""

    column: str


@dataclass(frozen=True)
class Max:
    """Maximum ``column`` value among selected rows (None if empty)."""

    column: str


@dataclass(frozen=True)
class TopK:
    """The ``k`` most frequent values of ``column`` among selected rows as
    ``((value, count), ...)`` sorted by (-count, value); ties break toward
    the smaller value, deterministically across shard merges."""

    column: str
    k: int


@dataclass(frozen=True)
class GroupBy:
    """Per-group aggregation over the groups of a low-cardinality ``key``
    column: ``{value: aggregate}`` for every group with at least one
    selected row.  ``value`` may be ``Count()``, ``Sum(col)``, or
    ``Avg(col)``."""

    key: str
    value: "Count | Sum | Avg" = Count()


AggSpec = Count | Mask | Sum | Avg | Min | Max | TopK | GroupBy


def normalize_agg(agg: "Agg | AggSpec") -> AggSpec:
    """Map the legacy ``Agg`` enum onto spec instances; pass specs through."""
    if agg is Agg.COUNT:
        return Count()
    if agg is Agg.MASK:
        return Mask()
    if isinstance(agg, AggSpec):
        return agg
    raise TypeError(f"not an aggregate spec: {agg!r}")


@dataclass(frozen=True)
class Query:
    where: Pred
    agg: "Agg | AggSpec" = Agg.COUNT
    tag: str = field(default="", compare=False)  # free-form client label


def and_(*preds: Pred) -> And:
    return And(preds)


def or_(*preds: Pred) -> Or:
    return Or(preds)
