"""Predicate -> core-expression lowering, the cached query compiler, and
the fused flush compiler.

Lowering rules:

* ``Eq(col, v)``      -> the equality bitmap page ``col=v`` (FALSE if ``v``
  never occurs);
* ``In(col, vs)``     -> OR over the member pages — one inverse-read MWS
  when the column's bitmaps are co-located inverted (§6.3);
* ``Range(col, lo, hi)`` -> the bit-sliced comparison network over the
  column's BSI pages (O'Neil/Quass ``v <= c``: walk slices MSB->LSB keeping
  an equality prefix, OR the strictly-less branches);
* ``And`` / ``Or`` / ``Not`` -> ``and_`` / ``or_`` / ``not_``.

The compiler memoizes :class:`CommandPlan`s keyed on **expression structure
+ leaf placement + leaf-region epochs**: repeated query shapes skip the
Planner, and — because structurally identical plans gather the same slot
patterns — land in the same vectorized batch of
:class:`repro_torch.query.device.FlashDevice`.

The epoch components are *region-granular* (one region per column, see
:func:`repro_torch.core.store.page_region`): a key carries, for every region its
leaves touch, the column's index-metadata epoch (distinct values / BSI
width — what lowering depends on) and the device store's region epoch
(full page reprograms).  Incremental appends bump neither unless they
introduce a new value or bit slice in that column, so appending to column
A leaves plans that only touch column B warm — and delta-page programs
never invalidate any plan at all (plans gather by slot, and appends only
extend page tails).

On top of per-query plans, :func:`compile_flush` compiles a whole flush —
every predicate signature group AND every aggregate reduce — into ONE
device program per *flush signature*: the gather-reduce kernel launches
feed the popcount reduces on the device, and the flush's complete result
set comes back as a single flat 32-bit payload, i.e. one host transfer per
flush however many batch groups and aggregate kinds it mixes (MASK
un-striping stays host-side).  :class:`FlushProgram` carries the device-resident
inputs (gather indices, order-restoring permutation, extra-plane stacks)
so steady-state serving re-dispatches a memoized program with zero
per-flush host preparation.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.core.commands import CommandPlan
from repro_torch.core.engine import eval_expr
from repro_torch.core.expr import (
    Expr,
    Node,
    Page,
    Threshold,
    and_,
    leaves,
    not_,
    or_,
)
from repro_torch.core.placement import auto_layout
from repro_torch.core.planner import Planner
from repro_torch.core.store import page_region
from repro_torch.query.aggregate import (
    group_extras,
    group_members,
    payload_size,
    payload_spec,
    unpack_group,
)
from repro_torch.query.ast import (
    And,
    AtLeast,
    Eq,
    In,
    Not,
    Or,
    Pred,
    Query,
    Range,
    canonicalize,
    pred_key,
)
from repro_torch.query.bitmap import (
    FALSE_PAGE,
    TRUE_PAGE,
    VALID_PAGE,
    BitmapStore,
    bsi_page,
    eq_page,
)
from repro_torch.query.device import (
    encode_idx,
    group_execs,
    hoist_flush,
    make_flush_runner,
)
from repro_torch.query.optimize import best_plan


def _le_expr(store: BitmapStore, column: str, c: int) -> Expr:
    """Bit-sliced ``column <= c`` over the column's BSI pages."""
    ci = store.columns[column]
    if c < 0:
        return Page(FALSE_PAGE)
    if c >= (1 << ci.bits) - 1:
        return Page(TRUE_PAGE)
    lt_terms: list[Expr] = []
    eq_prefix: list[Expr] = []
    for b in range(ci.bits - 1, -1, -1):
        s = Page(bsi_page(column, b))
        if (c >> b) & 1:
            lt_terms.append(
                and_(*eq_prefix, not_(s)) if eq_prefix else not_(s)
            )
            eq_prefix.append(s)
        else:
            eq_prefix.append(not_(s))
    eq = and_(*eq_prefix) if len(eq_prefix) > 1 else eq_prefix[0]
    return or_(*lt_terms, eq) if lt_terms else eq


def lower(pred: Pred, store: BitmapStore) -> Expr:
    """Lower a FlashQL predicate to a ``core.expr`` tree over bitmap pages.

    The root is ANDed with the store's tombstone (valid-row) page, so
    every compiled plan senses exactly ONE extra wordline and can only
    match live rows: deleted rows are masked inside the MWS itself, and —
    because the valid page's reserved tail bits are erased-zero — so are
    rows between ``num_rows`` and ``capacity_rows`` (a cached NOT/MASK
    plan evaluated after ``reserve_rows`` headroom exists cannot leak the
    reserved tail into COUNT/MASK).  A predicate that lowers to the
    constant FALSE page skips the splice (it matches nothing already);
    constant TRUE lowers to the valid page itself.
    """
    e = _lower(pred, store)
    if isinstance(e, Page):
        if e.name == FALSE_PAGE:
            return e
        if e.name == TRUE_PAGE:
            return Page(VALID_PAGE)
    return and_(e, Page(VALID_PAGE))


def _lower(pred: Pred, store: BitmapStore) -> Expr:
    """The recursive lowering body (no valid-page splice — ``lower``
    splices exactly once, at the root)."""
    if isinstance(pred, Eq):
        ci = store.columns.get(pred.column)
        if ci is None:
            raise KeyError(f"unknown column {pred.column!r}")
        if pred.value not in ci.values:
            return Page(FALSE_PAGE)
        return Page(eq_page(pred.column, pred.value))
    if isinstance(pred, In):
        ci = store.columns.get(pred.column)
        if ci is None:
            raise KeyError(f"unknown column {pred.column!r}")
        members = [
            Page(eq_page(pred.column, v))
            for v in pred.values
            if v in ci.values
        ]
        if not members:
            return Page(FALSE_PAGE)
        if len(members) == 1:
            return members[0]
        return or_(*members)
    if isinstance(pred, Range):
        ci = store.columns.get(pred.column)
        if ci is None:
            raise KeyError(f"unknown column {pred.column!r}")
        le_hi = (
            _le_expr(store, pred.column, pred.hi)
            if pred.hi is not None
            else Page(TRUE_PAGE)
        )
        ge_lo = (
            not_(_le_expr(store, pred.column, pred.lo - 1))
            if pred.lo is not None and pred.lo > 0
            else Page(TRUE_PAGE)
        )
        factors = [
            f
            for f in (le_hi, ge_lo)
            if not (isinstance(f, Page) and f.name == TRUE_PAGE)
        ]
        if not factors:
            return Page(TRUE_PAGE)
        if len(factors) == 1:
            return factors[0]
        return and_(*factors)
    if isinstance(pred, Not):
        return not_(_lower(pred.child, store))
    if isinstance(pred, And):
        return and_(*(_lower(c, store) for c in pred.children))
    if isinstance(pred, Or):
        return or_(*(_lower(c, store) for c in pred.children))
    if isinstance(pred, AtLeast):
        return _fold_atleast(
            pred.k, [_lower(c, store) for c in pred.children]
        )
    raise TypeError(f"not a FlashQL predicate: {pred!r}")


def _fold_atleast(k: int, lowered: list[Expr]) -> Expr:
    """Constant-fold a lowered k-of-N and pick its cheapest expression form.

    Children lowered to the constant FALSE page can never count and drop
    out; TRUE children always count, so they drop AND decrement ``k``.
    The degenerate survivors reuse the existing node shapes — ``k == n``
    is the AND and ``k == 1`` the OR — so plan caching and cross-query CSE
    share entries with queries spelled the boolean way.  Only the strict
    interior becomes a :class:`repro_torch.core.expr.Threshold`.
    """
    kids: list[Expr] = []
    for e in lowered:
        if isinstance(e, Page):
            if e.name == FALSE_PAGE:
                continue
            if e.name == TRUE_PAGE:
                k -= 1
                continue
        kids.append(e)
    if k <= 0:
        return Page(TRUE_PAGE)
    if k > len(kids):
        return Page(FALSE_PAGE)
    if len(kids) == 1:
        return kids[0]
    if k == len(kids):
        return and_(*kids)
    if k == 1:
        return or_(*kids)
    return Threshold(k, tuple(kids))


def lower_shared(
    pred: Pred,
    store: BitmapStore,
    shared: dict[tuple, str],
    used: set[str],
) -> Expr:
    """Lower a predicate, substituting shared-subexpression pages.

    ``shared`` maps :func:`repro_torch.query.ast.pred_key` keys to the page
    names holding (or standing in for) those subtrees' results — the
    cross-query CSE rewrite of :func:`repro_torch.query.optimize.cse_flush`.
    Every substituted name is added to ``used``.  The root is spliced
    with the valid page exactly like :func:`lower`.
    """
    e = _lower_shared(pred, store, shared, used)
    if isinstance(e, Page):
        if e.name == FALSE_PAGE:
            return e
        if e.name == TRUE_PAGE:
            return Page(VALID_PAGE)
    return and_(e, Page(VALID_PAGE))


def _lower_shared(
    pred: Pred,
    store: BitmapStore,
    shared: dict[tuple, str],
    used: set[str],
) -> Expr:
    name = shared.get(pred_key(pred))
    if name is not None:
        used.add(name)
        return Page(name)
    if isinstance(pred, Not):
        return not_(_lower_shared(pred.child, store, shared, used))
    if isinstance(pred, And):
        return and_(
            *(_lower_shared(c, store, shared, used) for c in pred.children)
        )
    if isinstance(pred, Or):
        return or_(
            *(_lower_shared(c, store, shared, used) for c in pred.children)
        )
    if isinstance(pred, AtLeast):
        return _fold_atleast(
            pred.k,
            [_lower_shared(c, store, shared, used) for c in pred.children],
        )
    return _lower(pred, store)


def expr_key(e: Expr) -> tuple:
    """Canonical structural key of a core expression."""
    if isinstance(e, Page):
        return ("p", e.name)
    if isinstance(e, Threshold):
        return ("thr", e.k) + tuple(expr_key(c) for c in e.children)
    assert isinstance(e, Node)
    return (e.op.value,) + tuple(expr_key(c) for c in e.children)


class PlanKey:
    """A plan-cache key, ``(expr_key, placements, epoch_sig)``, interned.

    Its hash is computed once, and :meth:`QueryCompiler.compile` hands out
    one object per distinct key, so the exec cache, the CSE cache and the
    flush-program cache hash and compare a repeat flush's keys in O(1),
    however large the plans.  A key rebuilt from a pickle computes its
    hash again (string hashes are salted per process).
    """

    __slots__ = ("parts", "_hash")

    def __init__(self, parts: tuple) -> None:
        self.parts = parts
        self._hash = hash(parts)

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        if self is other:
            return True
        if not isinstance(other, PlanKey):
            return NotImplemented
        return self._hash == other._hash and self.parts == other.parts

    def __reduce__(self):
        return (PlanKey, (self.parts,))

    def __repr__(self) -> str:
        return f"PlanKey{self.parts!r}"


@dataclass(frozen=True)
class CompiledQuery:
    query: Query
    expr: Expr
    plan: CommandPlan
    key: PlanKey
    cache_hit: bool
    # canonicalized predicate (optimizer on) — the structural identity
    # cross-query CSE and materialization key on; None when optimize=False
    canon: Pred | None = None


@dataclass
class QueryCompiler:
    """Lower + plan queries against one array, memoizing command plans.

    With ``optimize`` (the default), three optimizer stages run in the
    compile path:

    * predicates canonicalize (:func:`repro_torch.query.ast.canonicalize`)
      before lowering, so operand-order variants of one predicate share a
      single plan-cache entry;
    * plan-cache misses compile a small set of candidate chain orderings
      and keep the cheapest under the flashsim timing model
      (:func:`repro_torch.query.optimize.best_plan`);
    * predicates hot enough (``materialize_after`` compiles since the last
      mutation of their columns) have their result bitmap ESP-programmed
      once as a cached page (:meth:`materialize`), after which they lower
      to ``mat_page AND valid_page`` — one sensing, two wordlines.  The
      cache entry is guarded by the source columns' region epochs plus the
      store's row count, so appends/compaction invalidate it, while
      deletes need no invalidation at all: the live ``__valid`` tombstone
      page is composed at read time, never baked into the cached bitmap.
    """

    store: BitmapStore
    array: "object"  # FlashArray / FlashDevice (duck-typed: .layout)
    _plans: dict[tuple, CommandPlan] = field(default_factory=dict)
    hits: int = 0
    misses: int = 0
    optimize: bool = True
    # compiles of one canonical predicate before it is eligible for
    # materialization (heat resets when its cached page is invalidated);
    # None disables the stage
    materialize_after: int | None = None
    mat_limit: int = 32  # distinct materialized pages per device
    mat_hits: int = 0
    mat_invalidations: int = 0
    mat_builds: int = 0
    _live_versions: tuple | None = None
    # canonical-predicate heat: pred_key -> [compile count, canon pred]
    _heat: dict = field(default_factory=dict, repr=False)
    # live materializations: pred_key -> (page name, regions, guard)
    _mat: dict = field(default_factory=dict, repr=False)
    # stable page name per materialized predicate (re-materializing after
    # invalidation reprograms the same page in place, so cached plans that
    # gather its slot stay valid)
    _mat_names: dict = field(default_factory=dict, repr=False)
    # front cache keyed on the (frozen, hashable) Query itself: repeated
    # queries skip lowering + structural keying entirely, not just the
    # Planner.  Cleared whenever either content version moves (cheap to
    # rebuild: the next compile re-lowers and usually hits ``_plans``).
    _by_query: dict = field(default_factory=dict, repr=False)
    # lowered ExecPlans under the same keys (see exec_for): both
    # schedulers used to keep private exec caches with duplicate pruning
    # logic; centralizing them here keeps one freshness rule
    _execs: dict = field(default_factory=dict, repr=False)
    # every live PlanKey, by itself: equal keys are one object
    _keys: dict = field(default_factory=dict, repr=False)
    # attached by the owning scheduler (repro_torch.query.telemetry.Telemetry):
    # plan-compile misses report their Planner time as a histogram + span
    telemetry: object = None

    def epoch_sig(self, regions: tuple[str, ...]) -> tuple:
        """Current ``(region, column epoch, device region epoch)`` triple
        per region — the epoch components of a plan-cache key."""
        ce = self.store.column_epochs
        de = self.array.store.region_epochs
        return tuple((r, ce.get(r, 0), de.get(r, 0)) for r in regions)

    def key_fresh(self, key: PlanKey) -> bool:
        """Whether a plan-cache key's leaf-region epochs are all current.

        Exec/batch caches keyed on plan-cache keys prune through this: a
        stale key can never be produced by ``compile`` again.
        """
        sig = key.parts[2]
        return sig == self.epoch_sig(tuple(r for r, _, _ in sig))

    def compile(self, query: Query) -> CompiledQuery:
        versions = (self.store.epoch, self.array.store.epoch)
        if versions != self._live_versions:
            # some mutation happened (ingest/append/reprogram): evict plans
            # whose leaf regions moved — they are permanently unreachable —
            # and clear the query front cache (its entries bypass lowering,
            # which may now resolve differently).  Plans over untouched
            # regions survive, which is what keeps serving warm across
            # incremental appends.
            self._plans = {
                k: v for k, v in self._plans.items() if self.key_fresh(k)
            }
            self._execs = {
                k: v for k, v in self._execs.items() if self.key_fresh(k)
            }
            self._keys = {k: k for k in self._keys if self.key_fresh(k)}
            self._by_query.clear()
            self._live_versions = versions
        cached = self._by_query.get(query)
        if cached is not None:
            self.hits += 1
            self._note_heat(cached.canon)
            return cached
        if self.optimize:
            canon = canonicalize(query.where)
            self._note_heat(canon)
            expr = self._lower_optimized(canon)
        else:
            canon = None
            expr = lower(query.where, self.store)
        layout = self.array.layout
        if any(p.name not in layout for p in leaves(expr)):
            # late-placed pages (e.g. constants written after warmup) get
            # the §6.3 context-sensitive placement before planning
            auto_layout(expr, layout)
        pages = sorted(set(leaves(expr)), key=lambda p: p.name)
        placements = tuple((p.name, layout[p.name]) for p in pages)
        # The epoch components cover exactly the regions (columns) the
        # plan's leaves touch: mutating one column — or, in a sharded
        # deployment, one device — invalidates only the plans that sense
        # it, while every other cached plan stays warm.
        regions = tuple(
            sorted({page_region(p.name) for p in pages} - {None})
        )
        key = PlanKey((expr_key(expr), placements, self.epoch_sig(regions)))
        key = self._keys.setdefault(key, key)
        plan = self._plans.get(key)
        hit = plan is not None
        if hit:
            self.hits += 1
        else:
            self.misses += 1
            tele = self.telemetry
            timed = tele is not None and tele.enabled
            t0 = time.perf_counter() if timed else 0.0
            if self.optimize:
                # candidate chain orderings, cheapest by the flashsim
                # timing model; the cache key stays the canonical expr's
                plan, _, _ = best_plan(expr, layout)
            else:
                plan = Planner(layout).compile(expr)
            if timed:
                t1 = time.perf_counter()
                tele.observe("plan_compile_s", t1 - t0)
                tele.span(
                    "plan_compile",
                    "compile",
                    t0,
                    t1,
                    tid="compile",
                    args={"key": repr(key.parts[0])},
                )
            self._plans[key] = plan
        cq = CompiledQuery(query, expr, plan, key, hit, canon)
        if len(self._by_query) >= 4096:  # bound high-cardinality params
            self._by_query.clear()
        self._by_query[query] = replace(cq, cache_hit=True)
        return cq

    # -- hot-predicate materialization -----------------------------------

    def _note_heat(self, canon: Pred | None) -> None:
        if canon is None or self.materialize_after is None:
            return
        k = pred_key(canon)
        rec = self._heat.get(k)
        if rec is None:
            if len(self._heat) >= 4096:  # bound high-cardinality params
                self._heat.clear()
            self._heat[k] = [1, canon]
        else:
            rec[0] += 1

    def _mat_guard(self, regions: tuple[str, ...]) -> tuple:
        # region epochs catch column mutations and compaction; the row
        # count catches appends (which extend pages without bumping any
        # region epoch — a stale cached bitmap would zero-miss new rows).
        # Deletes bump neither: the cached page composes with the live
        # valid page at read time, so tombstones need no invalidation.
        return (self.epoch_sig(regions), self.store.num_rows)

    def _lower_optimized(self, canon: Pred) -> Expr:
        """Lower a canonical predicate, via its materialized page if the
        cache entry exists and its guard is still current."""
        k = pred_key(canon)
        m = self._mat.get(k)
        if m is not None:
            name, regions, guard = m
            if guard == self._mat_guard(regions):
                self.mat_hits += 1
                if self.telemetry is not None:
                    self.telemetry.count("materialization_hits")
                return and_(Page(name), Page(VALID_PAGE))
            del self._mat[k]
            self.mat_invalidations += 1
            if self.telemetry is not None:
                self.telemetry.count("materialization_invalidations")
            rec = self._heat.get(k)
            if rec is not None:
                rec[0] = 0  # re-earn the threshold after invalidation
        return lower(canon, self.store)

    def hot_preds(self) -> list[tuple[tuple, Pred]]:
        """``(key, canon)`` for predicates past the heat threshold that
        are not currently materialized."""
        if self.materialize_after is None:
            return []
        return [
            (k, rec[1])
            for k, rec in self._heat.items()
            if rec[0] >= self.materialize_after and k not in self._mat
        ]

    def materialize(self, key: tuple, canon: Pred) -> CommandPlan | None:
        """Evaluate + ESP-program a predicate's bitmap as a cached page.

        Returns the predicate's build plan — the one sensing pass that
        physically produces the latch result being programmed — so the
        caller can charge its traffic; None when the predicate is not
        worth (or not able to be) materialized.  The page is co-located
        with the valid page when its block has room, making the lowered
        ``mat AND valid`` read a single intra-block sensing.
        """
        expr = _lower(canon, self.store)
        if isinstance(expr, Page):
            return None  # already one page — nothing to gain
        pages = sorted(set(leaves(expr)), key=lambda p: p.name)
        regions = tuple(
            sorted({page_region(p.name) for p in pages} - {None})
        )
        name = self._mat_names.get(key)
        if name is None:
            if len(self._mat_names) >= self.mat_limit:
                return None
            name = f"__mat{len(self._mat_names)}"
        layout = self.array.layout
        if any(p.name not in layout for p in pages):
            auto_layout(expr, layout)
        snap = layout.snapshot()
        plan = Planner(layout).compile(expr)
        layout.restore(snap)  # build-plan spill scratch is throwaway
        words = eval_expr(expr, self.store.logical)  # host int32 words
        block = wordline = None
        if name not in layout and VALID_PAGE in layout:
            pv = layout[VALID_PAGE]
            fill = layout._block_fill.get(pv.block, 0)
            if fill < layout.wls_per_block:
                block, wordline = pv.block, fill
        self.array.fc_write(
            name, words, esp=True, block=block, wordline=wordline
        )
        self._mat_names[key] = name
        self._mat[key] = (name, regions, self._mat_guard(regions))
        self.mat_builds += 1
        if self.telemetry is not None:
            self.telemetry.count("materializations")
        return plan

    def exec_for(self, cq: CompiledQuery):
        """The lowered :class:`repro_torch.query.device.ExecPlan` of a compiled
        query, memoized under its plan-cache key: a hit skips the
        Python-side lowering entirely.  Stale keys are swept together with
        the plan cache (their epochs can never be produced again)."""
        e = self._execs.get(cq.key)
        if e is None:
            e = self.array.build_exec(cq.plan)
            self._execs[cq.key] = e
        return e

    @property
    def cache_size(self) -> int:
        return len(self._plans)


# -- the fused flush compiler -------------------------------------------------


@dataclass(frozen=True)
class FlushProgram:
    """One flush, compiled: a single device program + its inputs.

    ``run(data, mask)`` runs the whole flush — every sensing group, the
    order-restoring permutation, validity masking, and every aggregate
    reduce — on the device and returns one flat int32 payload; ``unpack``
    turns the transferred payload (viewed as ``uint32``) back into
    per-member partials (in flush member order).

    Everything here is device-resident and immutable, so a scheduler can
    memoize the program per batch composition + store epoch and re-run it
    every flush with zero host-side preparation.
    """

    key: tuple  # flush signature: (sense groups, reduce groups, words, cse, hoist)
    runner: object  # run(data, group_idxs, ..., cse_idxs, hoist_idxs, fold_idxs)
    n_members: int
    n_sense_groups: int
    n_reduce_groups: int
    # per sense group that does not fold: tuple of encoded (B_g, blocks, wls)
    group_idxs: tuple
    # (B,) member gather over the sensed rows: with whole-plan dedup it
    # maps each member onto its unique representative's row
    inv_perm: torch.Tensor
    sels: tuple  # per reduce group: (B_r,) member gather, or None if all
    extras: tuple  # per reduce group: (B_r, P, W) plane stack, or None
    reduce_parse: tuple  # per reduce group: (member tuple, payload leaves)
    extra_counts: tuple  # per member: extra planes sensed (traffic accounting)
    cse_idxs: tuple = ()  # per shared plan: tuple of encoded (1, blocks, wls)
    # the folds' commands, each sensed once for the whole flush
    # (hoist_flush): per launch (H, blocks, wls) slots, per fold launch
    # (P, 1, n) stack rows
    hoist_idxs: tuple = ()
    fold_idxs: tuple = ()
    sensings_hoisted: int = 0  # command sensings the folds save a run

    def run(self, data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Launch the program (asynchronous); returns the device payload."""
        return self.runner(
            data,
            self.group_idxs,
            self.inv_perm,
            mask,
            self.sels,
            self.extras,
            self.cse_idxs,
            self.hoist_idxs,
            self.fold_idxs,
        )

    def unpack(self, flat: np.ndarray, aggs: list) -> list:
        """Payload words (host ``uint32``) -> per-member partials.

        ``aggs`` are the flush members' aggregators in member order."""
        partials: list = [None] * self.n_members
        off = 0
        for members, leaves in self.reduce_parse:
            n = payload_size(leaves)
            host = unpack_group(flat[off : off + n], leaves)
            off += n
            for j, i in enumerate(members):
                partials[i] = aggs[i].member_partial(host, j)
        return partials


def compile_flush(
    execs: list,
    specs: list,
    stores: list[BitmapStore],
    store_keys: list,
    *,
    words: int,
    device: torch.device,
    runner_cache: dict,
    extras_cache: dict,
    pad: bool = True,
    cache_cap: int = 128,
    dedup_keys: list | None = None,
    shared_execs: tuple = (),
) -> FlushProgram:
    """Compile one flush into a :class:`FlushProgram` on ``device``.

    ``execs`` are the members' lowered plans (spill-free or spilling);
    callers route flushes over devices holding non-ESP pages through the
    per-group legacy path instead, since the fused program never injects
    read errors.  Runners are shared across flushes through
    ``runner_cache`` keyed on the flush signature and the device type;
    extra-plane stacks are memoized in ``extras_cache``.

    ``dedup_keys`` (one hashable per member — plan-cache keys in practice)
    turns on whole-plan dedup: only the first member of each key is
    sensed, and the member gather points duplicates at the
    representative's row.  ``shared_execs`` are the flush's cross-query
    shared subexpression plans (:func:`repro_torch.query.optimize.cse_flush`),
    sensed once before the member groups.  Batch groups of AND chains
    over commands that several plans sense fold: each command of those
    chains is sensed once and each chain is one gather over them
    (:func:`repro_torch.query.device.hoist_flush`); every other group
    senses its own commands.
    """
    assert all(e is not None for e in execs), "fused flush needs lowered plans"
    n = len(execs)
    if dedup_keys is not None:
        pos: dict = {}
        uix: list[int] = []
        urep: list[int] = []
        for i, k in enumerate(dedup_keys):
            j = pos.get(k)
            if j is None:
                j = pos[k] = len(uix)
                uix.append(i)
            urep.append(j)
        uexecs = [execs[i] for i in uix]
    else:
        uix = list(range(n))
        urep = list(range(n))
        uexecs = execs
    groups = group_execs(uexecs, pad=pad)
    hoist = hoist_flush(uexecs, groups, len(shared_execs))
    if hoist is None:
        folded = (False,) * len(groups)
        order = [i for _sig, members, _stacked in groups for i in members]
    else:
        folded, order = hoist.folded, hoist.order
    sense = [(signature, len(members)) for signature, members, _ in groups]
    group_idxs = [
        tuple(
            torch.as_tensor(x, device=device)
            for x in encode_idx(signature, stacked)
        )
        for (signature, _members, stacked), f in zip(groups, folded)
        if not f
    ]
    # row_of: unique-plan ordinal -> its row in the concatenated group
    # output; composing with urep gives the member gather
    row_of = np.empty(len(uexecs), dtype=np.int64)
    row_of[np.asarray(order)] = np.arange(len(uexecs), dtype=np.int64)
    inv = row_of[np.asarray(urep, dtype=np.int64)]

    aggs, rgroups = group_members(specs, stores)
    reduce_sigs: list[tuple] = []
    sels: list = []
    extras: list = []
    parse: list[tuple] = []
    extra_counts = [0] * n
    for gkey, members in rgroups.items():
        kind, sig = gkey[0], gkey[1:]
        ex, counts = group_extras(
            aggs, members, stores, store_keys, extras_cache, cache_cap, device
        )
        for i, c in counts.items():
            extra_counts[i] = c
        reduce_sigs.append(
            (kind, sig, len(members), 0 if ex is None else int(ex.shape[1]))
        )
        sels.append(
            None
            if len(members) == n
            else torch.as_tensor(members, dtype=torch.int64, device=device)
        )
        extras.append(ex)
        parse.append((tuple(members), payload_spec(kind, sig, len(members), words)))

    cse = tuple(e.signature for e in shared_execs)
    key = (
        tuple(sense),
        tuple(reduce_sigs),
        words,
        cse,
        () if hoist is None else hoist.key,
    )
    # the device type joins the cache key: runners on CUDA launch the
    # kernels, runners on the CPU run their plain versions
    rkey = key + (torch.device(device).type,)
    runner = runner_cache.get(rkey)
    if runner is None:
        if len(runner_cache) >= 128:
            runner_cache.clear()
        runner = make_flush_runner(key)
        runner_cache[rkey] = runner
    return FlushProgram(
        key=key,
        runner=runner,
        n_members=n,
        n_sense_groups=len(sense),
        n_reduce_groups=len(reduce_sigs),
        group_idxs=tuple(group_idxs),
        inv_perm=torch.as_tensor(inv, device=device),
        sels=tuple(sels),
        extras=tuple(extras),
        reduce_parse=tuple(parse),
        extra_counts=tuple(extra_counts),
        cse_idxs=tuple(
            tuple(
                torch.as_tensor(x, device=device)
                for x in encode_idx(
                    e.signature, [idx[None] for idx in e.idxs]
                )
            )
            for e in shared_execs
        ),
        hoist_idxs=()
        if hoist is None
        else tuple(torch.as_tensor(x, device=device) for x in hoist.sense),
        fold_idxs=()
        if hoist is None
        else tuple(torch.as_tensor(x, device=device) for _, x in hoist.folds),
        sensings_hoisted=0 if hoist is None else hoist.saved,
    )
