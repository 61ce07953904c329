"""Cost-based multi-query optimizer: sense once, answer many.

Flash-Cosmos makes a single multi-wordline sensing evaluate a many-operand
bitwise op, so the dominant serving cost is *how many sensings a flush
needs* — not how many queries it answers.  This module holds the three
optimizer stages the compiler and schedulers compose:

* **Canonicalization** (:func:`repro_torch.query.ast.canonicalize`, applied by
  ``QueryCompiler``): structurally-equal-modulo-commutativity predicates
  become identical, so they share one plan-cache entry and one sensing
  when they meet in a flush.

* **Cost-based reordering** (:func:`best_plan`): the flashsim timing model
  prices a plan — :func:`repro_torch.flashsim.timing.mws_latency_us` per MWS
  command, ``t_esp_us`` per spill (an ESP program is ~18x one sensing, so
  avoiding a spill dominates everything else) — and the compiler keeps the
  cheapest of a small set of candidate And/Or chain orderings.

* **Cross-query CSE** (:func:`cse_flush`): within one flush, queries are
  first deduplicated by whole-plan cache key (two queries with one
  predicate sense it once — the fused program's member gather fans the row
  out), then predicate *subtrees* shared by two or more distinct plans are
  extracted: the subtree is sensed once as a shared plan, its latch result
  is ESP-programmed to a scratch page (priced as one ``t_esp_us``, worn as
  one P/E cycle — exactly a planner spill), and every member plan that
  references it senses the scratch wordline instead of recomputing the
  subtree.  Inside the fused :class:`repro_torch.query.compile.FlushProgram` the
  scratch round-trip collapses to a static splice
  (:attr:`repro_torch.query.device._Step.shared`), so the rewrite stays a pure
  array program.  The whole rewrite is accepted only when the timing model
  says the flush got cheaper; otherwise the flush falls back to plain
  whole-plan dedup.

Hot-predicate materialization (the fourth stage) lives on
``QueryCompiler`` itself — see ``QueryCompiler.materialize`` — because its
cache is per-device state with epoch-guarded invalidation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from itertools import combinations

from repro_torch.core.bitops import BitOp
from repro_torch.core.commands import (
    CommandPlan,
    MWSCommand,
    SpillCommand,
    ThresholdCommand,
)
from repro_torch.core.expr import Expr, Node, Page, Threshold, and_, leaves, or_
from repro_torch.core.planner import Planner
from repro_torch.flashsim.geometry import DEFAULT_SSD, SSDConfig
from repro_torch.flashsim.timing import mws_latency_us, threshold_latency_us
from repro_torch.query.ast import Eq, Pred, iter_subtrees, pred_key, pred_size


def plan_cost_us(plan: CommandPlan, ssd: SSDConfig = DEFAULT_SSD) -> float:
    """Price a plan with the flashsim timing model (microseconds).

    Each MWS command costs the characterized multi-wordline sensing
    latency for its (blocks, max wordlines-per-block) shape; each spill
    costs one ESP program (``t_esp_us`` — the paper's zero-error program
    mode at tESP/tPROG = 2), which at the default config is ~18x a
    sensing: the cost function therefore prefers any reordering that
    trades spills for extra sensings.
    """
    cost = 0.0
    for cmd in plan.commands:
        if isinstance(cmd, ThresholdCommand):
            # dynamic-sensing staircase: slower than one wired-OR MWS,
            # far cheaper than the C(N, k) chain it replaces at large N
            max_wls = max(len(t.wordlines) for t in cmd.targets)
            cost += threshold_latency_us(
                ssd.t_r_us, len(cmd.targets), max_wls
            )
        elif isinstance(cmd, MWSCommand):
            max_wls = max(len(t.wordlines) for t in cmd.targets)
            cost += mws_latency_us(ssd.t_r_us, len(cmd.targets), max_wls)
        elif isinstance(cmd, SpillCommand):
            cost += ssd.t_esp_us
    return cost


def _primary_block(e: Expr, layout) -> int:
    for p in leaves(e):
        if p.name in layout:
            return layout[p.name].block
    return -1


def reorder_expr(e: Expr, layout) -> Expr:
    """Round-robin And/Or children across their primary leaf blocks.

    The planner buckets a chain's operands into inter-block MWS commands
    greedily, so runs of same-block operands fragment the packing;
    interleaving the blocks ([1,1,2,2] -> [1,2,1,2]) lets consecutive
    operands land in one command's block slots.  This is only a candidate
    generator — :func:`best_plan` keeps it solely when the timing model
    agrees.
    """
    if isinstance(e, Page):
        return e
    if isinstance(e, Threshold):
        # child order is sensing-irrelevant for a threshold (every child
        # gets its own block slot); recurse only
        return Threshold(
            e.k, tuple(reorder_expr(c, layout) for c in e.children)
        )
    kids = tuple(reorder_expr(c, layout) for c in e.children)
    if e.op in (BitOp.AND, BitOp.OR) and len(kids) >= 3:
        groups: dict[int, list[Expr]] = {}
        for k in kids:
            groups.setdefault(_primary_block(k, layout), []).append(k)
        if len(groups) > 1:
            buckets = sorted(groups.values(), key=len, reverse=True)
            out: list[Expr] = []
            i = 0
            while len(out) < len(kids):
                for b in buckets:
                    if i < len(b):
                        out.append(b[i])
                i += 1
            kids = tuple(out)
    return Node(e.op, kids)


_EXPAND_CAP = 20  # largest C(N, k) worth trial-compiling as a chain


def _has_threshold(e: Expr) -> bool:
    if isinstance(e, Page):
        return False
    if isinstance(e, Threshold):
        return True
    return any(_has_threshold(c) for c in e.children)


def _expand_thresholds(e: Expr) -> Expr | None:
    """Boolean-chain form of a threshold expression (the And/Or dual).

    ``Threshold(k, kids)`` is equivalent to ``OR over all C(N, k)``
    ``k``-subsets of ``AND(subset)`` — the form a device without dynamic
    sensing thresholds must execute.  An AND node with one Threshold child
    distributes its other factors INTO the expanded OR (the planner then
    inlines each AND-combination into the C-latch chain instead of
    spilling the big OR), which is exactly how ``pred AND valid-page``
    roots lower.  Returns None when any expansion exceeds
    :data:`_EXPAND_CAP` combinations — at that size the chain can never
    beat one threshold sensing, so the candidate is not worth compiling.
    """
    if isinstance(e, Page):
        return e
    if isinstance(e, Node) and e.op is BitOp.AND:
        thr = [c for c in e.children if isinstance(c, Threshold)]
        if len(thr) == 1:
            others = [
                _expand_thresholds(c)
                for c in e.children
                if not isinstance(c, Threshold)
            ]
            if any(o is None for o in others):
                return None
            t = thr[0]
            tkids = [_expand_thresholds(c) for c in t.children]
            if any(x is None for x in tkids):
                return None
            if math.comb(len(tkids), t.k) > _EXPAND_CAP:
                return None
            return or_(
                *(
                    and_(*combo, *others)
                    for combo in combinations(tkids, t.k)
                )
            )
    kids = []
    for c in e.children:
        x = _expand_thresholds(c)
        if x is None:
            return None
        kids.append(x)
    if isinstance(e, Threshold):
        if math.comb(len(kids), e.k) > _EXPAND_CAP:
            return None
        return or_(*(and_(*combo) for combo in combinations(kids, e.k)))
    return Node(e.op, tuple(kids))


def best_plan(
    expr: Expr, layout, ssd: SSDConfig = DEFAULT_SSD
) -> tuple[CommandPlan, Expr, float]:
    """Compile candidate orderings of ``expr``; keep the cheapest plan.

    Returns ``(plan, expr_of_plan, cost_us)``.  Trial compiles run under
    layout snapshots, so spill-scratch allocations of losing candidates
    never leak; the layout is left in the winning candidate's state.

    Threshold expressions compile BOTH forms — the native k-of-N sensing
    and the equivalent And/Or combination chain — and keep whichever the
    timing model prices lower: for small C(N, k) a couple of ordinary
    sensings undercut the staircase threshold sense, while for wide fuzzy
    matches the single threshold sensing wins by an order of magnitude.
    """
    cands = [expr]
    alt = reorder_expr(expr, layout)
    if alt != expr:
        cands.append(alt)
    if _has_threshold(expr):
        chain = _expand_thresholds(expr)
        if chain is not None and chain != expr:
            cands.append(chain)
    base = layout.snapshot()
    best = None
    for cand in cands:
        plan = Planner(layout).compile(cand)
        cost = plan_cost_us(plan, ssd)
        state = layout.snapshot()
        layout.restore(base)
        if best is None or cost < best[2]:
            best = (plan, cand, cost, state)
    plan, cand, cost, state = best
    layout.restore(state)
    return plan, cand, cost


# -- cross-query common-subexpression elimination ----------------------------


@dataclass(frozen=True)
class CseResult:
    """One flush's CSE rewrite: deduplicated members + shared subplans.

    ``member_execs[i]`` is member *i*'s exec — duplicates point at their
    representative's object, and :func:`repro_torch.query.compile.compile_flush`
    (given ``dedup_keys``) senses each distinct plan once, fanning the row
    out through the member gather.  ``member_plans`` / ``uix`` describe
    the unique members (for traffic accounting: the physical work is one
    plan per *unique* member plus the shared plans, not one per query).
    """

    member_execs: tuple
    member_plans: tuple  # per UNIQUE member, in uix order
    dedup_keys: tuple  # per member: whole-plan dedup key (plan-cache key)
    uix: tuple  # unique member indices into the flush
    shared_execs: tuple = ()
    shared_plans: tuple = ()
    shared_blocks: tuple = ()  # scratch blocks worn per flush execution
    n_rewritten: int = 0

    @property
    def n_members(self) -> int:
        return len(self.dedup_keys)

    @property
    def n_unique(self) -> int:
        return len(self.uix)

    @property
    def n_dedup_hits(self) -> int:
        return self.n_members - self.n_unique


def cse_flush(
    compiled: list,
    compiler,
    device,
    *,
    ssd: SSDConfig = DEFAULT_SSD,
    subexpr: bool = True,
    max_shared: int = 8,
) -> CseResult:
    """Plan one flush's cross-query sharing.

    ``compiled`` are the flush members' :class:`CompiledQuery` objects (in
    member order), ``compiler`` the owning ``QueryCompiler`` and
    ``device`` its ``FlashDevice``.  Whole-plan deduplication always
    applies; with ``subexpr``, predicate subtrees shared by >= 2 distinct
    member plans additionally become shared plans — sensed once, spilled
    to a scratch page, spliced into each referencing member — when the
    timing model prices the rewritten flush below the original.
    """
    from repro_torch.query.compile import _lower, lower_shared

    keys = [cq.key for cq in compiled]
    pos: dict = {}
    uix: list[int] = []
    urep: list[int] = []
    for i, k in enumerate(keys):
        j = pos.get(k)
        if j is None:
            j = pos[k] = len(uix)
            uix.append(i)
        urep.append(j)

    def plain() -> CseResult:
        uexecs = [compiler.exec_for(compiled[i]) for i in uix]
        return CseResult(
            member_execs=tuple(uexecs[j] for j in urep),
            member_plans=tuple(compiled[i].plan for i in uix),
            dedup_keys=tuple(keys),
            uix=tuple(uix),
        )

    if not subexpr or len(uix) < 2:
        return plain()

    # candidate shared subtrees: composite predicates appearing in >= 2
    # DISTINCT unique members (identical whole predicates already dedupe,
    # and a bare Eq is one wordline — nothing to share)
    occurs: dict[tuple, set[int]] = {}
    trees: dict[tuple, Pred] = {}
    for u, i in enumerate(uix):
        canon = getattr(compiled[i], "canon", None)
        if canon is None:
            continue
        for sub in iter_subtrees(canon):
            if isinstance(sub, Eq):
                continue
            k = pred_key(sub)
            occurs.setdefault(k, set()).add(u)
            trees.setdefault(k, sub)
    cands = [k for k, s in occurs.items() if len(s) >= 2]
    if not cands:
        return plain()
    # larger subtrees first: the top-down rewrite then subsumes any nested
    # candidate inside a member that shares the outer one
    cands.sort(key=lambda k: (-pred_size(trees[k]), k))

    store = compiler.store
    layout = device.layout
    accepted: dict[tuple, str] = {}
    shared_ord: dict[str, int] = {}
    shared_plans: list[CommandPlan] = []
    shared_blocks: list[int] = []
    for k in cands:
        if len(accepted) >= max_shared:
            break
        expr_s = _lower(trees[k], store)
        if isinstance(expr_s, Page):
            continue  # constant-folded / single page: nothing to share
        snap = layout.snapshot()
        plan_s = Planner(layout).compile(expr_s)
        if plan_s.num_sensing_ops < 2 and plan_s.num_spills == 0:
            layout.restore(snap)  # one sensing already: sharing can't win
            continue
        # the shared result is ESP-programmed to a real scratch page the
        # members re-sense (the fused program splices the latch value, but
        # the cost/wear model charges the physical round-trip)
        name, block, wl = layout.alloc_scratch()
        layout.place(name, block, wl, inverted=False)
        shared_ord[name] = len(accepted)
        accepted[k] = name
        shared_plans.append(plan_s)
        shared_blocks.append(block)
    if not accepted:
        return plain()

    uexecs: list = []
    uplans: list[CommandPlan] = []
    before = 0.0
    after = len(shared_plans) * ssd.t_esp_us  # one scratch program each
    n_rewritten = 0
    for u, i in enumerate(uix):
        cq = compiled[i]
        before += plan_cost_us(cq.plan, ssd)
        canon = getattr(cq, "canon", None)
        used: set[str] = set()
        if canon is not None:
            expr_r = lower_shared(canon, store, accepted, used)
        if not used:
            uplans.append(cq.plan)
            uexecs.append(compiler.exec_for(cq))
            after += plan_cost_us(cq.plan, ssd)
            continue
        plan_r, _, cost_r = best_plan(expr_r, layout, ssd)
        uplans.append(plan_r)
        uexecs.append(device.build_exec(plan_r, shared=shared_ord))
        after += cost_r
        n_rewritten += 1
    after += sum(plan_cost_us(p, ssd) for p in shared_plans)
    if n_rewritten == 0 or after >= before:
        return plain()
    shared_execs = tuple(device.build_exec(p) for p in shared_plans)
    return CseResult(
        member_execs=tuple(uexecs[j] for j in urep),
        member_plans=tuple(uplans),
        dedup_keys=tuple(keys),
        uix=tuple(uix),
        shared_execs=shared_execs,
        shared_plans=tuple(shared_plans),
        shared_blocks=tuple(shared_blocks),
        n_rewritten=n_rewritten,
    )
