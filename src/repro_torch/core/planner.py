"""Expression -> Flash-Cosmos command-plan compiler (paper §6.1–6.2, Fig. 16).

Compilation model:

* A **unit** is a subexpression computable by ONE MWS command given the
  layout: a page read; an intra-block AND (plain pages, one block); a
  De-Morgan OR (inverted pages, one block, inverse read); an inter-block
  OR-of-string-ANDs (≤ 4 blocks, Eq. 1).
* Outer **AND** chains units in the S-latch (first command inits S, the rest
  accumulate — ParaBit-AND semantics).  Only the FIRST command of an S-chain
  may use inverse read (§6.2 ordering rule); additional inverse units are
  *spilled*: computed by their own chain and ESP-programmed into a scratch
  page, then re-sensed as a plain operand.
* Outer **OR** runs one command per unit, accumulating in the C-latch via
  the move-S-to-C path (ParaBit-OR semantics); every command re-inits S, so
  any number of inverse-read units is fine.  Plain intra-AND units in
  distinct blocks are merged ≤ 4-per-command into inter-block MWS (Eq. 1).
* Outer **XOR** senses one unit at a time and folds with the inter-latch
  XOR command (§6.1).
* NAND/NOR/XNOR: single-unit cases use inverse read directly; multi-command
  chains apply the final complement during DMA (controller-side inverter —
  no extra flash-array operation).

Deeper nesting spills subexpression results to scratch pages.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.bitops import BitOp
from repro_torch.core.commands import (
    MAX_INTER_BLOCKS,
    ISCM,
    BlockPBM,
    CommandPlan,
    MWSCommand,
    SpillCommand,
    ThresholdCommand,
    TransferCommand,
    XORCommand,
)
from repro_torch.core.expr import Expr, Node, Page, Threshold
from repro_torch.core.placement import Layout


@dataclass(frozen=True)
class Unit:
    """One-MWS-command realization of a subexpression."""

    targets: tuple[BlockPBM, ...]
    inverse: bool


def _merge_pbms(pbms: list[BlockPBM]) -> tuple[BlockPBM, ...]:
    by_block: dict[int, int] = {}
    for t in pbms:
        by_block[t.block] = by_block.get(t.block, 0) | t.pbm
    return tuple(BlockPBM(b, m) for b, m in sorted(by_block.items()))


def _as_unit(e: Expr, layout: Layout) -> Unit | None:
    """Try to realize ``e`` as a single MWS command; None if impossible."""
    if isinstance(e, Page):
        p = layout[e.name]
        return Unit((BlockPBM(p.block, 1 << p.wordline),), p.inverted)

    if isinstance(e, Threshold):
        return None  # always its own ThresholdCommand, never a plain MWS

    assert isinstance(e, Node)
    kids = e.children
    if len(kids) == 1 and e.op in (BitOp.NAND, BitOp.NOR):  # NOT
        inner = _as_unit(kids[0], layout)
        if inner is None:
            return None
        return Unit(inner.targets, not inner.inverse)

    if not all(isinstance(k, Page) for k in kids):
        # OR over intra-block AND groups (Eq. 1) — each child AND-unit must
        # own a distinct block.
        if e.op.base is BitOp.OR and all(
            isinstance(k, (Node, Page)) for k in kids
        ):
            units = []
            for k in kids:
                u = _as_unit(k, layout)
                if (
                    u is None
                    or u.inverse
                    or len(u.targets) != 1
                ):
                    return None
                units.append(u)
            blocks = [u.targets[0].block for u in units]
            if len(set(blocks)) != len(blocks):
                return None
            if len(blocks) > MAX_INTER_BLOCKS:
                return None
            return Unit(
                _merge_pbms([u.targets[0] for u in units]),
                e.op is BitOp.NOR,
            )
        return None

    placements = [layout[k.name] for k in kids]
    base = e.op.base

    if base is BitOp.AND:
        if any(p.inverted for p in placements):
            return None  # AND wants plain storage
        blocks = {p.block for p in placements}
        if len(blocks) != 1:
            return None  # AND across blocks needs an S-chain
        pbm = 0
        for p in placements:
            pbm |= 1 << p.wordline
        return Unit(
            (BlockPBM(placements[0].block, pbm),), e.op is BitOp.NAND
        )

    if base is BitOp.OR:
        if all(p.inverted for p in placements):
            blocks = {p.block for p in placements}
            if len(blocks) == 1:  # De Morgan: inverse read of AND of A̅_i
                pbm = 0
                for p in placements:
                    pbm |= 1 << p.wordline
                return Unit(
                    (BlockPBM(placements[0].block, pbm),),
                    e.op is BitOp.OR,  # inverse => OR; plain sense => NOR
                )
            return None
        if all(not p.inverted for p in placements):
            blocks = [p.block for p in placements]
            if len(set(blocks)) == len(blocks) and len(blocks) <= MAX_INTER_BLOCKS:
                return Unit(
                    _merge_pbms(
                        [BlockPBM(p.block, 1 << p.wordline) for p in placements]
                    ),
                    e.op is BitOp.NOR,
                )
        return None

    return None  # XOR is never a single sensing


class Planner:
    def __init__(self, layout: Layout):
        self.layout = layout

    # -- public -----------------------------------------------------------
    def compile(self, e: Expr) -> CommandPlan:
        plan = CommandPlan()
        self._compile_into(e, plan, top=True)
        plan.commands.append(
            TransferCommand(plan.result_source, plan.result_invert)
        )
        return plan

    # -- internals ----------------------------------------------------------
    def _spill(self, e: Expr, plan: CommandPlan) -> Page:
        """Compute a subexpression with its own chain and ESP-program the
        result into a scratch page; returns the scratch leaf."""
        sub = CommandPlan()
        self._compile_into(e, sub, top=False)
        plan.commands.extend(sub.commands)
        name, block, wl = self.layout.alloc_scratch()
        self.layout.place(name, block, wl, inverted=sub.result_invert)
        plan.commands.append(
            SpillCommand(block, wl, name, source=sub.result_source)
        )
        return Page(name)

    def _units_or_spill(
        self, kids: tuple[Expr, ...], plan: CommandPlan
    ) -> list[Unit]:
        units = []
        for k in kids:
            u = _as_unit(k, self.layout)
            if u is None:
                leaf = self._spill(k, plan)
                u = _as_unit(leaf, self.layout)
                assert u is not None
            units.append(u)
        return units

    def _plain_single_unit(
        self, child: Expr, plan: CommandPlan, force: bool = False
    ) -> Unit:
        """A PLAIN single-block unit for ``child``, spilling if needed.

        Threshold sensing counts conducting blocks, so every operand must
        occupy its own block and conduct exactly when its value is 1 —
        inverted storage, multi-block units, and (with ``force``) block
        collisions are resolved by ESP-spilling to a fresh scratch block.
        """
        if not force:
            u = _as_unit(child, self.layout)
            if u is not None and not u.inverse and len(u.targets) == 1:
                return u
        leaf = self._spill(child, plan)
        u = _as_unit(leaf, self.layout)
        if u.inverse:  # NAND/NOR/XNOR-rooted spill: re-sense + re-spill plain
            leaf = self._spill(Node(BitOp.AND, (leaf,)), plan)
            u = _as_unit(leaf, self.layout)
        assert u is not None and not u.inverse and len(u.targets) == 1
        return u

    def _threshold_parts(
        self, e: Threshold, plan: CommandPlan
    ) -> tuple[tuple[BlockPBM, ...], int, bool]:
        """Resolve a Threshold's children to ThresholdCommand parameters.

        Fast path: when EVERY child is an inverted single-block unit in a
        distinct block, fold the polarity into the threshold instead of
        spilling — a block then conducts iff its child is 0, and

            #set >= k  <=>  N - #conducting >= k
                       <=>  NOT (#conducting >= N - k + 1)

        so the command uses k' = N-k+1 with inverse read (complement after
        the comparison).  Otherwise children are normalized to plain units
        in distinct blocks via :meth:`_plain_single_unit`.
        """
        units = [_as_unit(c, self.layout) for c in e.children]
        if all(
            u is not None and u.inverse and len(u.targets) == 1
            for u in units
        ):
            blocks = [u.targets[0].block for u in units]
            if len(set(blocks)) == len(blocks):
                return (
                    tuple(u.targets[0] for u in units),
                    len(units) - e.k + 1,
                    True,
                )
        out: list[Unit] = []
        seen: set[int] = set()
        for child, u in zip(e.children, units):
            force = u is None or u.inverse or len(u.targets) != 1
            u = self._plain_single_unit(child, plan, force=force)
            if u.targets[0].block in seen:
                u = self._plain_single_unit(child, plan, force=True)
            seen.add(u.targets[0].block)
            out.append(u)
        return tuple(u.targets[0] for u in out), e.k, False

    def _compile_threshold(self, e: Threshold, plan: CommandPlan) -> None:
        targets, k, inverse = self._threshold_parts(e, plan)
        plan.commands.append(
            ThresholdCommand(ISCM(inverse_read=inverse), targets, k=k)
        )
        plan.result_source = "S"
        plan.result_invert = False

    def _compile_into(self, e: Expr, plan: CommandPlan, top: bool) -> None:
        if isinstance(e, Page):
            e = Node(BitOp.AND, (e,))
        if isinstance(e, Threshold):
            self._compile_threshold(e, plan)
            return
        u = _as_unit(e, self.layout)
        if u is not None:
            plan.commands.append(
                MWSCommand(ISCM(inverse_read=u.inverse), u.targets)
            )
            plan.result_source = "S"
            plan.result_invert = False
            return

        base = e.op.base
        if base is BitOp.AND:
            self._compile_and_chain(e, plan)
        elif base is BitOp.OR:
            self._compile_or_chain(e, plan)
        else:
            self._compile_xor_chain(e, plan)

    def _compile_and_chain(self, e: Node, plan: CommandPlan) -> None:
        kids = list(e.children)
        # A threshold sense resolves in the S-latch exactly like a plain
        # MWS, so ONE Threshold child may head the S-chain directly (no
        # scratch round-trip); further thresholds spill like any other
        # non-unit subexpression.
        thr_kids = [k for k in kids if isinstance(k, Threshold)]
        kids = [k for k in kids if not isinstance(k, Threshold)]
        head_cmd: ThresholdCommand | None = None
        if thr_kids:
            kids.extend(self._spill(t, plan) for t in thr_kids[1:])
            targets, tk, tinv = self._threshold_parts(thr_kids[0], plan)
            head_cmd = ThresholdCommand(
                ISCM(inverse_read=tinv, init_c_latch=False), targets, k=tk
            )
        # AND of plain same-... pages spread across blocks: group by block.
        grouped: list[Expr] = []
        by_block: dict[int, list[Page]] = {}
        for k in kids:
            if isinstance(k, Page) and not self.layout[k.name].inverted:
                by_block.setdefault(self.layout[k.name].block, []).append(k)
            else:
                grouped.append(k)
        for block_pages in by_block.values():
            grouped.append(
                block_pages[0]
                if len(block_pages) == 1
                else Node(BitOp.AND, tuple(block_pages))
            )
        units = self._units_or_spill(tuple(grouped), plan)
        inverse_units = [u for u in units if u.inverse]
        plain_units = [u for u in units if not u.inverse]
        # De Morgan merge (the Fig. 16 command-① pattern): AND of inverse
        # units == ONE inverse-read inter-block MWS over the union of their
        # targets — valid while blocks stay distinct and within the ≤4-block
        # power budget; otherwise start a new chunk.
        inv_cmds: list[tuple[BlockPBM, ...]] = []
        bucket: list[BlockPBM] = []
        blocks: set[int] = set()
        for u in inverse_units:
            tblocks = {t.block for t in u.targets}
            if blocks & tblocks or len(blocks | tblocks) > MAX_INTER_BLOCKS:
                inv_cmds.append(_merge_pbms(bucket))
                bucket, blocks = [], set()
            bucket.extend(u.targets)
            blocks |= tblocks
        if bucket:
            inv_cmds.append(_merge_pbms(bucket))
        # §6.2 ordering: the (single) inverse-read command must head the
        # S-chain; further inverse chunks are spilled and re-sensed plain.
        # When a ThresholdCommand heads the chain instead, EVERY inverse
        # chunk spills (the head slot is taken).
        if head_cmd is not None:
            ordered = list(plain_units)
            spill_chunks = inv_cmds
        else:
            ordered = (
                [Unit(inv_cmds[0], True)] if inv_cmds else []
            ) + plain_units
            spill_chunks = inv_cmds[1:]
        for extra in spill_chunks:
            # init_c_latch must stay False: when this AND chain is inlined
            # into an OR chain, a C-init here would wipe the partial OR.
            plan.commands.append(
                MWSCommand(
                    ISCM(inverse_read=True, init_c_latch=False), extra
                )
            )
            name, block, wl = self.layout.alloc_scratch()
            self.layout.place(name, block, wl)
            plan.commands.append(SpillCommand(block, wl, name, source="S"))
            ordered.append(_as_unit(Page(name), self.layout))
        if head_cmd is not None:
            plan.commands.append(head_cmd)
        for i, u in enumerate(ordered):
            plan.commands.append(
                MWSCommand(
                    ISCM(
                        inverse_read=u.inverse,
                        init_s_latch=(i == 0 and head_cmd is None),
                        init_c_latch=False,  # C-latch untouched by AND chains
                    ),
                    u.targets,
                )
            )
        plan.result_source = "S"
        plan.result_invert = e.op is BitOp.NAND

    def _compile_or_chain(self, e: Node, plan: CommandPlan) -> None:
        # Non-unit AND children can be inlined: run their S-chain and pulse
        # move-S-to-C only on the LAST command (intermediate partial ANDs
        # must not leak into the C-latch OR).  Chains whose own sub-plan
        # needs the C-latch (spilled OR/XOR subexpressions) CANNOT be
        # inlined — they would clobber the accumulating OR — and go through
        # the unit/spill path like everything else.
        unit_kids: list[Expr] = []
        inline_chains: list[tuple[Node, CommandPlan]] = []
        thr_parts: list[tuple[tuple[BlockPBM, ...], int, bool]] = []
        for k in e.children:
            if isinstance(k, Threshold):
                # a threshold sense lands in S like a plain MWS; OR it into
                # the C-latch directly (every OR command re-inits S, so any
                # number of thresholds is fine).  Child spills emitted here
                # run before the C accumulation starts.
                thr_parts.append(self._threshold_parts(k, plan))
                continue
            if (
                isinstance(k, Node)
                and k.op is BitOp.AND
                and _as_unit(k, self.layout) is None
            ):
                # Trial-compile against a layout snapshot: a rejected chain
                # must not leak its scratch placements (they would pile up
                # in a long-running service) nor advance the scratch
                # counter for pages that are recompiled via _spill below.
                snap = self.layout.snapshot()
                sub = CommandPlan()
                self._compile_and_chain(k, sub)
                if not any(
                    isinstance(c, XORCommand)
                    or (
                        isinstance(c, MWSCommand)
                        and (c.iscm.init_c_latch or c.iscm.move_s_to_c)
                    )
                    for c in sub.commands
                ):
                    inline_chains.append((k, sub))
                    continue
                self.layout.restore(snap)
            unit_kids.append(k)
        units = self._units_or_spill(tuple(unit_kids), plan)
        # Merge plain single-block units into inter-block commands (Eq. 1).
        plain = [u for u in units if not u.inverse and len(u.targets) == 1]
        others = [u for u in units if u.inverse or len(u.targets) > 1]
        merged: list[Unit] = []
        bucket: list[BlockPBM] = []
        seen_blocks: set[int] = set()
        for u in plain:
            t = u.targets[0]
            if t.block in seen_blocks or len(bucket) == MAX_INTER_BLOCKS:
                merged.append(Unit(_merge_pbms(bucket), False))
                bucket, seen_blocks = [], set()
            bucket.append(t)
            seen_blocks.add(t.block)
        if bucket:
            merged.append(Unit(_merge_pbms(bucket), False))
        all_units = merged + others
        first_c = True
        for u in all_units:
            plan.commands.append(
                MWSCommand(
                    ISCM(
                        inverse_read=u.inverse,
                        init_s_latch=True,
                        init_c_latch=first_c,
                        move_s_to_c=True,
                    ),
                    u.targets,
                )
            )
            first_c = False
        for targets, tk, tinv in thr_parts:
            plan.commands.append(
                ThresholdCommand(
                    ISCM(
                        inverse_read=tinv,
                        init_s_latch=True,
                        init_c_latch=first_c,
                        move_s_to_c=True,
                    ),
                    targets,
                    k=tk,
                )
            )
            first_c = False
        for _chain, sub in inline_chains:
            assert not sub.result_invert  # op is AND (not NAND) by filter
            cmds = [c for c in sub.commands if isinstance(c, MWSCommand)]
            last = cmds[-1]
            for c in sub.commands:
                if c is last:
                    iscm = ISCM(
                        inverse_read=last.iscm.inverse_read,
                        init_s_latch=last.iscm.init_s_latch,
                        init_c_latch=first_c,
                        move_s_to_c=True,
                    )
                    if isinstance(last, ThresholdCommand):
                        plan.commands.append(
                            ThresholdCommand(iscm, last.targets, k=last.k)
                        )
                    else:
                        plan.commands.append(MWSCommand(iscm, last.targets))
                else:
                    plan.commands.append(c)
            first_c = False
        plan.result_source = "C"
        plan.result_invert = e.op is BitOp.NOR

    def _compile_xor_chain(self, e: Node, plan: CommandPlan) -> None:
        units = self._units_or_spill(e.children, plan)
        for i, u in enumerate(units):
            plan.commands.append(
                MWSCommand(
                    ISCM(
                        inverse_read=u.inverse,
                        init_s_latch=True,
                        init_c_latch=(i == 0),
                        move_s_to_c=(i == 0),
                    ),
                    u.targets,
                )
            )
            if i > 0:
                plan.commands.append(XORCommand())
        plan.result_source = "C" if len(units) > 1 else "S"
        plan.result_invert = e.op is BitOp.XNOR
