"""Physical placement of operand pages (paper §6.3 "Requirements").

The paper's placement rules, encoded:

* operands of an AND group should be **co-located in one block** (one
  intra-block MWS covers all of them);
* operands of an OR-heavy group should be stored **inverted and co-located**
  (inverse-read intra-block MWS + De Morgan gives OR in one command);
* OR across plain operands needs them in **different blocks** (inter-block
  MWS, ≤ 4 blocks per command for the power budget).

``Layout`` tracks name -> (block, wordline, inverted) and hands out scratch
pages for planner spills.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.commands import WLS_PER_BLOCK
from repro_torch.core.expr import Expr, Node, Page, Threshold
from repro_torch.core.bitops import BitOp


@dataclass(frozen=True)
class PagePlacement:
    block: int
    wordline: int
    inverted: bool = False  # stored as complement (for De Morgan OR)
    level: int = 0  # voltage level within the physical page (MLC/TLC)


@dataclass
class Layout:
    wls_per_block: int = WLS_PER_BLOCK
    # Multi-level packing: ``levels`` consecutive logical wordlines of a
    # block co-reside in ONE physical page at distinct voltage levels
    # (1 = SLC baseline, 2/3 = MLC/TLC-style packing).  Logical wordline
    # addressing — and hence every MWS/planner coordinate — is untouched:
    # packing changes the physical footprint, program grouping, timing,
    # and reliability accounting only (the device senses all levels of a
    # physical page in one staircase read, so a logical wordline is
    # always individually addressable).  Immutable after construction.
    levels: int = 1
    placements: dict[str, PagePlacement] = field(default_factory=dict)
    _block_fill: dict[int, int] = field(default_factory=dict)
    _next_block: int = 0
    _scratch_count: int = 0
    # reverse index (block, wordline) -> name, maintained by place(); the
    # engine resolves every sensed wordline through it, so lookup must not
    # scan all placements.
    _by_location: dict[tuple[int, int], str] = field(default_factory=dict)
    # appendable page regions: region name -> the block the region is
    # currently filling.  place_colocated(..., region=...) records it, so a
    # later call with the same region continues packing the same block —
    # incremental ingest drops a column's new equality/BSI pages into the
    # column's reserved region instead of scattering one page per block.
    # Forks copy region state, keeping shard layouts appending in lockstep.
    _regions: dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not 1 <= self.levels <= 3:
            raise ValueError(
                f"levels must be 1 (SLC) .. 3 (TLC), got {self.levels}"
            )

    # -- explicit placement ------------------------------------------------
    def place(
        self, name: str, block: int, wordline: int, inverted: bool = False
    ) -> PagePlacement:
        if name in self.placements:
            raise ValueError(f"page {name!r} already placed")
        if not 0 <= wordline < self.wls_per_block:
            raise ValueError("wordline out of range")
        if (block, wordline) in self._by_location:
            raise ValueError(
                f"block {block} wl {wordline} already holds "
                f"{self._by_location[(block, wordline)]!r}"
            )
        # logical wordline w lives at level (w % levels) of physical page
        # (w // levels) — consecutive co-located pages share one cell
        p = PagePlacement(block, wordline, inverted, wordline % self.levels)
        self.placements[name] = p
        self._by_location[(block, wordline)] = name
        self._block_fill[block] = max(
            self._block_fill.get(block, 0), wordline + 1
        )
        self._next_block = max(self._next_block, block + 1)
        return p

    def page_at(self, block: int, wordline: int) -> str:
        """O(1) reverse lookup of the page programmed at a physical location."""
        try:
            return self._by_location[(block, wordline)]
        except KeyError:
            raise KeyError(f"no page at block {block} wl {wordline}") from None

    def physical_wordlines(self) -> int:
        """Physical pages the layout occupies (the index-footprint metric).

        Each block's fill packs ``levels`` logical wordlines per physical
        page, so the footprint is sum(ceil(fill / levels)) — at TLC
        packing a 48-page column costs 16 physical pages.
        """
        return sum(
            -(-fill // self.levels)
            for fill in self._block_fill.values()
            if fill
        )

    # -- snapshot / rollback (planner trial compiles) ----------------------
    def snapshot(self) -> tuple:
        """Capture all mutable state; pair with :meth:`restore`.

        Lives on Layout (not its callers) so that growing the class with a
        new index or counter keeps rollback correct in one place.
        """
        return (
            dict(self.placements),
            dict(self._block_fill),
            self._next_block,
            self._scratch_count,
            dict(self._by_location),
            dict(self._regions),
        )

    def fork(self) -> "Layout":
        """Independent copy with identical placements (shard-local layouts).

        Sharded serving programs every shard device from one canonical
        layout: forks start bit-identical, so per-shard compiled plans share
        gather shapes (and hence batch signatures) across the fleet, while
        later spill allocations stay local to each shard.
        """
        other = Layout(wls_per_block=self.wls_per_block, levels=self.levels)
        other.restore(self.snapshot())
        return other

    def restore(self, snap: tuple) -> None:
        (
            self.placements,
            self._block_fill,
            self._next_block,
            self._scratch_count,
            self._by_location,
            self._regions,
        ) = (
            dict(snap[0]),
            dict(snap[1]),
            snap[2],
            snap[3],
            dict(snap[4]),
            dict(snap[5]),
        )

    # -- allocation helpers --------------------------------------------
    def alloc_block(self) -> int:
        b = self._next_block
        self._next_block += 1
        self._block_fill[b] = 0
        return b

    def place_colocated(
        self,
        names: list[str],
        inverted: bool = False,
        region: str | None = None,
    ) -> list[PagePlacement]:
        """Pack names into as few blocks as possible (AND / De-Morgan-OR).

        With ``region``, the packing state persists: a later call naming
        the same region continues filling the region's current block, so
        incrementally-ingested pages stay co-located with the column they
        extend (a fresh block is allocated only when the region fills up).
        """
        out = []
        block = self._regions.get(region) if region is not None else None
        if block is None:
            block = self.alloc_block()
        for name in names:
            wl = self._block_fill[block]
            if wl >= self.wls_per_block:
                block = self.alloc_block()
                wl = 0
            out.append(self.place(name, block, wl, inverted))
        if region is not None:
            self._regions[region] = block
        return out

    def place_spread(self, names: list[str]) -> list[PagePlacement]:
        """One block per name (plain OR via inter-block MWS)."""
        return [self.place(n, self.alloc_block(), 0, False) for n in names]

    def alloc_scratch(self) -> tuple[str, int, int]:
        """Scratch page for planner spills (ESP-programmed intermediates)."""
        name = f"__scratch{self._scratch_count}"
        self._scratch_count += 1
        block = self.alloc_block()
        self._block_fill[block] = 1
        return name, block, 0

    def __getitem__(self, name: str) -> PagePlacement:
        return self.placements[name]

    def __contains__(self, name: str) -> bool:
        return name in self.placements


def auto_layout(expr: Expr, layout: Layout | None = None) -> Layout:
    """Derive a placement from an expression per the paper's §6.3 rules.

    AND/NAND/XOR groups of leaves -> co-located plain; OR/NOR groups of
    leaves -> co-located inverted; nested nodes recurse.  Pages already
    placed (shared between subexpressions) are left where they are.
    """
    layout = layout if layout is not None else Layout()

    def walk(e: Expr, ctx: BitOp) -> None:
        if isinstance(e, Page):
            if e.name not in layout:
                if ctx.base is BitOp.OR:
                    layout.place_colocated([e.name], inverted=True)
                else:
                    layout.place_colocated([e.name], inverted=False)
            return
        if isinstance(e, Threshold):
            # a threshold sense counts CONDUCTING blocks, and an inverted
            # page conducts when the logical bit is clear — children are
            # placed plain and spread like an inter-block OR's operands
            # (k == 1 IS the OR), one child group per block slot
            leaf_children = [c for c in e.children if isinstance(c, Page)]
            new = [c.name for c in leaf_children if c.name not in layout]
            for name in new:
                layout.place_colocated([name], inverted=False)
            for c in e.children:
                if not isinstance(c, Page):
                    walk(c, BitOp.AND)
            return
        assert isinstance(e, Node)
        leaf_children = [c for c in e.children if isinstance(c, Page)]
        new = [c.name for c in leaf_children if c.name not in layout]
        if e.op.base is BitOp.OR:
            layout.place_colocated(new, inverted=True)
        else:
            layout.place_colocated(new, inverted=False)
        for c in e.children:
            if not isinstance(c, Page):
                walk(c, e.op)

    if isinstance(expr, Threshold):
        walk(expr, BitOp.AND)
    else:
        walk(expr, expr.op if isinstance(expr, Node) else BitOp.AND)
    return layout
