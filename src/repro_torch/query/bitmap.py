"""Bitmap indexes over columnar tables, ESP-programmed into a flash array.

Two index kinds per column (classic BMI organization, cf. O'Neil/Quass):

* **equality bitmaps** — one page ``col=v`` per distinct value ``v``; bit
  ``j`` is set iff row ``j`` has that value.  ``Eq`` is one page; ``In`` is
  an OR over the member pages.
* **bit-sliced index (BSI)** — one page ``col#b`` per bit position ``b`` of
  the column's values; ``Range`` predicates evaluate with the bit-sliced
  comparison network (``repro_torch.query.compile``), needing only
  ``ceil(log2 max)`` pages regardless of cardinality.

Placement follows the paper's §6.3 rules: pages first appearing in a warmup
query are placed by :func:`repro_torch.core.placement.auto_layout`;
remaining equality bitmaps are stored **inverted and co-located per
column** — ``In`` over one column then resolves in a single inverse-read
MWS — while BSI slices are stored plain + co-located.  Everything is
ESP-programmed, so query serving is error-free per the paper's
reliability result.

The logical pages stay host-resident (numpy ``uint32``); the device holds
them only inside the flash array's packed store.  Appends, deletes and
compaction (the mutable index) are not part of this port yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

import numpy as np
import torch

from repro_torch.core.bitops import WORD_BITS, num_words, to_words, valid_mask
from repro_torch.query.ast import Query


TRUE_PAGE = "__all"
FALSE_PAGE = "__none"
# Per-stripe tombstone page: bit j is set while row j is live.  The
# compiler ANDs it into every plan's sensing set (one extra wordline per
# MWS — nearly free), so COUNT/MASK/aggregates only ever see live rows.
# Stored NON-inverted: a delete clears logical bits, which is a physical
# 1->0 transition — exactly the program NAND supports without an erase,
# so tombstoning is a single delta-page ESP program however many rows die.
VALID_PAGE = "__valid"


def eq_region(column: str) -> str:
    """Layout region holding a column's equality bitmaps (inverted)."""
    return f"eq:{column}"


def bsi_region(column: str) -> str:
    """Layout region holding a column's BSI slices (plain)."""
    return f"bsi:{column}"


def eq_page(column: str, value: int) -> str:
    return f"{column}={value}"


def bsi_page(column: str, bit: int) -> str:
    return f"{column}#{bit}"


def bsi_pages(store: "BitmapStore", column: str) -> tuple[str, ...]:
    """Every BSI slice page of ``column``, LSB first (slice b = bit b)."""
    ci = store.columns[column]
    return tuple(bsi_page(column, b) for b in range(ci.bits))


def eq_pages(store: "BitmapStore", column: str) -> tuple[str, ...]:
    """Every equality-bitmap page of ``column``, in sorted value order."""
    ci = store.columns[column]
    return tuple(eq_page(column, v) for v in ci.values)



def fetch_pages(
    store: "BitmapStore", names: tuple[str, ...], device=None
) -> torch.Tensor:
    """Stack logical pages into one ``(len(names), words)`` int32 tensor
    on ``device``.

    This is how aggregators read their extra sensed planes (BSI slices /
    equality bitmaps): the logical pages, like everything ESP-programmed
    into the array, are error-free per the paper's reliability result.
    """
    return to_words(np.stack([store.logical[n] for n in names]), device)


@dataclass(frozen=True)
class ColumnIndex:
    """Per-column metadata the compiler lowers predicates against."""

    name: str
    values: tuple[int, ...]  # distinct values present, sorted
    bits: int  # BSI slice count = bit length of max value

    @property
    def max_value(self) -> int:
        return self.values[-1] if self.values else 0


@dataclass
class BitmapStore:
    """Ingests a columnar table; owns the logical bitmap pages."""

    num_rows: int = 0
    columns: dict[str, ColumnIndex] = field(default_factory=dict)
    # packed logical pages, HOST-resident (numpy uint32); consumers upload
    # them lazily (fc_write into the packed store, fetch_pages)
    logical: dict[str, np.ndarray] = field(default_factory=dict)
    # content version: bumped per ingest — snapshot-level caches (valid-row
    # masks, stacked aggregate extras) key on it
    epoch: int = 0
    # per-column *metadata* epochs: bumped only when a column's lowering-
    # relevant index metadata (distinct values / BSI bit width) changes;
    # plan caches key on the epochs of the columns a plan's leaves touch
    column_epochs: dict[str, int] = field(default_factory=dict)
    # row capacity the pages are sized for (``reserve_rows`` headroom)
    capacity_rows: int = 0
    # fleet-wide minimum word count (zero padding, masked out of every
    # aggregation — see valid_words_mask)
    min_words: int = 0
    # rows tombstoned since ingest: always 0 until deletes are ported
    deleted_rows: int = 0

    @property
    def words(self) -> int:
        return max(
            num_words(max(self.num_rows, self.capacity_rows)),
            self.min_words,
        )

    def valid_words_mask(self) -> np.ndarray:
        """Per-word mask of real rows: zeros in the last word's slack bits
        AND in any whole padding word beyond ``num_rows``."""
        mask = np.zeros((self.words,), dtype=np.uint32)
        mask[: num_words(self.num_rows)] = valid_mask(self.num_rows)
        return mask

    # -- ingest -------------------------------------------------------------
    def ingest(
        self,
        table: dict[str, np.ndarray],
        schema: dict[str, tuple[int, ...]] | None = None,
        reserve_rows: int = 0,
    ) -> None:
        """Build equality + BSI bitmaps for every column of ``table``.

        Columns are 1-D arrays of non-negative integers, all equal length.

        ``schema`` optionally forces each column's distinct-value set (a
        superset of the values actually present).  A sharded store ingests
        every shard with the *global* schema: values absent from a shard
        still get (all-zero) equality pages and the BSI width matches the
        global maximum, so predicate lowering, placement, and hence plan
        signatures are identical on every shard.

        ``reserve_rows`` sizes every page for that many rows beyond the
        ingested table (erased, zero tail words).
        """
        lengths = {len(v) for v in table.values()}
        if len(lengths) != 1:
            raise ValueError(f"ragged table: row counts {sorted(lengths)}")
        (n,) = lengths
        if self.num_rows and n != self.num_rows:
            raise ValueError("all ingests must share one row count")
        self.num_rows = n
        self.capacity_rows = max(self.capacity_rows, n + reserve_rows)
        self.epoch += 1

        ones = np.zeros((self.words,), dtype=np.uint32)
        ones[: num_words(n)] = valid_mask(n)
        self.logical.setdefault(TRUE_PAGE, ones)
        self.logical.setdefault(
            FALSE_PAGE, np.zeros((self.words,), np.uint32)
        )
        # the tombstone page starts as a copy of the all-rows page: every
        # ingested row is live, every reserved tail row is 0 — which is
        # also what masks rows >= num_rows out of NOT/MASK plans (the
        # compiler splices this page into every plan's sensing set)
        self.logical.setdefault(VALID_PAGE, ones.copy())

        for col, raw in table.items():
            vals = np.asarray(raw)
            if n and vals.min() < 0:
                raise ValueError(f"column {col!r} has negative values")
            if schema is not None:
                distinct = np.asarray(schema[col])
                missing = np.setdiff1d(vals, distinct)
                if missing.size:
                    raise ValueError(
                        f"column {col!r} has values {missing[:5]} outside "
                        "the forced schema"
                    )
            else:
                distinct = np.unique(vals)
            bits = (
                max(int(distinct[-1]).bit_length(), 1)
                if distinct.size
                else 1
            )
            self.columns[col] = ColumnIndex(
                col, tuple(int(v) for v in distinct), bits
            )
            self.column_epochs[col] = self.column_epochs.get(col, 0) + 1
            for v in distinct:
                bitsarr = (vals == v).astype(np.uint8)
                self.logical[eq_page(col, int(v))] = self._pack(bitsarr)
            for b in range(bits):
                slice_bits = ((vals >> b) & 1).astype(np.uint8)
                self.logical[bsi_page(col, b)] = self._pack(slice_bits)

    def _pack(self, bits: np.ndarray) -> np.ndarray:
        """Pack a row-bit array into a host page of ``self.words`` words
        (LSB-first per word, little word order — same convention as
        :func:`repro_torch.core.bitops.pack_bits`)."""
        span = np.zeros((self.words * WORD_BITS,), np.uint8)
        span[: bits.shape[0]] = bits
        return np.packbits(span, bitorder="little").view(np.uint32).copy()

    # -- deletes / tombstones ------------------------------------------------
    @property
    def live_rows(self) -> int:
        """Rows a query can still match (``num_rows`` minus tombstones)."""
        return self.num_rows - self.deleted_rows

    @property
    def tombstone_density(self) -> float:
        """Fraction of resident rows that are tombstoned (compaction
        trigger: garbage the stripe carries through every sensing)."""
        return self.deleted_rows / self.num_rows if self.num_rows else 0.0

    # -- program ------------------------------------------------------------
    def place_into(self, layout, warmup: Iterable[Query] = ()) -> None:
        """Compute §6.3 placements for every bitmap page into ``layout``.

        ``warmup`` queries steer placement: their lowered expressions run
        through :func:`auto_layout` first, so hot query shapes get the
        paper's context-sensitive inverted/plain co-location.  Pages no
        warmup query touches fall back to the per-column defaults described
        in the module docstring.  Pages already placed are left alone, so a
        sharded deployment can compute one canonical layout and fork it per
        device (``Layout.fork``).
        """
        from repro_torch.core.placement import auto_layout
        from repro_torch.query.compile import lower

        for q in warmup:
            auto_layout(lower(q.where, self), layout)

        for col, ci in self.columns.items():
            eq_new = [
                eq_page(col, v)
                for v in ci.values
                if eq_page(col, v) not in layout
            ]
            if eq_new:
                layout.place_colocated(
                    eq_new, inverted=True, region=eq_region(col)
                )
            bsi_new = [
                bsi_page(col, b)
                for b in range(ci.bits)
                if bsi_page(col, b) not in layout
            ]
            if bsi_new:
                layout.place_colocated(
                    bsi_new, inverted=False, region=bsi_region(col)
                )
        for const in (TRUE_PAGE, FALSE_PAGE, VALID_PAGE):
            # VALID_PAGE placement must stay non-inverted: deletes clear
            # logical bits in place, which is only the erase-free 1->0
            # program NAND supports if physical == logical
            if const in self.logical and const not in layout:
                layout.place_colocated([const], inverted=False)

    def program(
        self, array, warmup: Iterable[Query] = ()
    ) -> tuple[int, int]:
        """ESP-program every bitmap page into ``array`` (§6.3 placement).

        Returns ``(programs, words)`` physical-program stats: logical pages
        packed into the same physical page (``layout.levels > 1``) program
        in one ISPP pass, with the lead page charging wear/ESP counters and
        the group costing ``max`` of its members' word counts.  Bit-identical
        to per-page accounting at ``levels == 1``.
        """
        self.place_into(array.layout, warmup=warmup)
        levels = array.layout.levels
        groups: dict[tuple[int, int], list[tuple[str, np.ndarray]]] = {}
        for name, words in self.logical.items():
            p = array.layout[name]
            groups.setdefault(
                (p.block, p.wordline // levels), []
            ).append((name, words))
        programs = total = 0
        for group in groups.values():
            charge = True
            for name, words in group:
                array.fc_write(name, words, esp=True, charge=charge)
                charge = False
            programs += 1
            total += max(int(w.shape[0]) for _, w in group)
        return programs, total

