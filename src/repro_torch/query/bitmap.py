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

The index is *mutable*: :meth:`BitmapStore.append` extends a live index
with new rows, reprogramming only the delta pages (tail words of pages
the new rows set bits in, plus fresh pages for first-seen values and
grown BSI widths — placed into the column's reserved layout region);
:meth:`BitmapStore.delete` clears rows' bits in the tombstone page, and
:meth:`BitmapStore.rebuild` re-ingests the live rows (the host half of
compaction).  Page word capacity is fixed at ingest (``reserve_rows``).

The logical pages stay host-resident (numpy ``uint32``); the device holds
them only inside the flash array's packed store, whose snapshot takes
each delta in place.
"""

from __future__ import annotations

import time
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
    store: "BitmapStore", names: tuple[str, ...], device
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


def validate_batch(columns, rows: dict[str, np.ndarray]) -> int:
    """Schema-level append-batch validation; returns the batch length.

    The batch's column set must EXACTLY match ``columns`` (missing and
    unknown both reject), all columns must be equal length, and values
    must be non-negative.
    """
    missing = sorted(set(columns) - set(rows))
    unknown = sorted(set(rows) - set(columns))
    if missing or unknown:
        raise ValueError(
            "append batch columns do not match the ingest schema: "
            f"missing {missing}, unknown {unknown}"
        )
    lengths = {len(v) for v in rows.values()}
    if len(lengths) != 1:
        raise ValueError(f"ragged append batch: row counts {sorted(lengths)}")
    (b,) = lengths
    for col, vals in rows.items():
        arr = np.asarray(vals)
        if b and arr.min() < 0:
            raise ValueError(f"column {col!r} has negative values")
    return b


@dataclass(frozen=True)
class PageDelta:
    """One page's contribution to an append (delta-page programming).

    ``new`` pages (equality bitmap of a first-seen value, or a BSI slice
    for a grown bit width) carry their full words and a placement region;
    existing pages carry only the tail words from ``start`` on — the words
    an append actually changes — so programming cost scales with the
    appended rows, not the rows already resident.
    """

    name: str
    start: int  # first programmed word (0 for new pages)
    words: np.ndarray  # programmed words (the full page when new)
    new: bool = False
    region: str | None = None  # layout region for new pages
    inverted: bool = False  # placement inversion for new pages


@dataclass(frozen=True)
class AppendDelta:
    """Everything :meth:`BitmapStore.append` changed, ready to program."""

    rows: int  # appended row count
    start_row: int  # first appended global row index
    pages: tuple[PageDelta, ...]

    @property
    def num_programs(self) -> int:
        """ESP page programs this delta costs (one per touched page)."""
        return len(self.pages)


@dataclass
class BitmapStore:
    """Ingests a columnar table; owns the logical bitmap pages."""

    num_rows: int = 0
    columns: dict[str, ColumnIndex] = field(default_factory=dict)
    # packed logical pages, HOST-resident (numpy uint32): appends mutate
    # only the delta words in place; consumers upload them lazily
    # (fc_write into the packed store, fetch_pages)
    logical: dict[str, np.ndarray] = field(default_factory=dict)
    # content version: bumped per ingest, append and delete —
    # snapshot-level caches (valid-row masks, stacked aggregate extras)
    # key on it
    epoch: int = 0
    # per-column *metadata* epochs: bumped only when a column's lowering-
    # relevant index metadata (distinct values / BSI bit width) changes;
    # plan caches key on the epochs of the columns a plan's leaves touch,
    # so a value-stable append leaves every plan warm
    column_epochs: dict[str, int] = field(default_factory=dict)
    # row capacity the pages are sized for: in-capacity appends only ever
    # program erased tail words; appends past it are rejected
    capacity_rows: int = 0
    # fleet-wide minimum word count (zero padding, masked out of every
    # aggregation — see valid_words_mask)
    min_words: int = 0
    # rows tombstoned since ingest/rebuild: their VALID_PAGE bits are
    # cleared and every plan masks them out; ``num_rows`` keeps counting
    # them (row ids are stable between compactions)
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

        ``reserve_rows`` sizes every page for that many future
        :meth:`append` rows beyond the ingested table — the page word
        count is fixed here, so appends beyond the reserve are rejected.
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

    # -- incremental ingest --------------------------------------------------
    def check_append(self, rows: dict[str, np.ndarray]) -> int:
        """Validate an append batch WITHOUT mutating anything; returns the
        batch length.  Raises on an un-ingested store, a column set that
        does not match the ingest schema, ragged columns, negative values,
        and word-capacity overflow."""
        if not self.columns:
            raise ValueError("append() needs an ingested store")
        b = validate_batch(self.columns, rows)
        if num_words(self.num_rows + b) > self.words:
            raise ValueError(
                f"appending {b} rows to {self.num_rows} overflows the "
                f"store's {self.words}-word page capacity "
                f"({self.capacity_rows} rows); ingest with a larger "
                "reserve_rows to leave append headroom"
            )
        return b

    def _tail_words(
        self, name: str, new_bits: np.ndarray, n0: int, b: int
    ) -> tuple[int, np.ndarray]:
        """Delta words of a page whose rows ``n0..n0+b-1`` become
        ``new_bits``: only the words an append touches, with the partial
        first word preserving the resident rows' bits."""
        sw = n0 // WORD_BITS
        ew = num_words(n0 + b)
        span = np.zeros(((ew - sw) * WORD_BITS,), np.uint8)
        off = n0 - sw * WORD_BITS
        span[off : off + b] = new_bits
        words = np.packbits(span, bitorder="little").view(np.uint32).copy()
        if off and name in self.logical:
            old = int(self.logical[name][sw])
            words[0] |= np.uint32(old & ((1 << off) - 1))
        return sw, words

    def _apply_words(self, name: str, start: int, words: np.ndarray) -> None:
        """Mutate only the delta words of a host page (O(delta))."""
        page = self.logical.get(name)
        if page is None:
            page = np.zeros((self.words,), np.uint32)
            self.logical[name] = page
        page[start : start + words.shape[0]] = words

    def append(
        self,
        rows: dict[str, np.ndarray],
        schema_update: dict[str, tuple[int, ...]] | None = None,
    ) -> AppendDelta:
        """Append ``rows`` to the live index; returns the page deltas.

        Only pages an append actually changes appear in the delta: the
        all-rows and tombstone pages and every page with a set bit among
        the new rows get their *tail words* reprogrammed in place;
        first-seen values get fresh equality pages in the column's reserved
        (inverted, co-located) layout region, and values wider than the
        column's BSI index grow fresh slice pages in the BSI region — zero
        for all resident rows, so no old page is touched.  Pages with an
        all-zero delta cost nothing.  ``schema_update`` forces the
        post-append distinct-value set per column (a superset of old ∪
        batch).  Column metadata epochs bump only for columns whose value
        set / bit width changed.
        """
        b = self.check_append(rows)
        n0 = self.num_rows
        deltas: list[PageDelta] = []

        if b:
            for const in (TRUE_PAGE, VALID_PAGE):
                # appended rows are live: the tombstone page's tail extends
                # exactly like the all-rows page's (one delta program each)
                sw, words = self._tail_words(const, np.ones((b,), np.uint8), n0, b)
                self._apply_words(const, sw, words)
                deltas.append(PageDelta(const, sw, words))

        for col, ci in self.columns.items():
            vals = np.asarray(rows[col])
            forced = schema_update.get(col, ()) if schema_update is not None else ()
            new_values = sorted(
                ({int(v) for v in vals} | {int(v) for v in forced}) - set(ci.values)
            )
            all_values = tuple(sorted(set(ci.values) | set(new_values)))
            bits = max(
                ci.bits, max((int(v).bit_length() for v in all_values), default=1)
            )
            # equality bitmaps: tails of existing pages with hits, fresh
            # pages (zero for resident rows) for first-seen values
            if b:
                for v in sorted({int(v) for v in vals} & set(ci.values)):
                    hit = (vals == v).astype(np.uint8)
                    sw, words = self._tail_words(eq_page(col, v), hit, n0, b)
                    self._apply_words(eq_page(col, v), sw, words)
                    deltas.append(PageDelta(eq_page(col, v), sw, words))
            for v in new_values:
                eq_bits = np.zeros((n0 + b,), np.uint8)
                if b:
                    eq_bits[n0:] = (vals == v).astype(np.uint8)
                full = self._pack(eq_bits)
                self.logical[eq_page(col, v)] = full
                deltas.append(
                    PageDelta(
                        eq_page(col, v), 0, full, new=True,
                        region=eq_region(col), inverted=True,
                    )
                )
            # BSI slices: tails of existing slices with set bits, fresh
            # slices for a grown bit width (resident rows are all zero
            # there: every old value < 2^old_bits)
            if b:
                for bit in range(ci.bits):
                    sl = ((vals >> bit) & 1).astype(np.uint8)
                    if not sl.any():
                        continue
                    sw, words = self._tail_words(bsi_page(col, bit), sl, n0, b)
                    self._apply_words(bsi_page(col, bit), sw, words)
                    deltas.append(PageDelta(bsi_page(col, bit), sw, words))
            for new_bit in range(ci.bits, bits):
                slice_bits = np.zeros((n0 + b,), np.uint8)
                if b:
                    slice_bits[n0:] = ((vals >> new_bit) & 1).astype(np.uint8)
                full = self._pack(slice_bits)
                self.logical[bsi_page(col, new_bit)] = full
                deltas.append(
                    PageDelta(
                        bsi_page(col, new_bit), 0, full, new=True,
                        region=bsi_region(col), inverted=False,
                    )
                )
            if new_values or bits != ci.bits:
                self.columns[col] = ColumnIndex(col, all_values, bits)
                self.column_epochs[col] = self.column_epochs.get(col, 0) + 1

        self.num_rows = n0 + b
        if b or deltas:
            self.epoch += 1
        return AppendDelta(rows=b, start_row=n0, pages=tuple(deltas))

    def program_delta(
        self, array, delta: AppendDelta, telemetry=None
    ) -> tuple[int, int]:
        """ESP-program an append's page deltas into ``array``.

        New pages are placed into their column's reserved layout region
        and programmed whole; existing pages get one delta-page program
        covering only their tail words (``fc_append``).  Returns
        ``(programs, words)`` — the PHYSICAL page programs issued and the
        physical words they covered: under multi-level packing
        (``array.layout.levels > 1``) the logical pages co-resident in one
        physical page program together in ONE ISPP pass (the group's lead
        delta charges the wear/ESP counters) and the group's word cost is
        the union span of its members' programmed words.  At ``levels ==
        1`` the accounting is per page.  ``telemetry`` (attached by the
        owning scheduler) records the pass as a trace span and histograms
        when enabled.
        """
        timed = telemetry is not None and telemetry.enabled
        t0 = time.perf_counter() if timed else 0.0
        layout = array.layout
        for pd in delta.pages:
            if pd.new and pd.name not in layout:
                layout.place_colocated(
                    [pd.name], inverted=pd.inverted, region=pd.region
                )
        levels = layout.levels
        groups: dict[tuple[int, int], list[PageDelta]] = {}
        for pd in delta.pages:
            p = layout[pd.name]
            groups.setdefault((p.block, p.wordline // levels), []).append(pd)
        programs = words = 0
        for group in groups.values():
            lo = min(pd.start for pd in group)
            hi = max(pd.start + int(pd.words.shape[0]) for pd in group)
            charge = True
            for pd in group:
                if pd.new:
                    array.fc_write(pd.name, pd.words, esp=True, charge=charge)
                else:
                    array.fc_append(pd.name, pd.words, start=pd.start, charge=charge)
                charge = False
            programs += 1
            words += hi - lo
        if timed:
            t1 = time.perf_counter()
            telemetry.span(
                "program_delta",
                "ingest",
                t0,
                t1,
                tid="ingest",
                args={"pages": delta.num_programs, "rows": delta.rows},
            )
            telemetry.observe("append_pages_programmed", delta.num_programs)
            telemetry.observe("append_program_s", t1 - t0)
        return programs, words

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

    def live_bits(self) -> np.ndarray:
        """Boolean live-row mask over ``num_rows`` (the VALID_PAGE bits)."""
        page = self.logical[VALID_PAGE]
        bits = np.unpackbits(
            page.view(np.uint8), bitorder="little", count=self.num_rows
        )
        return bits.astype(bool)

    def check_delete(self, row_ids) -> np.ndarray:
        """Validate a delete batch WITHOUT mutating; returns the unique ids.

        Raises on non-integer ids, ids outside ``[0, num_rows)``,
        duplicate ids within the batch, and ids already tombstoned.
        """
        if VALID_PAGE not in self.logical:
            raise ValueError("delete() needs an ingested store")
        raw = np.asarray(row_ids)
        if raw.size and raw.dtype.kind not in "iu":
            raise ValueError(
                f"delete ids must be integers, got dtype {raw.dtype} "
                "(a float id would silently truncate to a neighbour row)"
            )
        # sort + an adjacent-equal test, not np.unique: numpy 2.3's hashed
        # unique takes ~100 s on 50M distinct ids where the sort takes 0.7
        ids = np.sort(raw.astype(np.int64, copy=False).ravel())
        if ids.size and (ids[1:] == ids[:-1]).any():
            raise ValueError("delete batch has duplicate row ids")
        if ids.size and (ids[0] < 0 or ids[-1] >= self.num_rows):
            raise ValueError(
                f"delete ids outside [0, {self.num_rows}): "
                f"{ids[(ids < 0) | (ids >= self.num_rows)][:5]}"
            )
        if ids.size:
            page = self.logical[VALID_PAGE]
            dead = (page[ids // WORD_BITS] >> (ids % WORD_BITS)) & 1 == 0
            if dead.any():
                raise ValueError(f"rows already deleted: {ids[dead][:5]}")
        return ids

    def delete(self, row_ids) -> AppendDelta:
        """Tombstone ``row_ids``; returns the (one-page) delta to program.

        Clears the rows' VALID_PAGE bits — a physical 1->0 transition on
        the non-inverted tombstone page, so however many rows die the cost
        is ONE delta-page program spanning the touched words.  No other
        page changes and no column or region epoch moves; the content
        epoch bumps so snapshot-level caches refresh.
        """
        ids = self.check_delete(row_ids)
        if not ids.size:
            return AppendDelta(rows=0, start_row=self.num_rows, pages=())
        page = self.logical[VALID_PAGE]
        # ids are sorted and unique, so each touched word's bits form one
        # run: OR them with reduceat (ufunc.at is per-element slow on
        # older numpy, which a delete of tens of millions of rows feels)
        word = ids // WORD_BITS
        bits = np.uint32(1) << (ids % WORD_BITS).astype(np.uint32)
        run = np.flatnonzero(np.r_[True, word[1:] != word[:-1]])
        page[word[run]] &= ~np.bitwise_or.reduceat(bits, run)
        sw = int(ids[0] // WORD_BITS)
        ew = int(ids[-1] // WORD_BITS) + 1
        self.deleted_rows += int(ids.size)
        self.epoch += 1
        return AppendDelta(
            rows=0,
            start_row=self.num_rows,
            pages=(PageDelta(VALID_PAGE, sw, page[sw:ew].copy()),),
        )

    # -- compaction ------------------------------------------------------------
    def to_table(self) -> dict[str, np.ndarray]:
        """Reconstruct the resident rows' column values from the BSI pages
        (``value[row] = sum_b slice_b[row] << b``) — what compaction
        rebuilds a stripe from."""
        n = self.num_rows
        out: dict[str, np.ndarray] = {}
        for col, ci in self.columns.items():
            vals = np.zeros((n,), dtype=np.int64)
            for b in range(ci.bits):
                bits = np.unpackbits(
                    self.logical[bsi_page(col, b)].view(np.uint8),
                    bitorder="little",
                    count=n,
                )
                vals |= bits.astype(np.int64) << b
            out[col] = vals
        return out

    def rebuild(
        self,
        table: dict[str, np.ndarray],
        *,
        reserve_rows: int = 0,
        schema: dict[str, tuple[int, ...]] | None = None,
        min_words: int | None = None,
    ) -> None:
        """Reset and re-ingest in place — the host half of compaction.

        Keeps the object identity (schedulers, compilers, and aggregators
        hold references) and the epoch counters, which keep rising, so no
        cache key minted against the old index matches the rebuilt one.
        ``schema`` (normally the pre-compaction value sets) keeps pages for
        values the surviving rows no longer contain; ``reserve_rows``
        re-opens append headroom; ``min_words`` re-applies padding.
        """
        self.logical.clear()
        self.columns.clear()
        self.num_rows = 0
        self.capacity_rows = 0
        self.deleted_rows = 0
        if min_words is not None:
            self.min_words = min_words
        self.ingest(table, schema=schema, reserve_rows=reserve_rows)

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

