"""Sharded FlashQL: one bitmap index striped over a fleet of FlashDevices.

The paper's SSD-level evaluation (§8) spreads an 800M-user bitmap over
many chips; this module is the serving-layer analogue.  A
:class:`ShardedBitmapStore` partitions table *rows* over ``num_shards``
independent :class:`repro_torch.query.device.FlashDevice`s — round-robin
(``policy="roundrobin"``) or contiguous ranges (``policy="range"``) — and
:class:`ShardedFlashQL` serves batched queries against the fleet:

* **scatter** — every admitted query fans out to each shard's queue;
  per-shard :class:`QueryCompiler`s compile it through that shard's plan
  cache (placements and cache keys are per device, so mutating one shard
  recompiles only that shard);
* **execute** — shard batches run as one batched launch sequence per
  signature *group* across the whole fleet: shards ingest with the global
  column schema and program from one forked canonical layout, so the same
  query yields the same plan signature on every shard, and plan-aware
  padding (:func:`repro_torch.query.device.group_execs`) merges the
  remaining shape variance.  Every shard's snapshot lives in one fleet
  tensor ``(shards, cap, words)`` on the card (each shard's
  ``PackedStore`` keeps its slab as its device buffer, so writes land
  there in place), and each batch element's slot indices are shifted
  into its own shard's rows — one gather-reduce launch per MWS step
  covers the group on every shard;
* **gather** — every aggregate flows through the pluggable
  :class:`repro_torch.query.aggregate.Aggregator` pipeline: shard batches
  reduce on the device (one weighted-popcount per reduce signature), and
  each aggregate's shard-merge rule combines the partials — ``COUNT``/
  ``SUM`` sum, ``MIN``/``MAX`` take the extremum, ``TOP-K``/``GROUP BY``
  merge per-value count vectors (the global schema aligns value order
  across shards), ``MASK`` un-stripes bitmaps back into global row order.
  The all-ones identity rows that pad ragged gathers, the packed word
  slack, and the fleet-width padding words of the last (short) stripe are
  all masked out via each shard's ``valid_words_mask``;
* **routing** — a ``range``-striped store (optionally ``stripe_key``-sorted
  so stripes hold disjoint key ranges) prunes shards whose stripe provably
  cannot match the query root (an ``Eq``/``In``/``Range`` conjunct with no
  overlapping values on that shard) *before* scatter: the shard never
  senses, and its partial is the aggregate's empty value.

* **appends** — :meth:`ShardedFlashQL.append` extends the live fleet:
  round-robin fleets stripe the tail rows onward (row ``j`` -> shard
  ``j % N``), ``stripe_key`` fleets route each row to the stripe owning
  its key range (keys past every range overflow into the last stripe),
  and plain ``range`` fleets extend the tail stripe.  Every stripe
  programs only its delta pages; first-seen values propagate to ALL
  shards as a forced schema update so aggregate shard-merges stay
  value-aligned, and ``shard_values``/``stripe_bounds`` track the new
  rows so range pruning stays sound.

* **pipelining** — with ``pipeline=True`` the fleet flushes
  *asynchronously*: each shard's batch compiles into one fused device
  program (sensing + every aggregate reduce, one payload — see
  :func:`repro_torch.query.compile.compile_flush`) and shard *k+1* is
  enqueued before shard *k*'s payload is gathered.  On the card the
  gather copies shard *k*'s payload on a side stream into pinned host
  memory after an event recorded right behind shard *k*'s program, so it
  waits for that program only, while shard *k+1*'s kernels run.
  Routing-aware queue depths let range-pruned shards donate their slots
  to hot stripes.  The lockstep path (default) remains the differential
  oracle.

``projection()`` replays each device's executed traffic through the
flashsim timing/energy model and aggregates over the fleet — wall-clock
as the max over concurrently-serving chips, energy as the sum — charging
appends for exactly the delta pages they ESP-programmed.
"""

from __future__ import annotations

import bisect
import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np
import torch

from repro_torch.core.bitops import num_words as _num_words
from repro_torch.core.bitops import to_words
from repro_torch.core.placement import Layout
from repro_torch.flashsim.geometry import DEFAULT_SSD, SSDConfig
from repro_torch.query.aggregate import (
    get_aggregator,
    merge_mask_batch,
    reduce_flush,
    validate_query,
)
from repro_torch.query.ast import And, Eq, In, Or, Pred, Query, Range
from repro_torch.query.bitmap import BitmapStore, validate_batch
from repro_torch.query.compile import QueryCompiler, compile_flush
from repro_torch.query.device import (
    FlashDevice,
    age_spill_blocks,
    encode_idx,
    group_execs,
    make_plan_runner,
    offset_slots,
    reorder_rows,
)
from repro_torch.query.optimize import cse_flush
from repro_torch.query.scheduler import (
    AGG_READ_SHAPE,
    QueryResult,
    attribute_result,
    merge_appends,
    plan_sensings,
    plan_thresholds,
    plan_traffic,
    project_traffic,
    queue_append,
    record_plan_traffic,
    registry_counters,
)
from repro_torch.query.telemetry import (
    TID_FLUSH,
    TID_MERGE,
    TID_TICKETS,
    Telemetry,
)

POLICIES = ("roundrobin", "range")


def _program_grouped(dev: FlashDevice, logical: dict) -> tuple[int, int]:
    """ESP-program a shard's logical pages grouped by PHYSICAL page.

    Under multi-level packing (``dev.layout.levels > 1``) the logical
    pages co-resident in one physical page program in a single ISPP pass:
    the group lead charges the wear/ESP counters, the other levels ride
    along (``charge=False``).  Returns ``(programs, words)`` physical
    stats — identical to per-page accounting at ``levels == 1``.
    """
    levels = dev.layout.levels
    groups: dict[tuple[int, int], list] = {}
    for name, words in logical.items():
        p = dev.layout[name]
        groups.setdefault((p.block, p.wordline // levels), []).append(
            (name, words)
        )
    programs = total = 0
    for group in groups.values():
        charge = True
        for name, words in group:
            dev.fc_write(name, words, esp=True, charge=charge)
            charge = False
        programs += 1
        total += max(int(w.shape[0]) for _, w in group)
    return programs, total


def stripe_rows(
    num_rows: int, num_shards: int, policy: str = "roundrobin"
) -> list[np.ndarray]:
    """Global row indices per shard, each in ascending (shard-local) order.

    ``roundrobin`` assigns row ``j`` to shard ``j % num_shards`` (balanced
    within one row); ``range`` cuts ``ceil(n / num_shards)``-row contiguous
    stripes (trailing shards may be short or empty).
    """
    if policy == "roundrobin":
        return [
            np.arange(s, num_rows, num_shards) for s in range(num_shards)
        ]
    if policy == "range":
        chunk = -(-num_rows // num_shards) if num_rows else 0
        return [
            np.arange(
                min(s * chunk, num_rows), min((s + 1) * chunk, num_rows)
            )
            for s in range(num_shards)
        ]
    raise ValueError(f"unknown stripe policy {policy!r}; use {POLICIES}")


def shard_cannot_match(
    pred: Pred, values: dict[str, tuple[int, ...]]
) -> bool:
    """Conservatively prove ``pred`` selects no rows on a shard that holds
    exactly the (sorted) per-column distinct ``values``.

    Sound, not complete: ``True`` means the shard's stripe provably cannot
    match (the result is empty there, no sensing needed); ``False`` means
    "might match".  ``Not`` is never pruned through — its complement could
    match anything — and ``And``/``Or`` prune if any / every child does.
    This is what makes ``Range``/``Eq`` roots route on a range-striped,
    ``stripe_key``-sorted store: stripes hold disjoint key ranges, so most
    shards fail the overlap test.
    """
    if isinstance(pred, Eq):
        vs = values.get(pred.column, ())
        i = bisect.bisect_left(vs, pred.value)
        return not (i < len(vs) and vs[i] == pred.value)
    if isinstance(pred, In):
        return all(
            shard_cannot_match(Eq(pred.column, v), values)
            for v in pred.values
        )
    if isinstance(pred, Range):
        vs = values.get(pred.column, ())
        i = (
            bisect.bisect_left(vs, pred.lo)
            if pred.lo is not None
            else 0
        )
        # no shard value >= lo, or the smallest such value exceeds hi
        return i >= len(vs) or (
            pred.hi is not None and vs[i] > pred.hi
        )
    if isinstance(pred, And):
        return any(shard_cannot_match(c, values) for c in pred.children)
    if isinstance(pred, Or):
        return all(shard_cannot_match(c, values) for c in pred.children)
    return False  # Not: conservatively assume it can match


@dataclass
class ShardedBitmapStore:
    """Row-striped bitmap index over ``num_shards`` shard-local stores.

    Every shard ingests its row subset with the *global* schema (union of
    distinct values per column), so a value absent from one shard still
    gets an all-zero equality page there: predicate lowering, placement,
    plan-cache keys, and batch signatures line up across the fleet.  Pages
    are zero-padded to a fleet-wide word count so shard snapshots share
    one width (and one fleet tensor).

    ``stripe_key`` (``range`` policy only) orders rows by that column's
    value before cutting contiguous stripes, so each shard holds a
    disjoint key range and ``Range``/``Eq`` queries on the key route to
    few shards (see :meth:`ShardedFlashQL.submit`).  Global row order —
    what ``MASK`` results and ``row_maps`` refer to — stays the table's
    ingest order.
    """

    num_shards: int
    policy: str = "roundrobin"
    stripe_key: str | None = None
    # row capacity reserved for appends (shared headroom: any stripe may
    # absorb the whole budget, since stripe-key routing is data-dependent)
    reserve_rows: int = 0
    shards: list[BitmapStore] = field(default_factory=list)
    row_maps: list[np.ndarray] = field(default_factory=list)
    num_rows: int = 0
    schema: dict[str, tuple[int, ...]] = field(default_factory=dict)
    # values actually PRESENT on each shard (the shard-local stores carry
    # the forced global schema, so routing needs this recorded separately)
    shard_values: list[dict[str, tuple[int, ...]]] = field(
        default_factory=list
    )
    # per-shard (lo, hi) of the stripe key (stripe_key fleets): appends
    # route to the stripe owning their key range (see :meth:`append`)
    stripe_bounds: list[tuple[int, int] | None] = field(
        default_factory=list
    )
    # the inverse of row_maps (global id -> shard, local position), built
    # once per set of row_maps arrays (see locate_rows)
    _inverse: tuple | None = field(default=None, repr=False)

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError("need at least one shard")
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown stripe policy {self.policy!r}; use {POLICIES}"
            )
        if self.stripe_key is not None and self.policy != "range":
            raise ValueError("stripe_key requires policy='range'")
        if not self.shards:
            self.shards = [BitmapStore() for _ in range(self.num_shards)]

    @property
    def active(self) -> list[int]:
        """Shards that hold at least one row (a short table can leave
        trailing ``range``-policy shards empty)."""
        return [s for s in range(self.num_shards) if self.shards[s].num_rows]

    # -- ingest -------------------------------------------------------------
    def ingest(self, table: dict[str, np.ndarray]) -> None:
        lengths = {len(v) for v in table.values()}
        if len(lengths) != 1:
            raise ValueError(f"ragged table: row counts {sorted(lengths)}")
        (n,) = lengths
        if self.num_rows and n != self.num_rows:
            raise ValueError("all ingests must share one row count")
        self.num_rows = n
        self.schema = {
            col: tuple(int(v) for v in np.unique(np.asarray(vals)))
            for col, vals in table.items()
        }
        if self.stripe_key is not None:
            if self.stripe_key not in table:
                raise KeyError(
                    f"stripe_key {self.stripe_key!r} not in table"
                )
            # contiguous stripes over the key-sorted order: each shard
            # holds a disjoint (sorted) key range, which is what makes
            # range routing prune; row_maps keep global (ingest) indices
            order = np.argsort(
                np.asarray(table[self.stripe_key]), kind="stable"
            )
            self.row_maps = [
                order[chunk]
                for chunk in stripe_rows(n, self.num_shards, "range")
            ]
        else:
            self.row_maps = stripe_rows(n, self.num_shards, self.policy)
        fleet_words = max(
            (
                _num_words(len(rows) + self.reserve_rows)
                for rows in self.row_maps
            ),
            default=0,
        )
        self.shard_values = [{} for _ in range(self.num_shards)]
        self.stripe_bounds = [None] * self.num_shards
        for s, (store, rows) in enumerate(zip(self.shards, self.row_maps)):
            if not len(rows):
                continue
            sub = {col: np.asarray(v)[rows] for col, v in table.items()}
            self.shard_values[s] = {
                col: tuple(int(v) for v in np.unique(vals))
                for col, vals in sub.items()
            }
            if self.stripe_key is not None:
                keys = sub[self.stripe_key]
                self.stripe_bounds[s] = (int(keys.min()), int(keys.max()))
            store.min_words = fleet_words
            store.ingest(
                sub, schema=self.schema, reserve_rows=self.reserve_rows
            )

    # -- incremental ingest --------------------------------------------------
    def _route_append(self, rows: dict[str, np.ndarray]):
        """Route + validate an append batch WITHOUT mutating anything.

        Returns ``(b, n0, active, subs, new_schema, changed)`` where
        ``subs`` maps each active shard to its (sub-batch, picked row
        positions).  Shared by :meth:`append` (which then mutates) and
        :meth:`check_append` (coalescing schedulers validate each queued
        batch cumulatively before accepting it).
        """
        if not self.num_rows:
            raise ValueError("append() needs an ingested store")
        b = validate_batch(self.schema, rows)
        arrays = {col: np.asarray(v) for col, v in rows.items()}
        n0 = self.num_rows
        active = self.active
        act = np.asarray(active, np.int64)

        # -- destination stripe per appended row
        if self.policy == "roundrobin":
            if len(active) == self.num_shards:
                dest = (n0 + np.arange(b)) % self.num_shards
            else:  # short table left trailing shards empty (never ingested)
                dest = act[(n0 + np.arange(b)) % len(active)]
        elif self.stripe_key is not None:
            his = np.asarray(
                [self.stripe_bounds[s][1] for s in active], np.int64
            )
            keys = arrays[self.stripe_key]
            owner = np.minimum(
                np.searchsorted(his, keys), len(active) - 1
            )  # past every range -> overflow into the last stripe
            dest = act[owner]
        else:  # plain range: the tail stripe owns all new positions
            dest = np.full((b,), active[-1], np.int64)

        new_schema = {
            col: tuple(
                sorted(set(vs) | {int(v) for v in arrays[col]})
            )
            for col, vs in self.schema.items()
        }
        changed = new_schema != self.schema

        # -- validate every destination BEFORE any shard mutates
        subs: dict[int, tuple[dict[str, np.ndarray], np.ndarray]] = {}
        for s in active:
            picked = np.flatnonzero(dest == s)
            subs[s] = (
                {col: arr[picked] for col, arr in arrays.items()},
                picked,
            )
        for s in active:
            sub, picked = subs[s]
            if len(picked) or changed:
                self.shards[s].check_append(sub)
        return b, n0, active, subs, new_schema, changed

    def check_append(self, rows: dict[str, np.ndarray]) -> int:
        """Fleet-wide append validation (no mutation); returns batch size."""
        b, *_ = self._route_append(rows)
        return b

    def append(self, rows: dict[str, np.ndarray]) -> dict[int, object]:
        """Route an append batch to its stripes; returns per-shard deltas.

        Routing by policy: ``roundrobin`` continues the stripe sequence
        (global row ``j`` -> shard ``j % num_shards``); a ``stripe_key``
        fleet routes each row to the stripe *owning* its key (the first
        stripe whose recorded key range reaches the key) with keys beyond
        every range overflowing into the last stripe; plain ``range``
        appends extend the tail stripe (new rows hold the highest global
        positions).  The whole batch — column set, lengths, values, and
        every destination shard's word capacity — is validated before any
        shard mutates.

        New values are propagated to EVERY active shard as a forced
        schema update (all-zero equality pages where absent), keeping
        value order aligned fleet-wide so aggregate shard-merges stay
        correct; ``shard_values`` records only the values actually
        present per stripe, so range routing keeps pruning soundly.
        """
        b, n0, active, subs, new_schema, changed = self._route_append(rows)

        # -- mutate
        deltas: dict[int, object] = {}
        for s in active:
            sub, picked = subs[s]
            if not len(picked) and not changed:
                continue
            deltas[s] = self.shards[s].append(sub, schema_update=new_schema)
            if not len(picked):
                continue
            self.row_maps[s] = np.concatenate(
                [self.row_maps[s], n0 + picked]
            )
            sv = dict(self.shard_values[s])
            for col, arr in sub.items():
                sv[col] = tuple(
                    sorted(set(sv.get(col, ())) | {int(v) for v in arr})
                )
            self.shard_values[s] = sv
            if self.stripe_key is not None:
                lo, hi = self.stripe_bounds[s]
                keys = sub[self.stripe_key]
                self.stripe_bounds[s] = (
                    min(lo, int(keys.min())),
                    max(hi, int(keys.max())),
                )
        self.schema = new_schema
        self.num_rows = n0 + b
        return deltas

    # -- deletes / tombstones ------------------------------------------------
    @property
    def deleted_rows(self) -> int:
        return sum(st.deleted_rows for st in self.shards)

    @property
    def live_rows(self) -> int:
        return self.num_rows - self.deleted_rows

    @property
    def tombstone_density(self) -> float:
        """Fleet-wide tombstone fraction (the auto-compaction trigger)."""
        return self.deleted_rows / self.num_rows if self.num_rows else 0.0

    def _row_inverse(self) -> tuple[np.ndarray, np.ndarray]:
        """``(shard_of, pos_of)`` over global ids: each row's stripe and
        its position there.  Built once per set of ``row_maps`` arrays
        (every mutation of the maps replaces an array, never writes into
        one; the cache holds the arrays it was built from, so their ids
        stay unique while it lives)."""
        key = (self.num_rows,) + tuple(id(m) for m in self.row_maps)
        if self._inverse is None or self._inverse[0] != key:
            shard_of = np.full((self.num_rows,), -1, dtype=np.int32)
            pos_of = np.zeros((self.num_rows,), dtype=np.int64)
            for s, rmap in enumerate(self.row_maps):
                shard_of[rmap] = s
                pos_of[rmap] = np.arange(len(rmap))
            self._inverse = (key, list(self.row_maps), shard_of, pos_of)
        return self._inverse[2], self._inverse[3]

    def locate_rows(self, row_ids) -> dict[int, np.ndarray]:
        """Route global row ids to shard-local positions.

        Returns ``{shard: local positions}``.  ``row_maps`` are NOT
        ascending in global id on ``stripe_key`` fleets (they follow the
        key-sorted stripe order), so routing inverts the maps outright
        instead of binary-searching them.
        """
        raw = np.asarray(row_ids)
        if raw.size and raw.dtype.kind not in "iu":
            raise ValueError(
                f"delete ids must be integers, got dtype {raw.dtype} "
                "(a float id would silently truncate to a neighbour row)"
            )
        # sort + an adjacent-equal test, not np.unique (see
        # BitmapStore.check_delete): same ids, same errors
        ids = np.sort(raw.astype(np.int64, copy=False).ravel())
        if ids.size and (ids[1:] == ids[:-1]).any():
            raise ValueError("delete batch has duplicate row ids")
        if ids.size and (ids[0] < 0 or ids[-1] >= self.num_rows):
            raise ValueError(
                f"delete ids outside [0, {self.num_rows}): "
                f"{ids[(ids < 0) | (ids >= self.num_rows)][:5]}"
            )
        shard_of, pos_of = self._row_inverse()
        groups: dict[int, np.ndarray] = {}
        owners = shard_of[ids]
        for s in np.flatnonzero(np.bincount(owners, minlength=self.num_shards)):
            groups[int(s)] = pos_of[ids[owners == s]]
        return groups

    def check_delete(self, row_ids) -> dict[int, np.ndarray]:
        """Fleet-wide delete validation (no mutation); returns the routing.
        Every destination shard validates BEFORE any shard mutates."""
        groups = self.locate_rows(row_ids)
        for s, local in groups.items():
            self.shards[s].check_delete(local)
        return groups

    def delete(self, row_ids) -> dict[int, object]:
        """Tombstone global ``row_ids``; returns per-shard deltas to program.

        Each destination stripe clears its local VALID_PAGE bits — one
        delta-page program per touched stripe, no row renumbering, no
        region epoch moves, plans stay warm fleet-wide.
        """
        groups = self.check_delete(row_ids)
        return {
            s: self.shards[s].delete(local) for s, local in groups.items()
        }

    # -- program ------------------------------------------------------------
    def program(
        self, devices: list[FlashDevice], warmup: Iterable[Query] = ()
    ) -> None:
        """ESP-program every shard into its device from ONE canonical
        layout: placements are computed once (§6.3 rules, warmup-steered)
        against the global schema and forked per device, so physically
        identical pages sit at identical (block, wordline) coordinates on
        every chip."""
        if len(devices) != self.num_shards:
            raise ValueError(
                f"{self.num_shards} shards need {self.num_shards} devices, "
                f"got {len(devices)}"
            )
        if not self.active:
            raise ValueError("ingest a table before programming")
        lead = devices[0].layout
        canonical = Layout(
            wls_per_block=lead.wls_per_block, levels=lead.levels
        )
        self.shards[self.active[0]].place_into(canonical, warmup=warmup)
        for s, dev in enumerate(devices):
            dev.layout = canonical.fork()
            _program_grouped(dev, self.shards[s].logical)


@dataclass(frozen=True)
class FleetTensor:
    """One ``(shards, cap, words)`` int32 device tensor whose slab
    ``data[p]`` is the device buffer of shard ``shards[p]``'s
    ``PackedStore``: every shard's snapshot, in place, with no stacked
    copy.  ``cap`` is at least every member store's host capacity, so
    writes (appends, deletes, updates, new slots up to ``cap``) land in
    the slabs; a slot past ``cap`` moves its store to a tensor of its own,
    and the next lockstep flush rebuilds the fleet at the new capacity."""

    data: torch.Tensor
    shards: tuple[int, ...]
    slabs: tuple[torch.Tensor, ...]  # data[p], as bound to the stores

    @property
    def cap(self) -> int:
        return int(self.data.shape[1])

    def base(self, s: int) -> int:
        """Row of shard ``s``'s slot 0 in the flat ``(shards * cap, W)``
        source."""
        return self.shards.index(s) * self.cap

    def serves(self, shards, devices) -> bool:
        """Whether every one of ``shards`` still reads its slab."""
        return all(
            s in self.shards
            and devices[s].store.bound_to(self.slabs[self.shards.index(s)])
            for s in shards
        )

    @property
    def source(self) -> torch.Tensor:
        return self.data.view(-1, self.data.shape[2])


def _payload_to_host(payload: torch.Tensor, ready, stream) -> np.ndarray:
    """One shard payload's words on the host (``uint32``): the blocking
    point of a pipelined gather.  On the card the copy runs on ``stream``
    after ``ready`` — the event recorded right behind the shard's program —
    into pinned memory, so it waits for that program alone and not for
    the shard programs enqueued after it; on the CPU it is ``.cpu()``."""
    if ready is None:
        return payload.cpu().numpy().view(np.uint32)
    host = torch.empty(payload.shape, dtype=payload.dtype, pin_memory=True)
    stream.wait_event(ready)
    with torch.cuda.stream(stream):
        host.copy_(payload, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return host.numpy().view(np.uint32)


@dataclass
class ShardedFlashQL:
    """Batched query serving over a sharded bitmap store (scatter/gather).

    The sharded counterpart of
    :class:`repro_torch.query.scheduler.BatchScheduler`: ``submit`` fans a
    query out to every shard's queue; ``flush`` drains up to
    ``queue_depth`` queries from each shard, executes all shard batches
    (one batched launch sequence per cross-shard signature group over the
    fleet tensor when shard snapshots share a shape; per-device batches
    otherwise), and gathers partial results into per-ticket
    :class:`QueryResult`s.
    """

    store: ShardedBitmapStore
    devices: list[FlashDevice]
    queue_depth: int = 256  # per-shard admissions per flush
    fuse_across_shards: bool = True
    # Pipelined (asynchronous per-shard) flushing: every shard's batch
    # compiles into ONE fused device program (sensing + every aggregate
    # reduce, see repro_torch.query.compile.compile_flush) and shards are
    # enqueued back-to-back, each payload gathered only after the next
    # shard's program was enqueued (double-buffered).  Routing-aware depths
    # let range-pruned shards donate their queue slots to hot stripes.
    # False keeps the lockstep flush (cross-shard signature groups +
    # per-reduce-signature transfers) — the differential oracle.
    pipeline: bool = False
    coalesce_appends: bool = False
    # -- the cost-based multi-query optimizer (repro_torch.query.optimize) --
    # per-shard canonicalized plan caching + cost-based chain orderings,
    # whole-plan dedup across the lockstep batch, full subtree CSE inside
    # each shard's fused pipelined flush, and fleet-wide hot-predicate
    # materialization; False serves exactly as before (the optimizer-off
    # baseline)
    optimize: bool = True
    # compiles of one canonical predicate before its result bitmap is
    # ESP-programmed on EVERY shard (fleet-wide, so device snapshot
    # shapes stay aligned); None disables materialization only
    materialize_after: int | None = 32
    # background-compaction policy: once the fleet's tombstone density
    # crosses this threshold (checked at mutation boundaries, never mid-
    # flush), compact() rebuilds the tombstoned stripes; None disables
    compact_density: float | None = None
    # grow capacity through the compaction rebuild instead of refusing an
    # overflowing append (re-stripes into wider pages, fleet-wide)
    grow_on_overflow: bool = False
    compilers: list[QueryCompiler] = field(default_factory=list)
    # the unified metrics registry + trace recorder shared by the fleet;
    # pass Telemetry(enabled=False) to strip every per-event recorder off
    # the hot path (counters keep counting — stats()/projection read them)
    telemetry: Telemetry = None  # type: ignore[assignment]

    _queues: list[list[tuple[int, Query]]] = field(default_factory=list)
    _meta: dict[int, tuple[Query, float]] = field(default_factory=dict)
    # per-ticket partials: shard -> int popcount (COUNT) / np words (MASK)
    _partials: dict[int, dict[int, object]] = field(default_factory=dict)
    _cache_hits: dict[int, bool] = field(default_factory=dict)
    _next_ticket: int = 0
    _runners: dict = field(default_factory=dict, repr=False)
    # the fleet tensor backing every shard snapshot (lockstep path)
    _fleet: FleetTensor | None = field(default=None, repr=False)
    _masks: list[np.ndarray] | None = field(default=None, repr=False)
    # fused-path analogue of FlashDevice._batch_cache: memoized grouping
    # and device-resident, fleet-offset gather idxs per batch composition
    _group_cache: dict = field(default_factory=dict, repr=False)
    _maskmat_cache: dict = field(default_factory=dict, repr=False)
    # stacked extra sensed planes per (shard, epoch, page tuple) — see
    # repro_torch.query.aggregate.reduce_flush
    _extras_cache: dict = field(default_factory=dict, repr=False)
    # pipelined mode: per-shard fused flush programs keyed on (shard,
    # batch composition, epochs) + shared runners per flush signature
    # (identical shard schemas share one runner)
    _flush_programs: dict = field(default_factory=dict, repr=False)
    _runner_cache: dict = field(default_factory=dict, repr=False)
    _mask_rows: dict = field(default_factory=dict, repr=False)
    # per-shard flush-level CSE rewrites, keyed on (shard, batch
    # composition, epochs) — see repro_torch.query.optimize.cse_flush
    _cse_cache: dict = field(default_factory=dict, repr=False)
    # queued (validated) append batches awaiting coalesced programming
    _append_buf: list = field(default_factory=list, repr=False)
    # the side stream pipelined gathers copy payloads on (card only)
    _copy_stream: object = field(default=None, repr=False)

    # -- stats --------------------------------------------------------------
    # counter attributes (queries_served, flushes, host_transfers, …) are
    # registry-backed properties — see registry_counters() below the class.
    # Projected-traffic shape counts stay real fields (Counter-valued).
    shard_traffic: list[Counter] = field(default_factory=list)
    # per-ticket attribution under accumulation (telemetry enabled only;
    # popped with the ticket in _collect_done, so in-flight size is
    # bounded by in-flight tickets)
    _attr: dict[int, dict] = field(default_factory=dict, repr=False)
    _host_postprocess: bool = False
    # fleet-tensor builds and the bytes copied into them (device-side
    # bookkeeping of this port, outside the telemetry registry)
    fleet_rebuilds: int = field(default=0, init=False)
    fleet_bytes_copied: int = field(default=0, init=False)

    def __post_init__(self):
        if len(self.devices) != self.store.num_shards:
            raise ValueError("one device per shard required")
        if self.telemetry is None:
            self.telemetry = Telemetry()
        if not self.compilers:
            self.compilers = [
                QueryCompiler(st, dev)
                for st, dev in zip(self.store.shards, self.devices)
            ]
        for comp, dev in zip(self.compilers, self.devices):
            comp.telemetry = self.telemetry
            comp.optimize = self.optimize
            comp.materialize_after = (
                self.materialize_after if self.optimize else None
            )
            dev.telemetry = self.telemetry
        for s in range(self.store.num_shards):
            self.telemetry.name_tid(s, f"shard {s}")
        self.telemetry.name_tid(TID_MERGE, "merge")
        self.telemetry.name_tid(TID_FLUSH, "flush")
        self.telemetry.name_tid(TID_TICKETS, "tickets")
        self.telemetry.providers.setdefault("plan_cache", self._plan_cache)
        self.telemetry.providers.setdefault("projection", self.projection)
        self.telemetry.providers.setdefault(
            "optimizer", self._optimizer_stats
        )
        self._queues = [[] for _ in range(self.store.num_shards)]
        self.shard_traffic = [
            Counter() for _ in range(self.store.num_shards)
        ]

    @property
    def device(self) -> torch.device:
        """Where the fleet's snapshots live and its kernels run."""
        return self.devices[0].device

    def _plan_cache(self) -> dict:
        return {
            "hits": sum(c.hits for c in self.compilers),
            "misses": sum(c.misses for c in self.compilers),
            "size": sum(c.cache_size for c in self.compilers),
        }

    def _optimizer_stats(self) -> dict:
        tele = self.telemetry
        served = int(self.queries_served)
        mws = sum(sum(c.values()) for c in self.shard_traffic)
        return {
            "enabled": self.optimize,
            "sensings_per_query": (mws / served) if served else None,
            "cse_plan_hits": int(tele.value("cse_plan_hits")),
            "cse_shared_senses": int(tele.value("cse_shared_senses")),
            "cse_rewritten_members": int(
                tele.value("cse_rewritten_members")
            ),
            "materializations": int(tele.value("materializations")),
            "materialization_hits": int(
                tele.value("materialization_hits")
            ),
            "materialization_invalidations": int(
                tele.value("materialization_invalidations")
            ),
        }

    def _maybe_materialize(self) -> None:
        """Fleet-wide materialization: a predicate hot on ANY shard's
        compiler materializes on EVERY shard — device snapshot shapes must
        stay aligned for the cross-shard fused groups, and a fanned-out
        query heats all its unpruned shards anyway.  Each shard's build
        (one sensing pass + one ESP page program) is charged to its own
        traffic mirrors."""
        if not self.optimize:
            return
        hot: dict = {}
        for comp in self.compilers:
            for key, canon in comp.hot_preds():
                hot.setdefault(key, canon)
        for key, canon in hot.items():
            for s, comp in enumerate(self.compilers):
                plan = comp.materialize(key, canon)
                if plan is not None:
                    self.telemetry.count(
                        f"shard{s}.wordlines_sensed",
                        record_plan_traffic(self.shard_traffic[s], plan),
                    )
                    thr = plan_thresholds(plan)
                    if thr:
                        self.telemetry.count("threshold_senses", thr)
                    self.telemetry.count("materialization_programs")
                    self.telemetry.count(
                        f"shard{s}.materialization_programs"
                    )

    # per-shard counter mirrors ("shard{s}.wordlines_sensed", …) live in
    # the registry next to the fleet totals; the legacy list attributes
    # read them out
    @property
    def shard_wordlines(self) -> list[int]:
        return [
            int(self.telemetry.value(f"shard{s}.wordlines_sensed"))
            for s in range(self.store.num_shards)
        ]

    @property
    def shard_esp_programs(self) -> list[int]:
        return [
            int(self.telemetry.value(f"shard{s}.esp_programs"))
            for s in range(self.store.num_shards)
        ]

    # -- incremental ingest --------------------------------------------------
    def append(self, rows: dict[str, np.ndarray]) -> int:
        """Append rows to the live fleet; returns pages ESP-programmed.

        The batch is validated — column set against the global ingest
        schema, lengths, values, and every destination stripe's capacity —
        *before* any shard queue or page state mutates, and appends are
        rejected while tickets are in flight (a ticket gathered across
        the mutation could merge partials from different index versions).
        Each stripe programs only its delta pages; plans over columns
        whose index metadata did not change stay warm on every shard.

        With ``coalesce_appends`` the (cumulatively validated) batch is
        queued and returns 0; the next ``flush()`` — or an explicit
        :meth:`apply_appends` — programs the whole queue as ONE delta per
        touched page per stripe.
        """
        if self._meta:
            raise RuntimeError(
                f"append() with {len(self._meta)} tickets in flight; "
                "flush() the fleet first so no ticket spans the mutation"
            )
        try:
            return self._admit_append(rows)
        except ValueError as err:
            if not (self.grow_on_overflow and "overflows" in str(err)):
                raise
            # capacity growth rides the compaction rebuild: every stripe
            # re-ingests into wider pages (the failed attempt validated
            # before mutating, so nothing is half-applied) with headroom
            # for the batch plus the original reserve — or twice the
            # batch, whichever is larger (any one stripe may absorb it)
            b = len(next(iter(rows.values())))
            self.compact(
                reserve_rows=b + max(2 * b, self.store.reserve_rows),
                rebuild_all=True,
            )
            return self._admit_append(rows)

    def _admit_append(self, rows: dict[str, np.ndarray]) -> int:
        if self.coalesce_appends:
            # shared validate+queue logic (per-batch column check, then
            # cumulative schema/stripe-capacity check) — see
            # repro_torch.query.scheduler.queue_append
            queue_append(self.store, self._append_buf, rows)
            return 0
        return self._program_append(rows)

    def _program_append(self, rows: dict[str, np.ndarray]) -> int:
        deltas = self.store.append(rows)  # validates before mutating
        tele = self.telemetry
        pages = words = logical = 0
        for s, delta in deltas.items():
            programs, phys = self.store.shards[s].program_delta(
                self.devices[s], delta, telemetry=tele
            )
            tele.count(f"shard{s}.esp_programs", programs)
            pages += programs
            words += phys
            logical += sum(int(pd.words.shape[0]) for pd in delta.pages)
            tele.count("rows_appended", delta.rows)
        tele.count("esp_delta_programs", pages)
        tele.count("words_programmed", words)
        tele.count("words_written", logical)
        # row counts moved: host-side valid-row masks and their
        # device-resident stacks are stale (the extras caches invalidate
        # through the stores' content epochs; the fleet tensor took the
        # delta words in place)
        self._masks = None
        self._maskmat_cache.clear()
        self._mask_rows.clear()
        return pages

    @property
    def appends_queued(self) -> int:
        return len(self._append_buf)

    def apply_appends(self) -> int:
        """Program every queued append batch as one coalesced delta: a
        stripe's page touched by many queued batches programs ONCE.  Ran
        automatically at the top of ``flush()``; returns pages programmed.
        """
        if not self._append_buf:
            return 0
        rows = merge_appends(self._append_buf)
        self.telemetry.count(
            "append_batches_coalesced", len(self._append_buf)
        )
        self._append_buf.clear()
        return self._program_append(rows)

    # -- deletes / updates / compaction --------------------------------------
    def delete(self, row_ids) -> int:
        """Tombstone global rows fleet-wide; returns pages ESP-programmed.

        Routing inverts ``row_maps`` (global id -> shard, local position);
        every destination stripe validates before any stripe mutates, then
        each programs ONE tombstone delta page.  Queued appends apply
        first, and — like appends — deletes are refused while tickets are
        in flight.  May trigger the auto-compaction policy.
        """
        if self._meta:
            raise RuntimeError(
                f"delete() with {len(self._meta)} tickets in flight; "
                "flush() the fleet first so no ticket spans the mutation"
            )
        self.apply_appends()
        deltas = self.store.delete(row_ids)
        tele = self.telemetry
        pages = words = logical = 0
        for s, delta in deltas.items():
            programs, phys = self.store.shards[s].program_delta(
                self.devices[s], delta, telemetry=tele
            )
            tele.count(f"shard{s}.esp_programs", programs)
            pages += programs
            words += phys
            logical += sum(int(pd.words.shape[0]) for pd in delta.pages)
        tele.count("rows_deleted", int(np.asarray(row_ids).size))
        tele.count("esp_delta_programs", pages)
        tele.count("words_programmed", words)
        tele.count("words_written", logical)
        tele.gauge("tombstone_density", self.store.tombstone_density)
        self._masks = None
        self._maskmat_cache.clear()
        self._mask_rows.clear()
        self._maybe_compact()
        return pages

    def update(self, row_ids, rows: dict[str, object]) -> int:
        """Update = delete + append (replacement rows get fresh tail ids).

        Both halves validate BEFORE either mutates — a bad update can
        never leave rows deleted but not re-appended.  Returns pages
        programmed (0 pending flush when appends coalesce).
        """
        if self._meta:
            raise RuntimeError(
                f"update() with {len(self._meta)} tickets in flight; "
                "flush() the fleet first so no ticket spans the mutation"
            )
        self.apply_appends()
        groups = self.store.check_delete(row_ids)
        arrays = {c: np.asarray(v) for c, v in rows.items()}
        b = self.store.check_append(arrays)
        nids = sum(len(v) for v in groups.values())
        if b != nids:
            raise ValueError(
                f"update() got {nids} row ids but {b} replacement rows"
            )
        n = self.delete(row_ids)
        n += self.append(arrays)
        self.telemetry.count("rows_updated", nids)
        return n

    def _maybe_compact(self) -> bool:
        if (
            self.compact_density is None
            or self.store.tombstone_density < self.compact_density
        ):
            return False
        self.compact()
        return True

    def compact(
        self, reserve_rows: int | None = None, rebuild_all: bool = False
    ) -> dict:
        """Erase-unit-aware rebuild of the tombstoned stripes; returns stats.

        Only stripes carrying tombstones erase and reprogram (their word
        budget cannot grow: restored headroom never exceeds the stripe's
        old capacity) — untouched stripes keep their devices, layouts, and
        warm plans; their epochs do not move.  Surviving rows are
        renumbered densely fleet-wide (row ``k`` = k-th live row in old
        global order) but never migrate between stripes, so renumbering is
        host-side metadata (``row_maps``) everywhere.  An explicit
        ``reserve_rows`` that widens any stripe's pages — or
        ``rebuild_all`` (the ``grow_on_overflow`` path) — escalates to a
        full-fleet rebuild so shard snapshots keep one shape.  Reprogrammed
        words count toward physical (never logical) write traffic: the
        fleet's write amplification.
        """
        if self._meta:
            raise RuntimeError(
                f"compact() with {len(self._meta)} tickets in flight; "
                "flush() the fleet first so no ticket spans the rebuild"
            )
        self.apply_appends()
        sstore, tele = self.store, self.telemetry
        t0 = time.perf_counter()
        dropped = sstore.deleted_rows
        active = sstore.active
        live_local = {s: sstore.shards[s].live_bits() for s in active}
        live_global = {s: sstore.row_maps[s][live_local[s]] for s in active}
        all_live = np.sort(
            np.concatenate(
                [live_global[s] for s in active]
                or [np.zeros((0,), np.int64)]
            )
        )

        def shard_reserve(s: int) -> int:
            if reserve_rows is not None:
                return reserve_rows
            st = sstore.shards[s]
            return st.capacity_rows - st.live_rows

        rebuild = [
            s
            for s in active
            if rebuild_all or sstore.shards[s].deleted_rows
        ]
        fleet_words = max((st.min_words for st in sstore.shards), default=0)
        needed = max(
            (
                _num_words(int(live_local[s].sum()) + shard_reserve(s))
                for s in rebuild
            ),
            default=0,
        )
        if needed > fleet_words and not rebuild_all:
            # wider pages on one stripe would break the fleet's one
            # shape — re-stripe everything at the new width
            rebuild_all, rebuild = True, list(active)
        if rebuild_all:
            fleet_words = max(
                (
                    _num_words(int(live_local[s].sum()) + shard_reserve(s))
                    for s in rebuild
                ),
                default=0,
            )

        # rebuilt stripes must share the fleet's canonical page placement
        # (fused cross-shard execution gathers identical (block, wordline)
        # coordinates on every chip): fork an untouched device's layout
        # when one survives, else recompute one canonical layout
        untouched = [s for s in active if s not in set(rebuild)]
        canonical = self.devices[untouched[0]].layout if untouched else None

        erased = pages = words = 0
        for s in rebuild:
            st, dev = sstore.shards[s], self.devices[s]
            keep = live_local[s]
            table = {c: v[keep] for c, v in st.to_table().items()}
            blocks = dev.erase_rebuild()
            st.rebuild(
                table,
                reserve_rows=shard_reserve(s),
                schema=sstore.schema,
                min_words=fleet_words,
            )
            if canonical is None:
                canonical = Layout(
                    wls_per_block=dev.layout.wls_per_block,
                    levels=dev.layout.levels,
                )
                st.place_into(canonical)
            dev.layout = canonical.fork()
            programs, phys = _program_grouped(dev, st.logical)
            dev.reset_after_rebuild()
            erased += blocks
            pages += programs
            words += phys
            tele.count(f"shard{s}.block_erases", blocks)
            tele.count(f"shard{s}.esp_programs", programs)
            sstore.shard_values[s] = {
                col: tuple(int(v) for v in np.unique(vals))
                for col, vals in table.items()
            }
            if sstore.stripe_key is not None:
                keys = table.get(sstore.stripe_key, np.zeros((0,)))
                sstore.stripe_bounds[s] = (
                    (int(keys.min()), int(keys.max())) if len(keys) else None
                )

        # dense global renumbering: rank of each surviving old id (host
        # metadata only — untouched stripes' pages and epochs stay put)
        for s in active:
            sstore.row_maps[s] = np.searchsorted(all_live, live_global[s])
        sstore.num_rows = int(all_live.size)
        if reserve_rows is not None:
            sstore.reserve_rows = reserve_rows

        self._masks = None
        self._fleet = None
        self._maskmat_cache.clear()
        self._mask_rows.clear()
        self._group_cache.clear()
        self._extras_cache.clear()
        self._flush_programs.clear()
        self._cse_cache.clear()

        tele.count("compactions")
        tele.count("block_erases", erased)
        tele.count("words_programmed", words)
        tele.count("compaction_rows_dropped", dropped)
        tele.gauge("tombstone_density", sstore.tombstone_density)
        self._record_wear()
        t1 = time.perf_counter()
        tele.span(
            "compact",
            "flush",
            t0,
            t1,
            args={"erased": erased, "shards": len(rebuild)},
        )
        tele.observe("compact_s", t1 - t0)
        return {
            "rows_dropped": dropped,
            "live_rows": sstore.num_rows,
            "shards_rebuilt": len(rebuild),
            "blocks_erased": erased,
            "words_reprogrammed": words,
            "seconds": t1 - t0,
        }

    def _record_wear(self) -> None:
        """Fleet-wide per-block wear gauges (P/E cycles)."""
        cycles = [
            n for dev in self.devices for n in dev.pec.values()
        ]
        if cycles:
            self.telemetry.gauge("max_pec", max(cycles))
            self.telemetry.gauge("mean_pec", sum(cycles) / len(cycles))

    # -- admission ----------------------------------------------------------
    def submit(self, query: Query) -> int:
        """Admit a query: it is scattered to every active shard's queue and
        executes on the next ``flush()``.

        Validation (predicate columns + the aggregate's target columns,
        via :func:`repro_torch.query.aggregate.validate_query`) happens
        here: a compile error inside ``flush`` would fire after some shard
        queues were popped, leaving the fleet's queues out of lockstep (a
        poisoned ticket).

        Shards whose stripe provably cannot match the query root
        (:func:`shard_cannot_match` against the values actually present on
        the stripe) are pruned *before* scatter: they never sense a page,
        and their partial is the aggregate's empty value.  On a
        ``range``-striped store with a ``stripe_key`` this routes
        key-range queries to the few shards holding the range.
        """
        # queued (coalesced) appends must land before admission: pruning
        # consults per-stripe present values, and a query for a value that
        # only exists in the queued batches would otherwise be pruned on
        # every shard.  Appends arriving back-to-back still coalesce.
        self.apply_appends()
        agg = validate_query(query, self.store.schema)
        ticket = self._next_ticket
        self._next_ticket += 1
        self._meta[ticket] = (query, time.perf_counter())
        self._partials[ticket] = {}
        self._cache_hits[ticket] = True
        for s in self.store.active:
            if shard_cannot_match(
                query.where, self.store.shard_values[s]
            ):
                self._partials[ticket][s] = agg.empty_partial(
                    self.store.shards[s]
                )
                self.telemetry.count("shards_pruned")
            else:
                self._queues[s].append((ticket, query))
        return ticket

    @property
    def pending(self) -> int:
        return max((len(q) for q in self._queues), default=0)

    # -- execution helpers ---------------------------------------------------
    def _fleet_source(self, shards: list[int]) -> FleetTensor | None:
        """The fleet tensor holding every one of ``shards``' snapshots, or
        None when the lockstep path must run per device instead: fusion is
        off, a shard holds non-ESP pages, or the snapshots differ in shape
        — the reference's conditions, so the counters agree.

        The fleet covers every active shard whose snapshot has the
        requested width, at a capacity of the largest host capacity among
        them; it is rebuilt (device-to-device copies, or the first upload
        of a store that never had a device buffer) only when one of
        ``shards`` no longer reads its slab — a slot that outgrew ``cap``,
        or a store rebuilt by ``compact()``.  Writes never rebuild it.
        """
        if not self.fuse_across_shards:
            return None
        if any(self.devices[s]._non_esp for s in shards):
            # the fused path never injects read errors; route shards with
            # non-ESP pages through execute_batch, which guards against
            # sensing them
            return None
        stores = [self.devices[s].store for s in shards]
        shape = (stores[0].num_slots, stores[0].padded_words)
        if any((st.num_slots, st.padded_words) != shape for st in stores):
            return None
        if self._fleet is None or not self._fleet.serves(shards, self.devices):
            members = tuple(
                s
                for s in self.store.active
                if self.devices[s].store.padded_words == shape[1]
            )
            cap = max(self.devices[s].store.capacity for s in members)
            data = torch.empty(
                (len(members), cap, shape[1]),
                dtype=torch.int32,
                device=self.device,
            )
            self._fleet = None  # the old slabs free as the stores rebind
            slabs = tuple(data[p] for p in range(len(members)))
            for s, slab in zip(members, slabs):
                self.fleet_bytes_copied += self.devices[s].store.bind(slab)
            self._fleet = FleetTensor(data, members, slabs)
            self.fleet_rebuilds += 1
        return self._fleet

    def _sharded_runner(self, signature):
        fn = self._runners.get(signature)
        if fn is None:
            fn = make_plan_runner(signature)
            self._runners[signature] = fn
        return fn

    # -- serving -------------------------------------------------------------
    def flush(self) -> dict[int, QueryResult]:
        """Drain pending queries from every shard queue, execute, reduce
        aggregates on the device, and gather completed tickets — including
        tickets completed purely by stripe routing (every shard pruned at
        ``submit``, nothing left to execute).

        ``pipeline=True`` flushes shards *asynchronously*: each shard's
        batch runs as one fused program (sensing + reduces, one payload)
        and the next shard is enqueued while the previous one computes;
        otherwise shards flush in lockstep under cross-shard signature
        groups with per-reduce-signature transfers.
        """
        self.apply_appends()
        self._maybe_materialize()
        if self.pipeline:
            return self._flush_pipelined()
        return self._flush_lockstep()

    def _pop_batch(self, s: int, depth: int, record: bool = True):
        """Pop up to ``depth`` queries from shard ``s``'s queue, compiled
        through its plan/exec caches; records plan traffic (fleet total +
        the ``shard{s}.*`` registry mirror) and, when telemetry is
        enabled, accumulates per-ticket sensing attribution.

        ``record=False`` defers the traffic recording to the caller: the
        optimizer paths dedup/CSE the batch first and charge only the
        plans that physically run (per-ticket attribution still reflects
        each query's standalone plan — what the ticket *asked for*)."""
        tele = self.telemetry
        batch, self._queues[s] = (
            self._queues[s][:depth],
            self._queues[s][depth:],
        )
        t_pop = time.perf_counter() if tele.enabled else 0.0
        out = []
        for ticket, q in batch:
            cq = self.compilers[s].compile(q)
            self._cache_hits[ticket] &= cq.cache_hit
            e = self.compilers[s].exec_for(cq)
            out.append((ticket, q, cq, e))
            if record:
                tele.count(
                    f"shard{s}.wordlines_sensed",
                    record_plan_traffic(self.shard_traffic[s], cq.plan),
                )
                thr = plan_thresholds(cq.plan)
                if thr:
                    tele.count("threshold_senses", thr)
            if tele.enabled:
                attr = self._attr.get(ticket)
                if attr is None:
                    attr = self._attr[ticket] = {
                        "sensings": 0,
                        "wordlines": 0,
                        "spill_steps": 0,
                        "agg_plane_reads": 0,
                        "shards": 0,
                        "queue_s": t_pop - self._meta[ticket][1],
                        "compile_s": 0.0,
                        "device_s": 0.0,
                        "transfer_s": 0.0,
                        "merge_s": 0.0,
                    }
                attr["sensings"] += plan_sensings(cq.plan)
                attr["wordlines"] += plan_traffic(cq.plan)[1]
                attr["spill_steps"] += e.spills if e is not None else 0
                attr["shards"] += 1
        tele.gauge(f"shard{s}.queue_depth", len(self._queues[s]))
        return out

    def _attr_phase(self, compiled, phase: str, dt: float) -> None:
        """Charge one shard-batch phase duration to every member ticket's
        attribution (telemetry enabled only).  Phase durations are
        shard-batch granular: a ticket's ``compile_s``/``device_s``/…
        sums the phases of every shard batch that served it — shared
        batch work, so members of one batch each report the full phase."""
        for ticket, _, _, _ in compiled:
            attr = self._attr.get(ticket)
            if attr is not None:
                attr[phase] += dt

    def _collect_done(self, t1: float) -> dict[int, QueryResult]:
        """Gather every ticket whose partials cover all active shards.

        Pops every per-ticket record (_meta / _partials / _cache_hits /
        _attr) as the ticket completes — long-running serving keeps only
        in-flight tickets in memory."""
        tele = self.telemetry
        expected = len(self.store.active)
        results: dict[int, QueryResult] = {}
        done = [
            t
            for t in list(self._partials)
            if len(self._partials[t]) == expected
        ]
        popped = []
        for ticket in done:
            q, t_submit = self._meta.pop(ticket)
            parts = self._partials.pop(ticket)
            agg = get_aggregator(q.agg)
            self._host_postprocess |= agg.host_postprocess
            popped.append((ticket, q, t_submit, parts, agg))
        # MASK tickets un-stripe together: one unpack/scatter pass per
        # shard and one packbits for the whole flush, instead of a numpy
        # pass per (ticket x shard) — see merge_mask_batch
        merged: dict[int, object] = {}
        mask_ix = [
            n for n, it in enumerate(popped) if it[4].kind == "mask"
        ]
        if len(mask_ix) > 1:
            vecs = merge_mask_batch(
                [popped[n][3] for n in mask_ix], self.store
            )
            merged = dict(zip(mask_ix, vecs))
            tele.count("mask_batch_merges")
        for n, (ticket, q, t_submit, parts, agg) in enumerate(popped):
            value = (
                merged[n] if n in merged else agg.merge(parts, self.store)
            )
            attr = self._attr.pop(ticket, None)
            results[ticket] = QueryResult(
                ticket,
                q,
                value,
                t1 - t_submit,
                cache_hit=self._cache_hits.pop(ticket),
                attribution=attr,
            )
            tele.count("total_latency_s", t1 - t_submit)
            if tele.enabled:
                attribute_result(tele, ticket, q, attr, t_submit, t1)
        tele.count("queries_served", len(done))
        if done and tele.enabled:
            t_m1 = time.perf_counter()
            tele.span("merge", "flush", t1, t_m1, tid=TID_MERGE)
            for ticket in done:
                a = results[ticket].attribution
                if a is not None:
                    a["merge_s"] = t_m1 - t1
        return results

    # -- pipelined (asynchronous per-shard) flushing -------------------------
    def _routed_depths(self, queued: list[int]) -> dict[int, int]:
        """Per-shard drain depths under a fleet-wide slot budget.

        The budget is ``queue_depth`` slots per *active* shard; shards
        whose queues are short — typically because stripe routing pruned
        their traffic at ``submit`` — donate their unused slots to shards
        with deeper queues.  A hot stripe can therefore drain far beyond
        ``queue_depth`` in one flush instead of serializing over many.
        """
        budget = self.queue_depth * max(len(self.store.active), 1)
        depths = {
            s: min(len(self._queues[s]), self.queue_depth) for s in queued
        }
        leftover = budget - sum(depths.values())
        # donate in equal shares across the shards that still have queue,
        # so two hot stripes split the budget instead of the lower-indexed
        # one absorbing it all
        while leftover > 0:
            needy = [
                s for s in queued if len(self._queues[s]) > depths[s]
            ]
            if not needy:
                break
            share = max(1, leftover // len(needy))
            for s in needy:
                take = min(
                    len(self._queues[s]) - depths[s], share, leftover
                )
                depths[s] += take
                leftover -= take
                if not leftover:
                    break
        return depths

    def _mask_row(self, s: int) -> torch.Tensor:
        """Device-resident (fleet_words,) valid-row mask of one shard."""
        key = (s, self.store.shards[s].epoch)
        row = self._mask_rows.get(key)
        if row is None:
            if len(self._mask_rows) >= 64:
                self._mask_rows.clear()
            row = to_words(
                self.store.shards[s].valid_words_mask(), self.devices[s].device
            )
            self._mask_rows[key] = row
        return row

    def _dispatch_shard(self, s: int, depth: int):
        """Compile + enqueue one shard's fused flush program (async).

        Returns ``(s, compiled, program, payload, aggs, ready)`` — the
        payload is an in-flight device tensor and ``ready`` the event
        recorded right behind its program (None on the CPU); nothing
        blocks here.  Shards whose device holds non-ESP pages run the
        synchronous per-group legacy path instead (their reads may inject
        errors) and return None.
        """
        tele = self.telemetry
        dev = self.devices[s]
        cse_on = self.optimize and not dev._non_esp
        t_d0 = time.perf_counter()
        compiled = self._pop_batch(s, depth, record=not cse_on)
        if not compiled:
            return None
        st = self.store.shards[s]
        aggs = [get_aggregator(q.agg) for _, q, _, _ in compiled]
        execs = [e for _, _, _, e in compiled]
        tele.count(
            "distinct_signatures",
            len({e.signature for e in execs if e is not None}),
        )
        t_d1 = time.perf_counter()
        if dev._non_esp:
            # legacy sync path: error-injecting eager guard + per-group
            # reduce transfers
            masked = dev.execute_batch_stacked(
                [cq.plan for _, _, cq, _ in compiled],
                execs=execs,
                batch_key=tuple((s, cq.key) for _, _, cq, _ in compiled),
            ) & self._mask_row(s)
            tele.count("signature_groups", dev.last_signature_groups)
            tele.count("eager_plans", dev.last_eager_plans)
            partials, extra_counts, n_groups = reduce_flush(
                masked,
                [q.agg for _, q, _, _ in compiled],
                [st] * len(compiled),
                [(s, st.epoch)] * len(compiled),
                extras_cache=self._extras_cache,
            )
            tele.count("host_transfers", n_groups)
            tele.count(f"shard{s}.host_transfers", n_groups)
            self._record_partials(s, compiled, partials, extra_counts)
            if tele.enabled:
                t_d2 = time.perf_counter()
                tele.span("compile", "shard", t_d0, t_d1, tid=s)
                tele.span("execute+reduce", "shard", t_d1, t_d2, tid=s)
                self._attr_phase(compiled, "compile_s", t_d1 - t_d0)
                self._attr_phase(compiled, "device_s", t_d2 - t_d1)
            return None
        # per-shard CSE: whole-plan dedup + shared-subtree extraction
        # within this shard's fused flush (repro_torch.query.optimize.cse_flush)
        cse = None
        if cse_on:
            ckey = (
                s,
                tuple(cq.key for _, _, cq, _ in compiled),
                st.epoch,
                dev.store.epoch,
            )
            cse = self._cse_cache.get(ckey)
            if cse is None:
                if len(self._cse_cache) >= 64:
                    self._cse_cache.clear()
                cse = cse_flush(
                    [cq for _, _, cq, _ in compiled],
                    self.compilers[s],
                    dev,
                )
                self._cse_cache[ckey] = cse
        # plan keys cover only the predicate side; the aggregate specs
        # join the key so same-predicate flushes under different
        # aggregates never share a program
        key = (
            s,
            tuple(cq.key for _, _, cq, _ in compiled),
            tuple(a.spec for a in aggs),
            st.epoch,
            dev.store.epoch,
        )
        program = self._flush_programs.get(key)
        if program is None:
            if len(self._flush_programs) >= 64:
                self._flush_programs.clear()
            program = compile_flush(
                execs if cse is None else list(cse.member_execs),
                [q.agg for _, q, _, _ in compiled],
                [st] * len(compiled),
                [(s, st.epoch)] * len(compiled),
                words=st.words,
                device=dev.device,
                runner_cache=self._runner_cache,
                extras_cache=self._extras_cache,
                pad=dev.pad_signatures,
                dedup_keys=(
                    None if cse is None else list(cse.dedup_keys)
                ),
                shared_execs=() if cse is None else cse.shared_execs,
            )
            self._flush_programs[key] = program
        t_d2 = time.perf_counter()
        payload = program.run(
            dev.store.snapshot(dev.device), self._mask_row(s)
        )
        ready = None
        if payload.is_cuda:
            ready = torch.cuda.Event()
            ready.record()
        if cse is None:
            age_spill_blocks(dev.pec, execs)
        else:
            # physical traffic + wear after CSE: each UNIQUE member plan
            # runs once (duplicates ride the member gather), each shared
            # subplan senses once and programs one scratch page
            age_spill_blocks(
                dev.pec,
                [cse.member_execs[i] for i in cse.uix]
                + list(cse.shared_execs),
            )
            for b in cse.shared_blocks:
                dev.pec[b] = dev.pec.get(b, 0) + 1
            wls = thr = 0
            for p in list(cse.member_plans) + list(cse.shared_plans):
                wls += record_plan_traffic(self.shard_traffic[s], p)
                thr += plan_thresholds(p)
            tele.count(f"shard{s}.wordlines_sensed", wls)
            if thr:
                tele.count("threshold_senses", thr)
            tele.count("cse_plan_hits", cse.n_dedup_hits)
            tele.count("cse_shared_senses", len(cse.shared_plans))
            tele.count("cse_rewritten_members", cse.n_rewritten)
            tele.count("cse_spill_programs", len(cse.shared_plans))
            tele.count(f"shard{s}.cse_esp_programs", len(cse.shared_plans))
        tele.count("fused_dispatches")
        tele.count(f"shard{s}.fused_dispatches")
        tele.count("signature_groups", program.n_sense_groups)
        if tele.enabled:
            t_d3 = time.perf_counter()
            tele.span("compile", "shard", t_d0, t_d2, tid=s)
            tele.span("dispatch", "shard", t_d2, t_d3, tid=s)
            self._attr_phase(compiled, "compile_s", t_d2 - t_d0)
            self._attr_phase(compiled, "device_s", t_d3 - t_d2)
        return (s, compiled, program, payload, aggs, ready)

    def _record_partials(self, s, compiled, partials, extra_counts):
        tele = self.telemetry
        for i, (ticket, _, _, _) in enumerate(compiled):
            self._partials[ticket][s] = partials[i]
            if extra_counts[i]:
                self.shard_traffic[s][AGG_READ_SHAPE] += extra_counts[i]
                tele.count(
                    f"shard{s}.wordlines_sensed", extra_counts[i]
                )
                attr = self._attr.get(ticket)
                if attr is not None:
                    attr["sensings"] += extra_counts[i]
                    attr["wordlines"] += extra_counts[i]
                    attr["agg_plane_reads"] += extra_counts[i]

    def _gather_shard(self, inflight) -> None:
        """Transfer one in-flight shard payload (the only blocking point)
        and record its partials."""
        tele = self.telemetry
        s, compiled, program, payload, aggs, ready = inflight
        t_g0 = time.perf_counter() if tele.enabled else 0.0
        if ready is not None and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=payload.device)
        host = _payload_to_host(payload, ready, self._copy_stream)
        tele.count("host_transfers")
        tele.count(f"shard{s}.host_transfers")
        if tele.enabled:
            t_g1 = time.perf_counter()
            tele.span("transfer", "shard", t_g0, t_g1, tid=s)
            self._attr_phase(compiled, "transfer_s", t_g1 - t_g0)
        partials = program.unpack(host, aggs)
        self._record_partials(s, compiled, partials, program.extra_counts)

    def _flush_pipelined(self) -> dict[int, QueryResult]:
        active = [s for s in self.store.active if self._queues[s]]
        expected = len(self.store.active)
        if not active and not any(
            len(p) == expected for p in self._partials.values()
        ):
            return {}
        tele = self.telemetry
        t0 = time.perf_counter()
        depths = self._routed_depths(active)
        if tele.enabled:
            for s, d in depths.items():
                tele.gauge(f"shard{s}.routed_depth", d)
        inflight: deque = deque()
        for s in active:
            entry = self._dispatch_shard(s, depths[s])
            if entry is not None:
                inflight.append(entry)
            # double buffer: collect shard k's payload only after shard
            # k+1 was enqueued, so the next shard's sensing overlaps the
            # previous shard's copy; at most two payloads are ever
            # co-resident
            while len(inflight) >= 2:
                self._gather_shard(inflight.popleft())
        while inflight:
            self._gather_shard(inflight.popleft())
        t1 = time.perf_counter()
        results = self._collect_done(t1)
        tele.count("flushes")
        tele.count("pipelined_flushes")
        tele.count("serve_time_s", t1 - t0)
        tele.span(
            "flush",
            "flush",
            t0,
            t1,
            args={"flush": int(self.flushes), "shards": len(active)},
        )
        tele.observe("flush_latency_s", t1 - t0)
        return results

    # -- lockstep (cross-shard fused) flushing -------------------------------
    def _flush_lockstep(self) -> dict[int, QueryResult]:
        active = [s for s in self.store.active if self._queues[s]]
        expected = len(self.store.active)
        if not active and not any(
            len(p) == expected for p in self._partials.values()
        ):
            return {}
        tele = self.telemetry
        t0 = time.perf_counter()

        # scatter: pop per-shard batches and compile through per-shard caches
        items: list[tuple[int, int, object]] = []  # (shard, ticket, exec|None)
        plans: list = []  # parallel to items
        keys: list[tuple] = []  # (shard, plan-cache key) per item
        popped: list = []  # the _pop_batch tuples, for phase attribution
        for s in active:
            for entry in self._pop_batch(
                s, self.queue_depth, record=not self.optimize
            ):
                ticket, q, cq, e = entry
                items.append((s, ticket, e))
                plans.append(cq.plan)
                keys.append((s, cq.key))
                popped.append(entry)

        # whole-plan dedup across the lockstep batch: members sharing one
        # (shard, canonical plan) sense once and read the same output row.
        # (Subtree CSE stays a pipelined/single-device feature — the
        # cross-shard groups would have to thread shared latch values
        # through every signature group.)
        uix = list(range(len(items)))
        inv: list[int] = uix
        if self.optimize and items:
            pos: dict = {}
            uix, inv = [], []
            for i, k in enumerate(keys):
                j = pos.get(k)
                if j is None:
                    j = pos[k] = len(uix)
                    uix.append(i)
                inv.append(j)
            tele.count("cse_plan_hits", len(items) - len(uix))
            for i in uix:
                s = items[i][0]
                tele.count(
                    f"shard{s}.wordlines_sensed",
                    record_plan_traffic(self.shard_traffic[s], plans[i]),
                )
                thr = plan_thresholds(plans[i])
                if thr:
                    tele.count("threshold_senses", thr)
        t_sc = time.perf_counter()

        if items:
            # execute: fused cross-shard signature groups over the fleet
            # tensor.  Group outputs are concatenated and re-ordered with
            # ONE gather — per-item slicing would cost O(shards x batch)
            # launches.  Only the UNIQUE items execute; duplicates gather
            # their representative's row below.
            uitems = [items[i] for i in uix]
            uplans = [plans[i] for i in uix]
            ukeys = [keys[i] for i in uix]
            execs = [e for _, _, e in uitems]
            tele.count(
                "distinct_signatures",
                len({e.signature for e in execs if e is not None}),
            )
            fleet_w = self.store.shards[active[0]].words
            pieces: list[torch.Tensor] = []  # (B_g, fleet_w) per group
            order: list[int] = []  # unique-item index per output row
            fleet = self._fleet_source(active)
            if fleet is not None:
                # the offsets depend on the fleet's members and capacity:
                # a rebuilt fleet must never reuse indices of the old one
                cache_key = (tuple(active), fleet.shards, fleet.cap) + tuple(
                    ukeys
                )
                prepared = self._group_cache.get(cache_key)
                if prepared is None:
                    prepared = []
                    for signature, members, stacked in group_execs(
                        execs, pad=True
                    ):
                        base = [fleet.base(uitems[i][0]) for i in members]
                        prepared.append(
                            (
                                signature,
                                tuple(
                                    torch.as_tensor(
                                        offset_slots(x, base),
                                        device=self.device,
                                    )
                                    for x in encode_idx(signature, stacked)
                                ),
                                members,
                            )
                        )
                    if len(self._group_cache) >= 64:
                        self._group_cache.clear()
                    self._group_cache[cache_key] = prepared
                tele.count("signature_groups", len(prepared))
                source = fleet.source
                for signature, idxs, members in prepared:
                    out = self._sharded_runner(signature)(source, *idxs)
                    pieces.append(out[:, :fleet_w])
                    order.extend(members)
                for s, _, e in uitems:
                    age_spill_blocks(self.devices[s].pec, (e,))
                tele.count("fused_flushes")
            else:
                # per-device fallback: each shard runs its own batches
                for s in active:
                    ix = [i for i, it in enumerate(uitems) if it[0] == s]
                    pieces.append(
                        self.devices[s].execute_batch_stacked(
                            [uplans[i] for i in ix],
                            execs=[execs[i] for i in ix],
                            batch_key=tuple(ukeys[i] for i in ix),
                        )
                    )
                    order.extend(ix)
                    tele.count(
                        "signature_groups",
                        self.devices[s].last_signature_groups,
                    )
                    tele.count(
                        "eager_plans", self.devices[s].last_eager_plans
                    )
            allout = reorder_rows(pieces, order)  # (U, fleet_w), uix order
            if len(uix) != len(items):
                # fan each duplicate out to its representative's row
                allout = allout[
                    torch.as_tensor(
                        np.asarray(inv, np.int64), device=allout.device
                    )
                ]

            # reduce: mask shard partials (identity pad rows, word slack,
            # and fleet-width padding of short stripes), then one
            # (weighted-)popcount reduce + one host transfer per reduce
            # signature across the whole flush, any mix of aggregate kinds
            masked = allout & self._mask_matrix(
                tuple(s for s, _, _ in items)
            )
            specs = [self._meta[t][0].agg for _, t, _ in items]
            partials, extra_counts, n_groups = reduce_flush(
                masked,
                specs,
                [self.store.shards[s] for s, _, _ in items],
                [
                    (s, self.store.shards[s].epoch)
                    for s, _, _ in items
                ],
                extras_cache=self._extras_cache,
            )
            tele.count("host_transfers", n_groups)

            for i, (s, ticket, _) in enumerate(items):
                self._partials[ticket][s] = partials[i]
                # extra planes the aggregate sensed on this shard (BSI
                # slices / equality bitmaps): single-wordline reads in
                # the projected traffic
                if extra_counts[i]:
                    self.shard_traffic[s][AGG_READ_SHAPE] += extra_counts[i]
                    tele.count(
                        f"shard{s}.wordlines_sensed", extra_counts[i]
                    )
                    attr = self._attr.get(ticket)
                    if attr is not None:
                        attr["sensings"] += extra_counts[i]
                        attr["wordlines"] += extra_counts[i]
                        attr["agg_plane_reads"] += extra_counts[i]

        t1 = time.perf_counter()
        if tele.enabled and items:
            tele.span("compile", "flush", t0, t_sc)
            tele.span("execute+reduce", "flush", t_sc, t1)
            self._attr_phase(popped, "compile_s", t_sc - t0)
            self._attr_phase(popped, "device_s", t1 - t_sc)
        results = self._collect_done(t1)
        tele.count("flushes")
        tele.count("serve_time_s", t1 - t0)
        tele.span(
            "flush",
            "flush",
            t0,
            t1,
            args={"flush": int(self.flushes), "shards": len(active)},
        )
        tele.observe("flush_latency_s", t1 - t0)
        return results

    def _mask_matrix(self, shard_seq: tuple[int, ...]) -> torch.Tensor:
        """Device-resident ``(len(shard_seq), fleet_words)`` valid-row mask
        stack, memoized per batch composition — row counts are fixed after
        ingest, so steady-state flushes skip the host build + upload."""
        cached = self._maskmat_cache.get(shard_seq)
        if cached is not None:
            return cached
        if self._masks is None:
            self._masks = [
                self.store.shards[s].valid_words_mask()
                for s in range(self.store.num_shards)
            ]
        mat = to_words(
            np.stack([self._masks[s] for s in shard_seq]), self.device
        )
        if len(self._maskmat_cache) >= 64:
            self._maskmat_cache.clear()
        self._maskmat_cache[shard_seq] = mat
        return mat

    def serve(self, queries: list[Query]) -> list[QueryResult]:
        """Submit + flush until drained; results in submission order."""
        tickets = [self.submit(q) for q in queries]
        results: dict[int, QueryResult] = {}
        while self.pending:
            results.update(self.flush())
        # tickets whose every shard was pruned at submit never enter a
        # queue; one more flush gathers them
        results.update(self.flush())
        return [results[t] for t in tickets]

    # -- reporting -----------------------------------------------------------
    def stats(self) -> dict:
        served = max(self.queries_served, 1)
        return {
            "num_shards": self.store.num_shards,
            "policy": self.store.policy,
            "queries_served": self.queries_served,
            "flushes": self.flushes,
            "fused_flushes": self.fused_flushes,
            "pipelined_flushes": self.pipelined_flushes,
            "fused_dispatches": self.fused_dispatches,
            "host_transfers": self.host_transfers,
            "shards_pruned": self.shards_pruned,
            "vmap_batches": self.signature_groups,
            "distinct_signatures": self.distinct_signatures,
            "eager_plans": self.eager_plans,
            "plan_cache_hits": sum(c.hits for c in self.compilers),
            "plan_cache_misses": sum(c.misses for c in self.compilers),
            "plan_cache_size": sum(c.cache_size for c in self.compilers),
            "queries_per_sec": (
                self.queries_served / self.serve_time_s
                if self.serve_time_s
                else float("inf")
            ),
            "mean_latency_s": self.total_latency_s / served,
            "mws_commands": sum(
                sum(c.values()) for c in self.shard_traffic
            ),
            "sensings_per_query": (
                sum(sum(c.values()) for c in self.shard_traffic) / served
            ),
            "threshold_senses": self.threshold_senses,
            "cse_plan_hits": self.cse_plan_hits,
            "cse_shared_senses": self.cse_shared_senses,
            "materializations": self.materializations,
            "materialization_hits": self.materialization_hits,
            "rows_appended": self.rows_appended,
            "esp_delta_programs": self.esp_delta_programs,
            "append_batches_coalesced": self.append_batches_coalesced,
            "rows_deleted": self.rows_deleted,
            "rows_updated": self.rows_updated,
            "compactions": self.compactions,
            "block_erases": self.block_erases,
            "live_rows": self.store.live_rows,
            "tombstone_density": self.store.tombstone_density,
            "write_amplification": (
                self.words_programmed / self.words_written
                if self.words_written
                else 0.0
            ),
        }

    def projection(self, ssd: SSDConfig = DEFAULT_SSD) -> dict:
        """Fleet-level SSD time/energy projection of the served traffic.

        Each shard device's MWS traffic is replayed through the paper's
        timing/energy model independently; the fleet serves shards
        concurrently, so projected wall-clock is the max over devices and
        energy is the sum — for Flash-Cosmos and the OSP baseline alike.
        """
        per_shard = [
            project_traffic(
                self.shard_traffic[s],
                wordlines_sensed=self.shard_wordlines[s],
                num_rows=self.store.shards[s].num_rows,
                num_queries=self.queries_served,
                host_postprocess=self._host_postprocess,
                # append deltas + CSE scratch-page programs + hot-predicate
                # materialization programs all ride this shard's ESP path
                esp_programs=self.shard_esp_programs[s]
                + int(self.telemetry.value(f"shard{s}.cse_esp_programs"))
                + int(
                    self.telemetry.value(
                        f"shard{s}.materialization_programs"
                    )
                ),
                block_erases=int(
                    self.telemetry.value(f"shard{s}.block_erases")
                ),
                levels=self.devices[s].layout.levels,
                ssd=ssd,
                name=f"flashql-shard{s}({self.queries_served}q)",
            )
            for s in self.store.active
            # a stripe with appends but no sensed traffic still did real
            # programming work — charge it (project_traffic handles the
            # program-only case)
            if self.shard_traffic[s] or self.shard_esp_programs[s]
        ]
        if not per_shard:
            raise ValueError("no traffic served yet")
        fc_t = max(p["fc_time_s"] for p in per_shard)
        osp_t = max(p["osp_time_s"] for p in per_shard)
        fc_e = sum(p["fc_energy_j"] for p in per_shard)
        osp_e = sum(p["osp_energy_j"] for p in per_shard)
        return {
            "workload": (
                f"flashql-sharded(x{self.store.num_shards}, "
                f"{self.queries_served}q)"
            ),
            "num_devices": self.store.num_shards,
            "fc_time_s": fc_t,
            "fc_energy_j": fc_e,
            "osp_time_s": osp_t,
            "osp_energy_j": osp_e,
            "speedup_vs_osp": osp_t / fc_t,
            "energy_ratio_vs_osp": osp_e / fc_e,
            "block_erases": sum(p.get("block_erases", 0) for p in per_shard),
            "per_shard": per_shard,
        }


registry_counters(
    ShardedFlashQL,
    (
        "queries_served",
        "flushes",
        "signature_groups",  # batch groups dispatched (post-padding)
        "distinct_signatures",  # exact signatures seen (pre-padding)
        "eager_plans",
        "fused_flushes",
        "pipelined_flushes",
        "fused_dispatches",  # fused flush programs executed
        "host_transfers",  # device->host result copies
        "shards_pruned",  # stripe-routing prunes (shard never sensed)
        "serve_time_s",
        "total_latency_s",
        "rows_appended",
        "esp_delta_programs",
        "append_batches_coalesced",
        "rows_deleted",
        "rows_updated",
        "compactions",
        "block_erases",
        "words_programmed",  # physical ESP traffic (appends+deletes+GC)
        "words_written",  # logical client mutations — WA denominator
        "threshold_senses",  # k-of-N one-shot sensings executed
        "compaction_rows_dropped",
        "cse_plan_hits",  # flush members served by another member's plan
        "cse_shared_senses",  # shared subtree plans sensed (pipelined CSE)
        "cse_rewritten_members",  # member plans spliced onto shared pages
        "cse_spill_programs",  # scratch-page ESP programs for shared results
        "materializations",  # hot-predicate bitmap pages built
        "materialization_hits",  # compiles lowered onto a cached mat page
        "materialization_invalidations",  # mat pages dropped (stale epochs)
        "materialization_programs",  # per-shard mat page ESP programs
    ),
)


def build_sharded_flashql(
    table: dict[str, np.ndarray],
    num_shards: int,
    *,
    policy: str = "roundrobin",
    stripe_key: str | None = None,
    num_planes: int = 4,
    warmup: Iterable[Query] = (),
    queue_depth: int = 256,
    device="cuda",
    reserve_rows: int = 0,
    pipeline: bool = False,
    coalesce_appends: bool = False,
    compact_density: float | None = None,
    grow_on_overflow: bool = False,
    optimize: bool = True,
    materialize_after: int | None = 32,
    levels: int = 1,
) -> ShardedFlashQL:
    """Ingest ``table``, program ``num_shards`` fresh devices, return the
    serving frontend — the one-call path used by tests and benchmarks.
    ``device`` is where every shard's snapshot lives and the kernels run:
    ``"cuda"`` (raises without a GPU) or ``"cpu"`` for the plain versions.
    ``reserve_rows`` leaves per-stripe word capacity for later
    :meth:`ShardedFlashQL.append` batches; ``pipeline`` enables the
    asynchronous per-shard fused flush (see :class:`ShardedFlashQL`);
    ``levels`` sets the multi-level packing factor (1 = SLC, 2 = MLC,
    3 = TLC) every device's layout programs/senses at."""
    devices = [
        FlashDevice(
            num_planes=num_planes,
            device=device,
            layout=Layout(levels=levels),
        )
        for _ in range(num_shards)
    ]
    store = ShardedBitmapStore(
        num_shards=num_shards,
        policy=policy,
        stripe_key=stripe_key,
        reserve_rows=reserve_rows,
    )
    store.ingest(table)
    store.program(devices, warmup=warmup)
    return ShardedFlashQL(
        store,
        devices,
        queue_depth=queue_depth,
        pipeline=pipeline,
        coalesce_appends=coalesce_appends,
        compact_density=compact_density,
        grow_on_overflow=grow_on_overflow,
        optimize=optimize,
        materialize_after=materialize_after,
    )
