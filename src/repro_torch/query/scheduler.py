"""BatchScheduler: admission, shape-grouped batching, and stats/projection.

The serving loop of FlashQL: clients ``submit`` queries (tickets), and
``flush`` compiles the pending set through the plan cache and executes it
as ONE fused device program per flush signature
(:func:`repro_torch.query.compile.compile_flush`): every predicate
signature group senses as a batch, the results feed every aggregate's
popcount reduce on the device, and the whole flush returns as a single
flat payload — one host transfer per flush, whatever mix of aggregate
kinds it holds (counted in ``host_transfers`` / ``fused_dispatches``).
Devices holding non-ESP pages (whose reads inject modelled bit errors)
fall back to the per-group legacy path: batches via
:meth:`FlashDevice.execute_batch_stacked`, then one reduce launch + one
transfer per reduce signature (:func:`repro_torch.query.aggregate.reduce_flush`).

Every stat the scheduler keeps lives in one
:class:`repro_torch.query.telemetry.Telemetry` registry; ``stats()`` reads
it.  The scheduler also records every executed MWS command's shape, so
``projection()`` can replay the served traffic through the paper's
full-scale SSD model (Table-1 geometry), next to the OSP baseline.

The index it serves is live: ``append`` programs delta pages (or queues
them under ``coalesce_appends`` until the next flush), ``delete`` and
``update`` clear rows in the tombstone page, and ``compact`` erases the
stripe's blocks and reprograms the live rows.  Mutations are refused
while queries are pending, so no ticket spans one.
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.core.bitops import to_words
from repro_torch.core.commands import MWSCommand, ThresholdCommand
from repro_torch.flashsim.geometry import DEFAULT_SSD, SSDConfig
from repro_torch.flashsim.platforms import Platform, run_workload
from repro_torch.flashsim.timing import level_program_factor, level_read_factor
from repro_torch.flashsim.workloads import BulkBitwiseWorkload, MWSCommandShape
from repro_torch.query.aggregate import (
    get_aggregator,
    reduce_flush,
    validate_query,
)
from repro_torch.query.ast import Count, Mask, Query, normalize_agg, walked
from repro_torch.query.bitmap import BitmapStore
from repro_torch.query.compile import QueryCompiler, compile_flush
from repro_torch.query.device import FlashDevice, age_spill_blocks
from repro_torch.query.optimize import cse_flush
from repro_torch.query.telemetry import (
    TID_FLUSH,
    TID_TICKETS,
    Telemetry,
)

# one extra sensed plane (a BSI slice / equality bitmap read for an
# aggregate) = one single-wordline sensing in the SSD projection
AGG_READ_SHAPE = MWSCommandShape(n_blocks=1, max_wls_per_block=1)


def merge_appends(batches: list[dict]) -> dict:
    """Concatenate queued append batches into one combined batch."""
    return {col: np.concatenate([b[col] for b in batches]) for col in batches[0]}


def queue_append(store, buf: list[dict], rows: dict) -> None:
    """Validate + queue one append batch for coalesced programming.

    THIS batch's column set is validated first (the merge below is built
    from the first queued batch's columns, so an unknown or missing column
    would slip through it), then the cumulative concatenation must fit the
    schema and capacity BEFORE the batch is accepted, so ``apply_appends``
    can never fail halfway.  Empty batches validate but queue nothing (an
    empty ndarray defaults to float64 and would poison the merged dtype).
    """
    arrays = {c: np.asarray(v) for c, v in rows.items()}
    store.check_append(arrays)
    store.check_append(merge_appends(buf + [arrays]))
    if len(next(iter(arrays.values()))):
        buf.append(arrays)


def plan_traffic(plan) -> tuple[tuple, int]:
    """A plan's projected-traffic contribution, memoized on the plan.

    Walking every MWS command's wordline bitmaps per flush dominated warm
    serving (it was ~2/3 of a steady-state sharded flush in profiles);
    plans are cached and immutable, so their ``(shape counts, wordlines)``
    is computed once and pinned on the instance.
    """
    memo = getattr(plan, "_traffic_memo", None)
    if memo is None:
        shapes: Counter = Counter()
        wls = 0
        for cmd in plan.commands:
            if isinstance(cmd, MWSCommand):
                shapes[
                    MWSCommandShape(
                        n_blocks=cmd.num_blocks,
                        max_wls_per_block=max(
                            len(t.wordlines) for t in cmd.targets
                        ),
                        threshold_k=cmd.k
                        if isinstance(cmd, ThresholdCommand)
                        else 0,
                    )
                ] += 1
                wls += cmd.num_wordlines
        memo = (tuple(shapes.items()), wls)
        plan._traffic_memo = memo
    return memo


def record_plan_traffic(counter: Counter, plan) -> int:
    """Fold a plan's MWS commands into a shape counter; returns wordlines.

    Shape counts keep long-running traffic O(distinct shapes); wordlines are
    tracked exactly because ragged commands pad to ``max_wls_per_block`` and
    must not inflate operand counts in the projection.
    """
    shapes, wls = plan_traffic(plan)
    for shape, cnt in shapes:
        counter[shape] += cnt
    return wls


def plan_sensings(plan) -> int:
    """MWS sensing operations a plan performs (memoized via plan_traffic)."""
    shapes, _ = plan_traffic(plan)
    return sum(cnt for _, cnt in shapes)


def plan_thresholds(plan) -> int:
    """k-of-N threshold sensings in a plan (memoized via plan_traffic)."""
    shapes, _ = plan_traffic(plan)
    return sum(cnt for shape, cnt in shapes if shape.threshold_k)


def attribute_result(
    tele: Telemetry,
    ticket: int,
    query: Query,
    attr: dict | None,
    t_submit: float,
    t_end: float,
) -> None:
    """Shared per-result telemetry: ticket trace span, latency histogram,
    and the slow-query log.  Called only when telemetry is enabled."""
    latency = t_end - t_submit
    tele.observe("query_latency_s", latency)
    sensings = attr["sensings"] if attr else 0
    tele.span(
        "ticket",
        "query",
        t_submit,
        t_end,
        tid=TID_TICKETS,
        args={"ticket": ticket, "sensings": sensings},
    )
    # the entry's repr walks the whole predicate: only for a logged query
    if tele.is_slow(latency, sensings):
        tele.slow(
            {
                "ticket": ticket,
                "predicate": repr(query.where),
                "agg": repr(query.agg),
                "latency_s": latency,
                "attribution": attr,
            },
            latency,
            sensings,
        )


def project_traffic(
    command_shape_counts: Counter,
    *,
    wordlines_sensed: int,
    num_rows: int,
    num_queries: int,
    host_postprocess: bool,
    esp_programs: int = 0,
    block_erases: int = 0,
    levels: int = 1,
    ssd: SSDConfig = DEFAULT_SSD,
    name: str = "flashql",
) -> dict:
    """Project served MWS traffic onto the paper's SSD timing/energy model.

    One call models one device (chip); a sharded fleet projects each
    device's traffic separately and aggregates — time as the max over
    concurrently-serving devices, energy as the sum (see
    ``repro_torch.query.shard``).

    ``esp_programs`` counts the *delta* page programs incremental appends
    issued — only the pages an update actually touched, never a full
    reprogram of the index.  They are charged at ``t_esp_us`` on the
    Flash-Cosmos side (ESP reliability costs ~2x a plain SLC program) and
    at ``t_prog_slc_us`` for the OSP baseline, which rewrites the same
    pages through the ordinary program path.

    ``block_erases`` counts whole-block erases (compaction rebuilds): both
    platforms pay ``t_bers_ms`` per block — garbage collection is the same
    erase-before-program dance wherever the data is computed on.

    ``levels`` is the multi-level packing factor (``Layout.levels``): both
    platforms sense L-level pages through a longer reference staircase
    (``level_read_factor``) and program them with finer ISPP verify steps
    (``level_program_factor``).  What makes packing a *win* is that the
    traffic counts themselves shrink — fewer physical programs/erases for
    the same logical pages — which the callers already fold in before
    projecting.
    """
    if not command_shape_counts and not esp_programs and not block_erases:
        raise ValueError("no traffic served yet")
    if levels > 1:
        ssd = replace(ssd, t_r_us=ssd.t_r_us * level_read_factor(levels))
    wl = BulkBitwiseWorkload(
        name=name,
        num_operands=wordlines_sensed,
        operand_bits=num_rows,
        # a program-only projection (appends landed on a stripe that never
        # sensed) streams no result bitmaps out
        result_bits=num_rows * (num_queries if command_shape_counts else 0),
        num_queries=1,  # shape counts already cover ALL served queries
        host_postprocess=host_postprocess,
        fc_command_counts=tuple(command_shape_counts.items()),
        fc_sensing_ops=sum(command_shape_counts.values()),
    )
    fc = run_workload(wl, Platform.FC, ssd)
    osp = run_workload(wl, Platform.OSP, ssd)
    prog_scale = level_program_factor(levels)
    t_esp = esp_programs * ssd.t_esp_us * prog_scale * 1e-6
    t_prog_osp = esp_programs * ssd.t_prog_slc_us * prog_scale * 1e-6
    t_erase = block_erases * ssd.t_bers_ms * 1e-3
    fc_time = fc.time_s + t_esp + t_erase
    osp_time = osp.time_s + t_prog_osp + t_erase
    fc_energy = fc.energy_j + (t_esp + t_erase) * ssd.p_prog_w
    osp_energy = osp.energy_j + (t_prog_osp + t_erase) * ssd.p_prog_w
    return {
        "workload": wl.name,
        "fc_time_s": fc_time,
        "fc_energy_j": fc_energy,
        "osp_time_s": osp_time,
        "osp_energy_j": osp_energy,
        "esp_programs": esp_programs,
        "block_erases": block_erases,
        "speedup_vs_osp": osp_time / fc_time,
        "energy_ratio_vs_osp": osp_energy / fc_energy,
    }


@dataclass(frozen=True)
class QueryResult:
    ticket: int
    query: Query
    value: object  # the aggregate's final value (int, float, BitVector, …)
    latency_s: float
    cache_hit: bool
    # per-query sensing + latency attribution (None when telemetry is
    # disabled): sensings / wordlines / spill_steps / agg_plane_reads are
    # exact per query; the *_s phase durations are the enclosing flush's
    # lifecycle (shared flush work — a batch amortizes it)
    attribution: dict | None = None

    # legacy accessors: COUNT/MASK callers predate the aggregate pipeline
    @property
    def count(self) -> int | None:
        spec = normalize_agg(self.query.agg)
        return self.value if isinstance(spec, Count) else None

    @property
    def mask(self):
        spec = normalize_agg(self.query.agg)
        return self.value if isinstance(spec, Mask) else None


# legacy counter attributes of the schedulers, reimplemented as read-only
# views over the telemetry registry (one source of truth; stats() stays
# bit-compatible — asserted in tests/test_query_telemetry.py)
def registry_counters(cls, names: tuple[str, ...]):
    for name in names:
        setattr(
            cls,
            name,
            property(lambda self, _n=name: self.telemetry.value(_n)),
        )
    return cls


@dataclass
class BatchScheduler:
    device: FlashDevice
    store: BitmapStore
    max_batch: int = 256
    compiler: QueryCompiler = None  # type: ignore[assignment]
    # one fused device program + ONE host transfer per flush (the default
    # serving path); False keeps the per-reduce-group legacy path — the
    # oracle the differential harness compares against
    fuse_flush: bool = True
    # queue small append() batches and program them as one coalesced delta
    # per touched page on the next flush (or apply_appends())
    coalesce_appends: bool = False
    # -- the cost-based multi-query optimizer (repro_torch.query.optimize) --
    # canonicalize predicates, pick chain orderings by the flashsim cost
    # model, dedup + CSE-share plans within each fused flush, and
    # materialize hot predicates; False serves exactly as before (the
    # optimizer-off baseline the Zipfian benchmark compares against)
    optimize: bool = True
    # compiles of one canonical predicate before its result bitmap is
    # ESP-programmed as a cached page (see QueryCompiler.materialize);
    # None disables materialization while keeping the other stages
    materialize_after: int | None = 32
    # -- background-compaction policy (see compact()) -----------------------
    # auto-compact when the stripe's tombstone density crosses this (None
    # disables the policy); checked after delete()/update() only, never
    # mid-flush, so no ticket spans a rebuild
    compact_density: float | None = None
    # on append overflow, rebuild into wider pages (capacity growth folded
    # into the compaction path) instead of rejecting the batch
    grow_on_overflow: bool = False
    # the unified metrics registry + trace recorder; pass
    # Telemetry(enabled=False) to strip every per-event recorder off the
    # hot path (counters keep counting — stats()/projection read them)
    telemetry: Telemetry = None  # type: ignore[assignment]

    _pending: list[tuple[int, Query, float]] = field(default_factory=list)
    _next_ticket: int = 0
    # executed traffic, aggregated per command shape (bounded memory even
    # for a long-running service); wordlines tracked exactly because ragged
    # commands pad to max_wls_per_block and must not inflate operand counts
    command_shape_counts: Counter = field(default_factory=Counter)
    _host_postprocess: bool = False
    # stacked extra sensed planes (BSI slices / equality bitmaps) per
    # (store epoch, page tuple) — see repro_torch.query.aggregate.reduce_flush
    _extras_cache: dict = field(default_factory=dict, repr=False)
    # device-resident valid-row word mask, memoized per ingest epoch
    _mask_cache: tuple | None = field(default=None, repr=False)
    # fused flush programs per (batch composition, store epochs) and their
    # runners per flush signature — see compile_flush
    _flush_programs: dict = field(default_factory=dict, repr=False)
    _runner_cache: dict = field(default_factory=dict, repr=False)
    # flush-level CSE rewrites per (batch composition, store epochs) —
    # see repro_torch.query.optimize.cse_flush
    _cse_cache: dict = field(default_factory=dict, repr=False)
    # queued (validated) append batches awaiting coalesced programming
    _append_buf: list = field(default_factory=list, repr=False)
    # predicate trees walked (hashed and their columns collected) at
    # admission since the previous flush; a repeat query walks none
    _walks: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.telemetry is None:
            self.telemetry = Telemetry()
        if self.compiler is None:
            self.compiler = QueryCompiler(self.store, self.device)
        self.compiler.telemetry = self.telemetry
        self.compiler.optimize = self.optimize
        self.compiler.materialize_after = (
            self.materialize_after if self.optimize else None
        )
        self.device.telemetry = self.telemetry
        self.telemetry.name_tid(TID_FLUSH, "flush")
        self.telemetry.name_tid(TID_TICKETS, "tickets")
        self.telemetry.providers.setdefault("plan_cache", self._plan_cache)
        self.telemetry.providers.setdefault("projection", self.projection)
        self.telemetry.providers.setdefault(
            "optimizer", self._optimizer_stats
        )

    def _plan_cache(self) -> dict:
        return {
            "hits": self.compiler.hits,
            "misses": self.compiler.misses,
            "size": self.compiler.cache_size,
        }

    def _optimizer_stats(self) -> dict:
        tele = self.telemetry
        served = int(self.queries_served)
        mws = sum(self.command_shape_counts.values())
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

    def _materialize_hot(self) -> None:
        """Materialization policy: at each flush boundary, ESP-program the
        result bitmaps of predicates past the compiler's heat threshold.
        The build's one sensing pass + page program are charged to traffic
        (the payoff is every later compile lowering to ``mat AND valid``)."""
        if not self.optimize:
            return
        for key, canon in self.compiler.hot_preds():
            plan = self.compiler.materialize(key, canon)
            if plan is not None:
                self.telemetry.count(
                    "wordlines_sensed",
                    record_plan_traffic(self.command_shape_counts, plan),
                )
                thr = plan_thresholds(plan)
                if thr:
                    self.telemetry.count("threshold_senses", thr)
                self.telemetry.count("materialization_programs")

    # -- incremental ingest --------------------------------------------------
    def _refuse_pending(self, what: str, spans: str = "mutation") -> None:
        if self._pending:
            raise RuntimeError(
                f"{what}() with {len(self._pending)} queries pending; "
                f"flush() first so no ticket spans the {spans}"
            )

    def append(self, rows: dict[str, object]) -> int:
        """Append rows to the live index; returns pages ESP-programmed.

        The whole batch is validated against the ingest schema (exact
        column set, equal lengths, non-negative values, word capacity)
        *before* any page state mutates, and appends are refused while
        queries are pending.  Only delta pages are programmed; plans over
        columns whose index metadata did not change stay warm.  With
        ``coalesce_appends`` the (fully validated) batch is queued instead
        and returns 0; the next ``flush()`` or :meth:`apply_appends`
        programs all queued batches as ONE delta per touched page.
        """
        self._refuse_pending("append")
        try:
            return self._admit_append(rows)
        except ValueError as err:
            if not (self.grow_on_overflow and "overflows" in str(err)):
                raise
            # capacity growth rides the compaction rebuild (the failed
            # attempt validated before mutating), leaving the batch plus
            # the original headroom — or twice the batch — free
            b = len(next(iter(rows.values())))
            self.compact(
                reserve_rows=b
                + max(2 * b, self.store.capacity_rows - self.store.live_rows)
            )
            return self._admit_append(rows)

    def _admit_append(self, rows: dict) -> int:
        if self.coalesce_appends:
            queue_append(self.store, self._append_buf, rows)
            return 0
        return self._program_append(rows)

    def _program_append(self, rows: dict) -> int:
        delta = self.store.append(rows)  # validates before mutating
        programs, words = self.store.program_delta(
            self.device, delta, telemetry=self.telemetry
        )
        self.telemetry.count("rows_appended", delta.rows)
        self.telemetry.count("esp_delta_programs", programs)
        self._count_programmed_words(delta, words)
        return programs

    def _count_programmed_words(self, delta, physical: int) -> None:
        """Write-amplification accounting for one client mutation's delta:
        ``words_programmed`` counts the words physically ESP-programmed
        (multi-level packing merges co-resident pages), ``words_written``
        the words the mutation changed (the per-logical-page sum).
        Compaction adds to the physical side only."""
        self.telemetry.count("words_programmed", physical)
        self.telemetry.count(
            "words_written", sum(int(pd.words.shape[0]) for pd in delta.pages)
        )

    @property
    def appends_queued(self) -> int:
        return len(self._append_buf)

    def apply_appends(self) -> int:
        """Program every queued append batch as one coalesced delta (a page
        touched by many queued batches programs ONCE); returns the pages
        programmed.  Runs at the top of ``flush()``, so queries submitted
        after an append always see its rows."""
        if not self._append_buf:
            return 0
        rows = merge_appends(self._append_buf)
        self.telemetry.count("append_batches_coalesced", len(self._append_buf))
        self._append_buf.clear()
        return self._program_append(rows)

    # -- deletes / updates / compaction --------------------------------------
    def delete(self, row_ids) -> int:
        """Tombstone rows; returns pages ESP-programmed (always 1).

        Queued appends apply first so ``row_ids`` address the up-to-date
        table; refused while queries are pending.  One delta-page program
        of the tombstone page; no region epoch moves, so every cached plan
        stays warm.  May trigger the auto-compaction policy.
        """
        self._refuse_pending("delete")
        self.apply_appends()
        delta = self.store.delete(row_ids)
        programs, words = self.store.program_delta(
            self.device, delta, telemetry=self.telemetry
        )
        self.telemetry.count("rows_deleted", len(np.asarray(row_ids)))
        self.telemetry.count("esp_delta_programs", programs)
        self._count_programmed_words(delta, words)
        self.telemetry.gauge("tombstone_density", self.store.tombstone_density)
        self._maybe_compact()
        return programs

    def update(self, row_ids, rows: dict[str, object]) -> int:
        """Update = delete + append: tombstone ``row_ids``, append ``rows``
        (fresh row ids at the tail); returns pages programmed.  Both halves
        validate BEFORE either mutates."""
        self._refuse_pending("update")
        self.apply_appends()
        ids = self.store.check_delete(row_ids)
        arrays = {c: np.asarray(v) for c, v in rows.items()}
        b = self.store.check_append(arrays)
        if b != ids.size:
            raise ValueError(
                f"update() got {ids.size} row ids but {b} replacement rows"
            )
        n = self.delete(ids)
        n += self.append(arrays)
        self.telemetry.count("rows_updated", ids.size)
        return n

    def _maybe_compact(self) -> bool:
        """The background-compaction policy: rebuild once tombstone density
        crosses ``compact_density`` (at mutation boundaries only)."""
        if (
            self.compact_density is None
            or self.store.tombstone_density < self.compact_density
        ):
            return False
        self.compact()
        return True

    def compact(self, reserve_rows: int | None = None) -> dict:
        """Rewrite the stripe without its tombstoned rows; returns stats.

        NAND programs only 1->0, so reclaiming tombstoned capacity erases
        every block the stripe occupies (one P/E cycle each, charged in the
        SSD projection) and ESP-reprograms the surviving rows, renumbered
        densely in old id order.  ``reserve_rows`` sets the fresh append
        headroom and defaults to the stripe's full pre-compaction capacity.
        The reprogram counts toward physical (not logical) programmed
        words.  The returned ``seconds`` split into ``to_table_s``,
        ``rebuild_s`` (erase + host re-ingest) and ``program_s``; the
        device snapshot is uploaded whole by the next flush.
        """
        self._refuse_pending("compact", "rebuild")
        self.apply_appends()
        store, tele = self.store, self.telemetry
        t0 = time.perf_counter()
        dropped = store.deleted_rows
        live = store.live_bits()
        table = {c: v[live] for c, v in store.to_table().items()}
        if reserve_rows is None:
            reserve_rows = store.capacity_rows - store.live_rows
        schema = {c: ci.values for c, ci in store.columns.items()}
        t_table = time.perf_counter()
        erased = self.device.erase_rebuild()
        store.rebuild(table, reserve_rows=reserve_rows, schema=schema)
        t_rebuild = time.perf_counter()
        _, words = store.program(self.device)
        self.device.reset_after_rebuild()
        self._flush_programs.clear()
        self._extras_cache.clear()
        self._cse_cache.clear()
        self._mask_cache = None
        tele.count("compactions")
        tele.count("block_erases", erased)
        tele.count("words_programmed", words)
        tele.count("compaction_rows_dropped", dropped)
        tele.gauge("tombstone_density", 0.0)
        self._record_wear()
        t1 = time.perf_counter()
        tele.span("compact", "flush", t0, t1, args={"erased": erased})
        tele.observe("compact_s", t1 - t0)
        return {
            "rows_dropped": dropped,
            "live_rows": store.num_rows,
            "capacity_rows": store.capacity_rows,
            "blocks_erased": erased,
            "words_reprogrammed": words,
            "seconds": t1 - t0,
            "to_table_s": t_table - t0,
            "rebuild_s": t_rebuild - t_table,
            "program_s": t1 - t_rebuild,
        }

    def _record_wear(self) -> None:
        """Per-block wear gauges (P/E cycles) after erase-heavy operations."""
        pec = self.device.pec
        if pec:
            self.telemetry.gauge("max_pec", max(pec.values()))
            self.telemetry.gauge("mean_pec", sum(pec.values()) / len(pec))

    # -- admission ----------------------------------------------------------
    def submit(self, query: Query) -> int:
        """Admit a query; returns its ticket.  Queries execute on the next
        ``flush()`` (or ``serve()``), ``max_batch`` at a time.

        Validation (predicate columns + the aggregate's target columns)
        happens here, so a bad query raises immediately instead of
        poisoning a later flush.
        """
        fresh = not walked(query.where)
        validate_query(query, self.store.columns)
        self._walks += fresh
        ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.append((ticket, query, time.perf_counter()))
        return ticket

    @property
    def pending(self) -> int:
        return len(self._pending)

    # -- serving -------------------------------------------------------------
    def flush(self) -> dict[int, QueryResult]:
        """Compile, batch-execute, and aggregate all pending queries
        (queued appends are programmed first)."""
        self.apply_appends()
        if not self._pending:
            return {}
        self._materialize_hot()
        tele = self.telemetry
        batch, self._pending = (
            self._pending[: self.max_batch],
            self._pending[self.max_batch :],
        )
        tele.gauge("pending_after_pop", len(self._pending))
        tele.gauge("predicate_walks", self._walks)  # one of PORT_GAUGES
        self._walks = 0
        t0 = time.perf_counter()
        compiled = [self.compiler.compile(q) for _, q, _ in batch]
        execs = [self.compiler.exec_for(cq) for cq in compiled]
        t_comp = time.perf_counter()
        if self._mask_cache is None or self._mask_cache[0] != self.store.epoch:
            self._mask_cache = (
                self.store.epoch,
                to_words(self.store.valid_words_mask(), self.device.device),
            )
        mask_words = self._mask_cache[1]
        queries = [q for _, q, _ in batch]
        aggs = [get_aggregator(q.agg) for q in queries]

        cse = None
        if self.fuse_flush and not self.device._non_esp:
            # the fused path: ONE program senses every signature group and
            # reduces every aggregate kind on the device; ONE
            # payload transfer brings back the whole flush.  Epochs inside
            # the plan keys + the content epochs make stale hits impossible.
            # Plan keys cover only the predicate side, so the members'
            # aggregate specs join the key explicitly — the same predicates
            # under different aggregates are different programs.
            if self.optimize:
                ckey = (
                    tuple(cq.key for cq in compiled),
                    self.store.epoch,
                    self.device.store.epoch,
                )
                cse = self._cse_cache.get(ckey)
                if cse is None:
                    if len(self._cse_cache) >= 64:
                        self._cse_cache.clear()
                    cse = cse_flush(compiled, self.compiler, self.device)
                    self._cse_cache[ckey] = cse
            key = (
                tuple(cq.key for cq in compiled),
                tuple(a.spec for a in aggs),
                self.store.epoch,
                self.device.store.epoch,
            )
            program = self._flush_programs.get(key)
            if program is None:
                if len(self._flush_programs) >= 64:
                    self._flush_programs.clear()
                program = compile_flush(
                    execs if cse is None else list(cse.member_execs),
                    [q.agg for q in queries],
                    [self.store] * len(queries),
                    [self.store.epoch] * len(queries),
                    words=self.store.words,
                    device=self.device.device,
                    runner_cache=self._runner_cache,
                    extras_cache=self._extras_cache,
                    pad=self.device.pad_signatures,
                    dedup_keys=(
                        None if cse is None else list(cse.dedup_keys)
                    ),
                    shared_execs=() if cse is None else cse.shared_execs,
                )
                self._flush_programs[key] = program
            payload = program.run(
                self.device.store.snapshot(self.device.device), mask_words
            )
            if cse is None:
                age_spill_blocks(self.device.pec, execs)
            else:
                # wear: one run of each UNIQUE member plan + each shared
                # plan, plus one scratch program per shared result
                age_spill_blocks(
                    self.device.pec,
                    [cse.member_execs[i] for i in cse.uix]
                    + list(cse.shared_execs),
                )
                for b in cse.shared_blocks:
                    self.device.pec[b] = self.device.pec.get(b, 0) + 1
            tele.count("fused_dispatches")
            # an emulation detail, not modelled traffic (PORT_GAUGES)
            tele.gauge("sense_commands_hoisted", program.sensings_hoisted)
            self.device.last_signature_groups = program.n_sense_groups
            t_disp = time.perf_counter()
            # the single device->host copy of the flush (also the barrier
            # that keeps qps/latency from measuring only Python dispatch)
            host = payload.cpu().numpy().view(np.uint32)
            tele.count("host_transfers")
            t_xfer = time.perf_counter()
            partials = program.unpack(host, aggs)
            extra_counts = list(program.extra_counts)
            tele.span("dispatch", "flush", t_comp, t_disp)
            tele.span("transfer", "flush", t_disp, t_xfer)
        else:
            # legacy path (devices with non-ESP pages, and the oracle for
            # the differential harness): batch groups + one reduce launch
            # and one transfer per reduce signature
            plans = [c.plan for c in compiled]
            stacked = (
                self.device.execute_batch_stacked(
                    plans,
                    execs=execs,
                    # epochs inside cq.key make the memoized grouping
                    # impossible to hit stale
                    batch_key=tuple(cq.key for cq in compiled),
                )
                & mask_words
            )  # (B, W), padding zeroed
            t_disp = time.perf_counter()
            partials, extra_counts, n_groups = reduce_flush(
                stacked,
                [q.agg for q in queries],
                [self.store] * len(queries),
                [self.store.epoch] * len(queries),
                extras_cache=self._extras_cache,
            )
            tele.count("host_transfers", n_groups)
            tele.count("eager_plans", self.device.last_eager_plans)
            # every reduce group's transfer waited for the device work
            t_xfer = time.perf_counter()
            tele.span("dispatch", "flush", t_comp, t_disp)
            tele.span("reduce+transfer", "flush", t_disp, t_xfer)
        t1 = time.perf_counter()
        if cse is not None:
            # physical traffic after CSE: each UNIQUE member plan runs once
            # (duplicates ride the member gather) plus each shared subplan
            wls = thr = 0
            for p in list(cse.member_plans) + list(cse.shared_plans):
                wls += record_plan_traffic(self.command_shape_counts, p)
                thr += plan_thresholds(p)
            tele.count("wordlines_sensed", wls)
            if thr:
                tele.count("threshold_senses", thr)
            tele.count("cse_plan_hits", cse.n_dedup_hits)
            tele.count("cse_shared_senses", len(cse.shared_plans))
            tele.count("cse_rewritten_members", cse.n_rewritten)
            tele.count("cse_spill_programs", len(cse.shared_plans))
        results: dict[int, QueryResult] = {}
        for i, ((ticket, q, t_submit), cq) in enumerate(zip(batch, compiled)):
            agg = aggs[i]
            self._host_postprocess |= agg.host_postprocess
            if cse is None:
                self.telemetry.count(
                    "wordlines_sensed",
                    record_plan_traffic(self.command_shape_counts, cq.plan),
                )
                thr = plan_thresholds(cq.plan)
                if thr:
                    self.telemetry.count("threshold_senses", thr)
            # each extra plane the aggregate sensed (a BSI slice or an
            # equality bitmap) is one single-wordline read in the
            # projected traffic
            if extra_counts[i]:
                self.command_shape_counts[AGG_READ_SHAPE] += extra_counts[i]
                tele.count("wordlines_sensed", extra_counts[i])
            attr = None
            if tele.enabled:
                attr = {
                    "sensings": plan_sensings(cq.plan) + extra_counts[i],
                    "wordlines": plan_traffic(cq.plan)[1] + extra_counts[i],
                    "spill_steps": execs[i].spills if execs[i] else 0,
                    "agg_plane_reads": extra_counts[i],
                    "queue_s": t0 - t_submit,
                    "compile_s": t_comp - t0,
                    "device_s": t_disp - t_comp,
                    "transfer_s": t_xfer - t_disp,
                    "reduce_s": t1 - t_xfer,
                }
                attribute_result(tele, ticket, q, attr, t_submit, t1)
            results[ticket] = QueryResult(
                ticket,
                q,
                agg.finalize(partials[i], self.store),
                t1 - t_submit,
                cq.cache_hit,
                attribution=attr,
            )
            tele.count("total_latency_s", t1 - t_submit)

        tele.count("queries_served", len(batch))
        tele.count("flushes")
        tele.count("vmap_batches", self.device.last_signature_groups)
        tele.count("serve_time_s", t1 - t0)
        tele.span("compile", "flush", t0, t_comp)
        tele.span("reduce", "flush", t_xfer, t1)
        tele.span(
            "flush",
            "flush",
            t0,
            t1,
            args={"flush": int(self.flushes), "batch": len(batch)},
        )
        tele.observe("flush_latency_s", t1 - t0)
        return results

    def serve(self, queries: list[Query]) -> list[QueryResult]:
        """Submit + flush until drained; results in submission order."""
        tickets = [self.submit(q) for q in queries]
        results: dict[int, QueryResult] = {}
        while self._pending:
            results.update(self.flush())
        return [results[t] for t in tickets]

    # -- reporting -----------------------------------------------------------
    def stats(self) -> dict:
        served = max(self.queries_served, 1)
        return {
            "queries_served": self.queries_served,
            "flushes": self.flushes,
            "vmap_batches": self.vmap_batches,
            "eager_plans": self.eager_plans,
            "plan_cache_hits": self.compiler.hits,
            "plan_cache_misses": self.compiler.misses,
            "plan_cache_size": self.compiler.cache_size,
            "queries_per_sec": (
                self.queries_served / self.serve_time_s
                if self.serve_time_s
                else float("inf")
            ),
            "mean_latency_s": self.total_latency_s / served,
            "mws_commands": sum(self.command_shape_counts.values()),
            "sensings_per_query": (
                sum(self.command_shape_counts.values()) / served
            ),
            "threshold_senses": self.threshold_senses,
            "cse_plan_hits": self.cse_plan_hits,
            "cse_shared_senses": self.cse_shared_senses,
            "materializations": self.materializations,
            "materialization_hits": self.materialization_hits,
            "fused_dispatches": self.fused_dispatches,
            "host_transfers": self.host_transfers,
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
                else 1.0
            ),
        }

    def projection(self, ssd: SSDConfig = DEFAULT_SSD) -> dict:
        """Full-scale SSD time/energy projection of the served traffic.

        Replays every executed MWS command shape through the paper's timing
        and energy model at Table-1 geometry, with the result bitmaps of all
        served queries streamed out — reported next to the outside-storage
        (OSP) baseline that would sense and ship every operand page.
        """
        return project_traffic(
            self.command_shape_counts,
            wordlines_sensed=int(self.wordlines_sensed),
            num_rows=self.store.num_rows,
            num_queries=int(self.queries_served),
            host_postprocess=self._host_postprocess,
            # appends' delta programs + CSE scratch-page programs + hot-
            # predicate materialization programs all ride the ESP path
            esp_programs=int(
                self.esp_delta_programs
                + self.cse_spill_programs
                + self.materialization_programs
            ),
            block_erases=int(self.block_erases),
            levels=self.device.layout.levels,
            ssd=ssd,
            name=f"flashql({int(self.queries_served)}q)",
        )


registry_counters(
    BatchScheduler,
    (
        "queries_served",
        "flushes",
        "vmap_batches",
        "eager_plans",
        "serve_time_s",
        "total_latency_s",
        "fused_dispatches",
        "host_transfers",
        "rows_appended",
        "esp_delta_programs",
        "append_batches_coalesced",
        "wordlines_sensed",
        "threshold_senses",
        "rows_deleted",
        "rows_updated",
        "compactions",
        "block_erases",
        "words_programmed",
        "words_written",
        "compaction_rows_dropped",
        "cse_plan_hits",
        "cse_shared_senses",
        "cse_rewritten_members",
        "cse_spill_programs",
        "materializations",
        "materialization_hits",
        "materialization_invalidations",
        "materialization_programs",
    ),
)
