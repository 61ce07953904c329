"""FlashQL telemetry: metrics registry, trace spans, sensing attribution.

One zero-dependency (stdlib-only) observability layer for the whole query
stack.  Both schedulers (:class:`repro_torch.query.scheduler.BatchScheduler`,
:class:`repro_torch.query.shard.ShardedFlashQL`) carry a :class:`Telemetry`
instance and route every stat they keep through it:

* **counters** — monotonic accounting (``host_transfers``,
  ``fused_dispatches``, ``wordlines_sensed``, per-shard mirrors, …).
  Counters are *always on*: they are functional inputs — ``stats()`` and
  the SSD time/energy projection are computed from them — and an
  increment is one dict update per event, so there is nothing to save by
  gating them.  The schedulers' legacy counter attributes are thin
  properties over this registry (asserted bit-compatible in
  ``tests/test_query_telemetry.py``).
* **gauges** — last-value samples (per-shard queue depth, routed drain
  budgets).
* **histograms** — bounded rings of observations with nearest-rank
  p50/p95/p99 (flush latency, per-query latency, plan-compile time).
  :func:`percentile` is the repo's ONE quantile codepath —
  ``benchmarks/_harness.py`` delegates here.
* **trace spans** — the flush lifecycle (admission -> plan compile ->
  fused dispatch -> device execute -> host transfer -> reduce -> shard
  merge) recorded into a bounded ring and exportable as a Chrome
  trace-event JSON (:meth:`Telemetry.export_trace`) — load it in
  ``chrome://tracing`` / Perfetto and a pipelined 4-shard flush reads as
  overlapping per-shard rows.
* **slow-query log** — tickets whose latency or sensing count crosses a
  configurable threshold land in a bounded ring with their predicate
  repr and full attribution.

Everything except counters is **off when** ``enabled=False``: ``span`` /
``observe`` / ``gauge`` / ``slow`` return after one attribute check, the
schedulers skip building per-ticket attribution entirely, and no query
result changes either way (differential-tested).  The overhead of the
enabled path is gated in ``benchmarks/flashql_telemetry.py`` (within 10%
of disabled serving).

Every buffer here is bounded (ring buffers via ``deque(maxlen=...)``), so
a long-running service's telemetry memory is O(capacity), never O(tickets
served).
"""

from __future__ import annotations

import json
import math
import time
from collections import deque
from typing import Callable

# trace rows (Chrome trace "tid"s) shared by both schedulers: shard rows
# occupy 0..num_shards-1, then these synthetic rows follow
TID_FLUSH = "flush"
TID_MERGE = "merge"
TID_TICKETS = "tickets"

# gauges only the port's BatchScheduler writes: emulation details with no
# counterpart in the reference (command sensings its fused flush saves,
# predicate trees walked at admission), gauges so that the counters stay
# the reference's
PORT_GAUGES = ("sense_commands_hoisted", "predicate_walks")


def percentile(samples, q: float) -> float | None:
    """The ``q``-th percentile (nearest-rank) of a sample set, or ``None``
    when the set is empty.

    The single quantile implementation in the repo: histogram summaries
    and the benchmark harness (``benchmarks/_harness.py``) both call this.
    A fresh (or fully-drained) ring has no distribution to summarize —
    that is an answerable question, not an error, so callers get ``None``
    and omit the quantile instead of unwinding a snapshot mid-build.
    """
    s = sorted(samples)
    if not s:
        return None
    rank = min(max(1, math.ceil(q / 100 * len(s))), len(s))  # 1-based
    return s[rank - 1]


class Histogram:
    """Bounded ring of observations with nearest-rank quantile summary.

    ``count``/``total`` (and hence ``mean``) cover every observation ever
    made; quantiles cover the retained ring (the most recent ``capacity``
    samples) — a long-running service keeps O(capacity) memory and its
    tail percentiles track the *recent* distribution, which is what a
    latency gate wants.
    """

    __slots__ = ("samples", "count", "total")

    def __init__(self, capacity: int = 2048):
        self.samples: deque = deque(maxlen=capacity)
        self.count = 0
        self.total = 0.0

    def observe(self, value: float) -> None:
        self.samples.append(value)
        self.count += 1
        self.total += value

    def summary(self) -> dict:
        """Count/mean plus ring quantiles; quantile keys are OMITTED (not
        ``None``-valued, not raised over) when the ring holds no samples —
        ``Telemetry.snapshot()`` must stay total on a fresh registry."""
        out: dict = {"count": self.count}
        if self.count:
            out["mean"] = self.total / self.count
        if self.samples:
            out.update(
                p50=percentile(self.samples, 50),
                p95=percentile(self.samples, 95),
                p99=percentile(self.samples, 99),
                max=max(self.samples),
            )
        return out


class Telemetry:
    """The unified registry + trace recorder (see module docstring).

    ``enabled=False`` freezes every per-event recorder (spans, gauges,
    histograms, slow log) behind a single attribute check; counters keep
    counting because ``stats()`` and the SSD projection are built on them.
    """

    def __init__(
        self,
        enabled: bool = True,
        *,
        trace_capacity: int = 4096,
        hist_capacity: int = 2048,
        slow_capacity: int = 256,
        slow_latency_s: float | None = None,
        slow_sensings: int | None = None,
    ):
        self.enabled = enabled
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.hists: dict[str, Histogram] = {}
        self.hist_capacity = hist_capacity
        self.trace: deque = deque(maxlen=trace_capacity)
        self.slow_queries: deque = deque(maxlen=slow_capacity)
        self.slow_latency_s = slow_latency_s
        self.slow_sensings = slow_sensings
        # snapshot sections computed lazily at snapshot() time (plan-cache
        # counters live on the compilers, the projection on the scheduler)
        self.providers: dict[str, Callable[[], object]] = {}
        self.tid_names: dict[object, str] = {}
        self._t0 = time.perf_counter()

    # -- counters (always on: stats()/projection inputs) ---------------------
    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def value(self, name: str, default: float = 0) -> float:
        return self.counters.get(name, default)

    # -- per-event recorders (no-ops when disabled) --------------------------
    def gauge(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram(self.hist_capacity)
        h.observe(value)

    def span(
        self,
        name: str,
        cat: str,
        t_start: float,
        t_end: float,
        tid: object = TID_FLUSH,
        args: dict | None = None,
    ) -> None:
        """Record one complete trace span from already-taken perf_counter
        stamps — the hot path never takes extra timestamps for tracing."""
        if not self.enabled:
            return
        self.trace.append((name, cat, tid, t_start, t_end, args))

    def name_tid(self, tid: object, name: str) -> None:
        """Label a trace row (emitted as thread_name metadata on export)."""
        self.tid_names[tid] = name

    def is_slow(self, latency_s: float, sensings: int) -> bool:
        """Whether a query crosses the latency OR sensing threshold."""
        return self.enabled and (
            (self.slow_latency_s is not None and latency_s >= self.slow_latency_s)
            or (self.slow_sensings is not None and sensings >= self.slow_sensings)
        )

    def slow(self, entry: dict, latency_s: float, sensings: int) -> None:
        """Log ``entry`` if it crosses the latency OR sensing threshold."""
        if self.is_slow(latency_s, sensings):
            self.slow_queries.append(entry)

    # -- reporting -----------------------------------------------------------
    def snapshot(self) -> dict:
        """Everything the registry knows, as one plain dict.

        Counters and gauges verbatim, histogram summaries, the slow-query
        log, plus every registered provider section — the schedulers
        register ``plan_cache`` (hits/misses/size off the live compilers)
        and ``projection`` (the SSD time/energy model over the served
        traffic; ``None`` until traffic exists), so observed host metrics
        and projected device metrics read out together.
        """
        out: dict = {
            "enabled": self.enabled,
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: h.summary() for k, h in self.hists.items()},
            "slow_queries": list(self.slow_queries),
            "trace_events": len(self.trace),
        }
        for key, fn in self.providers.items():
            try:
                out[key] = fn()
            except ValueError:  # e.g. projection before any traffic
                out[key] = None
        return out

    def export_trace(self, path: str | None = None) -> dict:
        """The recorded spans as a Chrome trace-event JSON object.

        Complete ("ph": "X") events with microsecond timestamps relative
        to this Telemetry's construction, one trace row per tid (labelled
        via thread_name metadata).  Written to ``path`` when given; load
        the file in ``chrome://tracing`` or https://ui.perfetto.dev.
        """
        events: list[dict] = []
        tids = {}
        for tid in self.tid_names:
            tids.setdefault(tid, len(tids))
        for name, cat, tid, t_start, t_end, args in self.trace:
            row = tids.setdefault(tid, len(tids))
            ts = (t_start - self._t0) * 1e6
            dur = max(t_end - t_start, 0.0) * 1e6
            if tid == TID_TICKETS:
                # tickets legitimately overlap (one can straddle flushes),
                # so they export as nestable async pairs, not "X" slices —
                # each renders as its own sub-track keyed on its id
                base = {
                    "name": name,
                    "cat": cat,
                    "pid": 0,
                    "tid": row,
                    "id": (args or {}).get("ticket", 0),
                }
                events.append(
                    {**base, "ph": "b", "ts": ts, "args": args or {}}
                )
                events.append({**base, "ph": "e", "ts": ts + dur})
                continue
            ev = {
                "name": name,
                "cat": cat,
                "ph": "X",
                "pid": 0,
                "tid": row,
                "ts": ts,
                "dur": dur,
            }
            if args:
                ev["args"] = args
            events.append(ev)
        for tid, row in tids.items():
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 0,
                    "tid": row,
                    "args": {"name": self.tid_names.get(tid, str(tid))},
                }
            )
        trace = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace


def validate_trace(trace: dict) -> int:
    """Validate an exported Chrome trace: well-formed events and properly
    nested spans; returns the number of duration events checked.

    Nesting is checked per trace row (tid): sorted by start time, every
    span must either be fully contained in the enclosing open span or
    start after it ends — partial overlap within a row means the recorded
    lifecycle stamps are inconsistent.  (Different rows — shards, the
    merge row, the ticket row — legitimately overlap; that overlap IS the
    pipelining the trace exists to show.)
    """
    if "traceEvents" not in trace:
        raise ValueError("missing traceEvents")
    rows: dict[object, list[tuple[float, float, str]]] = {}
    n = 0
    open_async: dict[tuple, float] = {}
    for ev in trace["traceEvents"]:
        # async ticket pairs ("b"/"e") overlap by design; only check that
        # every begin closes with a non-negative duration
        if ev.get("ph") == "b":
            open_async[(ev.get("id"), ev.get("name"))] = ev["ts"]
            continue
        if ev.get("ph") == "e":
            key = (ev.get("id"), ev.get("name"))
            if key not in open_async:
                raise ValueError(f"async end without begin: {ev!r}")
            if ev["ts"] < open_async.pop(key):
                raise ValueError(f"async event ends before it begins: {ev!r}")
            n += 1
            continue
        if ev.get("ph") != "X":
            continue
        if ev["dur"] < 0 or not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"malformed event {ev!r}")
        rows.setdefault((ev.get("pid"), ev.get("tid")), []).append(
            (ev["ts"], ev["ts"] + ev["dur"], ev["name"])
        )
        n += 1
    eps = 1.0  # μs: perf_counter stamps taken back-to-back may tie
    for row in rows.values():
        row.sort(key=lambda e: (e[0], -(e[1] - e[0])))
        stack: list[tuple[float, float, str]] = []
        for start, end, name in row:
            while stack and start >= stack[-1][1] - eps:
                stack.pop()
            if stack and end > stack[-1][1] + eps:
                raise ValueError(
                    f"span {name!r} [{start:.1f}, {end:.1f}] overlaps "
                    f"{stack[-1][2]!r} ending {stack[-1][1]:.1f} "
                    "without nesting"
                )
            stack.append((start, end, name))
    if open_async:
        raise ValueError(f"unclosed async events: {sorted(open_async)}")
    return n
