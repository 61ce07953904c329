"""FlashQL on one device through the port's public entry.

The BMI index arrives as bitmaps, one per day, and not as a table of
rows: at the configuration's size that table would hold a byte per user
per day.  So the adapter fills a ``BitmapStore`` with the pages that
``BitmapStore.ingest`` builds for a column of 0/1 values (``day=0``,
``day=1`` and the BSI slice ``day#0``; the CPU tests hold the two equal
at a small size), then ``BitmapStore.program`` ESP-programs them into a
``FlashDevice``, placing them for the traffic's queries (the paper's
§6.3 placement), and a ``BatchScheduler`` serves the queries.  The
traffic's plain specs, a predicate and its query's own aggregate, become
``repro_torch.query`` objects here, once per distinct pair.
"""

from __future__ import annotations

import numpy as np

from repro_torch import query as q
from repro_torch.query.bitmap import FALSE_PAGE, TRUE_PAGE, VALID_PAGE, ColumnIndex, bsi_page, eq_page


def day_column(day: int) -> str:
    return f"day{day:04d}"


def build_store(bitmaps: np.ndarray, users: int) -> q.BitmapStore:
    """The store ``ingest`` would build from 0/1 day columns whose packed
    rows are ``bitmaps`` (days, words), oldest day first."""
    store = q.BitmapStore(num_rows=users, capacity_rows=users)
    store.epoch += 1
    valid = store.valid_words_mask()
    store.logical[TRUE_PAGE] = valid
    store.logical[FALSE_PAGE] = np.zeros_like(valid)
    store.logical[VALID_PAGE] = valid.copy()
    for day, words in enumerate(bitmaps):
        col = day_column(day)
        store.columns[col] = ColumnIndex(col, (0, 1), 1)
        store.column_epochs[col] = 1
        store.logical[eq_page(col, 0)] = ~words & valid
        store.logical[eq_page(col, 1)] = words
        store.logical[bsi_page(col, 0)] = words.copy()
    return store


class System:
    """The program under test, built from a configuration and the bitmaps."""

    def __init__(self, config: dict, bitmaps: np.ndarray, traffic, device, telemetry_enabled: bool):
        self.days = int(config["days"])
        self.telemetry = q.Telemetry(enabled=telemetry_enabled, trace_capacity=1 << 20)
        store = build_store(bitmaps, int(config["users"]))
        dev = q.FlashDevice(num_planes=config["planes"], device=device)
        self._queries: dict[tuple, q.Query] = {}
        store.program(dev, warmup=[self.query(p, a) for p, a in traffic.queries()])
        self.sched = q.BatchScheduler(
            dev,
            store,
            optimize=config["optimize"],
            materialize_after=config["materialize_after"],
            telemetry=self.telemetry,
        )

    def query(self, pred, agg) -> q.Query:
        found = self._queries.get((pred, agg))
        if found is None:
            if pred[0] != "days":
                raise ValueError(f"unknown predicate {pred!r}")
            last = [q.Eq(day_column(t), 1) for t in range(self.days - int(pred[1]), self.days)]
            spec = {"count": q.Count, "mask": q.Mask}[agg[0]]()
            found = self._queries[pred, agg] = q.Query(q.And(last), agg=spec)
        return found

    def submit(self, pred, agg) -> int:
        return self.sched.submit(self.query(pred, agg))

    def flush(self) -> dict:
        return {t: r.value for t, r in self.sched.flush().items()}

    @property
    def pending(self) -> int:
        return self.sched.pending

    def counters(self) -> dict:
        return dict(self.telemetry.counters)

    def spans(self) -> list:
        """The program's telemetry spans: (name, cat, tid, t0, t1)."""
        return [(n, c, tid, a, b) for n, c, tid, a, b, _ in self.telemetry.trace]

    def close(self) -> None:
        self.sched = None
        self._queries.clear()
