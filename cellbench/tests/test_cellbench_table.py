"""A configuration whose data is a table and whose queries carry their own
aggregates joins the harness as new entries and modules only: its data
maker, generator, adapter, reference and reckoner are registered here
under the names its configuration and mix give, and nothing under
``cellbench/`` is edited.  FlashQL serves the table through
``BitmapStore.ingest`` and ``BatchScheduler`` on the CPU; planted faults
in what it answers must come out not correct."""

import dataclasses
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from _setup import ROOT

from cellbench import harness
from cellbench.harness import load_benchmark, run_cell
from cellbench.traffic.generator import freeze, rng_for

CELL = "table.mix"
CONFIG = {
    "name": "table-t",
    "system": "table_t",
    "reference": "table_t",
    "data": "table_t",
    "work": "table_t",
    "rows": 3000,
    # column: number of values; "revenue" is the measure
    "columns": {"region": 5, "brand": 40, "revenue": 200},
    "planes": 4,
}
MIX = {
    "loop": "closed",
    "generator": "table_t",
    "queries": [
        [["eq", "region", 2], ["count"]],
        [["and", ["eq", "region", 1], ["in", "brand", [3, 4, 5, 17]]], ["sum", "revenue"]],
        [["in", "brand", [0, 1, 2, 7]], ["groupby", "region", ["count"]]],
        [["eq", "region", 3], ["groupby", "brand", ["sum", "revenue"]]],
        [["and", ["eq", "region", 0], ["in", "brand", [9, 10]]], ["avg", "revenue"]],
        [["eq", "brand", 11], ["mask"]],
    ],
    "warmup_flushes": 2,
}


def make_table(config, seed, device):
    rng = rng_for(seed, 7)
    table = {c: rng.integers(0, n, config["rows"]) for c, n in config["columns"].items()}
    return table, config["rows"]


class Traffic:
    """Every flush asks each of the mix's queries once, in the seed's order."""

    def __init__(self, mix, seed):
        self.mix, self.seed = mix, seed
        order = rng_for(seed, 0).permutation(len(mix["queries"]))
        self._queries = [freeze(mix["queries"][i]) for i in order]

    def queries(self):
        return list(self._queries)


def to_pred(spec):
    from repro_torch import query as q

    if spec[0] == "eq":
        return q.Eq(spec[1], spec[2])
    if spec[0] == "in":
        return q.In(spec[1], spec[2])
    if spec[0] == "and":
        return q.And([to_pred(s) for s in spec[1:]])
    raise ValueError(f"unknown predicate {spec!r}")


def to_agg(spec):
    from repro_torch import query as q

    if spec[0] == "groupby":
        return q.GroupBy(spec[1], to_agg(spec[2]))
    if spec[0] in ("count", "mask"):
        return {"count": q.Count, "mask": q.Mask}[spec[0]]()
    return {"sum": q.Sum, "avg": q.Avg}[spec[0]](spec[1])


class TableSystem:
    def __init__(self, config, table, traffic, device, telemetry_enabled):
        from repro_torch import query as q

        self.telemetry = q.Telemetry(enabled=telemetry_enabled)
        store = q.BitmapStore()
        store.ingest(table)
        dev = q.FlashDevice(num_planes=config["planes"], device=device)
        store.program(dev)
        self.sched = q.BatchScheduler(dev, store, telemetry=self.telemetry)
        self._queries = {}

    def submit(self, pred, agg):
        from repro_torch import query as q

        if (pred, agg) not in self._queries:
            self._queries[pred, agg] = q.Query(to_pred(pred), agg=to_agg(agg))
        return self.sched.submit(self._queries[pred, agg])

    def flush(self):
        return {t: r.value for t, r in self.sched.flush().items()}

    @property
    def pending(self):
        return self.sched.pending

    def counters(self):
        return dict(self.telemetry.counters)

    def spans(self):
        return []

    def close(self):
        self.sched = None


class TableReference:
    """Plain numpy over the table, made again from the seed."""

    def __init__(self, config, seed, traffic, device="cpu"):
        self.table, self.rows = make_table(config, seed, device)

    def select(self, pred):
        t = self.table
        if pred[0] == "eq":
            return t[pred[1]] == pred[2]
        if pred[0] == "in":
            return np.isin(t[pred[1]], pred[2])
        return np.logical_and.reduce([self.select(p) for p in pred[1:]])

    def aggregate(self, sel, agg):
        if agg[0] == "count":
            return int(sel.sum())
        if agg[0] == "sum":
            return int(self.table[agg[1]][sel].sum())
        if agg[0] == "avg":
            n = int(sel.sum())
            return int(self.table[agg[1]][sel].sum()) / n if n else None
        key = self.table[agg[1]]
        return {int(v): self.aggregate(sel & (key == v), agg[2]) for v in np.unique(key[sel])}

    def answer(self, pred, agg):
        return self.aggregate(self.select(pred), agg)

    def mask_words(self, pred):
        span = np.zeros(-(-self.rows // 32) * 32, bool)
        span[: self.rows] = self.select(pred)
        return np.packbits(span, bitorder="little").view(np.uint32)

    def close(self):
        pass


reckoned: list = []  # each call of the reckoner: (rows, members)


def reckon(config, rows, members):
    reckoned.append((rows, list(members)))
    return {"sense_bytes": 1, "reduce_bytes": 1, "payload_bytes": 1, "ops": 1}


@pytest.fixture
def table_cell(monkeypatch):
    bench = load_benchmark(ROOT)
    bench["configs"].append({"name": "table-t", "file": "cellbench/configs/table-t.json", "reduced": []})
    bench["workloads"].append({"name": CELL, "config": "table-t", "traffic": "table-mix", "chips": 1})
    load_json, load_mix = harness.load_json, harness.load_mix
    monkeypatch.setattr(harness, "load_benchmark", lambda root=ROOT: bench)
    monkeypatch.setattr(harness, "load_json", lambda p: dict(CONFIG) if Path(p).name == "table-t.json" else load_json(p))
    monkeypatch.setattr(harness, "load_mix", lambda name: MIX if name == "table-mix" else load_mix(name))
    plugins = {
        "data": SimpleNamespace(make=make_table),
        "generators": SimpleNamespace(make=lambda mix, seed, config: Traffic(mix, seed)),
        "systems": SimpleNamespace(System=TableSystem),
        "reference": SimpleNamespace(Reference=TableReference),
        "work": SimpleNamespace(reckon=reckon),
    }
    for kind, mod in plugins.items():
        monkeypatch.setitem(sys.modules, f"cellbench.{kind}.table_t", mod)
    reckoned.clear()


def run(**kw):
    return run_cell(CELL, 2**31 + 11, 0.5, kw.pop("trace", False), device="cpu", **kw)


def test_the_table_cell_is_correct(table_cell):
    r = run()
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["attempted"] % len(MIX["queries"]) == 0 and r["failed"] == 0
    assert set(r["checks"]) == {"wrong_answers", "wrong_mask_words", "unanswered"}


def test_the_reference_answers_each_aggregate():
    ref = TableReference(CONFIG, 3, None)
    region, revenue = ref.table["region"], ref.table["revenue"]
    sel = region == 3
    by_brand = ref.answer(("eq", "region", 3), ("groupby", "brand", ("sum", "revenue")))
    assert sum(by_brand.values()) == ref.answer(("eq", "region", 3), ("sum", "revenue")) == int(revenue[sel].sum())
    assert sum(ref.answer(("eq", "brand", 5), ("groupby", "region", ("count",))).values()) == int(
        (ref.table["brand"] == 5).sum()
    )
    assert ref.answer(("eq", "region", 9), ("avg", "revenue")) is None


def test_the_reckoner_it_names_gets_each_query_with_its_own_aggregate(table_cell):
    r = run(trace=True)
    assert r["correct"] and reckoned
    rows, members = reckoned[0]
    assert rows == CONFIG["rows"]
    assert sorted(members) == sorted(freeze(q) for q in MIX["queries"])


def test_no_reckoner_reckons_nothing(table_cell, monkeypatch):
    monkeypatch.setitem(CONFIG, "work", None)
    assert harness.plugins(CONFIG, MIX).work is None
    assert run(trace=True)["correct"] and not reckoned


def flush_altered(monkeypatch, change):
    from repro_torch.query import BatchScheduler

    flush = BatchScheduler.flush

    def altered(self):
        out = flush(self)
        for r in out.values():
            change(r)
        return out

    monkeypatch.setattr(BatchScheduler, "flush", altered)


def sum_off_by_one(r):
    from repro_torch import query as q

    if isinstance(r.query.agg, q.Sum):
        object.__setattr__(r, "value", r.value + 1)


def group_left_out(r):
    from repro_torch import query as q

    if isinstance(r.query.agg, q.GroupBy) and r.value:
        value = dict(r.value)
        value.pop(next(iter(value)))
        object.__setattr__(r, "value", value)


def another_querys_aggregate(monkeypatch):
    from repro_torch import query as q
    from repro_torch.query import BatchScheduler

    submit = BatchScheduler.submit

    def counted(self, query):
        if isinstance(query.agg, q.Sum):
            query = dataclasses.replace(query, agg=q.Count())
        return submit(self, query)

    monkeypatch.setattr(BatchScheduler, "submit", counted)


@pytest.mark.parametrize(
    "plant",
    [
        lambda mp: flush_altered(mp, sum_off_by_one),
        lambda mp: flush_altered(mp, group_left_out),
        another_querys_aggregate,
    ],
    ids=["sum_off_by_one", "group_left_out", "another_querys_aggregate"],
)
def test_a_planted_fault_is_caught(table_cell, monkeypatch, plant):
    plant(monkeypatch)
    r = run()
    assert not r["correct"] and r["checks"]["wrong_answers"]["value"] > 0
