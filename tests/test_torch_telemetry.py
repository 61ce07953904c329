"""One-device serving on the port against the JAX reference: telemetry and
the one-transfer flush.

Each scenario mirrors an unsharded test of the reference
(``tests/test_query_telemetry.py`` and ``tests/test_query_pipeline.py``)
and runs the same inputs, made from a numpy seed, through ``repro`` and
``repro_torch`` (on the CPU).  The reference's own asserts run on both
sides, and the two sides must return equal answers, ``stats()``
counters, registry counters, plan-cache and runner-cache sizes, trace
event names and attribution counts.  Where the reference counts real
``jax.device_get`` calls, the port's ``.cpu()`` calls are counted: one
per fused flush.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch.query as T
from repro_torch.query.ast import and_ as t_and
from repro_torch.query.oracle import np_select

_TIMED = ("queries_per_sec", "mean_latency_s")


class _CpuCounter:
    """Counts the port's ``.cpu()`` calls (its device->host copies)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = torch.Tensor.cpu

        def counted(t, *a, **k):
            self.calls += 1
            return real(t, *a, **k)

        monkeypatch.setattr(torch.Tensor, "cpu", counted)


PORT = SimpleNamespace(
    q=T, and_=t_and, np_select=np_select, transfers=_CpuCounter, dev_kw={"device": "cpu"}
)


@pytest.fixture(scope="module")
def ref():
    import jax

    import repro.query as R
    from repro.query.ast import and_
    from repro.query.oracle import np_select as r_np_select

    class DeviceGetCounter:
        def __init__(self, monkeypatch):
            self.calls = 0
            real = jax.device_get

            def counted(x):
                self.calls += 1
                return real(x)

            monkeypatch.setattr(jax, "device_get", counted)

    return SimpleNamespace(
        q=R, and_=and_, np_select=r_np_select, transfers=DeviceGetCounter, dev_kw={}
    )


def _scheduler(S, table, planes=2, reserve=0, **kw):
    store = S.q.BitmapStore()
    store.ingest(table, reserve_rows=reserve)
    dev = S.q.FlashDevice(num_planes=planes, **S.dev_kw)
    store.program(dev)
    return S.q.BatchScheduler(dev, store, **kw)


def _table(rng, n):
    return {
        "country": rng.integers(0, 6, n),
        "device": rng.integers(0, 4, n),
        "sales": rng.integers(0, 500, n),
    }


def _queries(S):  # test_query_telemetry.py::_queries
    q = S.q
    return [
        q.Query(q.Eq("country", 1)),
        q.Query(S.and_(q.Eq("country", 2), q.Eq("device", 1)), agg=q.Sum("sales")),
        q.Query(q.In("device", [0, 2]), agg=q.Count()),
        q.Query(q.Range("sales", 13, 437)),  # deep range: spills
    ]


def _mixed_queries(S):  # test_query_pipeline.py::_mixed_queries
    q = S.q
    aggs = (
        q.Count(), q.Mask(), q.Sum("sales"), q.Avg("sales"), q.Min("sales"),
        q.Max("sales"), q.TopK("device", 3), q.GroupBy("device", q.Sum("sales")),
    )
    preds = [
        q.Eq("country", 1),
        S.and_(q.Eq("country", 2), q.Eq("device", 1)),
        q.In("device", [0, 2]),
        q.Range("sales", 13, 437),
    ]
    return [q.Query(p, agg=a) for p in preds for a in aggs]


def _value(r):
    v = r.value
    if hasattr(v, "words"):
        return ("mask", np.asarray(v.words).view(np.uint32).tolist())
    return v


def _values(results) -> list:
    return [_value(r) for r in results]


def _counters(sched) -> tuple:
    stats = {k: v for k, v in sched.stats().items() if k not in _TIMED}
    counters = {
        k: v
        for k, v in sched.telemetry.snapshot()["counters"].items()
        if not k.endswith("_s")
    }
    return stats, counters


# -- test_query_telemetry.py --------------------------------------------------------


def _stats_mirror_registry(S, monkeypatch):
    sched = _scheduler(S, _table(np.random.default_rng(0), 600), max_batch=3)
    res = sched.serve(_queries(S))
    s = sched.stats()
    c = sched.telemetry.snapshot()["counters"]
    for key in (
        "queries_served", "flushes", "vmap_batches", "fused_dispatches",
        "host_transfers", "rows_appended", "esp_delta_programs",
        "append_batches_coalesced",
    ):
        assert s[key] == c.get(key, 0), key
    assert s["queries_served"] == 4
    assert s["plan_cache_hits"] == sched.compiler.hits
    assert s["mean_latency_s"] == pytest.approx(c["total_latency_s"] / 4)
    assert s["queries_per_sec"] == pytest.approx(4 / c["serve_time_s"])
    snap = sched.telemetry.snapshot()
    assert snap["plan_cache"]["hits"] == sched.compiler.hits
    assert snap["projection"]["fc_time_s"] > 0
    return _values(res), _counters(sched), snap["plan_cache"], snap["projection"]


def _fused_flush_counters_match_real_transfers(S, monkeypatch):
    sched = _scheduler(S, _table(np.random.default_rng(2), 500))
    queries = _queries(S)
    for query in queries:
        sched.submit(query)
    with monkeypatch.context() as mp:
        counter = S.transfers(mp)
        a = sched.flush()
        assert counter.calls == 1
        assert sched.host_transfers == sched.fused_dispatches == 1
        for query in queries:
            sched.submit(query)
        b = sched.flush()
        assert counter.calls == 2
        assert sched.host_transfers == sched.fused_dispatches == 2
    assert len(sched._flush_programs) == 1
    return [_value(a[t]) for t in sorted(a)] + [_value(b[t]) for t in sorted(b)], _counters(sched)


def _disabled_telemetry_changes_no_result(S, monkeypatch):
    table = _table(np.random.default_rng(4), 500)
    on = _scheduler(S, table)
    off = _scheduler(S, table, telemetry=S.q.Telemetry(enabled=False))
    a, b = on.serve(_queries(S)), off.serve(_queries(S))
    assert _values(a) == _values(b)
    assert all(r.attribution is None for r in b)
    snap = off.telemetry.snapshot()
    assert snap["histograms"] == {} and snap["trace_events"] == 0
    return _values(a), _counters(on), _counters(off)


def _unsharded_pending_drains(S, monkeypatch):
    sched = _scheduler(S, _table(np.random.default_rng(6), 300), max_batch=2)
    for _ in range(6):
        sched.serve(_queries(S))
    assert sched._pending == [] and sched.pending == 0
    return _counters(sched)


def _batch_scheduler_trace_nests(S, monkeypatch):
    sched = _scheduler(S, _table(np.random.default_rng(8), 400), max_batch=2)
    sched.serve(_queries(S))
    trace = sched.telemetry.export_trace()
    assert S.q.validate_trace(trace) > 0
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"flush", "compile", "dispatch", "transfer", "reduce"} <= names
    return sorted(names), _counters(sched)


def _attribution_contents(S, monkeypatch):
    sched = _scheduler(S, _table(np.random.default_rng(9), 500))
    results = sched.serve(_queries(S))
    for r in results:
        a = r.attribution
        assert a["sensings"] >= 1 and a["wordlines"] >= 1
        for phase in ("queue_s", "compile_s", "device_s", "transfer_s", "reduce_s"):
            assert a[phase] >= 0.0
    assert results[3].attribution["spill_steps"] > 0
    assert results[0].attribution["spill_steps"] == 0
    assert results[1].attribution["agg_plane_reads"] > 0
    assert results[0].attribution["agg_plane_reads"] == 0
    exact = ("sensings", "wordlines", "spill_steps", "agg_plane_reads")
    return [{k: r.attribution[k] for k in exact} for r in results]


def _slow_query_log_thresholds(S, monkeypatch):
    table = _table(np.random.default_rng(11), 400)
    queries = _queries(S)
    sched = _scheduler(S, table, telemetry=S.q.Telemetry(slow_latency_s=0.0))
    sched.serve(queries)
    log = list(sched.telemetry.slow_queries)
    assert len(log) == len(queries)
    assert log[0]["predicate"] == repr(queries[0].where)
    assert log[0]["attribution"]["sensings"] >= 1 and log[0]["latency_s"] > 0
    quiet = _scheduler(S, table, telemetry=S.q.Telemetry(slow_latency_s=1e9, slow_sensings=10**9))
    quiet.serve(queries)
    assert list(quiet.telemetry.slow_queries) == []
    sensed = _scheduler(S, table, telemetry=S.q.Telemetry(slow_sensings=1))
    sensed.serve(queries)
    assert len(sensed.telemetry.slow_queries) == len(queries)
    return [(e["ticket"], e["agg"], e["attribution"]["sensings"]) for e in log]


# -- test_query_pipeline.py ------------------------------------------------------------


def _mixed_flush_is_one_transfer_one_dispatch(S, monkeypatch):
    n = 700
    table = _table(np.random.default_rng(0), n)
    sched = _scheduler(S, table)
    queries = _mixed_queries(S)
    for query in queries:
        sched.submit(query)
    with monkeypatch.context() as mp:
        counter = S.transfers(mp)
        results = sched.flush()
        assert counter.calls == 1
    assert sched.host_transfers == sched.fused_dispatches == sched.flushes == 1
    by_ticket = [results[t] for t in sorted(results)]
    for query, r in zip(queries, by_ticket):
        sel = S.np_select(query.where, table, n)
        if isinstance(query.agg, S.q.Count):
            assert r.value == int(sel.sum())
        elif isinstance(query.agg, S.q.Sum):
            assert r.value == int(table["sales"][sel].sum())
    return _values(by_ticket), _counters(sched)


def _flush_signature_programs_are_reused(S, monkeypatch):
    sched = _scheduler(S, _table(np.random.default_rng(1), 300))
    queries = _mixed_queries(S)
    sched.serve(queries)
    assert len(sched._flush_programs) == 1 and len(sched._runner_cache) == 1
    for _ in range(3):
        sched.serve(queries)
    assert len(sched._flush_programs) == 1 and len(sched._runner_cache) == 1
    assert sched.fused_dispatches == sched.flushes == sched.host_transfers == 4
    return _counters(sched)


def _same_predicate_different_aggregates(S, monkeypatch):
    q = S.q
    table = _table(np.random.default_rng(10), 300)
    sel = table["country"] == 1
    sched = _scheduler(S, table)
    out = []
    for agg, want in (
        (q.Min("sales"), int(table["sales"][sel].min())),
        (q.Max("sales"), int(table["sales"][sel].max())),
        (q.Count(), int(sel.sum())),
        (q.Sum("sales"), int(table["sales"][sel].sum())),
    ):
        (r,) = sched.serve([q.Query(q.Eq("country", 1), agg=agg)])
        assert r.value == want
        out.append(r.value)
    return out, _counters(sched)


def _spilling_plans_share_the_fused_flush(S, monkeypatch):
    q = S.q
    n = 900
    table = {"age": np.random.default_rng(6).integers(0, 64, n)}
    sched = _scheduler(S, table)
    queries = [
        q.Query(q.Range("age", 13, 37), agg=q.Count()),
        q.Query(q.Range("age", 5, 60), agg=q.Sum("age")),
        q.Query(q.Range("age", 13, 37), agg=q.Max("age")),
    ]
    sched.serve(queries)  # warm
    uploads = sched.device.store.snapshot_uploads
    for query in queries:
        sched.submit(query)
    with monkeypatch.context() as mp:
        counter = S.transfers(mp)
        results = sched.flush()
        assert counter.calls == 1
    assert sched.eager_plans == 0
    assert sched.device.store.snapshot_uploads == uploads
    vals = [results[t].value for t in sorted(results)]
    sel1 = (table["age"] >= 13) & (table["age"] <= 37)
    assert vals == [
        int(sel1.sum()),
        int(table["age"][(table["age"] >= 5) & (table["age"] <= 60)].sum()),
        int(table["age"][sel1].max()),
    ]
    return vals, _counters(sched)


def _coalesced_appends_program_one_delta_per_page(S, monkeypatch):
    q = S.q
    n = 400
    table = _table(np.random.default_rng(7), n)
    half = {c: v[: n // 2] for c, v in table.items()}
    imm = _scheduler(S, half, reserve=n)
    co = _scheduler(S, half, reserve=n, coalesce_appends=True)
    one = _scheduler(S, half, reserve=n)
    step = n // 20
    batches = [
        {c: v[n // 2 + i * step : n // 2 + (i + 1) * step] for c, v in table.items()}
        for i in range(10)
    ]
    imm_pages = sum(imm.append(b) for b in batches)
    for b in batches:
        assert co.append(b) == 0
    assert co.appends_queued == 10
    co_pages = co.apply_appends()
    one_pages = one.append({c: np.concatenate([b[c] for b in batches]) for c in batches[0]})
    assert co_pages == one_pages < imm_pages
    assert co.stats()["append_batches_coalesced"] == 10
    qs = [q.Query(q.Eq("country", 2), agg=a) for a in (q.Count(), q.Sum("sales"))]
    vals = [r.value for r in co.serve(qs)]
    assert [r.value for r in imm.serve(qs)] == vals
    return vals, (imm_pages, co_pages), _counters(co)


def _coalesced_appends_keep_refusal_and_validation(S, monkeypatch):
    q = S.q
    n = 200
    table = _table(np.random.default_rng(8), n)
    half = {c: v[: n // 2] for c, v in table.items()}
    sched = _scheduler(S, half, reserve=n // 2, coalesce_appends=True)
    batch = {c: v[n // 2 : n // 2 + 10] for c, v in table.items()}
    sched.submit(q.Query(q.Eq("country", 1)))
    with pytest.raises(RuntimeError, match="pending"):
        sched.append(batch)
    sched.flush()
    sched.append(batch)
    with pytest.raises(ValueError, match="bogus"):
        sched.append({**batch, "bogus": np.zeros(10, int)})
    with pytest.raises(ValueError, match="missing"):
        sched.append({"country": batch["country"]})
    with pytest.raises(ValueError, match="overflow"):
        sched.append({c: np.concatenate([v] * 3) for c, v in table.items()})
    assert sched.appends_queued == 1
    (r,) = sched.serve([q.Query(q.Eq("country", 1))])
    assert r.value == int((table["country"][: n // 2 + 10] == 1).sum())
    return r.value, _counters(sched)


SCENARIOS = {
    "telemetry_stats_mirror_registry": _stats_mirror_registry,
    "telemetry_fused_flush_counters_match_real_transfers": _fused_flush_counters_match_real_transfers,
    "telemetry_disabled_changes_no_result": _disabled_telemetry_changes_no_result,
    "telemetry_pending_drains": _unsharded_pending_drains,
    "telemetry_trace_nests": _batch_scheduler_trace_nests,
    "telemetry_attribution_contents": _attribution_contents,
    "telemetry_slow_query_log_thresholds": _slow_query_log_thresholds,
    "pipeline_mixed_flush_is_one_transfer_one_dispatch": _mixed_flush_is_one_transfer_one_dispatch,
    "pipeline_flush_signature_programs_are_reused": _flush_signature_programs_are_reused,
    "pipeline_same_predicate_different_aggregates": _same_predicate_different_aggregates,
    "pipeline_spilling_plans_share_the_fused_flush": _spilling_plans_share_the_fused_flush,
    "pipeline_coalesced_appends_program_one_delta_per_page": _coalesced_appends_program_one_delta_per_page,
    "pipeline_coalesced_appends_keep_refusal_and_validation": _coalesced_appends_keep_refusal_and_validation,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(ref, name, monkeypatch):
    want = SCENARIOS[name](ref, monkeypatch)
    assert SCENARIOS[name](PORT, monkeypatch) == want
