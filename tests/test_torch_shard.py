"""The sharded fleet on the port against the JAX reference: serving.

Each scenario mirrors a test of the reference's sharded serving
(``tests/test_query_shard.py``, the sharded halves of
``test_query_pipeline.py`` and ``test_query_telemetry.py``, the shard
merge rules of ``test_query_aggregates.py``, ``test_query_optimizer.py``'s
pipelined fleet and ``test_query_differential.py``'s striping cases) and
runs the same inputs, made from a numpy seed, through ``repro`` and
``repro_torch`` (on the CPU).  The reference's own asserts run on both
sides, and the two sides must return equal results: answers, MASK words
bit for bit, ``stats()`` counters, the telemetry registry's counters and
``projection()``.  Where the reference counts real ``jax.device_get``
calls, the port's ``.cpu()`` calls are counted.

The lockstep flush gathers every shard's rows from one fleet tensor;
the ``cuda`` case holds a small fleet on the card equal to the same
fleet on the CPU.  The differential corpora live in
``tests/test_torch_shard_mutations.py``.  The reference is imported inside a fixture, so that
case runs without JAX.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch.query as T
from repro_torch.core.engine import fused_block_reduce as t_fused_block_reduce
from repro_torch.core.store import IDENTITY_SLOT, ZERO_SLOT
from repro_torch.core.store import PackedStore as TPackedStore
from repro_torch.query.ast import and_ as t_and
from repro_torch.query.shard import stripe_rows as t_stripe_rows
from repro_torch.query.state import export_fleet_state, load_reference_fleet

# host-clock fields; everything else in stats() is a counter
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


def _port_block_reduce(words, inverse):
    return np.asarray(t_fused_block_reduce(torch.from_numpy(words.view(np.int32)), inverse))


PORT = SimpleNamespace(
    name="port",
    q=T,
    PackedStore=TPackedStore,
    stripe_rows=t_stripe_rows,
    block_reduce=_port_block_reduce,
    transfers=_CpuCounter,
    and_=t_and,
    dev_kw={"device": "cpu"},
)


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    import repro.query as R
    from repro.core.engine import fused_block_reduce
    from repro.core.store import PackedStore
    from repro.query.ast import and_
    from repro.query.shard import stripe_rows

    class DeviceGetCounter:
        def __init__(self, monkeypatch):
            self.calls = 0
            real = jax.device_get

            def counted(x):
                self.calls += 1
                return real(x)

            monkeypatch.setattr(jax, "device_get", counted)

    return SimpleNamespace(
        name="ref",
        q=R,
        PackedStore=PackedStore,
        stripe_rows=stripe_rows,
        block_reduce=lambda w, inv: np.asarray(fused_block_reduce(jnp.asarray(w), inv)),
        transfers=DeviceGetCounter,
        and_=and_,
        dev_kw={},
    )


def _both(ref, scenario, *args):
    """Run ``scenario(side, *args)`` through both packages; equal results."""
    want = scenario(ref, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def _build(S, table, shards, **kw):
    return S.q.build_sharded_flashql(table, shards, **kw, **S.dev_kw)


def _scheduler(S, table, planes=2, **kw):
    store = S.q.BitmapStore()
    store.ingest(table)
    dev = S.q.FlashDevice(num_planes=planes, **S.dev_kw)
    store.program(dev)
    return S.q.BatchScheduler(dev, store, **kw)


def _value(r):
    v = r.value
    if hasattr(v, "words"):
        return ("mask", np.asarray(v.words).view(np.uint32).tolist())
    return v


def _values(results) -> list:
    return [_value(r) for r in results]


def _counters(sq) -> tuple:
    """stats() without host clocks, and the registry's counters."""
    stats = {k: v for k, v in sq.stats().items() if k not in _TIMED}
    counters = {
        k: v
        for k, v in sq.telemetry.snapshot()["counters"].items()
        if not k.endswith("_s")
    }
    return stats, counters


def _bits(r, n):
    words = np.ascontiguousarray(np.asarray(r.value.words)).view(np.uint8)
    return np.unpackbits(words, bitorder="little")[:n].astype(bool)


def _rand_words(rng, w):
    return rng.integers(0, 2**32, (w,), dtype=np.uint32)


# -- tables of the mirrored reference tests --------------------------------------


def _shard_table(rng, n):  # tests/test_query_shard.py
    return {"country": rng.integers(0, 8, n), "device": rng.integers(0, 4, n)}


def _sales_table(rng, n):  # test_query_pipeline.py / test_query_telemetry.py
    return {
        "country": rng.integers(0, 6, n),
        "device": rng.integers(0, 4, n),
        "sales": rng.integers(0, 500, n),
    }


def _all_aggs(q):
    return (
        q.Count(),
        q.Mask(),
        q.Sum("sales"),
        q.Avg("sales"),
        q.Min("sales"),
        q.Max("sales"),
        q.TopK("device", 3),
        q.GroupBy("device", q.Sum("sales")),
    )


def _mixed_queries(S):  # test_query_pipeline.py::_mixed_queries
    q = S.q
    preds = [
        q.Eq("country", 1),
        S.and_(q.Eq("country", 2), q.Eq("device", 1)),
        q.In("device", [0, 2]),
        q.Range("sales", 13, 437),  # deep range: spills
    ]
    return [q.Query(p, agg=a) for p in preds for a in _all_aggs(q)]


def _tele_queries(S):  # test_query_telemetry.py::_queries
    q = S.q
    return [
        q.Query(q.Eq("country", 1)),
        q.Query(S.and_(q.Eq("country", 2), q.Eq("device", 1)), agg=q.Sum("sales")),
        q.Query(q.In("device", [0, 2]), agg=q.Count()),
        q.Query(q.Range("sales", 13, 437)),  # deep range: spills
    ]


# -- tests/test_query_shard.py ----------------------------------------------------


def _packed_store_epoch_bumps_on_writes_not_scratch(S):
    st = S.PackedStore()
    assert st.epoch == 0
    st["a"] = np.zeros(4, np.uint32)
    e1 = st.epoch
    assert e1 > 0
    st["a"] = np.ones(4, np.uint32)
    assert st.epoch > e1
    e2 = st.epoch
    st["__scratch0"] = np.zeros(4, np.uint32)
    st["__scratch0"] = np.ones(4, np.uint32)
    assert st.epoch == e2
    return st.epoch


def _mutating_one_shard_recompiles_only_its_region(S):
    q = S.q
    table = _shard_table(np.random.default_rng(0), 300)
    sq = _build(S, table, 3, num_planes=1)
    qs = [q.Query(q.Eq("country", 1)), q.Query(q.In("device", [0, 2]))]
    out = [_values(sq.serve(qs))]
    assert [c.misses for c in sq.compilers] == [2, 2, 2]
    out.append(_values(sq.serve(qs)))
    assert [c.hits for c in sq.compilers] == [2, 2, 2]
    page = "country=1"
    sq.devices[1].fc_write(page, sq.store.shards[1].logical[page], esp=True)
    out.append(_values(sq.serve(qs)))
    assert [c.misses for c in sq.compilers] == [2, 3, 2]
    assert [c.hits for c in sq.compilers] == [4, 3, 4]
    (r,) = sq.serve([q.Query(q.Eq("country", 1))])
    assert r.count == int((table["country"] == 1).sum())
    return out, _counters(sq)


def _scratch_spills_keep_shard_caches_warm(S):
    q = S.q
    table = {"age": np.random.default_rng(1).integers(0, 64, 400)}
    sq = _build(S, table, 2, num_planes=1)
    query = q.Query(q.Range("age", 13, 37))
    out = _values(sq.serve([query]))
    misses = [c.misses for c in sq.compilers]
    out += _values(sq.serve([query]))
    assert [c.misses for c in sq.compilers] == misses
    assert all(c.hits >= 1 for c in sq.compilers)
    return out, _counters(sq)


def _stats_count_tickets_once(S):
    q = S.q
    sq = _build(S, _shard_table(np.random.default_rng(2), 500), 3, queue_depth=4)
    res = sq.serve([q.Query(q.Eq("country", c % 8)) for c in range(10)])
    s = sq.stats()
    assert s["queries_served"] == 10 and s["flushes"] == 3
    assert s["mean_latency_s"] > 0 and s["queries_per_sec"] > 0
    assert s["mean_latency_s"] * 10 == pytest.approx(sq.total_latency_s)
    assert s["mws_commands"] >= 10 * 3
    return _values(res), _counters(sq)


def _latency_monotone_in_queue_position(S):
    q = S.q
    sq = _build(S, _shard_table(np.random.default_rng(3), 200), 2, queue_depth=2)
    tickets = [sq.submit(q.Query(q.Eq("country", c % 8))) for c in range(6)]
    results = {}
    while sq.pending:
        results.update(sq.flush())
    lats = [results[t].latency_s for t in tickets]
    assert all(v > 0 for v in lats)
    assert max(lats[4:]) >= min(lats[:2])
    return [results[t].value for t in tickets], _counters(sq)


def _plan_aware_batching_merges_shapes(S):
    q = S.q
    t = _shard_table(np.random.default_rng(4), 400)
    sq = _build(S, t, 2, num_planes=1)
    qs = [q.Query(q.In("country", [0, 1, 2])), q.Query(q.In("device", [0, 1]))]
    sq.serve(qs)
    s = sq.stats()
    assert s["distinct_signatures"] == 2
    assert s["vmap_batches"] == 1
    assert s["fused_flushes"] == 1
    r1, r2 = sq.serve(qs)
    assert r1.count == int(np.isin(t["country"], [0, 1, 2]).sum())
    assert r2.count == int(np.isin(t["device"], [0, 1]).sum())
    return _counters(sq)


def _zero_slot_is_or_neutral_under_inverse_read(S):
    rng = np.random.default_rng(5)
    cube = rng.integers(0, 2**32, (2, 3, 4), dtype=np.uint32)
    ones = np.full((1, 3, 4), 0xFFFFFFFF, dtype=np.uint32)
    zero_block = np.concatenate([np.zeros((1, 1, 4), np.uint32), ones[:, :2]], axis=1)
    padded = np.concatenate([cube, zero_block], axis=0)
    out = []
    for inverse in (False, True):
        a = S.block_reduce(cube, inverse).view(np.uint32)
        np.testing.assert_array_equal(a, S.block_reduce(padded, inverse).view(np.uint32))
        out.append(a.tolist())
    return out


def _unknown_column_rejected_at_submit(S):
    q = S.q
    t = _shard_table(np.random.default_rng(10), 100)
    sq = _build(S, t, 2)
    with pytest.raises(KeyError, match="nope"):
        sq.submit(q.Query(S.and_(q.Eq("country", 1), q.Eq("nope", 1))))
    assert sq.pending == 0
    (r,) = sq.serve([q.Query(q.Eq("country", 1))])
    assert r.count == int((t["country"] == 1).sum())
    return _counters(sq)


def _per_device_fallback_matches_fused(S):
    q = S.q
    table = _shard_table(np.random.default_rng(8), 257)
    qs = [q.Query(q.Eq("country", 2)), q.Query(q.In("device", [1, 3]), agg=q.Agg.MASK)]
    fused_sq = _build(S, table, 3)
    fused = fused_sq.serve(qs)
    sq = _build(S, table, 3)
    sq.fuse_across_shards = False
    fallback = sq.serve(qs)
    assert sq.fused_flushes == 0 and sq.stats()["vmap_batches"] >= 3
    assert _values(fallback) == _values(fused)
    return _values(fallback), _counters(sq), _counters(fused_sq)


def _non_esp_page_routes_shard_to_guarded_path(S):
    q = S.q
    rng = np.random.default_rng(9)
    t = _shard_table(rng, 200)
    sq = _build(S, t, 2)
    sq.devices[0].fc_write("telemetry", _rand_words(rng, sq.store.shards[0].words), esp=False)
    (r,) = sq.serve([q.Query(q.Eq("country", 1))])
    assert r.count == int((t["country"] == 1).sum())
    assert sq.fused_flushes == 0
    return _counters(sq)


def _stripe_rows_partitions_exactly(S):
    out = []
    for n in (0, 1, 7, 64, 97):
        for s in (1, 2, 3, 5):
            for policy in ("roundrobin", "range"):
                parts = S.stripe_rows(n, s, policy)
                assert len(parts) == s
                np.testing.assert_array_equal(np.sort(np.concatenate(parts)), np.arange(n))
                out.append([p.tolist() for p in parts])
    return out


def _sharded_store_forces_global_schema(S):
    store = S.q.ShardedBitmapStore(num_shards=2)
    store.ingest({"c": np.array([5, 0, 0, 0])})
    for st in store.shards:
        assert st.columns["c"].values == (0, 5)
        assert "c=5" in st.logical
    assert int(np.asarray(store.shards[1].logical["c=5"]).sum()) == 0
    return store.shard_values, [m.tolist() for m in store.row_maps]


def _shard_devices_share_canonical_layout(S):
    q = S.q
    sq = _build(
        S,
        _shard_table(np.random.default_rng(6), 300),
        3,
        warmup=[q.Query(q.In("country", [0, 1, 2]))],
    )
    lead = sq.devices[0].layout.placements
    for dev in sq.devices[1:]:
        assert dev.layout.placements == lead
    pl = [sq.devices[2].layout[f"country={v}"] for v in (0, 1, 2)]
    assert all(p.inverted for p in pl) and len({p.block for p in pl}) == 1
    return sorted((n, p.block, p.wordline, p.inverted) for n, p in lead.items())


def _identity_and_zero_slots_always_present(S):
    st = S.PackedStore(planes=2)
    st["p"] = np.arange(6, dtype=np.uint32)
    snap = np.asarray(st.snapshot(**({"device": "cpu"} if S is PORT else {})))
    snap = snap.view(np.uint32)
    assert snap[IDENTITY_SLOT].min() == 0xFFFFFFFF
    assert snap[ZERO_SLOT].max() == 0
    return snap.tolist()


def _fleet_projection_aggregates_devices(S):
    q = S.q
    sq = _build(S, _shard_table(np.random.default_rng(7), 600), 2)
    sq.serve([q.Query(S.and_(q.Eq("country", 1), q.Eq("device", 2)))] * 4)
    proj = sq.projection()
    assert proj["num_devices"] == 2 and len(proj["per_shard"]) == 2
    assert proj["fc_time_s"] == pytest.approx(max(p["fc_time_s"] for p in proj["per_shard"]))
    assert proj["fc_energy_j"] == pytest.approx(sum(p["fc_energy_j"] for p in proj["per_shard"]))
    assert proj["speedup_vs_osp"] > 0
    return proj, _counters(sq)


# -- the sharded halves of test_query_pipeline.py --------------------------------


def _same_predicate_different_aggregates(S):
    q = S.q
    table = _sales_table(np.random.default_rng(10), 300)
    sel = table["country"] == 1
    sq = _build(S, table, 2, num_planes=2, pipeline=True)
    (r_min,) = sq.serve([q.Query(q.Eq("country", 1), agg=q.Min("sales"))])
    (r_max,) = sq.serve([q.Query(q.Eq("country", 1), agg=q.Max("sales"))])
    assert r_min.value == int(table["sales"][sel].min())
    assert r_max.value == int(table["sales"][sel].max())
    return _counters(sq)


def _pipelined_matches_lockstep_one_transfer_per_shard(S):
    q = S.q
    table = _sales_table(np.random.default_rng(3), 1003)
    queries = _mixed_queries(S)
    lock = _build(S, table, 3, num_planes=2)
    pipe = _build(S, table, 3, num_planes=2, pipeline=True)
    a = lock.serve(queries)
    b = pipe.serve(queries)
    assert [r.query for r in b] == queries
    assert _values(a) == _values(b)
    s = pipe.stats()
    active = len(pipe.store.active)
    assert s["pipelined_flushes"] == s["flushes"]
    assert s["fused_dispatches"] == s["host_transfers"] == s["flushes"] * active
    assert lock.stats()["host_transfers"] > lock.stats()["flushes"]
    return _values(a), _counters(lock), _counters(pipe), lock.projection(), pipe.projection()


def _pipelined_non_esp_shard_falls_back(S):
    q = S.q
    rng = np.random.default_rng(4)
    table = _sales_table(rng, 200)
    sq = _build(S, table, 2, pipeline=True)
    sq.devices[0].fc_write("telemetry", _rand_words(rng, sq.store.shards[0].words), esp=False)
    (r,) = sq.serve([q.Query(q.Eq("country", 1))])
    assert r.count == int((table["country"] == 1).sum())
    return _counters(sq)


def _routed_queue_depth_drains_hot_stripe(S):
    q = S.q
    rng = np.random.default_rng(5)
    table = {"uid": rng.integers(0, 1000, 400), "sales": rng.integers(0, 50, 400)}
    hot = [
        q.Query(q.Range("uid", 0, 99), agg=a)
        for a in (q.Count(), q.Sum("sales"), q.Min("sales"), q.Max("sales"))
    ] * 2
    kw = dict(policy="range", stripe_key="uid", num_planes=2, queue_depth=2)
    sq = _build(S, table, 4, pipeline=True, **kw)
    res = sq.serve(hot)
    sel = table["uid"] <= 99
    assert res[0].value == int(sel.sum())
    assert res[1].value == int(table["sales"][sel].sum())
    assert sq.stats()["shards_pruned"] > 0
    assert sq.flushes == 1
    lock = _build(S, table, 4, **kw)
    lock.serve(hot)
    assert lock.flushes == 4
    return _values(res), _counters(sq), _counters(lock)


# -- the sharded halves of test_query_telemetry.py ------------------------------


def _sharded_stats_mirror_registry(S):
    q = S.q
    sq = _build(S, _sales_table(np.random.default_rng(1), 400), 3, queue_depth=4, pipeline=True)
    sq.serve(_tele_queries(S))
    s = sq.stats()
    c = sq.telemetry.snapshot()["counters"]
    for key in (
        "queries_served",
        "flushes",
        "pipelined_flushes",
        "fused_dispatches",
        "host_transfers",
        "shards_pruned",
        "distinct_signatures",
    ):
        assert s[key] == c.get(key, 0), key
    assert s["vmap_batches"] == c.get("signature_groups", 0)
    assert s["plan_cache_hits"] == sum(x.hits for x in sq.compilers)
    snap = sq.telemetry.snapshot()
    assert snap["plan_cache"]["misses"] == sum(x.misses for x in sq.compilers)
    assert snap["projection"]["num_devices"] == 3
    return _counters(sq), snap["plan_cache"], snap["projection"], snap["optimizer"]


def _sharded_totals_equal_per_shard_sums(S, monkeypatch):
    q = S.q
    sq = _build(S, _sales_table(np.random.default_rng(3), 600), 4, queue_depth=8, pipeline=True)
    with monkeypatch.context() as mp:
        counter = S.transfers(mp)
        res = sq.serve(_tele_queries(S))
    c = sq.telemetry.snapshot()["counters"]
    n = sq.store.num_shards
    for total, shard_key in (
        ("host_transfers", "host_transfers"),
        ("fused_dispatches", "fused_dispatches"),
        ("esp_delta_programs", "esp_programs"),
    ):
        assert c.get(total, 0) == sum(c.get(f"shard{s}.{shard_key}", 0) for s in range(n)), total
    assert c["host_transfers"] == counter.calls
    assert sq.shard_wordlines == [int(c.get(f"shard{s}.wordlines_sensed", 0)) for s in range(n)]
    assert sum(sq.shard_wordlines) > 0
    return _values(res), counter.calls, _counters(sq)


def _disabled_telemetry_changes_no_result(S):
    q = S.q
    table = _sales_table(np.random.default_rng(4), 500)
    queries = _tele_queries(S)
    on = _build(S, table, 3, queue_depth=4, pipeline=True)
    off = _build(S, table, 3, queue_depth=4, pipeline=True)
    off.telemetry.enabled = False
    res_on, res_off = on.serve(queries), off.serve(queries)
    assert _values(res_on) == _values(res_off)
    assert all(a.attribution is not None and b.attribution is None for a, b in zip(res_on, res_off))
    snap = off.telemetry.snapshot()
    assert snap["enabled"] is False
    assert snap["histograms"] == {} and snap["trace_events"] == 0 and snap["slow_queries"] == []
    assert snap["counters"]["queries_served"] == len(queries)
    assert off.stats()["host_transfers"] == on.stats()["host_transfers"]
    assert snap["projection"]["fc_time_s"] > 0
    return _values(res_on), _counters(off)


def _long_running_serving_keeps_bounded_state(S):
    q = S.q
    sq = _build(S, _sales_table(np.random.default_rng(5), 300), 2, queue_depth=2, pipeline=True)
    sq.telemetry = type(sq.telemetry)(
        trace_capacity=16, hist_capacity=8, slow_capacity=4, slow_latency_s=0.0
    )
    sq.__post_init__()
    queries = _tele_queries(S)
    for _ in range(12):
        sq.serve(queries)
    assert sq._meta == {} and sq._partials == {} and sq._cache_hits == {} and sq._attr == {}
    tele = sq.telemetry
    assert len(tele.trace) <= 16
    assert len(tele.slow_queries) <= 4
    assert all(len(h.samples) <= 8 for h in tele.hists.values())
    assert tele.hists["query_latency_s"].count == 12 * len(queries)
    return _counters(sq)


def _trace_export_parses_and_nests(S, path):
    q = S.q
    sq = _build(S, _sales_table(np.random.default_rng(7), 500), 4, queue_depth=4, pipeline=True)
    sq.serve(_tele_queries(S))
    sq.serve(_tele_queries(S))
    sq.telemetry.export_trace(str(path))
    trace = json.loads(path.read_text())
    assert S.q.validate_trace(trace) > 0
    names = {e["name"] for e in trace["traceEvents"]}
    for expected in ("flush", "compile", "dispatch", "transfer", "merge", "ticket"):
        assert expected in names, expected
    rows = {
        e["args"]["name"]
        for e in trace["traceEvents"]
        if e["ph"] == "M" and e["name"] == "thread_name"
    }
    assert {"shard 0", "shard 3", "merge", "flush", "tickets"} <= rows
    assert any(e["ph"] == "b" for e in trace["traceEvents"])
    return sorted(names), sorted(rows), _counters(sq)


def _attribution_counts_serving_shards(S):
    q = S.q
    n = 300
    table = {"k": np.arange(n), "v": np.random.default_rng(10).integers(0, 4, n)}
    sq = _build(S, table, 3, policy="range", stripe_key="k", queue_depth=8, pipeline=True)
    res = sq.serve(
        [q.Query(q.Range("k", 0, 10), agg=q.Count()), q.Query(q.In("v", [0, 1, 2, 3]), agg=q.Count())]
    )
    assert res[0].attribution["shards"] == 1
    assert res[1].attribution["shards"] == 3
    assert sq.shards_pruned == 2
    exact = ("sensings", "wordlines", "spill_steps", "agg_plane_reads", "shards")
    return [{k: r.attribution[k] for k in exact} for r in res], _counters(sq)


# -- the shard merge rules of test_query_aggregates.py ----------------------------


def _mixed_aggregates_keep_signature_groups(S):
    q = S.q
    table = _sales_table(np.random.default_rng(8), 257)
    base = _build(S, table, 3, num_planes=2)
    base.serve([q.Query(q.Eq("country", c)) for c in range(3)])
    mixed = _build(S, table, 3, num_planes=2)
    res = mixed.serve([q.Query(q.Eq("country", c), agg=a) for c in range(3) for a in _all_aggs(q)])
    assert mixed.stats()["vmap_batches"] == base.stats()["vmap_batches"]
    return _values(res), _counters(mixed)


def _bad_aggregate_rejected_at_submit(S):
    q = S.q
    table = _sales_table(np.random.default_rng(9), 100)
    sched = _scheduler(S, table)
    sq = _build(S, table, 2, num_planes=2)
    for bad in (
        q.Sum("nope"),
        q.Avg("nope"),
        q.Min("nope"),
        q.TopK("nope", 2),
        q.GroupBy("nope"),
        q.GroupBy("device", q.Sum("nope")),
    ):
        for s in (sched, sq):
            with pytest.raises(KeyError, match="nope"):
                s.submit(q.Query(q.Eq("country", 1), agg=bad))
    with pytest.raises(ValueError, match="k >= 1"):
        sched.submit(q.Query(q.Eq("country", 1), agg=q.TopK("device", 0)))
    with pytest.raises(TypeError, match="Count/Sum/Avg"):
        sq.submit(q.Query(q.Eq("country", 1), agg=q.GroupBy("device", q.Mask())))
    with pytest.raises(KeyError, match="ghost"):
        sched.submit(q.Query(q.Eq("ghost", 1)))
    assert sched.pending == 0 and sq.pending == 0
    (r,) = sq.serve([q.Query(q.Eq("country", 1), agg=q.Sum("sales"))])
    assert r.value == int(table["sales"][table["country"] == 1].sum())
    return _counters(sq)


def _empty_selection_aggregates(S):
    q = S.q
    table = _sales_table(np.random.default_rng(10), 64)
    empty = S.and_(q.Eq("country", 1), q.Not(q.Eq("country", 1)))
    aggs = (q.Count(), q.Sum("sales"), q.Avg("sales"), q.Min("sales"), q.Max("sales"),
            q.TopK("device", 2), q.GroupBy("device"))
    out = []
    for s in (_scheduler(S, table), _build(S, table, 2, num_planes=2)):
        rs = s.serve([q.Query(empty, agg=a) for a in aggs])
        assert [r.value for r in rs] == [0, 0, None, None, None, (), {}]
        out.append(_values(rs))
    return out


def _topk_tie_break_across_shards(S):
    q = S.q
    table = {"device": np.array([0, 1, 2, 3] * 8), "sales": np.arange(32)}
    want = ((0, 8), (1, 8), (2, 8))
    query = q.Query(q.In("device", [0, 1, 2, 3]), agg=q.TopK("device", 3))
    assert _scheduler(S, table).serve([query])[0].value == want
    for shards in (2, 3):
        assert _build(S, table, shards, num_planes=2).serve([query])[0].value == want
    return want


def _range_stripe_routing_prunes_shards(S):
    q = S.q
    rng = np.random.default_rng(11)
    table = {"uid": rng.integers(0, 1000, 400), "sales": rng.integers(0, 50, 400)}
    sq = _build(S, table, 4, policy="range", stripe_key="uid", num_planes=2)
    (r,) = sq.serve([q.Query(q.Range("uid", 0, 99), agg=q.Sum("sales"))])
    assert r.value == int(table["sales"][table["uid"] <= 99].sum())
    assert sq.stats()["shards_pruned"] >= 2
    before = sq.stats()["mws_commands"]
    rs = sq.serve(
        [
            q.Query(q.Eq("uid", 10**6), agg=q.Count()),
            q.Query(q.Eq("uid", 10**6), agg=q.Mask()),
            q.Query(q.Eq("uid", 10**6), agg=q.Min("sales")),
        ]
    )
    assert rs[0].value == 0 and int(np.asarray(rs[1].value.to_bits()).sum()) == 0
    assert rs[2].value is None
    assert sq.stats()["mws_commands"] == before
    return _values(rs), _counters(sq)


def _stripe_key_mask_unstripes_sorted_rows(S):
    q = S.q
    rng = np.random.default_rng(12)
    n = 130
    table = {"uid": rng.permutation(n), "sales": rng.integers(0, 9, n)}
    sq = _build(S, table, 3, policy="range", stripe_key="uid", num_planes=2)
    (r,) = sq.serve([q.Query(q.Range("uid", 10, 40), agg=q.Mask())])
    np.testing.assert_array_equal(_bits(r, n), (table["uid"] >= 10) & (table["uid"] <= 40))
    return _value(r), _counters(sq)


# -- test_query_optimizer.py: the pipelined fleet -----------------------------------


def _sharded_optimizer_exact_and_cheaper(S):
    q = S.q
    rng = np.random.default_rng(41)
    table = {
        "country": rng.integers(0, 8, 90),
        "age": rng.integers(13, 90, 90),
        "device": rng.integers(0, 4, 90),
    }
    shared = q.Range("age", 15, 70)
    queries = [q.Query(S.and_(q.Eq("country", c % 4), shared)) for c in range(8)] + [
        q.Query(S.and_(q.Eq("country", 1), shared), agg=q.Agg.MASK)
    ]
    on = _build(S, table, 2, num_planes=2, pipeline=True)
    off = _build(S, table, 2, num_planes=2, pipeline=True, optimize=False)
    got_on, got_off = on.serve(queries), off.serve(queries)
    assert _values(got_on) == _values(got_off)
    assert off.stats()["sensings_per_query"] > on.stats()["sensings_per_query"]
    assert on.stats()["cse_plan_hits"] >= 4
    return _values(got_on), _counters(on), _counters(off)


# -- test_query_differential.py: striping edge cases ------------------------------


def _rows_fewer_than_shards(S):
    q = S.q
    sq = _build(S, {"c": np.array([1, 0])}, 3, policy="range", num_planes=1)
    assert len(sq.store.active) == 2
    r_count, r_mask = sq.serve([q.Query(q.Eq("c", 1)), q.Query(q.Eq("c", 1), agg=q.Agg.MASK)])
    assert r_count.count == 1
    np.testing.assert_array_equal(_bits(r_mask, 2), [True, False])
    return _values([r_count, r_mask]), _counters(sq)


def _roundrobin_mask_unstripes_row_order(S):
    q = S.q
    n = 10
    sq = _build(S, {"c": np.arange(n) % 3}, 3, policy="roundrobin", num_planes=1)
    (r,) = sq.serve([q.Query(q.Eq("c", 0), agg=q.Agg.MASK)])
    np.testing.assert_array_equal(_bits(r, n), (np.arange(n) % 3) == 0)
    return _value(r), _counters(sq)


SCENARIOS = {
    "shard_packed_store_epoch_bumps_on_writes_not_scratch": _packed_store_epoch_bumps_on_writes_not_scratch,
    "shard_mutating_one_shard_recompiles_only_its_region": _mutating_one_shard_recompiles_only_its_region,
    "shard_scratch_spills_keep_shard_caches_warm": _scratch_spills_keep_shard_caches_warm,
    "shard_stats_count_tickets_once": _stats_count_tickets_once,
    "shard_latency_monotone_in_queue_position": _latency_monotone_in_queue_position,
    "shard_plan_aware_batching_merges_shapes": _plan_aware_batching_merges_shapes,
    "shard_zero_slot_is_or_neutral_under_inverse_read": _zero_slot_is_or_neutral_under_inverse_read,
    "shard_unknown_column_rejected_at_submit": _unknown_column_rejected_at_submit,
    "shard_per_device_fallback_matches_fused": _per_device_fallback_matches_fused,
    "shard_non_esp_page_routes_shard_to_guarded_path": _non_esp_page_routes_shard_to_guarded_path,
    "shard_stripe_rows_partitions_exactly": _stripe_rows_partitions_exactly,
    "shard_sharded_store_forces_global_schema": _sharded_store_forces_global_schema,
    "shard_devices_share_canonical_layout": _shard_devices_share_canonical_layout,
    "shard_identity_and_zero_slots_always_present": _identity_and_zero_slots_always_present,
    "shard_fleet_projection_aggregates_devices": _fleet_projection_aggregates_devices,
    "pipeline_same_predicate_different_aggregates": _same_predicate_different_aggregates,
    "pipeline_matches_lockstep_one_transfer_per_shard": _pipelined_matches_lockstep_one_transfer_per_shard,
    "pipeline_non_esp_shard_falls_back": _pipelined_non_esp_shard_falls_back,
    "pipeline_routed_queue_depth_drains_hot_stripe": _routed_queue_depth_drains_hot_stripe,
    "telemetry_sharded_stats_mirror_registry": _sharded_stats_mirror_registry,
    "telemetry_disabled_changes_no_result": _disabled_telemetry_changes_no_result,
    "telemetry_long_running_serving_keeps_bounded_state": _long_running_serving_keeps_bounded_state,
    "telemetry_attribution_counts_serving_shards": _attribution_counts_serving_shards,
    "aggregates_mixed_keep_signature_groups": _mixed_aggregates_keep_signature_groups,
    "aggregates_bad_aggregate_rejected_at_submit": _bad_aggregate_rejected_at_submit,
    "aggregates_empty_selection": _empty_selection_aggregates,
    "aggregates_topk_tie_break_across_shards": _topk_tie_break_across_shards,
    "aggregates_range_stripe_routing_prunes_shards": _range_stripe_routing_prunes_shards,
    "aggregates_stripe_key_mask_unstripes_sorted_rows": _stripe_key_mask_unstripes_sorted_rows,
    "optimizer_sharded_exact_and_cheaper": _sharded_optimizer_exact_and_cheaper,
    "differential_rows_fewer_than_shards": _rows_fewer_than_shards,
    "differential_roundrobin_mask_unstripes_row_order": _roundrobin_mask_unstripes_row_order,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(ref, name):
    _both(ref, SCENARIOS[name])


def test_per_shard_sums_and_real_transfers_match_reference(ref, monkeypatch):
    _both(ref, _sharded_totals_equal_per_shard_sums, monkeypatch)


def test_trace_export_matches_reference(ref, tmp_path):
    want = _trace_export_parses_and_nests(ref, tmp_path / "ref.json")
    assert _trace_export_parses_and_nests(PORT, tmp_path / "port.json") == want


# -- a reference fleet carried across -----------------------------------------------


def test_load_reference_fleet_serves_identically(ref):
    """A reference fleet — ingested, programmed and served once —
    exported with its devices and loaded into the port answers the next
    flushes, lockstep and pipelined, as the reference fleet does."""
    rng = np.random.default_rng(21)
    n = 211
    table = {
        "country": rng.integers(0, 6, n),
        "device": rng.integers(0, 4, n),
        "age": rng.integers(0, 90, n),
    }

    def queries(S):
        q = S.q
        return [
            q.Query(q.Eq("country", 2)),
            q.Query(S.and_(q.In("device", [0, 3]), q.Range("age", 20, 70))),
            q.Query(q.Range("age", 5, 40), agg=q.Mask()),
            q.Query(q.Not(q.Eq("device", 1)), agg=q.Sum("age")),
            q.Query(q.Eq("country", 4), agg=q.GroupBy("device", q.Avg("age"))),
        ]

    kw = dict(policy="range", stripe_key="age", num_planes=2)
    src = _build(ref, table, 3, **kw)
    src.serve(queries(ref))
    arrays, meta = export_fleet_state(src.store, src.devices)
    sstore, devices = load_reference_fleet(arrays, meta, device="cpu")
    port = T.ShardedFlashQL(sstore, devices)
    for pipeline in (False, True):
        port.pipeline = src.pipeline = pipeline
        got = _values(port.serve(queries(PORT)))
        assert got == _values(src.serve(queries(ref)))
    assert [len(m) for m in port.store.row_maps] == [len(m) for m in src.store.row_maps]


# -- the fleet on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    return torch.device("cuda")


def _fleet_stream(device) -> list:
    """A 3-shard fleet over a row count no shard count divides, served
    lockstep and pipelined, then appended to, deleted from and compacted,
    serving after every step; every value comes back as plain data."""
    rng = np.random.default_rng(31)
    n = 1001
    table = _sales_table(rng, n)
    sq = T.build_sharded_flashql(table, 3, num_planes=2, reserve_rows=256, device=device)
    queries = _mixed_queries(PORT)
    out = []
    for step in ("lockstep", "pipelined", "append", "delete", "compact"):
        if step == "append":
            sq.append(_sales_table(rng, 97))
        elif step == "delete":
            sq.delete(rng.choice(sq.store.num_rows, 150, replace=False))
        elif step == "compact":
            sq.compact()
        sq.pipeline = step == "pipelined"
        out.append((step, _values(sq.serve(queries)), _counters(sq)))
        sq.pipeline = not sq.pipeline
        out.append((step, _values(sq.serve(queries)), _counters(sq)))
    return out


@pytest.mark.cuda
def test_fleet_on_the_card_equals_the_cpu_fleet(cuda):
    assert _fleet_stream(cuda) == _fleet_stream("cpu")
