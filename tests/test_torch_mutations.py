"""The live index on the port against the JAX reference: append, delete,
update, compact.

Each scenario mirrors a single-device test of the reference
(``tests/test_query_ingest.py``, ``test_query_lifecycle.py``,
``test_query_mlc.py``, ``test_query_optimizer.py`` and the unsharded half
of ``test_query_differential.py``'s lifecycle stream) and runs the same
inputs, made from a numpy seed, through ``repro`` and ``repro_torch``
(on the CPU).  The two must give equal answers and equal counters:
``stats()`` (words programmed and written, write amplification, delta
programs, rows appended and deleted, compactions, block erases, plan-cache
hits and misses, MWS commands), P/E wear, ESP programs and every epoch.
MASK words compare bit for bit.

The port keeps its device snapshot in place across writes where the
reference re-uploads it; ``test_snapshot_tracks_host_buffer_in_place``
holds the snapshot equal to the host buffer after a random mutation
stream, with ``snapshot_uploads`` flat until ``compact()`` (one upload),
on the CPU and, in its ``cuda`` copy, on the card.  The reference is
imported inside a fixture, so the ``cuda`` test runs without JAX.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch.query as T
from repro_torch.core.bitops import to_uint32, to_words
from repro_torch.core.placement import Layout as TLayout
from repro_torch.core.planner import Planner as TPlanner
from repro_torch.core.store import PackedStore as TPackedStore
from repro_torch.query.compile import _lower as t_raw_lower
from repro_torch.query.oracle import np_select
from repro_torch.query.scheduler import plan_traffic as t_plan_traffic
from repro_torch.query.state import export_state, load_reference_state
from repro_torch.query.telemetry import PORT_GAUGES

# host-clock fields; everything else in stats() is a counter
_TIMED = ("queries_per_sec", "mean_latency_s")

PORT = SimpleNamespace(
    name="port",
    q=T,
    Layout=TLayout,
    PackedStore=TPackedStore,
    Planner=TPlanner,
    raw_lower=t_raw_lower,
    plan_traffic=t_plan_traffic,
    np_select=np_select,
    dev_kw={"device": "cpu"},
)


@pytest.fixture(scope="module")
def ref():
    import repro.query as R
    from repro.core.placement import Layout
    from repro.core.planner import Planner
    from repro.core.store import PackedStore
    from repro.query.compile import _lower
    from repro.query.oracle import np_select as r_np_select
    from repro.query.scheduler import plan_traffic

    return SimpleNamespace(
        name="ref",
        q=R,
        Layout=Layout,
        PackedStore=PackedStore,
        Planner=Planner,
        raw_lower=_lower,
        plan_traffic=plan_traffic,
        np_select=r_np_select,
        dev_kw={},
    )


def _both(ref, scenario, *args):
    """Run ``scenario(side, *args)`` through both packages; equal results."""
    want = scenario(ref, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def _deploy(S, table, *, reserve=64, planes=2, levels=1, **sched_kw):
    store = S.q.BitmapStore()
    store.ingest(table, reserve_rows=reserve)
    dev = S.q.FlashDevice(num_planes=planes, layout=S.Layout(levels=levels), **S.dev_kw)
    store.program(dev)
    return S.q.BatchScheduler(dev, store, **sched_kw)


def _state(s) -> tuple:
    """Every counter and epoch the two packages must agree on."""
    dev = s.device
    return (
        {k: v for k, v in s.stats().items() if k not in _TIMED},
        int(s.words_programmed),
        int(s.words_written),
        dict(dev.pec),
        dev.esp_programs,
        dev.block_erases,
        dev.store.epoch,
        dict(dev.store.region_epochs),
        s.store.epoch,
        dict(s.store.column_epochs),
    )


def _value(r):
    if r.mask is not None:
        return ("mask", [int(w) for w in np.asarray(r.value.words).view(np.uint32)])
    return r.value


def _serve(s, queries) -> list:
    return [_value(r) for r in s.serve(queries)]


def _mask_bits(r, n):
    words = np.ascontiguousarray(np.asarray(r.value.words)).view(np.uint8)
    return np.unpackbits(words, bitorder="little")[:n].astype(bool)


def _raises(exc, match, fn) -> str:
    with pytest.raises(exc, match=match) as info:
        fn()
    return str(info.value)


# -- tables of the mirrored reference tests --------------------------------------


def _lifecycle_table(rng, n):
    return {"c": rng.integers(0, 6, n), "v": rng.integers(0, 32, n)}


def _wide_table(rng, n):
    return {
        "country": rng.integers(0, 6, n),
        "device": rng.integers(0, 4, n),
        "age": rng.integers(0, 90, n),
    }


def _mlc_table(rng, n, cols=5, card=4):
    return {chr(ord("a") + i): rng.integers(0, card, n) for i in range(cols)}


# -- tests/test_query_ingest.py ----------------------------------------------------


def _packed_store_epochs(S):
    st = S.PackedStore()
    st["a=1"] = np.zeros(4, np.uint32)
    st["b=1"] = np.zeros(4, np.uint32)
    log = [dict(st.region_epochs), st.epoch]
    st["a=1"] = np.ones(4, np.uint32)
    log += [dict(st.region_epochs), st.epoch]
    st.append_words("b=1", np.asarray([7], np.uint32), start=3)
    log += [dict(st.region_epochs), st.epoch, int(np.asarray(st["b=1"])[3])]
    st["__scratch0"] = np.zeros(4, np.uint32)
    log.append(st.epoch)
    log.append(_raises(ValueError, "out of range", lambda: st.append_words("a=1", np.zeros(2, np.uint32), start=3)))
    return log


def _counted_append(S, n, batch):
    rng = np.random.default_rng(3)
    table = {"c": rng.integers(0, 8, n), "v": rng.integers(0, 64, n)}
    table["c"][:8] = np.arange(8)
    table["v"][:2] = [0, 63]
    sched = _deploy(S, table, reserve=128)
    before = sched.device.esp_programs
    sched.append(batch)
    return sched, sched.device.esp_programs - before


def _append_scales_with_delta(S):
    rng = np.random.default_rng(4)
    batch = {"c": rng.integers(0, 8, 16), "v": rng.integers(0, 64, 16)}
    _, p_small = _counted_append(S, 400, batch)
    large, p_large = _counted_append(S, 4000, batch)
    assert p_small == p_large > 0
    assert p_large <= 2 + (min(16, 8) + 3) + (min(16, 64) + 6)
    assert p_large < len(large.store.logical) // 2
    return p_small, p_large, _state(large)


def _zero_delta_pages(S):
    sched = _deploy(S, {"c": np.array([0, 1, 2, 3] * 10)}, reserve=128)
    before = sched.device.esp_programs
    pages = sched.append({"c": np.zeros(4, np.int64)})
    assert pages == sched.device.esp_programs - before == 3
    return pages, _state(sched)


def _projection_counts_delta(S):
    sched = _deploy(S, {"c": np.arange(40) % 5}, reserve=128)
    sched.serve([S.q.Query(S.q.Eq("c", 1))])
    sched.append({"c": np.array([1, 1, 4])})
    proj = sched.projection()
    assert proj["esp_programs"] == sched.esp_delta_programs > 0
    return proj, _state(sched)


def _append_leaves_disjoint_plans_warm(S):
    q = S.q
    rng = np.random.default_rng(5)
    sched = _deploy(S, {"a": rng.integers(0, 4, 80), "b": rng.integers(0, 4, 80)}, reserve=128)
    qa, qb = q.Query(q.Eq("a", 1)), q.Query(q.In("b", [0, 2]))
    log = [_serve(sched, [qa, qb]), sched.compiler.misses]
    sched.append({"a": np.array([1, 2]), "b": np.array([0, 3])})
    res = sched.serve([qa, qb])
    log += [[r.cache_hit for r in res], sched.compiler.misses]
    sched.append({"a": np.array([9]), "b": np.array([0])})
    res = sched.serve([qa, qb])
    log += [[r.cache_hit for r in res], sched.compiler.misses]
    assert log[-2:] == [[False, True], 3]
    log.append(_serve(sched, [q.Query(q.Eq("a", 9))]))
    return log, _state(sched)


_BAD_APPENDS = [
    ({"a": np.array([1])}, "missing"),
    ({"a": np.array([1]), "b": np.array([2]), "x": np.array([3])}, "unknown"),
    ({"a": np.array([1, 2]), "b": np.array([0])}, "ragged"),
    ({"a": np.array([1]), "b": np.array([-3])}, "negative"),
    ({"a": np.zeros(10_000, np.int64), "b": np.zeros(10_000, np.int64)}, "reserve_rows"),
]


def _bad_appends_rejected(S):
    out = []
    for bad, match in _BAD_APPENDS:
        sched = _deploy(S, {"a": np.arange(20) % 3, "b": np.arange(20) % 2}, reserve=32)
        before = _state(sched)
        out.append(_raises(ValueError, match, lambda: sched.append(bad)))
        assert _state(sched) == before and sched.store.num_rows == 20
    return out


def _refused_while_pending(S):
    q = S.q
    table = {"a": np.arange(20) % 3, "b": np.arange(20) % 2}
    sched = _deploy(S, table, reserve=32)
    sched.submit(q.Query(q.Eq("a", 1)))
    calls = (
        lambda: sched.append({"a": np.array([1]), "b": np.array([0])}),
        lambda: sched.delete([0]),
        lambda: sched.update([0], {"a": np.array([1]), "b": np.array([0])}),
        sched.compact,
    )
    out = [_raises(RuntimeError, "pending", c) for c in calls]
    sched.flush()
    out.append(sched.append({"a": np.array([1]), "b": np.array([0])}))
    out.append(_raises(ValueError, "ingested", lambda: q.BitmapStore().append({"a": np.array([1])})))
    return out, _state(sched)


def _group_by_first_seen_values(S):
    q = S.q
    sched = _deploy(S, {"g": np.array([0, 0, 1, 1, 1]), "v": np.array([3, 1, 2, 2, 4])}, reserve=32, planes=1)
    log = _serve(sched, [q.Query(q.Range("v", 0, 100), agg=q.GroupBy("g", q.Count()))])
    sched.append({"g": np.array([5, 5, 0]), "v": np.array([9, 1, 2])})
    log += _serve(
        sched,
        [
            q.Query(q.Range("v", 0, 100), agg=q.GroupBy("g", q.Count())),
            q.Query(q.Eq("g", 5), agg=q.Sum("v")),
        ],
    )
    assert log == [{0: 2, 1: 3}, {0: 3, 1: 3, 5: 2}, 10]
    return log, _state(sched)


def _bsi_width_growth(S):
    q = S.q
    sched = _deploy(S, {"v": np.array([1, 2, 3, 4, 5])}, reserve=32, planes=1)
    sched.append({"v": np.array([200, 9])})
    log = _serve(sched, [q.Query(q.Range("v", 0, 9)), q.Query(q.Range("v", 10, None))])
    assert log == [6, 1]
    return log, _state(sched)


# -- tests/test_query_lifecycle.py -------------------------------------------------


def _valid_page_one_wordline(S):
    q = S.q
    store = q.BitmapStore()
    store.ingest(_lifecycle_table(np.random.default_rng(0), 400), reserve_rows=32)
    dev = q.FlashDevice(num_planes=1, **S.dev_kw)
    store.program(dev)
    preds = [
        q.Eq("c", 2),
        q.In("c", [0, 3, 5]),
        q.Range("v", 5, 20),
        q.Not(q.Eq("c", 1)),
        q.Eq("c", 2) & q.Not(q.Range("v", 0, 10)),
    ]
    out = []
    for pred in preds:
        spliced = S.plan_traffic(S.Planner(dev.layout).compile(q.lower(pred, store)))[1]
        raw = S.plan_traffic(S.Planner(dev.layout).compile(S.raw_lower(pred, store)))[1]
        assert spliced == raw + 1
        out.append(spliced)
    return out


def _deleted_rows_never_match(S):
    q = S.q
    rng = np.random.default_rng(1)
    n = 500
    table = _lifecycle_table(rng, n)
    sched = _deploy(S, table)
    dead = rng.choice(n, 120, replace=False)
    sched.delete(dead)
    live = np.ones(n, bool)
    live[dead] = False
    log = []
    for pred in (q.Eq("c", 3), q.Range("v", 0, 31), q.Not(q.Eq("c", 0))):
        want = np_select(pred, table, n) & live if S is PORT else None
        r_count, r_mask = sched.serve([q.Query(pred, agg=q.Agg.COUNT), q.Query(pred, agg=q.Agg.MASK)])
        if want is not None:
            assert r_count.count == int(want.sum())
            np.testing.assert_array_equal(_mask_bits(r_mask, n), want)
        log += [_value(r_count), _value(r_mask)]
    return log, _state(sched)


def _delete_keeps_plans_warm(S):
    q = S.q
    sched = _deploy(S, _lifecycle_table(np.random.default_rng(2), 300))
    qs = [q.Query(q.Eq("c", 1)), q.Query(q.Range("v", 4, 9))]
    log = [_serve(sched, qs), sched.compiler.misses]
    before = sched.device.esp_programs
    pages = sched.delete(np.arange(0, 50))
    assert pages == sched.device.esp_programs - before == 1
    log += [_serve(sched, qs), sched.compiler.misses]
    assert log[1] == log[3]
    return log, _state(sched)


def _delete_validation(S):
    sched = _deploy(S, _lifecycle_table(np.random.default_rng(3), 100))
    out = [
        _raises(ValueError, "outside", lambda: sched.delete([5, 100])),
        _raises(ValueError, "duplicate", lambda: sched.delete([5, 5])),
        _raises(ValueError, "integers", lambda: sched.delete(np.array([1.5]))),
    ]
    sched.delete([5])
    out.append(_raises(ValueError, "already deleted", lambda: sched.delete([5, 6])))
    assert sched.store.deleted_rows == 1 and sched.stats()["rows_deleted"] == 1
    return out, _state(sched)


def _update_validates_both_halves(S):
    q = S.q
    n = 200
    table = _lifecycle_table(np.random.default_rng(4), n)
    sched = _deploy(S, table)
    out = [
        _raises(ValueError, "replacement", lambda: sched.update([1, 2, 3], {"c": np.array([1]), "v": np.array([2])})),
        _raises(ValueError, None, lambda: sched.update([1, n + 5], {c: v[:2] for c, v in table.items()})),
    ]
    assert sched.store.deleted_rows == 0
    sched.update([1, 2], {"c": np.array([5, 5]), "v": np.array([7, 7])})
    out += _serve(sched, [q.Query(q.Eq("c", 5) & q.Eq("v", 7))])
    want = (table["c"] == 5) & (table["v"] == 7)
    want[[1, 2]] = False
    assert out[-1] == int(want.sum()) + 2
    return out, _state(sched)


def _compact_reclaims_capacity(S):
    q = S.q
    n = 400
    table = _lifecycle_table(np.random.default_rng(5), n)
    sched = _deploy(S, table, reserve=100)
    cap = sched.store.capacity_rows
    sched.delete(np.arange(0, 150))
    stats = sched.compact()
    assert stats["rows_dropped"] == 150 and stats["blocks_erased"] > 0
    assert sched.store.capacity_rows == cap and sched.store.num_rows == n - 150
    (r,) = sched.serve([q.Query(q.Eq("c", 2), agg=q.Agg.MASK)])
    np.testing.assert_array_equal(_mask_bits(r, n - 150), table["c"][150:] == 2)
    snap = sched.telemetry.snapshot()
    s = sched.stats()
    assert s["write_amplification"] > 1.0 and snap["gauges"]["max_pec"] >= 1
    keys = ("rows_dropped", "live_rows", "capacity_rows", "blocks_erased", "words_reprogrammed")
    return (
        {k: stats[k] for k in keys},
        _value(r),
        {k: v for k, v in snap["counters"].items() if not k.endswith("_s")},
        # the port's own gauges have no counterpart in the reference
        {k: v for k, v in snap["gauges"].items() if k not in PORT_GAUGES},
        sched.projection(),
        _state(sched),
    )


def _auto_compaction(S):
    sched = _deploy(S, _lifecycle_table(np.random.default_rng(6), 200), compact_density=0.3)
    sched.delete(np.arange(0, 30))
    log = [sched.stats()["compactions"]]
    sched.delete(np.arange(30, 70))
    log += [sched.stats()["compactions"], sched.store.num_rows]
    assert log == [0, 1, 130]
    return log, _state(sched)


def _grow_on_overflow(S):
    q = S.q
    rng = np.random.default_rng(7)
    table = _lifecycle_table(rng, 100)
    sched = _deploy(S, table, reserve=4, grow_on_overflow=True)
    big = _lifecycle_table(rng, 300)
    sched.append(big)
    assert sched.stats()["compactions"] == 1
    log = _serve(sched, [q.Query(q.Eq("c", 0))])
    assert log == [int((np.concatenate([table["c"], big["c"]]) == 0).sum())]
    return log, _state(sched)


def _not_plan_before_append(S):
    q = S.q
    rng = np.random.default_rng(8)
    n = 150
    table = _lifecycle_table(rng, n)
    sched = _deploy(S, table, reserve=128)
    pred = q.Not(q.Eq("c", 2))
    (r0,) = sched.serve([q.Query(pred, agg=q.Agg.MASK)])
    np.testing.assert_array_equal(_mask_bits(r0, n + 128), np.r_[table["c"] != 2, np.zeros(128, bool)])
    batch = _lifecycle_table(rng, 40)
    sched.append(batch)
    merged = np.concatenate([table["c"], batch["c"]])
    r1, r2 = sched.serve([q.Query(pred, agg=q.Agg.MASK), q.Query(pred, agg=q.Agg.COUNT)])
    np.testing.assert_array_equal(_mask_bits(r1, n + 40), merged != 2)
    assert not _mask_bits(r1, n + 128)[n + 40 :].any()  # reserved tail rows stay zero
    assert r2.count == int((merged != 2).sum())
    return [_value(r0), _value(r1), _value(r2)], _state(sched)


def _rejected_coalesced_append(S):
    q = S.q
    rng = np.random.default_rng(9)
    table = _lifecycle_table(rng, 100)
    sched = _deploy(S, table, reserve=32, coalesce_appends=True)
    good1 = _lifecycle_table(rng, 5)
    sched.append(good1)
    out = [
        _raises(ValueError, "overflows", lambda: sched.append(_lifecycle_table(rng, 5000))),
        _raises(ValueError, None, lambda: sched.append({"c": np.array([1]), "wrong": np.array([2])})),
    ]
    good2 = _lifecycle_table(rng, 5)
    sched.append(good2)
    assert sched.appends_queued == 2
    out.append(sched.apply_appends())
    assert sched.appends_queued == 0
    merged = np.concatenate([table["c"], good1["c"], good2["c"]])
    (r,) = sched.serve([q.Query(q.Eq("c", 1), agg=q.Agg.MASK)])
    np.testing.assert_array_equal(_mask_bits(r, 110), merged == 1)
    return out, _value(r), _state(sched)


# -- tests/test_query_mlc.py and benchmarks/flashql_mlc.py --smoke -----------------


def _packing_shrinks_wordlines(S):
    table = _mlc_table(np.random.default_rng(13), 96, card=6)
    used = [_deploy(S, table, reserve=0, levels=lv).device.layout.physical_wordlines() for lv in (1, 2, 3)]
    assert used[0] > used[1] > used[2] and used[0] / used[2] >= 1.8
    return used


def _level_one_is_slc(S):
    rng = np.random.default_rng(15)
    sched = _deploy(S, _mlc_table(rng, 64), levels=1, reserve=64)
    sched.append(_mlc_table(rng, 40))
    assert sched.words_programmed == sched.words_written
    assert sched.stats()["write_amplification"] == 1.0
    return _state(sched)


def _packing_cuts_delta_traffic(S):
    q = S.q
    rng = np.random.default_rng(17)
    table = _mlc_table(rng, 64)
    batches = [_mlc_table(rng, 24) for _ in range(3)]
    queries = [
        q.Query(q.AtLeast(2, [q.Eq(c, 1) for c in "abc"]), agg=q.Count()),
        q.Query(q.AtLeast(3, [q.Eq(c, 2) for c in "abcde"]), agg=q.Count()),
    ]
    out = {}
    for levels in (1, 3):
        sched = _deploy(S, table, levels=levels, reserve=3 * 24)
        for b in batches:
            sched.append(b)
        out[levels] = (_serve(sched, queries), _state(sched))
    assert out[1][0] == out[3][0]
    assert out[3][1][1] < out[1][1][1] and out[1][1][1] / out[3][1][1] >= 1.5
    return out


def _mlc_smoke_counters(S):
    """benchmarks/flashql_mlc.py --smoke up to its append: the table of
    4,000 rows x 6 columns of 6 values ingested at SLC, MLC and TLC (2.71x
    fewer words programmed at TLC), then one 256-row append (2.80x)."""
    rng = np.random.default_rng(0)
    table = {chr(ord("a") + i): rng.integers(0, 6, 4000) for i in range(6)}
    ingest, systems = {}, {}
    for lv in (1, 2, 3):
        store = S.q.BitmapStore()
        store.ingest(table, reserve_rows=256)
        dev = S.q.FlashDevice(num_planes=4, layout=S.Layout(levels=lv), **S.dev_kw)
        ingest[lv] = store.program(dev)
        systems[lv] = S.q.BatchScheduler(dev, store)
    batch = {chr(ord("a") + i): rng.integers(0, 6, 256) for i in range(6)}
    for sched in systems.values():
        sched.append(batch)
    density = ingest[1][1] / ingest[3][1]
    delta = systems[1].words_programmed / systems[3].words_programmed
    assert (round(density, 2), round(delta, 2)) == (2.71, 2.80)
    return ingest, {lv: _state(s) for lv, s in systems.items()}


# -- tests/test_query_optimizer.py -------------------------------------------------


def _materialization_append_invalidates(S):
    q = S.q
    rng = np.random.default_rng(51)
    n = 80
    table = _wide_table(rng, n)
    sched = _deploy(S, table, reserve=40, materialize_after=2)
    hot = q.Range("age", 10, 60) & q.In("device", [0, 1])
    log = []

    def check(resident, live):
        (r,) = sched.serve([q.Query(hot, agg=q.Agg.MASK)])
        m = len(live)
        np.testing.assert_array_equal(_mask_bits(r, m), S.np_select(hot, resident, m) & live)
        log.append(_value(r))

    live = np.ones(n, bool)
    for _ in range(4):
        check(table, live)
    comp = sched.compiler
    log.append((comp.mat_builds, comp.mat_hits, comp.mat_invalidations))
    assert log[-1][0] == 1 and log[-1][2] == 0
    sched.delete(np.asarray([3, 17, 44]))  # deletes must NOT invalidate
    live[[3, 17, 44]] = False
    check(table, live)
    log.append((comp.mat_builds, comp.mat_invalidations))
    assert log[-1] == (1, 0)
    batch = _wide_table(rng, 9)  # appends MUST
    sched.append(batch)
    table = {c: np.concatenate([v, batch[c]]) for c, v in table.items()}
    live = np.concatenate([live, np.ones(9, bool)])
    for _ in range(4):
        check(table, live)
    log.append((comp.mat_builds, comp.mat_hits, comp.mat_invalidations))
    assert log[-1][0] == 2 and log[-1][2] == 1
    return log, _state(sched)


def _materialization_stable_page(S):
    q = S.q
    rng = np.random.default_rng(52)
    sched = _deploy(S, _wide_table(rng, 60), reserve=30, materialize_after=1)
    hot = q.Range("age", 0, 45) & q.Eq("country", 1)
    sched.serve([q.Query(hot)] * 2)
    sched.serve([q.Query(hot)] * 2)
    (name0,) = sched.compiler._mat_names.values()
    sched.append(_wide_table(rng, 5))
    sched.serve([q.Query(hot)] * 2)
    sched.serve([q.Query(hot)] * 2)
    (name1,) = sched.compiler._mat_names.values()
    assert sched.compiler.mat_builds == 2 and name0 == name1
    return name1, _state(sched)


SCENARIOS = {
    "ingest_packed_store_epochs": _packed_store_epochs,
    "ingest_append_scales_with_delta": _append_scales_with_delta,
    "ingest_zero_delta_pages": _zero_delta_pages,
    "ingest_projection_counts_delta": _projection_counts_delta,
    "ingest_disjoint_plans_warm": _append_leaves_disjoint_plans_warm,
    "ingest_bad_appends_rejected": _bad_appends_rejected,
    "ingest_refused_while_pending": _refused_while_pending,
    "ingest_group_by_first_seen_values": _group_by_first_seen_values,
    "ingest_bsi_width_growth": _bsi_width_growth,
    "lifecycle_valid_page_one_wordline": _valid_page_one_wordline,
    "lifecycle_deleted_rows_never_match": _deleted_rows_never_match,
    "lifecycle_delete_keeps_plans_warm": _delete_keeps_plans_warm,
    "lifecycle_delete_validation": _delete_validation,
    "lifecycle_update_validates_both_halves": _update_validates_both_halves,
    "lifecycle_compact_reclaims_capacity": _compact_reclaims_capacity,
    "lifecycle_auto_compaction": _auto_compaction,
    "lifecycle_grow_on_overflow": _grow_on_overflow,
    "lifecycle_not_plan_before_append": _not_plan_before_append,
    "lifecycle_rejected_coalesced_append": _rejected_coalesced_append,
    "mlc_packing_shrinks_wordlines": _packing_shrinks_wordlines,
    "mlc_level_one_is_slc": _level_one_is_slc,
    "mlc_packing_cuts_delta_traffic": _packing_cuts_delta_traffic,
    "mlc_smoke_counters_2_71x": _mlc_smoke_counters,
    "optimizer_append_invalidates_materialized": _materialization_append_invalidates,
    "optimizer_materialized_page_is_stable": _materialization_stable_page,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(ref, name):
    _both(ref, SCENARIOS[name])


# -- the lifecycle stream of tests/test_query_differential.py, unsharded ------------

# two of the reference's LIFECYCLE_CORPUS streams (130 rows straddle a
# word boundary, 31 fit in one word); the reference's jit compiles make
# each stream cost seconds, so the other two stay in its own suite
LIFECYCLE_CORPUS = [(33, 130), (34, 31)]


def _random_pred(q, rng, depth=0):
    kind = rng.integers(0, 6 if depth < 2 else 4)
    if kind == 0:
        return q.Eq("country", int(rng.integers(0, 7)))  # 6 may be absent
    if kind == 1:
        return q.In("device", [int(v) for v in rng.choice(5, rng.integers(1, 4))])
    if kind == 2:
        lo = int(rng.integers(0, 70))
        return q.Range("age", lo, lo + int(rng.integers(0, 40)))
    if kind == 3:
        return q.Not(_random_pred(q, rng, depth + 1))
    kids = [_random_pred(q, rng, depth + 1) for _ in range(rng.integers(2, 4))]
    return q.ast.and_(*kids) if kind == 4 else q.ast.or_(*kids)


def _random_agg(q, rng):
    col = ("country", "device", "age")[int(rng.integers(0, 3))]
    kind = int(rng.integers(0, 6))
    if kind < 4:
        return (q.Sum, q.Avg, q.Min, q.Max)[kind](col)
    if kind == 4:
        return q.TopK(col, int(rng.integers(1, 5)))
    key = ("country", "device")[int(rng.integers(0, 2))]
    inner = (q.Count(), q.Sum("age"), q.Avg("age"))[int(rng.integers(0, 3))]
    return q.GroupBy(key, inner)


def _lifecycle_stream(S, seed, n, optimize):
    """Five rounds (append, delete, update, compact, delete), each
    followed by a flush of COUNTs, MASKs and one random aggregate; returns
    every round's answers and counters.  On the port, COUNT and MASK are
    also held against numpy on the live rows."""
    q = S.q
    rng = np.random.default_rng(seed)
    resident = _wide_table(rng, n)
    live = np.ones(n, bool)
    sched = _deploy(S, dict(resident), reserve=n, optimize=optimize)
    warm = [_random_pred(q, rng) for _ in range(2)]
    rounds = []
    for kind in ("append", "delete", "update", "compact", "delete"):
        if kind == "append":
            batch = _wide_table(rng, int(rng.integers(3, 10)))
            sched.append(batch)
            resident = {c: np.concatenate([v, batch[c]]) for c, v in resident.items()}
            live = np.concatenate([live, np.ones(len(batch["age"]), bool)])
        elif kind == "delete":
            pool = np.flatnonzero(live)
            ids = rng.choice(pool, min(len(pool) // 3, 25), replace=False)
            sched.delete(ids)
            live[ids] = False
        elif kind == "update":
            pool = np.flatnonzero(live)
            ids = rng.choice(pool, min(len(pool), 6), replace=False)
            rows = _wide_table(rng, len(ids))
            sched.update(ids, rows)
            live[ids] = False
            resident = {c: np.concatenate([v, rows[c]]) for c, v in resident.items()}
            live = np.concatenate([live, np.ones(len(ids), bool)])
        else:
            sched.compact()
            resident = {c: v[live] for c, v in resident.items()}
            live = np.ones(int(live.sum()), bool)
        preds = [_random_pred(q, rng) for _ in range(2)] + warm
        queries = (
            [q.Query(p) for p in preds[:2]]
            + [q.Query(p, agg=q.Agg.MASK) for p in preds]
            + [q.Query(preds[0], agg=_random_agg(q, rng))]
        )
        results = sched.serve(queries)
        if S is PORT:
            m = len(live)
            for qq, r in zip(queries, results):
                want = np_select(qq.where, resident, m) & live
                if r.count is not None:
                    assert r.count == int(want.sum()), (kind, qq)
                elif r.mask is not None:
                    np.testing.assert_array_equal(_mask_bits(r, m), want, err_msg=f"{kind} {qq}")
        rounds.append(([_value(r) for r in results], _state(sched)))
    return rounds


@pytest.mark.parametrize("optimize", [True, False], ids=["opt", "noopt"])
@pytest.mark.parametrize("seed,n", LIFECYCLE_CORPUS)
def test_lifecycle_stream_matches_reference(ref, seed, n, optimize):
    rounds = _both(ref, _lifecycle_stream, seed, n, optimize)
    assert len(rounds) == 5


# -- state carried across: a tombstoned reference store --------------------------------


@pytest.fixture(scope="module")
def tombstoned_ref(ref):
    """A reference deployment after an append, a delete and an update,
    its export, and the batch both sides append next."""
    rng = np.random.default_rng(21)
    sched = _deploy(ref, _wide_table(rng, 300), reserve=120)
    sched.append(_wide_table(rng, 20))
    sched.delete(rng.choice(320, 60, replace=False))
    live = np.flatnonzero(sched.store.live_bits())
    sched.update(live[:5], _wide_table(rng, 5))
    return sched, export_state(sched.store, sched.device), _wide_table(rng, 30)


def test_load_reference_state_of_a_tombstoned_store(ref, tombstoned_ref):
    """A tombstoned reference store, exported and loaded into the port,
    round-trips field for field; then the port and the reference (each
    under a fresh scheduler) serve, append, delete and compact from that
    state with equal answers and counters."""
    ref_sched, (arrays, meta), batch = tombstoned_ref
    assert meta["bitmap"]["deleted_rows"] == 65
    store, dev = load_reference_state(arrays, meta, device="cpu")
    got_arrays, got_meta = export_state(store, dev)
    assert got_meta == meta
    for k in arrays:
        np.testing.assert_array_equal(got_arrays[k], arrays[k])
    out = {}
    for S, (st, dv) in ((ref, (ref_sched.store, ref_sched.device)), (PORT, (store, dev))):
        q = S.q
        sched = q.BatchScheduler(dv, st)
        queries = [
            q.Query(q.Eq("country", 2)),
            q.Query(q.Not(q.In("device", [0, 3])), agg=q.Agg.MASK),
            q.Query(q.Range("age", 10, 50), agg=q.Sum("age")),
        ]
        log = [_serve(sched, queries)]
        sched.append(batch)
        sched.delete(np.flatnonzero(st.live_bits())[:20])
        log.append(_serve(sched, queries))
        log.append(sched.compact()["rows_dropped"])
        log.append(_serve(sched, queries))
        out[S.name] = (log, _state(sched))
    assert out["port"] == out["ref"]


# -- the device snapshot, kept in place ---------------------------------------------


def _snapshot_stream(device):
    """A random mutation stream with flushes between its steps: appends
    that add slots (first-seen values, grown BSI widths) past the host
    buffer's first capacities, deletes, updates, then ``compact()``.
    After every step the device snapshot equals the host buffer bit for
    bit; ``snapshot_uploads`` stays at 1 until ``compact()``, which adds
    exactly one."""
    q = T
    rng = np.random.default_rng(41)
    n = 1000
    table = {"c": rng.integers(0, 4, n), "v": rng.integers(0, 8, n)}
    store = q.BitmapStore()
    store.ingest(table, reserve_rows=4000)
    dev = q.FlashDevice(num_planes=2, device=device)
    store.program(dev)
    sched = q.BatchScheduler(dev, store)
    probe = [q.Query(q.Eq("c", 1)), q.Query(q.Range("v", 2, 5), agg=q.Sum("v"))]

    def check(uploads):
        sched.serve(probe)
        ps = dev.store
        snap = ps.snapshot(dev.device)
        assert snap.shape == (ps.num_slots, ps._buf.shape[1])
        assert torch.equal(snap.cpu(), to_words(ps._buf[: ps.num_slots]))
        assert ps.snapshot_uploads == uploads
        assert snap.data_ptr() != to_words(ps._buf).data_ptr()  # a copy, never a view

    check(1)
    slots0 = dev.store.num_slots
    for step in range(12):
        kind = step % 4
        live = np.flatnonzero(store.live_bits())
        if kind == 0:  # new values and a wider BSI: new slots
            b = int(rng.integers(50, 200))
            top = 4 + 3 * step
            sched.append({"c": rng.integers(0, top, b), "v": rng.integers(0, 1 << (3 + step), b)})
        elif kind == 1:
            b = int(rng.integers(1, 60))
            sched.append({"c": rng.integers(0, 4, b), "v": rng.integers(0, 8, b)})
        elif kind == 2:
            sched.delete(rng.choice(live, 40, replace=False))
        else:
            ids = rng.choice(live, 7, replace=False)
            sched.update(ids, {"c": rng.integers(0, 4, 7), "v": rng.integers(0, 8, 7)})
        check(1)
    assert dev.store.num_slots > max(32, slots0)  # the host and device buffers grew
    sched.compact()
    check(2)
    sched.append({"c": np.array([1, 99]), "v": np.array([3, 1000])})
    check(2)
    return to_uint32(dev.store.snapshot(dev.device))


def test_snapshot_tracks_host_buffer_in_place():
    words = _snapshot_stream("cpu")
    assert words.shape[0] > 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_snapshot_tracks_host_buffer_in_place_on_the_card(cuda):
    on_card = _snapshot_stream(cuda)
    np.testing.assert_array_equal(on_card, _snapshot_stream("cpu"))
