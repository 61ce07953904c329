"""The sharded fleet on the port against the JAX reference: the live
index (append, delete, update, compact), the differential harness, and
the fleet tensor.

Each scenario mirrors a sharded test of the reference
(``tests/test_query_ingest.py``, ``test_query_lifecycle.py`` and
``test_query_pipeline.py``'s coalesced appends) and runs the same
inputs, made from a numpy seed, through ``repro`` and ``repro_torch`` (on
the CPU); answers, MASK words, ``stats()``, the telemetry registry's
counters, row maps and ``projection()`` must be equal.  From
``test_query_differential.py``: three corpus entries serve random
predicates and aggregates on every sharded system of the port against
numpy, one of them through both packages as well, and mutation streams
(appends, deletes, updates, compactions, k-of-N predicates) run on the
port's fleets against numpy.

The fleet tensor is the port's own: every shard's snapshot is a slab of
one device tensor, writes land in it in place (``snapshot_uploads`` flat,
no rebuild), a slot past its capacity rebuilds it once, and ``compact()``
uploads only the rebuilt stripes.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch.query as T
from repro_torch.core.bitops import to_uint32
from repro_torch.query.ast import and_ as t_and
from repro_torch.query.ast import or_ as t_or
from repro_torch.query.oracle import np_select

_TIMED = ("queries_per_sec", "mean_latency_s")

PORT = SimpleNamespace(
    name="port", q=T, and_=t_and, or_=t_or, np_select=np_select, dev_kw={"device": "cpu"}
)


@pytest.fixture(scope="module")
def ref():
    import repro.query as R
    from repro.query.ast import and_, or_
    from repro.query.oracle import np_select as r_np_select

    return SimpleNamespace(
        name="ref", q=R, and_=and_, or_=or_, np_select=r_np_select, dev_kw={}
    )


def _both(ref, scenario, *args):
    want = scenario(ref, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def _build(S, table, shards, **kw):
    return S.q.build_sharded_flashql(table, shards, **kw, **S.dev_kw)


def _value(r):
    v = r.value
    if hasattr(v, "words"):
        return ("mask", np.asarray(v.words).view(np.uint32).tolist())
    return v


def _values(results) -> list:
    return [_value(r) for r in results]


def _state(sq) -> tuple:
    """Every counter and piece of striping state the packages share."""
    stats = {k: v for k, v in sq.stats().items() if k not in _TIMED}
    counters = {
        k: v for k, v in sq.telemetry.snapshot()["counters"].items() if not k.endswith("_s")
    }
    store = sq.store
    return (
        stats,
        counters,
        [m.tolist() for m in store.row_maps],
        store.num_rows,
        store.schema,
        store.shard_values,
        store.stripe_bounds,
        [(st.num_rows, st.epoch, st.deleted_rows) for st in store.shards],
        [(dict(d.pec), d.esp_programs, d.block_erases, d.store.epoch) for d in sq.devices],
    )


def _bits(r, n):
    words = np.ascontiguousarray(np.asarray(r.value.words)).view(np.uint8)
    return np.unpackbits(words, bitorder="little")[:n].astype(bool)


def _raises(exc, match, fn) -> str:
    with pytest.raises(exc, match=match) as info:
        fn()
    return str(info.value)


def _sales_table(rng, n):
    return {
        "country": rng.integers(0, 6, n),
        "device": rng.integers(0, 4, n),
        "sales": rng.integers(0, 500, n),
    }


def _lifecycle_table(rng, n):  # test_query_lifecycle.py::_table
    return {"c": rng.integers(0, 5, n), "v": rng.integers(0, 40, n)}


# -- test_query_ingest.py ---------------------------------------------------------


def _stable_append_keeps_every_shard_warm(S):
    q = S.q
    rng = np.random.default_rng(6)
    table = {"a": rng.integers(0, 4, 90), "b": rng.integers(0, 4, 90)}
    sq = _build(S, table, 3, num_planes=2, reserve_rows=96)
    qs = [q.Query(q.Eq("a", 1)), q.Query(q.In("b", [0, 2]))]
    out = _values(sq.serve(qs))
    misses = [c.misses for c in sq.compilers]
    sq.append({"a": np.array([1, 0, 2]), "b": np.array([3, 3, 1])})
    out += _values(sq.serve(qs))
    assert [c.misses for c in sq.compilers] == misses
    assert all(c.hits >= 2 for c in sq.compilers)
    return out, _state(sq)


BAD_APPENDS = [
    ({"a": np.array([1])}, "missing"),
    ({"a": np.array([1]), "b": np.array([2]), "x": np.array([3])}, "unknown"),
    ({"a": np.array([1, 2]), "b": np.array([0])}, "ragged"),
    ({"a": np.array([1]), "b": np.array([-3])}, "negative"),
    ({"a": np.zeros(10_000, np.int64), "b": np.zeros(10_000, np.int64)}, "reserve_rows"),
]


def _rejects_bad_append_before_any_shard_mutates(S, case):
    bad, match = BAD_APPENDS[case]
    table = {"a": np.arange(21) % 3, "b": np.arange(21) % 2}
    sq = _build(S, table, 3, num_planes=1, reserve_rows=16)
    before = _state(sq)
    msg = _raises(ValueError, match, lambda: sq.append(bad))
    assert _state(sq) == before
    return msg, before


def _append_rejected_while_tickets_in_flight(S):
    q = S.q
    sq = _build(S, {"a": np.arange(20) % 3}, 2, num_planes=1, reserve_rows=16)
    sq.submit(q.Query(q.Eq("a", 1)))
    msg = _raises(RuntimeError, "in flight", lambda: sq.append({"a": np.array([1])}))
    sq.flush()
    sq.append({"a": np.array([1])})
    return msg, _state(sq)


def _roundrobin_append_continues_stripe_sequence(S):
    q = S.q
    n0, b, s = 10, 5, 3
    sq = _build(S, {"c": np.arange(n0) % 4}, s, policy="roundrobin", num_planes=1, reserve_rows=32)
    sq.append({"c": (np.arange(n0, n0 + b)) % 4})
    for shard in range(s):
        np.testing.assert_array_equal(sq.store.row_maps[shard], np.arange(shard, n0 + b, s))
    (r,) = sq.serve([q.Query(q.Eq("c", 0), agg=q.Agg.MASK)])
    np.testing.assert_array_equal(_bits(r, n0 + b), (np.arange(n0 + b) % 4) == 0)
    return _value(r), _state(sq)


def _stripe_key_append_routes_to_owning_stripe(S):
    q = S.q
    table = {"k": np.arange(60), "v": np.arange(60) % 3}
    sq = _build(S, table, 3, policy="range", stripe_key="k", num_planes=1, reserve_rows=32)
    sizes = [len(m) for m in sq.store.row_maps]
    sq.append({"k": np.array([5, 25, 999]), "v": np.array([0, 0, 0])})
    assert [len(m) for m in sq.store.row_maps] == [x + 1 for x in sizes]
    assert sq.store.stripe_bounds[2][1] == 999
    pruned = sq.shards_pruned
    (r,) = sq.serve([q.Query(q.Eq("k", 999))])
    assert r.count == 1 and sq.shards_pruned == pruned + 2
    (r2,) = sq.serve([q.Query(q.Eq("k", 77))])  # a value no stripe holds
    return r2.count, _state(sq)


def _plain_range_append_extends_tail_stripe(S):
    q = S.q
    table = {"c": np.arange(12) % 4}
    sq = _build(S, table, 3, policy="range", num_planes=1, reserve_rows=16)
    sizes = [len(m) for m in sq.store.row_maps]
    sq.append({"c": np.array([1, 2])})
    assert [len(m) for m in sq.store.row_maps] == [sizes[0], sizes[1], sizes[2] + 2]
    (r,) = sq.serve([q.Query(q.Eq("c", 1))])
    assert r.count == int((np.r_[table["c"], [1, 2]] == 1).sum())
    return _state(sq)


def _projection_charges_program_only_stripes(S):
    q = S.q
    table = {"k": np.arange(30), "v": np.arange(30) % 2}
    sq = _build(S, table, 3, policy="range", stripe_key="k", num_planes=1, reserve_rows=16)
    sq.append({"k": np.array([999, 1000]), "v": np.array([1, 1])})
    sq.serve([q.Query(q.Eq("k", 3))])
    proj = sq.projection()
    assert sum(p["esp_programs"] for p in proj["per_shard"]) == sq.esp_delta_programs
    assert sq.shard_esp_programs[2] > 0
    return proj, _state(sq)


# -- test_query_lifecycle.py ------------------------------------------------------


def _partial_compaction_rebuilds_only_tombstoned_stripes(S):
    q = S.q
    n = 240
    table = _lifecycle_table(np.random.default_rng(10), n)
    sq = _build(S, dict(table), 3, num_planes=1, reserve_rows=32)
    sq.delete(np.arange(0, 60, 3))
    pre = [d.store.epoch for d in sq.devices]
    assert [s.deleted_rows > 0 for s in sq.store.shards] == [True, False, False]
    stats = sq.compact()
    assert stats["shards_rebuilt"] == 1
    post = [d.store.epoch for d in sq.devices]
    assert post[0] > pre[0] and post[1:] == pre[1:]
    live = np.ones(n, bool)
    live[np.arange(0, 60, 3)] = False
    (r,) = sq.serve([q.Query(q.Eq("c", 1), agg=q.Agg.MASK)])
    np.testing.assert_array_equal(_bits(r, int(live.sum())), (table["c"] == 1)[live])
    stats.pop("seconds")
    return stats, _value(r), _state(sq)


def _mutations_refused_while_tickets_in_flight(S):
    q = S.q
    table = _lifecycle_table(np.random.default_rng(11), 100)
    sq = _build(S, dict(table), 2, num_planes=1, reserve_rows=16)
    sq.submit(q.Query(q.Eq("c", 1)))
    msgs = [
        _raises(RuntimeError, "in flight", call)
        for call in (
            lambda: sq.delete([0]),
            lambda: sq.update([0], {c: v[:1] for c, v in table.items()}),
            lambda: sq.compact(),
        )
    ]
    sq.flush()
    sq.delete([0])
    return msgs, _state(sq)


def _delete_validation_rejects_before_any_shard(S):
    table = _lifecycle_table(np.random.default_rng(12), 90)
    sq = _build(S, dict(table), 3, num_planes=1, reserve_rows=16)
    sq.delete([4, 5])
    before = _state(sq)
    msgs = [
        _raises(ValueError, "integers", lambda: sq.delete(np.array([1.0]))),
        _raises(ValueError, "duplicate", lambda: sq.delete([7, 7])),
        _raises(ValueError, "outside", lambda: sq.delete([3, 90])),
        _raises(ValueError, "already", lambda: sq.delete([1, 5])),
        _raises(ValueError, "replacement", lambda: sq.update([1, 2], {c: v[:1] for c, v in table.items()})),
    ]
    assert _state(sq) == before
    return msgs, before


def _update_and_grow_on_overflow(S):
    q = S.q
    rng = np.random.default_rng(13)
    table = _lifecycle_table(rng, 64)
    sq = _build(S, dict(table), 3, num_planes=1, reserve_rows=4, grow_on_overflow=True)
    sq.update([3, 10], {c: v[:2] for c, v in _lifecycle_table(rng, 2).items()})
    sq.append(_lifecycle_table(rng, 40))  # past every stripe's reserve: grows
    res = sq.serve([q.Query(q.Eq("c", c), agg=a) for c in range(5) for a in (q.Count(), q.Sum("v"))])
    return _values(res), _state(sq)


def _auto_compaction_on_a_fleet(S):
    q = S.q
    rng = np.random.default_rng(14)
    sq = _build(S, _lifecycle_table(rng, 120), 2, num_planes=1, reserve_rows=8, compact_density=0.25)
    sq.delete(np.arange(0, 20))
    assert sq.compactions == 0
    sq.delete(np.arange(20, 40))
    assert sq.compactions == 1
    res = sq.serve([q.Query(q.In("c", [0, 1]), agg=a) for a in (q.Count(), q.Max("v"), q.Mask())])
    return _values(res), _state(sq)


# -- test_query_pipeline.py: coalesced appends on a pipelined fleet ---------------


def _coalesced_appends_match_immediate(S):
    q = S.q
    n = 300
    table = _sales_table(np.random.default_rng(9), n)
    half = {c: v[: n // 2] for c, v in table.items()}
    step = n // 10
    batches = [
        {c: v[n // 2 + i * step : n // 2 + (i + 1) * step] for c, v in table.items()}
        for i in range(4)
    ]
    imm = _build(S, half, 3, num_planes=2, reserve_rows=n)
    co = _build(S, half, 3, num_planes=2, reserve_rows=n, pipeline=True, coalesce_appends=True)
    for b in batches:
        imm.append(b)
        assert co.append(b) == 0
    m = n // 2 + 4 * step
    qs = [q.Query(q.Eq("country", 2), agg=a) for a in (q.Count(), q.Sum("sales"), q.Mask())]
    a, b = imm.serve(qs), co.serve(qs)
    sel = table["country"][:m] == 2
    assert a[0].value == b[0].value == int(sel.sum())
    assert a[1].value == b[1].value == int(table["sales"][:m][sel].sum())
    assert _values(a)[2] == _values(b)[2]
    assert co.esp_delta_programs < imm.esp_delta_programs
    return _values(b), _state(imm), _state(co)


SCENARIOS = {
    "ingest_stable_append_keeps_every_shard_warm": (_stable_append_keeps_every_shard_warm,),
    **{
        f"ingest_rejects_bad_append_{BAD_APPENDS[i][1]}": (
            _rejects_bad_append_before_any_shard_mutates,
            i,
        )
        for i in range(len(BAD_APPENDS))
    },
    "ingest_append_rejected_while_tickets_in_flight": (_append_rejected_while_tickets_in_flight,),
    "ingest_roundrobin_append_continues_stripe_sequence": (_roundrobin_append_continues_stripe_sequence,),
    "ingest_stripe_key_append_routes_to_owning_stripe": (_stripe_key_append_routes_to_owning_stripe,),
    "ingest_plain_range_append_extends_tail_stripe": (_plain_range_append_extends_tail_stripe,),
    "ingest_projection_charges_program_only_stripes": (_projection_charges_program_only_stripes,),
    "lifecycle_partial_compaction_rebuilds_only_tombstoned": (
        _partial_compaction_rebuilds_only_tombstoned_stripes,
    ),
    "lifecycle_mutations_refused_while_tickets_in_flight": (_mutations_refused_while_tickets_in_flight,),
    "lifecycle_delete_validation_rejects_before_any_shard": (_delete_validation_rejects_before_any_shard,),
    "lifecycle_update_and_grow_on_overflow": (_update_and_grow_on_overflow,),
    "lifecycle_auto_compaction_on_a_fleet": (_auto_compaction_on_a_fleet,),
    "pipeline_coalesced_appends_match_immediate": (_coalesced_appends_match_immediate,),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(ref, name):
    fn, *args = SCENARIOS[name]
    _both(ref, fn, *args)


# -- test_query_differential.py's corpus, at shard counts {1, 2, 3} ----------------

# three of the reference's CORPUS entries: a prime row count that never
# divides, a word-straddling count under range striping, and one below a word
DIFFERENTIAL_CORPUS = [(11, 97, "roundrobin"), (14, 130, "range"), (16, 31, "range")]


def _random_pred(S, rng, depth=0):
    q = S.q
    kind = rng.integers(0, 6 if depth < 2 else 4)
    if kind == 0:
        return q.Eq("country", int(rng.integers(0, 7)))
    if kind == 1:
        return q.In("device", [int(v) for v in rng.choice(5, rng.integers(1, 4))])
    if kind == 2:
        lo = int(rng.integers(0, 70))
        return q.Range("age", lo, lo + int(rng.integers(0, 40)))
    if kind == 3:
        return q.Not(_random_pred(S, rng, depth + 1))
    children = [_random_pred(S, rng, depth + 1) for _ in range(rng.integers(2, 4))]
    return S.and_(*children) if kind == 4 else S.or_(*children)


def _random_agg(q, rng):
    col = ("country", "device", "age")[int(rng.integers(0, 3))]
    kind = int(rng.integers(0, 6))
    if kind < 4:
        return (q.Sum, q.Avg, q.Min, q.Max)[kind](col)
    if kind == 4:
        return q.TopK(col, int(rng.integers(1, 5)))
    key = ("country", "device")[int(rng.integers(0, 2))]
    return q.GroupBy(key, (q.Count(), q.Sum("age"), q.Avg("age"))[int(rng.integers(0, 3))])


def _np_agg_oracle(q, spec, sel, table):
    """test_query_differential.py's plain-numpy aggregate over ``sel``."""
    if isinstance(spec, q.Sum):
        return int(table[spec.column][sel].sum())
    if isinstance(spec, q.Avg):
        c = int(sel.sum())
        return int(table[spec.column][sel].sum()) / c if c else None
    if isinstance(spec, (q.Min, q.Max)):
        v = table[spec.column][sel]
        return (int(v.min()) if isinstance(spec, q.Min) else int(v.max())) if len(v) else None
    if isinstance(spec, q.TopK):
        vals, counts = np.unique(table[spec.column][sel], return_counts=True)
        ranked = sorted(zip(vals.tolist(), counts.tolist()), key=lambda vc: (-vc[1], vc[0]))
        return tuple((int(v), int(c)) for v, c in ranked)[: spec.k]
    out = {}
    for v in np.unique(table[spec.key]):
        m = sel & (table[spec.key] == v)
        if m.any():
            out[int(v)] = (
                int(m.sum()) if isinstance(spec.value, q.Count)
                else _np_agg_oracle(q, spec.value, m, table)
            )
    return out


def _differential(S, seed, n, policy, only=None):
    """The reference's ``_run_differential`` over the sharded systems:
    shard counts {1, 2, 3}, the pipelined fleet and, on range striping,
    the stripe_key-routed fleets (or the ``only`` ones among them); every
    answer against numpy."""
    q = S.q
    rng = np.random.default_rng(seed)
    table = {
        "country": rng.integers(0, 6, n),
        "device": rng.integers(0, 4, n),
        "age": rng.integers(0, 90, n),
    }
    preds = [_random_pred(S, rng) for _ in range(5)]
    aggs = [_random_agg(q, rng) for _ in preds]
    queries = (
        [q.Query(p) for p in preds]
        + [q.Query(p, agg=q.Agg.MASK) for p in preds]
        + [q.Query(p, agg=a) for p, a in zip(preds, aggs)]
    )
    systems = {s: _build(S, table, s, policy=policy, num_planes=2) for s in (1, 2, 3)}
    systems["pipelined"] = _build(S, table, 3, policy=policy, num_planes=2, pipeline=True)
    if policy == "range":
        kw = dict(policy="range", stripe_key="age", num_planes=2)
        systems["routed"] = _build(S, table, 3, **kw)
        systems["routed-pipelined"] = _build(S, table, 3, pipeline=True, **kw)
    if only is not None:
        systems = {name: systems[name] for name in only}
    out = {}
    k = len(preds)
    for name, sq in systems.items():
        res = sq.serve(queries)
        for i, (p, a) in enumerate(zip(preds, aggs)):
            want = S.np_select(p, table, n)
            assert res[i].count == int(want.sum()), (name, p)
            np.testing.assert_array_equal(_bits(res[k + i], n), want)
            assert res[2 * k + i].value == _np_agg_oracle(q, a, want, table), (name, p, a)
        out[name] = (_values(res), _state(sq))
    return out


@pytest.mark.parametrize("seed,n,policy", DIFFERENTIAL_CORPUS)
def test_differential_corpus_matches_numpy(seed, n, policy):
    """The port's six sharded systems against numpy on three corpus
    entries (the reference's own differential test checks the same)."""
    _differential(PORT, seed, n, policy)


def test_differential_matches_reference(ref):
    """One corpus entry through both packages, on the 3-shard lockstep
    and pipelined fleets: answers and every counter equal (each
    reference fleet compiles its own programs for seconds, so the other
    systems and entries run port-only, above)."""
    _both(ref, _differential, *DIFFERENTIAL_CORPUS[-1], (3, "pipelined"))


# -- the mutation streams of test_query_differential.py, on the port's fleets ------

STREAM_CORPUS = [(21, 97, "roundrobin"), (23, 130, "range"), (24, 31, "roundrobin")]


def _stream_table(rng, n):
    return {
        "country": rng.integers(0, 6, n),
        "device": rng.integers(0, 4, n),
        "age": rng.integers(0, 90, n),
    }


def _random_atleast(S, rng):
    kids = [_random_pred(S, rng, depth=2) for _ in range(int(rng.integers(2, 6)))]
    return S.q.AtLeast(int(rng.integers(1, len(kids) + 1)), kids)


def _check_round(queries, results, table, live):
    """Every answer against numpy over the live resident rows (MASK bits
    cover every resident row; tombstoned ones read 0)."""
    n = len(live)
    for query, r in zip(queries, results):
        want = np_select(query.where, table, n) & live
        if r.mask is not None:
            np.testing.assert_array_equal(_bits(r, n), want, err_msg=repr(query))
        elif isinstance(query.agg, T.Sum):
            assert r.value == int(table["age"][want].sum()), query
        else:
            assert r.count == int(want.sum()), query


@pytest.mark.parametrize("seed,n,policy", STREAM_CORPUS)
def test_mutation_stream_matches_numpy(seed, n, policy):
    """Append, delete, update and compact rounds over fleets of 1, 2 and
    3 shards, lockstep, pipelined with coalesced appends and (range)
    stripe_key-routed — plain and k-of-N predicates, every round exact."""
    rng = np.random.default_rng(seed)
    resident = _stream_table(rng, n)
    live = np.ones(n, bool)
    kw = dict(num_planes=2, reserve_rows=n, device="cpu")
    systems = {s: T.build_sharded_flashql(dict(resident), s, policy=policy, **kw) for s in (1, 2, 3)}
    systems["pipelined"] = T.build_sharded_flashql(
        dict(resident), 3, policy=policy, pipeline=True, coalesce_appends=True, **kw
    )
    if policy == "range":
        systems["routed"] = T.build_sharded_flashql(
            dict(resident), 3, policy="range", stripe_key="age", **kw
        )
    for kind in ("serve", "append", "delete", "update", "append", "compact"):
        if kind in ("append", "update"):
            batch = _stream_table(rng, int(rng.integers(3, 9)))
            b = len(batch["age"])
            ids = rng.choice(np.flatnonzero(live), b, replace=False) if kind == "update" else None
            for sq in systems.values():
                sq.update(ids, batch) if kind == "update" else sq.append(batch)
            resident = {c: np.concatenate([v, batch[c]]) for c, v in resident.items()}
            if ids is not None:
                live[ids] = False
            live = np.concatenate([live, np.ones(b, bool)])
        elif kind == "delete":
            ids = rng.choice(np.flatnonzero(live), min(int(live.sum()) // 4, 15), replace=False)
            for sq in systems.values():
                sq.delete(ids)
            live[ids] = False
        elif kind == "compact":
            for sq in systems.values():
                sq.compact()
            resident = {c: v[live] for c, v in resident.items()}
            live = np.ones(int(live.sum()), bool)
        preds = [_random_pred(PORT, rng) for _ in range(3)] + [_random_atleast(PORT, rng)]
        queries = (
            [T.Query(p) for p in preds]
            + [T.Query(p, agg=T.Agg.MASK) for p in preds]
            + [T.Query(p, agg=T.Sum("age")) for p in preds]
        )
        for name, sq in systems.items():
            try:
                _check_round(queries, sq.serve(queries), resident, live)
            except AssertionError as err:
                raise AssertionError(f"{(seed, n, policy, name, kind)}: {err}") from err


# -- the fleet tensor -----------------------------------------------------------------


def _fleet_lifecycle(device) -> list:
    """A 3-shard fleet through appends (one with a first-seen value,
    which adds slots), a delete and a compaction, serving lockstep after
    each; returns the answers, and checks the fleet tensor's invariants."""
    rng = np.random.default_rng(41)
    n = 500
    table = {"country": rng.integers(0, 6, n), "device": rng.integers(0, 4, n), "sales": rng.integers(0, 40, n)}
    sq = T.build_sharded_flashql(table, 3, num_planes=2, reserve_rows=128, device=device)
    queries = [
        T.Query(q, agg=a)
        for q in (T.Eq("country", 2), T.In("device", [1, 3]), T.Range("sales", 9, 30))
        for a in (T.Count(), T.Mask(), T.Sum("sales"))
    ]
    out = [_values(sq.serve(queries))]
    fleet = sq._fleet
    assert sq.fleet_rebuilds == 1
    assert [d.store.snapshot_uploads for d in sq.devices] == [1, 1, 1]

    def slabs_hold_host_buffers():
        for p, s in enumerate(sq._fleet.shards):
            ps = sq.devices[s].store
            got = to_uint32(sq._fleet.data[p, : ps.num_slots])
            np.testing.assert_array_equal(got, ps._buf[: ps.num_slots])

    slabs_hold_host_buffers()
    sq.pipeline = True  # per-shard programs read the same slabs: no upload
    out.append(_values(sq.serve(queries)))
    sq.pipeline = False
    sq.append({c: v[:60] for c, v in table.items()})  # known values: written in place
    sq.delete(rng.choice(sq.store.num_rows, 40, replace=False))
    out.append(_values(sq.serve(queries)))
    assert sq._fleet is fleet and sq.fleet_rebuilds == 1
    assert [d.store.snapshot_uploads for d in sq.devices] == [1, 1, 1]
    slabs_hold_host_buffers()
    # first-seen country values add an equality page each on every
    # shard: enough of them to pass the fleet's capacity, so the stores
    # outgrow their slabs and the fleet grows once, on the device (no
    # upload)
    k = fleet.cap - sq.devices[0].store.num_slots + 1
    sq.append({"country": np.arange(100, 100 + k), "device": np.zeros(k, np.int64), "sales": np.full(k, 7)})
    assert sq.devices[0].store.num_slots > fleet.cap
    out.append(_values(sq.serve(queries + [T.Query(T.Eq("country", 100 + k // 2))])))
    assert sq.fleet_rebuilds == 2 and sq._fleet.cap > fleet.cap
    assert [d.store.snapshot_uploads for d in sq.devices] == [1, 1, 1]
    slabs_hold_host_buffers()
    sq.compact()  # every stripe has tombstones: each uploads once more
    out.append(_values(sq.serve(queries)))
    assert sq.fleet_rebuilds == 3
    assert [d.store.snapshot_uploads for d in sq.devices] == [2, 2, 2]
    slabs_hold_host_buffers()
    return out


def test_fleet_tensor_takes_writes_in_place():
    _fleet_lifecycle("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fleet_tensor_on_the_card_equals_the_cpu_fleet(cuda):
    assert _fleet_lifecycle(cuda) == _fleet_lifecycle("cpu")
