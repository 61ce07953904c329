"""FlashQL's SUM/AVG/MIN/MAX/TOP-K/GROUP BY on the port against the JAX
reference.

Mirrors the single-device scenarios of ``tests/test_query_aggregates.py``
(the sharded ones wait for the port's ``query/shard.py``): the
weighted-popcount and MIN/MAX slice-walk identities, the batching
invariant of a flush mixing every aggregate kind, admission-time
validation, empty selections, aggregate slice reads in the SSD
projection, and the absence of per-aggregate ladders.  Each scenario runs
on the same seeded table through both packages; answers and counters must
be equal and equal to numpy.  ``chip_smoke.py``'s aggregate mix is served
at a few thousand rows the same way.  Tolerance: none — AVG is the same
Python division of the same exact integers in both packages.
"""

import importlib.util
import inspect
import pkgutil
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.query as R
import repro_torch.query as T
from repro.query.aggregate import bsi_extreme as ref_bsi_extreme
from repro.query.aggregate import sliced_counts as ref_sliced_counts
from repro_torch.core.bitops import to_words
from repro_torch.query.aggregate import bsi_extreme, sliced_counts
from _hypothesis_compat import given, settings, st  # hypothesis optional

# host-clock fields; everything else in stats() is a counter
_TIMED = ("queries_per_sec", "mean_latency_s")


def _aggs(M):
    return (
        M.Count(),
        M.Mask(),
        M.Sum("sales"),
        M.Avg("sales"),
        M.Min("sales"),
        M.Max("sales"),
        M.TopK("device", 3),
        M.GroupBy("device"),
        M.GroupBy("device", M.Sum("sales")),
        M.GroupBy("device", M.Avg("sales")),
    )


def _table(rng, n):
    return {
        "country": rng.integers(0, 6, n),
        "device": rng.integers(0, 4, n),
        "sales": rng.integers(0, 500, n),
    }


def _scheduler(M, table, planes=2, **kw):
    store = M.BitmapStore()
    store.ingest(table)
    dev = M.FlashDevice(num_planes=planes, **({"device": "cpu"} if M is T else {}))
    store.program(dev)
    return M.BatchScheduler(dev, store, **kw)


def _value(r):
    return np.asarray(r.value.words).tolist() if r.mask is not None else r.value


def _counters(sched):
    return {k: v for k, v in sched.stats().items() if k not in _TIMED}


# -- weighted-popcount identities ----------------------------------------------


def _pack_rows(rows) -> np.ndarray:
    """Bool rows -> (R, W) uint32 words, bit i of the row in word i // 32."""
    bits = np.asarray(rows, bool)
    pad = (-bits.shape[1]) % 32
    bits = np.pad(bits, ((0, 0), (0, pad)))
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)


def _slices(seed, n, bits):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << bits, n)
    sel = rng.integers(0, 2, n).astype(bool)
    mask = _pack_rows([sel])  # (1, W)
    slices = _pack_rows([(vals >> b) & 1 for b in range(bits)])[None]  # (1, bits, W)
    return vals, sel, mask, slices


def _check_sum_identity(seed: int, n: int, bits: int) -> None:
    vals, sel, mask, slices = _slices(seed, n, bits)
    got = sliced_counts(to_words(mask), to_words(slices))
    assert got.dtype == torch.int32
    got = got.numpy()[0]
    want = np.asarray(ref_sliced_counts(mask, slices, interpret=True))[0]
    np.testing.assert_array_equal(got, want)
    assert sum(int(c) << b for b, c in enumerate(got)) == int(vals[sel].sum())


def _check_extreme_identity(seed: int, n: int, bits: int) -> None:
    vals, sel, mask, slices = _slices(seed, n, bits)
    for maximize in (False, True):
        dec, nonempty = bsi_extreme(to_words(mask), to_words(slices), maximize=maximize)
        rdec, rnonempty = ref_bsi_extreme(mask, slices, maximize=maximize)
        np.testing.assert_array_equal(dec.numpy(), np.asarray(rdec))
        np.testing.assert_array_equal(nonempty.numpy(), np.asarray(rnonempty))
        assert bool(nonempty[0]) == bool(sel.any())
        if sel.any():
            got = sum(int(d) << b for b, d in enumerate(dec[0].tolist()))
            assert got == int(vals[sel].max() if maximize else vals[sel].min())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sum_weighted_popcount_identity_corpus(seed):
    _check_sum_identity(seed, n=97 + seed, bits=7)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_minmax_slice_walk_identity_corpus(seed):
    _check_extreme_identity(seed, n=97 + seed, bits=7)


_PROPERTY = dict(
    seed=st.integers(min_value=0, max_value=2**16),
    n=st.integers(min_value=1, max_value=200),
    bits=st.integers(min_value=1, max_value=10),
)


@settings(max_examples=6, deadline=None)
@given(**_PROPERTY)
def test_sum_weighted_popcount_identity_property(seed, n, bits):
    _check_sum_identity(seed, n, bits)


@settings(max_examples=6, deadline=None)
@given(**_PROPERTY)
def test_minmax_slice_walk_identity_property(seed, n, bits):
    _check_extreme_identity(seed, n, bits)


# -- batching: aggregation must not multiply signature groups -----------------


@pytest.fixture(scope="module")
def mixed_flush():
    """A flush holding every aggregate kind over four predicates, and the
    same predicates as COUNTs only, served by both packages."""
    table = _table(np.random.default_rng(7), 513)
    out = {"table": table}
    for M in (R, T):
        preds = [M.Eq("country", c) & M.Eq("device", c % 4) for c in range(4)]
        base = _scheduler(M, table)
        base.serve([M.Query(p) for p in preds])
        mixed = _scheduler(M, table)
        queries = [M.Query(p, agg=a) for p in preds for a in _aggs(M)]
        results = mixed.serve(queries)
        out[M] = (base, mixed, queries, results)
    return out


def test_mixed_aggregate_flush_keeps_count_only_vmap_groups(mixed_flush):
    """One flush holding EVERY aggregate kind dispatches exactly the
    signature groups of the COUNT-only flush, and forks no plan-cache
    entry — in both packages, with equal answers and counters."""
    table = mixed_flush["table"]
    (rb, rm, _, rres), (tb, tm, tq, tres) = mixed_flush[R], mixed_flush[T]
    assert tb.device.last_signature_groups >= 1
    assert tm.device.last_signature_groups == tb.device.last_signature_groups
    assert tm.device.last_signature_groups == rm.device.last_signature_groups
    assert tm.compiler.misses == tb.compiler.misses == rm.compiler.misses
    assert [_value(r) for r in tres] == [_value(r) for r in rres]
    assert _counters(tm) == _counters(rm)
    for q, r in zip(tq, tres):
        sel = np.ones(513, bool)
        for leaf in q.where.children:
            sel &= table[leaf.column] == leaf.value
        if isinstance(q.agg, T.Count):
            assert r.value == int(sel.sum())
        elif isinstance(q.agg, T.Sum):
            assert r.value == int(table["sales"][sel].sum())
        elif isinstance(q.agg, T.Max):
            assert r.value == (int(table["sales"][sel].max()) if sel.any() else None)


# -- admission-time validation ------------------------------------------------


@pytest.mark.parametrize("M", [R, T], ids=["ref", "port"])
def test_bad_aggregate_rejected_at_submit(M):
    table = _table(np.random.default_rng(9), 100)
    sched = _scheduler(M, table)
    for bad in (
        M.Sum("nope"),
        M.Avg("nope"),
        M.Min("nope"),
        M.TopK("nope", 2),
        M.GroupBy("nope"),
        M.GroupBy("device", M.Sum("nope")),
    ):
        with pytest.raises(KeyError, match="nope"):
            sched.submit(M.Query(M.Eq("country", 1), agg=bad))
    with pytest.raises(ValueError, match="k >= 1"):
        sched.submit(M.Query(M.Eq("country", 1), agg=M.TopK("device", 0)))
    with pytest.raises(TypeError, match="Count/Sum/Avg"):
        sched.submit(M.Query(M.Eq("country", 1), agg=M.GroupBy("device", M.Mask())))
    with pytest.raises(KeyError, match="ghost"):
        sched.submit(M.Query(M.Eq("ghost", 1)))
    # nothing was admitted and serving still works
    assert sched.pending == 0
    (r,) = sched.serve([M.Query(M.Eq("country", 1), agg=M.Sum("sales"))])
    assert r.value == int(table["sales"][table["country"] == 1].sum())


# -- semantics edge cases -----------------------------------------------------


@pytest.mark.parametrize("fuse_flush", [True, False], ids=["fused", "legacy"])
def test_empty_selection_aggregates(fuse_flush):
    """MIN/MAX/AVG of an empty selection are None; TOP-K/GROUP BY empty."""
    table = _table(np.random.default_rng(10), 64)
    got = {}
    for M in (R, T):
        # a contradiction: executes (Not is never pruned) but selects nothing
        empty = M.Eq("country", 1) & M.Not(M.Eq("country", 1))
        aggs = (M.Count(), M.Sum("sales"), M.Avg("sales"), M.Min("sales"), M.Max("sales"),
                M.TopK("device", 2), M.GroupBy("device"))
        sched = _scheduler(M, table, fuse_flush=fuse_flush)
        got[M] = [r.value for r in sched.serve([M.Query(empty, agg=a) for a in aggs])]
    assert got[T] == got[R] == [0, 0, None, None, None, (), {}]


# -- aggregate traffic reaches the SSD projection -----------------------------


def test_aggregate_slice_reads_counted_in_projection():
    from repro.query.scheduler import AGG_READ_SHAPE as REF_SHAPE
    from repro_torch.query.scheduler import AGG_READ_SHAPE as PORT_SHAPE

    table = _table(np.random.default_rng(13), 100)
    got = {}
    for M, AGG_READ_SHAPE in ((R, REF_SHAPE), (T, PORT_SHAPE)):
        # the predicate plan itself senses single-wordline commands that
        # land in the same shape bucket: compare with a COUNT-only baseline
        base = _scheduler(M, table)
        base.serve([M.Query(M.Eq("country", 1))])
        sched = _scheduler(M, table)
        sched.serve([M.Query(M.Eq("country", 1), agg=M.Sum("sales"))])
        bits = sched.store.columns["sales"].bits
        extra = sched.command_shape_counts[AGG_READ_SHAPE] - base.command_shape_counts[AGG_READ_SHAPE]
        assert extra == bits
        assert sched.wordlines_sensed - base.wordlines_sensed == bits
        proj = sched.projection()  # host postprocess flagged, model runs
        assert proj["fc_time_s"] > 0
        got[M] = (proj, _counters(sched))
    assert got[T] == got[R]


# -- the ladders are gone -----------------------------------------------------


def test_no_per_agg_ladders_in_query_modules():
    """No per-Agg special case survives in the port's query modules: every
    aggregate flows through the Aggregator interface.  ``ast`` is where
    the legacy ``Agg`` enum is defined and normalized, so it is exempt."""
    import importlib

    import repro_torch.query as pkg

    names = [m.name for m in pkgutil.iter_modules(pkg.__path__) if m.name != "ast"]
    assert "scheduler" in names and "aggregate" in names
    for name in names:
        src = inspect.getsource(importlib.import_module(f"repro_torch.query.{name}"))
        assert "Agg.COUNT" not in src and "Agg.MASK" not in src, name


# -- chip_smoke.py's aggregate mix --------------------------------------------


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("optimize", [True, False], ids=["opt", "noopt"])
@pytest.mark.parametrize("fuse_flush", [True, False], ids=["fused", "legacy"])
def test_smoke_aggregate_mix_matches_reference(optimize, fuse_flush):
    """chip_smoke.py's table and its flush of 71 COUNT/MASK queries beside
    20 aggregates, at 2,000 rows: the port's answers equal numpy and the
    reference's, and so do its counters, after a first and a warm flush."""
    smoke = _chip_smoke()
    table = smoke.make_table(2000, smoke.SEED)
    got = {}
    for M, kw in ((R, {}), (T, {"device": "cpu"})):
        queries = smoke.build_queries(M, smoke.SEED) + smoke.build_aggregates(M, smoke.SEED)
        store = M.BitmapStore()
        store.ingest(table)
        dev = M.FlashDevice(num_planes=4, **kw)
        store.program(dev, warmup=queries[:3])
        sched = M.BatchScheduler(dev, store, optimize=optimize, fuse_flush=fuse_flush, max_batch=256)
        first = sched.serve(queries)
        counters = [_counters(sched)]
        warm = sched.serve(queries)
        counters.append(_counters(sched))
        if M is T:
            oracle = smoke.Oracle(table, store.words)
            smoke.check_results(queries, first, oracle, mask_sample=store.words)
            smoke.check_results(queries, warm, oracle)
        got[M] = ([_value(r) for r in first + warm], counters)
    assert got[T] == got[R]
    st = got[T][1][0]
    assert st["flushes"] == 1
    if fuse_flush:  # one transfer per fused flush, else one per reduce group
        assert st["host_transfers"] == st["fused_dispatches"] == 1
    else:
        assert st["fused_dispatches"] == 0 and st["host_transfers"] > 1
