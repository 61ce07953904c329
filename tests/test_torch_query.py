"""FlashQL serving on the port against the JAX reference, end to end.

The README quickstart table (about 5,000 rows, made from a numpy seed) is
ingested, programmed and served through ``BatchScheduler`` in both
packages — COUNT and MASK over Eq, In, Not, a Range deep enough to spill,
and k-of-n thresholds — with the optimizer on and off and the fused flush
on and off.  Answers, ``stats()`` counters, ``projection()`` and the P/E
wear must be equal; packed words compare bit for bit.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.query as R
import repro_torch.query as T
from repro_torch.query.oracle import np_select
from repro_torch.query.state import export_state, load_reference_state

ROWS = 5000
# host-clock fields; everything else in stats() is a counter
_TIMED = ("queries_per_sec", "mean_latency_s")


def _table(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "country": rng.integers(0, 8, ROWS),
        "age": rng.integers(13, 90, ROWS),
        "device": rng.integers(0, 4, ROWS),
    }


def _queries(M):
    return [
        M.Query(M.Eq("country", 3)),
        M.Query(M.Eq("country", 3) & M.Range("age", 18, 35)),
        M.Query(M.In("country", [0, 1, 2]), agg=M.Agg.MASK),
        M.Query(M.Not(M.Eq("device", 1))),
        M.Query(M.Range("age", 17, 71)),  # deep BSI chain: spills
        M.Query(M.Range("age", 17, 71), agg=M.Agg.MASK),
        M.Query(M.AtLeast(2, [M.Eq("country", 1), M.Eq("device", 2), M.Range("age", 20, 40)])),
        M.Query(
            M.AtLeast(3, [M.In("country", [1, 2, 3]), M.Eq("device", 2), M.In("country", [2, 3, 5]),
                          M.In("device", [2, 3]), M.Not(M.Eq("country", 2))])
        ),
        M.Query(M.Eq("country", 3)),  # a duplicate: deduplicated by the optimizer
        M.Query(M.Not(M.Eq("device", 1)), agg=M.Agg.MASK),
    ]


def _deploy(M, table, **dev_kw):
    store = M.BitmapStore()
    store.ingest(table)
    dev = M.FlashDevice(num_planes=4, **dev_kw)
    store.program(dev, warmup=[M.Query(M.In("country", [0, 1, 2]))])
    return store, dev


def _serve(M, store, dev, *, optimize, fuse_flush, rounds=2):
    sched = M.BatchScheduler(dev, store, optimize=optimize, fuse_flush=fuse_flush)
    values = []
    for _ in range(rounds):  # the second round runs warm (cached programs)
        for r in sched.serve(_queries(M)):
            values.append(r.count if r.count is not None else np.asarray(r.value.words).tolist())
    stats = {k: v for k, v in sched.stats().items() if k not in _TIMED}
    return values, stats, sched.projection(), dict(dev.pec)


@pytest.mark.parametrize("optimize", [True, False], ids=["opt", "noopt"])
@pytest.mark.parametrize("fuse_flush", [True, False], ids=["fused", "legacy"])
def test_serving_matches_reference(optimize, fuse_flush):
    table = _table()
    ref = _serve(R, *_deploy(R, table), optimize=optimize, fuse_flush=fuse_flush)
    port = _serve(T, *_deploy(T, table, device="cpu"), optimize=optimize, fuse_flush=fuse_flush)
    assert port[0] == ref[0]  # counts and mask words
    assert port[1] == ref[1]  # stats() counters
    assert port[2] == ref[2]  # SSD projection
    assert port[3] == ref[3]  # P/E wear (spill programs included)
    if fuse_flush:
        assert port[1]["host_transfers"] == port[1]["flushes"] == port[1]["fused_dispatches"]


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("optimize", [True, False], ids=["opt", "noopt"])
def test_smoke_mix_matches_reference(optimize):
    """chip_smoke.py's table and query mix, at a small row count, served
    as the smoke serves them: the port's answers equal numpy and its
    counters equal the reference's after a first and a warm flush."""
    smoke = _chip_smoke()
    rows = 3000
    table = smoke.make_table(rows, smoke.SEED)
    got = {}
    for M, kw in ((R, {}), (T, {"device": "cpu"})):
        queries = smoke.build_queries(M, smoke.SEED)
        store = M.BitmapStore()
        store.ingest(table)
        dev = M.FlashDevice(num_planes=4, **kw)
        store.program(dev, warmup=queries[:3])
        sched = M.BatchScheduler(dev, store, optimize=optimize, max_batch=256)
        first = sched.serve(queries)
        counters = [{k: sched.stats()[k] for k in smoke._COUNTERS}]
        warm = sched.serve(queries)
        counters.append({k: sched.stats()[k] for k in smoke._COUNTERS})
        if M is T:
            oracle = smoke.Oracle(table, store.words)
            smoke.check_results(queries, first, oracle, mask_sample=store.words)
            smoke.check_results(queries, warm, oracle, mask_sample=store.words)
        values = [r.count if r.count is not None else np.asarray(r.value.words).tolist()
                  for r in first + warm]
        got[M] = (values, counters)
    assert got[T] == got[R]
    assert got[T][1][0]["host_transfers"] == got[T][1][0]["flushes"] == 1


def test_smoke_mutation_path_rehearsal():
    """chip_smoke.py's live-index phase on the CPU at 2^13 rows: every
    step's answers equal numpy, B1 calls equal their plain version, and
    the snapshot is uploaded whole once, and once more at compact()."""
    out = _chip_smoke().mutation_path("cpu", 1 << 13, log=lambda line: None)
    steps = {s["step"]: s for s in out["steps"]}
    assert len(steps) == 14
    assert [s["snapshot_uploads"] for s in out["steps"]] == [1] * 12 + [2, 2]
    assert steps["append_4"]["slots"] == steps["append_3"]["slots"] + 4  # 2 pages, 2 slices
    assert steps["append_4"]["b1_calls_checked"] > 0 and steps["compact"]["b1_calls_checked"] > 0
    assert steps["compact"]["rows_dropped"] >= 0.4 * steps["delete_wave"]["rows"]
    for s in out["steps"][:12]:  # every delta programmed was written in place
        written = s["snapshot_bytes_written"] + s["flush_snapshot_bytes_written"]
        assert written >= s["bytes_programmed"] > 0
    assert steps["coalesced_appends_4"]["snapshot_bytes_written"] == 0  # queued until the flush


def test_smoke_shard_path_rehearsal():
    """chip_smoke.py's sharded phase at 2^13 rows (fleet B at 2^12) on the
    CPU: both fleets answer as numpy does, the host transfers per flush
    are as the phase asserts, and the append and delete write into the
    fleet tensor in place."""
    smoke = _chip_smoke()
    out = smoke.shard_path("cpu", 1 << 13, 1 << 12, log=lambda msg: None)
    rec = out.pop("recorded")
    assert rec.calls["mws_shard_lockstep"] and rec.calls["mws_shard_pipelined"]
    modes = out["modes"]
    assert modes["lockstep_count_mask"]["host_transfers_per_flush"] == 2  # COUNT + MASK
    assert modes["pipelined_count_mask"]["host_transfers_per_flush"] == 4  # one per shard
    assert modes["pipelined_count_mask"]["calls_checked"] == {"popcount": 4, "threshold": 4}
    assert out["fleet"]["rebuilds"] == 1 and out["fleet"]["rebuilds_by_writes"] == 0
    for step in ("append", "delete"):
        assert out["mutations"][step]["snapshot_uploads"] == [1, 1, 1, 1]
        assert out["mutations"][step]["snapshot_bytes_written"] > 0
    assert out["routed"]["shards_pruned"] > 0


def test_answers_match_numpy():
    table = _table(1)
    store, dev = _deploy(T, table, device="cpu")
    sched = T.BatchScheduler(dev, store)
    qs = _queries(T)
    for q, r in zip(qs, sched.serve(qs)):
        want = np_select(q.where, table, ROWS)
        if r.count is not None:
            assert r.count == int(want.sum()), q
        else:
            got = np.unpackbits(np.asarray(r.value.words).view(np.uint8), bitorder="little")
            np.testing.assert_array_equal(got[:ROWS].astype(bool), want)
            assert not got[ROWS:].any()  # padding bits stay zero


def test_load_reference_state_serves_identically():
    """A port device loaded from the reference's exported state and one
    built by the port's own ingest + program serve identical answers."""
    table = _table(2)
    ref_store, ref_dev = _deploy(R, table)
    arrays, meta = export_state(ref_store, ref_dev)
    loaded = load_reference_state(arrays, meta, device="cpu")
    native = _deploy(T, table, device="cpu")
    # the port's own ingest + program reaches the reference's state,
    # field for field, and so does the loaded copy
    for got_arrays, got_meta in (export_state(*native), export_state(*loaded)):
        assert got_meta == meta
        assert got_arrays.keys() == arrays.keys()
        for k in arrays:
            np.testing.assert_array_equal(got_arrays[k], arrays[k])
    a = _serve(T, *loaded, optimize=True, fuse_flush=True)
    b = _serve(T, *native, optimize=True, fuse_flush=True)
    assert a == b


def test_unported_surfaces_raise_naming_the_roadmap():
    """The mutations (ROADMAP A4) and the sharded fleet (A6) are ported:
    the live index runs and raises nothing, and the three sharded names
    exist, a 2-shard CPU fleet answering a COUNT as the reference's does."""
    store, dev = _deploy(T, _table(), device="cpu")
    sched = T.BatchScheduler(dev, store)
    assert sched.append({"country": [1], "age": [20], "device": [0]}) > 0
    assert sched.delete([0]) == 1
    assert sched.update([1], {"country": [2], "age": [30], "device": [1]}) > 0
    assert sched.compact()["rows_dropped"] == 2
    for name in ("ShardedBitmapStore", "ShardedFlashQL", "build_sharded_flashql"):
        assert getattr(T, name) is getattr(T.shard, name)
    table = _table(4)
    if not torch.cuda.is_available():  # the card is the default: no silent CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.build_sharded_flashql(table, 2)
    counts = [
        M.build_sharded_flashql(table, 2, **kw).serve(
            [M.Query(M.Eq("country", 3) & M.Range("age", 18, 35))]
        )[0].count
        for M, kw in ((R, {}), (T, {"device": "cpu"}))
    ]
    assert counts[0] == counts[1] == int(
        ((table["country"] == 3) & (table["age"] >= 18) & (table["age"] <= 35)).sum()
    )


def test_execute_batch_equals_sequential():
    """tests/test_query.py::test_batched_execution_equals_sequential: the
    batched path and FlashArray.execute agree, and equal the reference's
    batched words."""
    from repro_torch.core.bitops import to_uint32
    from repro_torch.core.engine import FlashArray

    table = _table(5)
    words = {}
    for M, kw in ((R, {}), (T, {"device": "cpu"})):
        store, dev = _deploy(M, table, **kw)
        plans = [M.QueryCompiler(store, dev).compile(M.Query(M.Eq("country", c))).plan for c in range(8)]
        words[M] = [np.asarray(w if M is R else to_uint32(w)) for w in dev.execute_batch(plans)]
    arr = FlashArray(device="cpu")
    store = T.BitmapStore()
    store.ingest(table)
    store.program(arr)
    comp = T.QueryCompiler(store, arr)
    for c, got in enumerate(words[T]):
        seq = arr.execute(comp.compile(T.Query(T.Eq("country", c))).plan)
        np.testing.assert_array_equal(got, to_uint32(seq))
        np.testing.assert_array_equal(got, words[R][c])


def test_execute_batch_allows_unrelated_non_esp_pages():
    """tests/test_query.py::test_batch_allows_unrelated_non_esp_pages: a
    noisy page the batch never senses leaves batching on; sensing it from
    the batch path raises."""
    from repro_torch.core.expr import Page
    from repro_torch.core.planner import Planner

    rng = np.random.default_rng(14)
    store = T.BitmapStore()
    store.ingest({"c": rng.integers(0, 4, 200)})
    dev = T.FlashDevice(num_planes=1, device="cpu")
    store.program(dev)
    dev.fc_write("telemetry", rng.integers(0, 2**32, (store.words,), dtype=np.uint32), esp=False)
    plan = T.QueryCompiler(store, dev).compile(T.Query(T.Eq("c", 1))).plan
    (out,) = dev.execute_batch([plan])
    assert out.shape == (store.words,)
    with pytest.raises(ValueError, match="non-ESP"):
        dev.execute_batch([Planner(dev.layout).compile(Page("telemetry"))])


def test_noisy_page_takes_the_legacy_path():
    """A non-ESP page on the device routes every flush through the
    per-group legacy path (no fused dispatch), in both packages alike."""
    table = _table(3)
    for M, kw in ((R, {}), (T, {"device": "cpu"})):
        store, dev = _deploy(M, table, **kw)
        dev.fc_write("noise", store.logical["country=1"], esp=False)
        sched = M.BatchScheduler(dev, store)
        (r,) = sched.serve([M.Query(M.Eq("country", 2))])
        assert r.count == int((table["country"] == 2).sum())
        assert sched.stats()["fused_dispatches"] == 0
