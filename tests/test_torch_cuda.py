"""The port on the card against the port on the CPU (plain versions).

Every path that launches a kernel — the fused flush, the per-group legacy
flush, the eager engine with noisy reads, a state loaded from an export —
must give the CPU run's answers and counters bit for bit.  These tests
need an NVIDIA GPU and skip elsewhere; the file imports no JAX, so it
runs on a GPU machine without it:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import repro_torch.query as T
from _bmi import bmi_store, day_bits, day_column
from repro_torch.core.bitops import to_uint32
from repro_torch.core.engine import FlashArray
from repro_torch.core.expr import Page, and_, or_
from repro_torch.kernels.mws import mws_gather
from repro_torch.kernels.popcount import popcount
from repro_torch.kernels.threshold import threshold_reduce
from repro_torch.query import compile as compile_mod
from repro_torch.query.device import encode_idx
from repro_torch.query.state import export_state, load_reference_state

ROWS = 70_001  # ragged: the last word is partly padding
_TIMED = ("queries_per_sec", "mean_latency_s")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    return torch.device("cuda")


def _table():
    rng = np.random.default_rng(11)
    return {
        "country": rng.integers(0, 8, ROWS),
        "age": rng.integers(13, 90, ROWS),
        "device": rng.integers(0, 4, ROWS),
    }


def _queries():
    return [
        T.Query(T.Eq("country", 3) & T.Eq("device", 1)),
        T.Query(T.In("device", [1, 2])),
        T.Query(T.Range("age", 17, 71)),
        T.Query(T.Range("age", 17, 71), agg=T.Agg.MASK),
        T.Query(T.Not(T.Eq("country", 2)), agg=T.Agg.MASK),
        T.Query(T.AtLeast(3, [T.In("country", [1, 2, 3]), T.Eq("device", 2),
                              T.In("country", [2, 3, 5]), T.In("device", [2, 3]),
                              T.Not(T.Eq("country", 2))])),
        T.Query(T.Eq("country", 3) & T.Eq("device", 1)),
    ]


def _serve(device, *, optimize, fuse_flush, deploy=None):
    if deploy is None:
        store = T.BitmapStore()
        store.ingest(_table())
        dev = T.FlashDevice(num_planes=4, device=device)
        store.program(dev, warmup=[T.Query(T.In("country", [0, 1, 2]))])
    else:
        store, dev = deploy
    sched = T.BatchScheduler(dev, store, optimize=optimize, fuse_flush=fuse_flush)
    out = []
    for _ in range(2):
        for r in sched.serve(_queries()):
            out.append(r.count if r.count is not None else np.asarray(r.value.words).tolist())
    stats = {k: v for k, v in sched.stats().items() if k not in _TIMED}
    return out, stats, dict(dev.pec)


@pytest.mark.cuda
@pytest.mark.parametrize("optimize", [True, False])
@pytest.mark.parametrize("fuse_flush", [True, False])
def test_serving_on_the_card_matches_the_cpu(cuda, optimize, fuse_flush):
    counts = [mws_gather.launches, popcount.launches, threshold_reduce.launches]
    got = _serve(cuda, optimize=optimize, fuse_flush=fuse_flush)
    want = _serve("cpu", optimize=optimize, fuse_flush=fuse_flush)
    assert got == want
    launched = [mws_gather.launches, popcount.launches, threshold_reduce.launches]
    assert all(b > a for a, b in zip(counts, launched))


@pytest.mark.cuda
def test_loaded_state_serves_on_the_card(cuda):
    store = T.BitmapStore()
    store.ingest(_table())
    dev = T.FlashDevice(num_planes=4, device="cpu")
    store.program(dev)
    loaded = load_reference_state(*export_state(store, dev), device=cuda)
    assert loaded[1].device.type == "cuda"
    got = _serve(cuda, optimize=True, fuse_flush=True, deploy=loaded)
    want = _serve("cpu", optimize=True, fuse_flush=True, deploy=(store, dev))
    assert got[0] == want[0]


@pytest.mark.cuda
def test_eager_engine_on_the_card(cuda):
    """fc_read with spills and noisy reads: ESP pages exact, the non-ESP
    page flipped at its modelled rate on both devices alike (same seed,
    same generator: the flips are drawn on the host)."""
    rng = np.random.default_rng(5)
    names = ["c1", "c2", "c3", "c4"]
    words = {n: rng.integers(0, 2**32, 4099, dtype=np.uint32) for n in names}
    expr = and_(or_(Page("c1"), Page("c2")), or_(Page("c3"), Page("c4")))
    results = []
    for device in ("cpu", cuda):
        arr = FlashArray(device=device)
        for wl, n in enumerate(names):
            arr.layout.place(n, 0, wl, inverted=True)
            arr.fc_write(n, words[n], esp=n != "c4")
        arr.pec[0] = 10_000
        results.append(to_uint32(arr.fc_read(expr)))
    np.testing.assert_array_equal(results[0], results[1])


@pytest.mark.cuda
def test_hoisted_bmi_flush_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """The paper's five BMI windows in one flush: the card senses each of
    their 25 distinct commands once (one streaming launch) and folds the
    five AND chains (one staged launch), and gives the CPU's counts and
    MASK words bit for bit; so does a flush in which plans that do not
    fold read a command the folds hoist, inverted and over two blocks, and
    sense it themselves."""
    built = []
    group_execs = compile_mod.group_execs

    def recorded(*args, **kwargs):
        built.append(group_execs(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(compile_mod, "group_execs", recorded)
    users, days = (1 << 17) + 5, 1095
    bits = day_bits(users, days, 9)
    windows = [T.And([T.Eq(day_column(t), 1) for t in range(days - w, days)])
               for w in (30, 182, 365, 730, 1095)]
    either = windows[0] | T.And([T.Eq(day_column(t), 1) for t in range(30)])
    mixed = [T.Not(either), either, either & T.Not(T.Eq(day_column(40), 1))]
    got = []
    for device in ("cpu", cuda):
        store = bmi_store(bits)
        dev = T.FlashDevice(num_planes=4, device=device)
        store.program(dev, warmup=[T.Query(p) for p in windows])
        sched = T.BatchScheduler(dev, store, optimize=True)
        before = dict(mws_gather.variant_launches)
        out = [r.count for r in sched.serve([T.Query(p) for p in windows])]
        out += [np.asarray(r.value.words).tolist()
                for r in sched.serve([T.Query(p, agg=T.Agg.MASK) for p in windows])]
        if device != "cpu":
            assert {k: v - before[k] for k, v in mws_gather.variant_launches.items()} == {
                "streaming": 2, "staged": 2}
        assert sched.telemetry.gauges["sense_commands_hoisted"] == 32
        # beside the folds, plans that do not fold run as group_execs built
        # them: a two-block command the folds hoist, plain and inverted
        out += [r.count for r in sched.serve([T.Query(p) for p in mixed] + [T.Query(p) for p in windows])]
        (program,) = [p for k, p in sched._flush_programs.items() if len(k[0]) == 8]
        unfolded = [(sig, stacked)
                    for (sig, _m, stacked), f in zip(built[-1], program.key[4][2]) if not f]
        assert any(st.inverse and st.shape[0] == 2 for sig, _ in unfolded for st in sig)
        for idxs, (sig, stacked) in zip(program.group_idxs, unfolded, strict=True):
            for x, want in zip(idxs, encode_idx(sig, stacked), strict=True):
                np.testing.assert_array_equal(x.cpu().numpy(), want)
        stats = {k: v for k, v in sched.stats().items() if k not in _TIMED}
        got.append((out, stats, dict(dev.pec)))
    assert got[0] == got[1]
