"""A fused flush senses each distinct MWS command once (``hoist_flush``).

The paper's BMI windows (30 to 1,095 days) share their newest days: the
placement gives each window's new days blocks of their own, so the five
plans are chains of single-block commands, and the longer windows repeat
the shorter ones' commands.  The fused flush senses each repeated command
once, and each window's AND chain folds into one gather over the hoisted
rows.  Batch groups that do not fold run their steps as built, whether or
not their plans share commands.
Answers are held against numpy; the counters and gauges the reference
has are held in ``test_torch_query.py``/``test_torch_telemetry.py``.
"""

from collections import Counter

import numpy as np
import pytest

import repro_torch.query as T
from _bmi import bmi_store, day_bits, day_column, window as _window
from repro_torch.core.commands import MWSCommand
from repro_torch.query import compile as compile_mod
from repro_torch.query import device as device_mod
from repro_torch.query.device import encode_idx
from repro_torch.query.oracle import np_select

USERS = 1000
DAYS = 1095
WINDOWS = (30, 182, 365, 730, 1095)
GAUGE = "sense_commands_hoisted"

# the five windows' hoisted stack and folds, pinned (store slots: three
# a day, days of one block consecutive).  A stack row is one block's
# days, (first slot, days); the 30-day window's block also senses the
# valid page (slot 4).  A fold row names the stack rows of one window's
# chain.
STACK = (
    (3201, 30), (2745, 48), (2889, 48), (3033, 48), (3177, 8),
    (2196, 48), (2340, 48), (2484, 48), (2628, 39),
    (1101, 48), (1245, 48), (1389, 48), (1533, 48), (1677, 48), (1821, 48),
    (1965, 48), (2109, 29),
    (6, 48), (150, 48), (294, 48), (438, 48), (582, 48), (726, 48), (870, 48),
    (1014, 29),
)
FOLDS = (
    [0],
    [1, 2, 3, 0, 4],
    [5, 6, 7, 8, 1, 2, 3, 4, 0],
    [9, 10, 11, 12, 13, 14, 15, 5, 6, 7, 1, 2, 3, 8, 0, 16, 4],
    [17, 18, 19, 20, 21, 22, 23, 24, 9, 10, 11, 12, 13, 14, 15, 16,
     5, 6, 7, 8, 1, 2, 3, 4, 0],
)


def _padded(row: list, n: int) -> list:
    """A gather row padded as the program pads it: its first entry repeated."""
    return row + row[:1] * (n - len(row))


@pytest.fixture(scope="module")
def bmi():
    """The BMI store at a small size, placed for the five windows."""
    bits = day_bits(USERS, DAYS, 7)
    store = bmi_store(bits)
    dev = T.FlashDevice(num_planes=4, device="cpu")
    store.program(dev, warmup=[_window(DAYS - w, DAYS) for w in WINDOWS])
    return store, dev, bits.astype(bool)


@pytest.fixture
def built(monkeypatch):
    """The batch groups ``group_execs`` builds for each flush compiled."""
    seen = []
    group_execs = compile_mod.group_execs

    def recorded(*args, **kwargs):
        seen.append(group_execs(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(compile_mod, "group_execs", recorded)
    return seen


@pytest.fixture
def gathers(monkeypatch):
    """Every B1 call of the device program, in order (gather-row shapes)."""
    calls = []
    gather = device_mod.mws_gather

    def counted(src, idx, *args, **kwargs):
        calls.append(tuple(idx.shape))
        return gather(src, idx, *args, **kwargs)

    monkeypatch.setattr(device_mod, "mws_gather", counted)
    return calls


def _commands(sched, queries) -> Counter:
    """Each MWS command of the queries' own plans, by the cells it senses."""
    return Counter(
        tuple((t.block, tuple(t.wordlines)) for t in cmd.targets)
        for q in queries
        for cmd in sched.compiler.compile(q).plan.commands
        if isinstance(cmd, MWSCommand)
    )


def _serve(sched, queries):
    for q in queries:
        sched.submit(q)
    out = sched.flush()
    return [out[t].value for t in sorted(out)]


def test_nested_windows_sense_each_command_once(bmi, gathers, built):
    store, dev, bits = bmi
    sched = T.BatchScheduler(dev, store, optimize=True)
    queries = [_window(DAYS - w, DAYS) for w in WINDOWS]
    assert _serve(sched, queries) == [int(bits[DAYS - w :].all(0).sum()) for w in WINDOWS]
    cmds = _commands(sched, queries)
    repeats = sum(n - 1 for n in cmds.values())
    assert (sum(cmds.values()), len(cmds), repeats) == (57, 25, 32)
    assert sched.telemetry.gauges[GAUGE] == repeats
    # one launch senses the 25 commands, one folds the five chains
    assert gathers == [(25, 1, max(len(c[0][1]) for c in cmds)), (5, 1, 25)]
    assert dev.last_signature_groups == 5
    assert GAUGE not in sched.telemetry.counters
    (program,) = sched._flush_programs.values()
    assert program.key[4] == (((25, 1, 48),), ((False, (5, 1, 25)),), (True,) * 5)
    stack = [
        [first + 3 * d for d in range(days)] + [4] * (k == 0)
        for k, (first, days) in enumerate(STACK)
    ]
    np.testing.assert_array_equal(
        program.hoist_idxs[0][:, 0].numpy(), [_padded(r, 48) for r in stack]
    )
    np.testing.assert_array_equal(
        program.fold_idxs[0][:, 0].numpy(), [_padded(r, 25) for r in FOLDS]
    )

    # beside the folds, plans that do not fold and read a command the
    # folds hoist (a two-block command, read plain and inverted) run as
    # group_execs built them and sense it themselves
    gathers.clear()
    w30, w_old = bits[DAYS - 30 :].all(0), bits[:30].all(0)
    either = queries[0].where | _window(0, 30).where
    mixed = [
        T.Query(T.Not(either)),
        T.Query(either),
        T.Query(either & T.Not(T.Eq(day_column(40), 1))),
    ] + queries
    assert _serve(sched, mixed) == [
        int((~(w30 | w_old)).sum()),
        int((w30 | w_old).sum()),
        int(((w30 | w_old) & ~bits[40]).sum()),
    ] + [int(bits[DAYS - w :].all(0).sum()) for w in WINDOWS]
    (program,) = [p for k, p in sched._flush_programs.items() if len(k[0]) == 8]
    sense, folds, folded = program.key[4]
    assert sum(folded) == 6 and {shape[1] for shape in sense} == {1, 2}
    groups = built[-1]
    assert [(sig, len(members)) for sig, members, _ in groups] == list(program.key[0])
    unfolded = [(sig, stacked) for (sig, _m, stacked), f in zip(groups, folded) if not f]
    assert len(program.group_idxs) == len(unfolded) == 2
    for idxs, (sig, stacked) in zip(program.group_idxs, unfolded):
        for got, want in zip(idxs, encode_idx(sig, stacked), strict=True):
            np.testing.assert_array_equal(got.numpy(), want)
    # past the hoist's and the folds' launches, one B1 call per command
    # the unfolded plans name
    named = _commands(sched, [mixed[0], mixed[2]])
    assert any(n > 1 for n in named.values())
    assert len(gathers) - len(sense) - len(folds) == sum(named.values())
    # the gauge counts what the folds save alone
    folding = _commands(sched, [mixed[1]] + queries)
    assert sched.telemetry.gauges[GAUGE] == sum(n - 1 for n in folding.values())

    # a flush of plans with no common command: the steps run unhoisted,
    # one launch per command, and the gauge reads 0
    gathers.clear()
    disjoint = [_window(DAYS - 30, DAYS), _window(0, 30)]
    assert _serve(sched, disjoint) == [
        int(bits[DAYS - 30 :].all(0).sum()),
        int(bits[:30].all(0).sum()),
    ]
    cmds = _commands(sched, disjoint)
    assert max(cmds.values()) == 1
    assert len(gathers) == sum(cmds.values())
    assert all(shape[0] == 1 for shape in gathers)
    assert sched.telemetry.gauges[GAUGE] == 0
    (program,) = [p for k, p in sched._flush_programs.items() if len(k[0]) == 2]
    assert (program.hoist_idxs, program.fold_idxs, program.key[4]) == ((), (), ())


ROWS = 3000


def _table():
    rng = np.random.default_rng(3)
    return {
        "country": rng.integers(0, 8, ROWS),
        "age": rng.integers(13, 90, ROWS),
        "device": rng.integers(0, 4, ROWS),
    }


def _mixed():
    """Inverse reads, multi-block and threshold senses, spilling chains."""
    five = T.In("country", [1, 2, 3, 4, 5])
    return [
        T.Query(T.Eq("country", 3) & T.Range("age", 18, 35)),
        T.Query(T.In("country", [0, 1, 2]), agg=T.Agg.MASK),
        T.Query(T.Not(T.Eq("device", 1))),
        T.Query(T.Range("age", 17, 71)),
        T.Query(T.AtLeast(2, [T.Eq("country", 1), T.Eq("device", 2), T.Range("age", 20, 40)])),
        T.Query(T.Not(five), agg=T.Agg.MASK),
        T.Query(five & T.Eq("device", 2)),
        T.Query(five | T.Range("age", 30, 60)),
    ]


@pytest.mark.parametrize("optimize", [False, True])
def test_repeats_that_fold_nowhere_keep_the_program(optimize, built):
    """Each query twice in one flush.  Without the optimizer's dedup every
    command repeats, but no batch group is a pure AND chain, so nothing
    folds: a hoist would add a launch to save a few page reads, so the
    flush runs the program it had, with its answers.  With the optimizer
    the duplicates dedupe first."""
    table = _table()
    store = T.BitmapStore()
    store.ingest(table)
    dev = T.FlashDevice(num_planes=4, device="cpu")
    store.program(dev, warmup=[T.Query(T.In("country", [0, 1, 2, 3, 4, 5]))])
    sched = T.BatchScheduler(dev, store, optimize=optimize)
    queries = _mixed() + _mixed()[::-1]
    for q, r in zip(queries, sched.serve(queries)):
        want = np_select(q.where, table, ROWS)
        if r.count is not None:
            assert r.count == int(want.sum()), q
        else:
            words = np.ascontiguousarray(np.asarray(r.value.words)).view(np.uint8)
            got = np.unpackbits(words, bitorder="little")[:ROWS].astype(bool)
            np.testing.assert_array_equal(got, want, err_msg=repr(q))
    (program,) = sched._flush_programs.values()
    assert (program.hoist_idxs, program.fold_idxs, program.key[4]) == ((), (), ())
    assert sched.telemetry.gauges[GAUGE] == program.sensings_hoisted == 0
    assert [(sig, len(members)) for sig, members, _ in built[-1]] == list(program.key[0])
    if not optimize:
        assert max(_commands(sched, queries).values()) > 1
