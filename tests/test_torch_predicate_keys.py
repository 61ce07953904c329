"""Each predicate tree is walked and hashed once; each plan key hashed once.

A composite predicate (``And``, ``Or``, ``Not``, ``AtLeast``) and an
``In`` keep their hash and the set of columns they read after the first
walk, and ``QueryCompiler.compile`` interns every plan-cache key as one
``PlanKey`` with its hash computed once.  So a repeat flush of the BMI
windows (30 to 1,095 ``Eq`` leaves each) hashes and validates its queries
in O(1) per query.  Held here: equality, ``repr`` and the dataclass fields
are the reference's; a kept hash never crosses a pickle (string hashes are
salted per process); admission still checks every column against the
store as it is now; the ``predicate_walks`` gauge counts the walks.
"""

import copy
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro_torch.query as T
from _bmi import bmi_store, day_bits, day_column, window as _window
from repro_torch.query import ast as port_ast
from repro_torch.query.ast import pred_columns, walked
from repro_torch.query.compile import PlanKey
from repro_torch.query.oracle import np_select

ROOT = Path(__file__).resolve().parents[1]
USERS = 256
DAYS = 1095
WINDOWS = (30, 182, 365, 730, 1095)
GAUGE = "predicate_walks"


def _tree(M, n=40):
    kids = [M.Eq(f"c{i:03d}", i % 3) for i in range(n)]
    return M.And(kids + [M.Not(M.In("x", [3, 1, 2])), M.Or([M.Range("y", 1, 9), M.Eq("z", 0)])])


def _nodes(M):
    return [
        M.Eq("a", 1),
        M.In("a", [3, 1, 1]),
        M.Range("a", None, 4),
        M.Not(M.Eq("a", 1)),
        M.AtLeast(2, [M.Eq("a", 1), M.Eq("b", 2), M.In("c", [1, 2])]),
        _tree(M),
        M.Query(_tree(M), agg=M.Sum("v"), tag="t"),
        M.Query(M.Eq("a", 1), agg=M.GroupBy("k", M.Avg("v"))),
        M.TopK("a", 3),
        M.Count(),
    ]


# -- the kept hash -------------------------------------------------------------


def test_equal_nodes_built_apart_hash_and_compare_equal():
    for a, b in zip(_nodes(T), _nodes(T)):
        assert a is not b and a == b and hash(a) == hash(b), a
        assert hash(a) == hash(a) == hash(b)  # kept, and the same again
    p = _tree(T)
    assert T.And(p.children) == p and T.Or(p.children) != p
    assert T.Query(p, tag="x") == T.Query(p, tag="y")
    assert hash(T.Query(p, tag="x")) == hash(T.Query(p, tag="y"))
    assert T.Query(p) != T.Query(p, agg=T.Agg.MASK)
    assert {_tree(T): 1}.get(_tree(T)) == 1


def test_repr_fields_and_replace_are_the_reference_s():
    R = pytest.importorskip("repro.query")
    for mine, theirs in zip(_nodes(T), _nodes(R)):
        hash(mine)  # the kept digest is not part of what follows
        assert repr(mine) == repr(theirs)
        assert [(f.name, f.compare, f.hash) for f in dataclasses.fields(mine)] == [
            (f.name, f.compare, f.hash) for f in dataclasses.fields(theirs)
        ]
    q = T.Query(_tree(T), tag="a")
    hash(q)
    r = dataclasses.replace(q, tag="b")
    assert r == q and hash(r) == hash(q) and r.tag == "b"
    s = dataclasses.replace(q.where, children=q.where.children[:3])
    assert s != q.where and not walked(s) and s == T.And(q.where.children[:3])


def test_copies_compute_their_own_hash():
    p = _tree(T)
    h = hash(p)
    assert walked(p)
    for c in (copy.copy(p), copy.deepcopy(p), pickle.loads(pickle.dumps(p))):
        assert not walked(c) and c == p and hash(c) == h and walked(c)


_WRITER = """
import pickle, sys
import repro_torch.query as T
from repro_torch.query.compile import PlanKey
q = T.Query(T.And([T.Eq(f"c{i:03d}", i % 3) for i in range(40)] + [T.Not(T.In("x", [3, 1, 2]))]))
k = PlanKey((("and", ("p", "c000=0"), ("p", "x=1")), (("c000=0", 3),), (("c000", 1, 0),)))
sys.stdout.buffer.write(pickle.dumps((q, k, hash(q), hash(q.where), hash(k))))
"""

_READER = """
import pickle, sys
import repro_torch.query as T
from repro_torch.query.ast import walked
from repro_torch.query.compile import PlanKey
q, k, hq, hw, hk = pickle.loads(sys.stdin.buffer.read())
assert not walked(q.where), "a kept hash crossed the pickle"
mine = T.Query(T.And([T.Eq(f"c{i:03d}", i % 3) for i in range(40)] + [T.Not(T.In("x", [3, 1, 2]))]))
key = PlanKey((("and", ("p", "c000=0"), ("p", "x=1")), (("c000=0", 3),), (("c000", 1, 0),)))
queries, keys = {mine: "query"}, {key: "key"}
print(queries.get(q), keys.get(k), hash(q.where) != hw, hash(k) != hk, hash(q) != hq)
"""


def test_pickled_node_finds_its_entry_under_another_hash_seed():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    blob = subprocess.run(
        [sys.executable, "-c", _WRITER],
        env={**env, "PYTHONHASHSEED": "1"},
        capture_output=True,
        check=True,
        timeout=120,
    ).stdout
    out = subprocess.run(
        [sys.executable, "-c", _READER],
        env={**env, "PYTHONHASHSEED": "2"},
        input=blob,
        capture_output=True,
        check=True,
        timeout=120,
    ).stdout.decode()
    # found in the reader's dicts, under hashes that differ from the writer's
    assert out.split() == ["query", "key", "True", "True", "True"], out


def test_pred_columns_is_the_set_columns_of_walks():
    for p in [n for n in _nodes(T) if isinstance(n, port_ast.Pred)]:
        assert pred_columns(p) == set(port_ast.columns_of(p))
    with pytest.raises(TypeError, match="not a FlashQL predicate"):
        pred_columns(T.And([T.Eq("a", 1), "junk"]))
    with pytest.raises(TypeError, match="not a FlashQL predicate"):
        hash(T.Not("junk"))


# -- the compiler's keys -------------------------------------------------------


def _table(seed=0, n=600):
    rng = np.random.default_rng(seed)
    return {
        "country": rng.integers(0, 8, n),
        "age": rng.integers(13, 90, n),
        "device": rng.integers(0, 4, n),
    }


def _scheduler(table, reserve=0):
    store = T.BitmapStore()
    store.ingest(table, reserve_rows=reserve)
    dev = T.FlashDevice(num_planes=4, device="cpu")
    store.program(dev)
    return T.BatchScheduler(dev, store)


def test_a_fresh_equal_query_hits_the_compile_cache_and_shares_its_key():
    sched = _scheduler(_table())
    comp = sched.compiler
    a, b = T.Eq("country", 3), T.Range("age", 18, 35)
    first = comp.compile(T.Query(a & b))
    hits, misses = comp.hits, comp.misses
    again = comp.compile(T.Query(T.Eq("country", 3) & T.Range("age", 18, 35)))
    assert (comp.hits, comp.misses) == (hits + 1, misses)
    assert again.cache_hit and again.key is first.key
    # operands commuted: another front-cache entry, the same interned key
    swapped = comp.compile(T.Query(b & a, agg=T.Agg.MASK))
    assert swapped.key is first.key and isinstance(first.key, PlanKey)
    assert comp.exec_for(swapped) is comp.exec_for(first)


def test_stale_interned_keys_are_swept_with_the_plans():
    table = _table(1)
    sched = _scheduler(table, reserve=64)
    comp = sched.compiler
    q = T.Query(T.Eq("country", 3) & T.Range("age", 18, 35))
    sched.serve([q])
    old = comp.compile(q).key
    assert comp.key_fresh(old) and any(k is old for k in comp._keys)
    # a new value in "country" moves that column's epoch
    sched.append({"country": np.full(4, 9), "age": np.full(4, 20), "device": np.zeros(4, int)})
    (r,) = sched.serve([q])
    new = comp.compile(q).key
    assert not comp.key_fresh(old) and new != old and new.parts[0] == old.parts[0]
    assert all(k is not old for k in comp._keys) and old not in comp._plans
    table = {c: np.concatenate([v, np.full(4, x)]) for (c, v), x in zip(table.items(), (9, 20, 0))}
    assert r.value == int(np_select(q.where, table, len(table["age"])).sum())


# -- admission -----------------------------------------------------------------


def test_admission_checks_every_column_against_the_store_as_it_is_now():
    table = _table(2)
    sched = _scheduler(table)
    q = T.Query(T.Eq("country", 3) & T.Not(T.In("device", [1, 2])), agg=T.Sum("age"))
    sched.serve([q])
    assert walked(q.where)
    with pytest.raises(KeyError, match="unknown column 'ghost'"):
        sched.submit(T.Query(T.Eq("country", 3) & T.Eq("ghost", 1)))
    with pytest.raises(KeyError, match="ghost"):
        sched.submit(T.Query(q.where, agg=T.Sum("ghost")))  # a walked tree, a bad target
    with pytest.raises(KeyError, match="ghost"):
        sched.submit(T.Query(q.where, agg=T.GroupBy("ghost")))
    # "device" leaves the store: the same Query object is refused again
    sched.store.rebuild({c: v for c, v in table.items() if c != "device"})
    with pytest.raises(KeyError, match="unknown column 'device'"):
        sched.submit(q)
    assert sched.pending == 0
    # and a target column that left: the predicate's columns are all there
    sched.store.rebuild({"country": table["country"], "device": table["device"]})
    with pytest.raises(KeyError, match="age"):
        sched.submit(T.Query(T.Eq("country", 3) & T.Not(T.In("device", [1, 2])), agg=T.Sum("age")))


# -- the gauge on the BMI windows ------------------------------------------------


@pytest.fixture(scope="module")
def bmi():
    """The BMI store at a small size, placed for the five windows."""
    bits = day_bits(USERS, DAYS, 11)
    store = bmi_store(bits)
    dev = T.FlashDevice(num_planes=4, device="cpu")
    store.program(dev, warmup=[_window(DAYS - w, DAYS) for w in WINDOWS])
    table = {day_column(t): bits[t] for t in range(DAYS)}
    return store, dev, table


def _flush(sched, queries):
    for q in queries:
        sched.submit(q)
    out = sched.flush()
    return [out[t].value for t in sorted(out)]


def test_predicate_walks_reads_five_then_none(bmi):
    store, dev, table = bmi
    sched = T.BatchScheduler(dev, store, optimize=True, materialize_after=None)
    queries = [_window(DAYS - w, DAYS) for w in WINDOWS]
    want = [int(np_select(q.where, table, USERS).sum()) for q in queries]
    assert _flush(sched, queries) == want
    assert sched.telemetry.gauges[GAUGE] == len(WINDOWS)
    for _ in range(2):
        assert _flush(sched, queries) == want
        assert sched.telemetry.gauges[GAUGE] == 0
    assert GAUGE not in sched.telemetry.counters and GAUGE not in sched.stats()
    assert sched.compiler.misses == len(WINDOWS)


def test_fresh_equal_queries_walk_each_tree_once_a_flush(bmi):
    store, dev, table = bmi
    sched = T.BatchScheduler(dev, store, optimize=True, materialize_after=None)
    want = None
    for flush in range(3):
        queries = [_window(DAYS - w, DAYS) for w in WINDOWS]
        if want is None:
            want = [int(np_select(q.where, table, USERS).sum()) for q in queries]
        assert _flush(sched, queries) == want
        assert sched.telemetry.gauges[GAUGE] == len(WINDOWS)
        assert sched.compiler.hits == len(WINDOWS) * flush
    assert sched.compiler.misses == len(WINDOWS)
