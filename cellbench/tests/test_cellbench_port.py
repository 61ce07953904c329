"""The port on the CPU (its kernels' plain versions) against the reference,
through the whole harness, for every cell at 4,000 users; the store the
adapter fills equals the one ``ingest`` builds; the control and planted
faults must come out not correct."""

import json
import subprocess
import sys

import numpy as np
import pytest
from _setup import ROOT, TINY

from cellbench import harness
from cellbench.harness import load_benchmark, run_cell

CELLS = [c["name"] for c in load_benchmark(ROOT)["workloads"]]
# the harness serves MASK queries (``"agg": ["mask"]``) for a later cell that
# reads the result bitmaps out; these tests hold that path here
MASK = "bmi.mask"
MASK_MIX = {"loop": "closed", "months": [1, 6, 12, 24, 36], "days_per_month": 30.4166, "agg": ["mask"],
            "warmup_flushes": 3}


@pytest.fixture
def with_mask_cell(monkeypatch):
    bench = load_benchmark(ROOT)
    bench["workloads"].append({"name": MASK, "config": "bmi1095d-1dev", "traffic": "bmi-mask", "chips": 1})
    load_mix = harness.load_mix
    monkeypatch.setattr(harness, "load_benchmark", lambda root=ROOT: bench)
    monkeypatch.setattr(harness, "load_mix", lambda name: MASK_MIX if name == "bmi-mask" else load_mix(name))


def run(cell, **kw):
    return run_cell(cell, 2**31 + 5, 0.5, False, device="cpu", config_override={**TINY, **kw.pop("cfg", {})}, **kw)


@pytest.mark.parametrize("cell", CELLS + [MASK])
def test_port_matches_reference(cell, with_mask_cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == {"wrong_answers", "wrong_mask_words", "unanswered"}
    assert list(r)[-1] == "checks"


def test_the_store_equals_what_ingest_builds():
    from repro_torch import query as q

    from cellbench.systems.flashql import build_store, day_column
    from cellbench.tables import make_days

    users = 1000
    days = make_days({"users": users, "days": 7}, 4).numpy().view(np.uint32)
    bits = np.unpackbits(days.view(np.uint8), axis=1, bitorder="little")[:, :users]
    ingested = q.BitmapStore()
    ingested.ingest({day_column(t): bits[t] for t in range(7)})
    built = build_store(days, users)
    assert built.columns == ingested.columns and built.column_epochs == ingested.column_epochs
    assert (built.num_rows, built.words, built.epoch) == (ingested.num_rows, ingested.words, ingested.epoch)
    assert list(built.logical) == list(ingested.logical)
    for name, words in ingested.logical.items():
        assert np.array_equal(built.logical[name], words), name


@pytest.mark.parametrize("cell", CELLS + [MASK])
def test_control_is_not_correct(cell, with_mask_cell):
    r = run(cell, cfg={"system": "noisy_reference", "control": {"rber": 0.01}})
    assert not r["correct"]
    assert r["checks"]["wrong_answers"]["value"] + r["checks"]["wrong_mask_words"]["value"] > 0


@pytest.fixture
def plant(monkeypatch):
    """Replace a method of the program for one test."""
    return monkeypatch.setattr


def flush_altered(plant, change):
    from repro_torch.query import BatchScheduler

    flush = BatchScheduler.flush

    def altered(self):
        out = flush(self)
        change(out)
        return out

    plant(BatchScheduler, "flush", altered)


def test_altered_count_is_caught(plant):
    def plus_one(out):
        r = next(iter(out.values()))
        object.__setattr__(r, "value", r.value + 1)

    flush_altered(plant, plus_one)
    r = run("bmi.count")
    assert not r["correct"] and r["checks"]["wrong_answers"]["value"] > 0


def test_altered_mask_bit_is_caught(plant, with_mask_cell):
    def flip(out):
        for r in out.values():
            words = np.array(r.value.words, dtype=np.uint32)
            words[-1] ^= 1
            object.__setattr__(r.value, "words", words)

    flush_altered(plant, flip)
    r = run("bmi.mask")
    assert not r["correct"] and r["checks"]["wrong_mask_words"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS + [MASK])
def test_an_answer_left_out_is_caught(plant, cell, with_mask_cell):
    def drop(out):
        if out:
            out.pop(next(iter(out)))

    flush_altered(plant, drop)
    r = run(cell)
    assert not r["correct"] and r["checks"]["unanswered"]["value"] > 0


def test_a_window_short_of_its_oldest_day_is_caught(plant):
    from cellbench.systems import flashql

    query = flashql.System.query

    def shorter(self, pred, agg):
        return query(self, ("days", pred[1] - 1), agg)

    plant(flashql.System, "query", shorter)
    r = run("bmi.count")
    assert not r["correct"] and r["checks"]["wrong_answers"]["value"] > 0


def test_run_loads_no_jax_and_no_reference_package():
    code = (
        "import sys, json; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src'];"
        "from cellbench.harness import run_cell, forbidden_modules;"
        "r = run_cell('bmi.count', 3, 0.3, False, device='cpu', config_override={'users': 4000});"
        "print(json.dumps({'correct': r['correct'], 'forbidden': forbidden_modules(),"
        " 'tops': sorted({m.split('.')[0] for m in sys.modules})}))"
    )
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, timeout=300)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["forbidden"] == []
    assert "repro_torch" in res["tops"] and not {"jax", "jaxlib", "flax", "repro"} & set(res["tops"])


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload", "bmi.count", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_outside_a_checkout_exits_nonzero(tmp_path):
    import shutil

    shutil.copytree(ROOT / "cellbench", tmp_path / "cellbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload", "bmi.count", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and out.stdout.strip() == ""
