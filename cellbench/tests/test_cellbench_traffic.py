"""The traffic and the day bitmaps are deterministic by seed, and every
file the benchmark names loads by name."""

import json

import numpy as np
import pytest
from _setup import ROOT

from cellbench.harness import find_cell, load_benchmark, load_reader, metrics_of
from cellbench.tables import make_days, num_words, tail_mask
from cellbench.traffic.generator import Traffic, load_mix, window_days

BENCH = load_benchmark(ROOT)
MIXES = sorted({c["traffic"] for c in BENCH["workloads"]})


def test_windows_are_the_papers():
    mix = load_mix("bmi-count")
    assert [window_days(m, mix["days_per_month"]) for m in mix["months"]] == [30, 182, 365, 730, 1095]


def test_every_seed_asks_the_same_windows_in_its_own_order():
    mix = load_mix("bmi-count")
    a, b, c = Traffic(mix, 2**31 + 17, 1095), Traffic(mix, 2**31 + 17, 1095), Traffic(mix, 2**33 + 1, 1095)
    assert a.take() == b.take() == a.take()
    assert sorted(a.take()) == sorted(c.take()) and len(a.take()) == 5
    orders = {tuple(Traffic(mix, s, 1095).take()) for s in range(20)}
    assert len(orders) > 1


def test_a_window_longer_than_the_days_held_is_refused():
    import pytest

    with pytest.raises(ValueError):
        Traffic(load_mix("bmi-count"), 1, 1000)


def test_days_are_deterministic_by_seed_and_clean_past_the_last_user():
    cfg = {"users": 4000, "days": 60}
    a, b, c = make_days(cfg, 2**40 + 3), make_days(cfg, 2**40 + 3), make_days(cfg, 2**40 + 4)
    assert a.shape == (60, num_words(4000)) and a.dtype.is_signed
    assert bool((a == b).all()) and not bool((a == c).all())
    assert bool((a[:, -1] & ~tail_mask(4000) == 0).all())


def test_every_window_keeps_its_own_share_of_users():
    cfg = {"users": 1 << 14, "days": 100}
    d = make_days(cfg, 9).numpy().view(np.uint32)
    bits = np.unpackbits(d.view(np.uint8), axis=1, bitorder="little")[:, : cfg["users"]].astype(bool)
    kept = [int(np.logical_and.reduce(bits[100 - n :], axis=0).sum()) for n in (3, 10, 30, 60, 100)]
    assert kept == sorted(kept, reverse=True) and len(set(kept)) == 5
    # streaks: about 1 - sqrt(30 / 101) of the users hold every one of the last 30 days
    assert abs(kept[2] / cfg["users"] - (1 - (30 / 101) ** 0.5)) < 0.03
    assert 0.55 < bits.mean() < 0.8


def test_every_named_file_loads():
    for cell in BENCH["workloads"]:
        _, config = find_cell(BENCH, cell["name"])
        cfg = json.loads((ROOT / config["file"]).read_text())
        assert cfg["name"] == config["name"]
        assert set(config["reduced"]) <= set(cfg["published"])
        assert all(cfg[k] != cfg["published"][k] for k in config["reduced"])
        assert (ROOT / "cellbench" / "systems" / f"{cfg['system']}.py").is_file()
        assert (ROOT / "cellbench" / "reference" / f"{cfg['reference']}.py").is_file()
        for m in metrics_of(BENCH, cell["name"], False) + metrics_of(BENCH, cell["name"], True):
            assert callable(load_reader(m["name"]).read)
    for mix in MIXES:
        assert (ROOT / "cellbench" / "traffic" / f"{load_mix(mix)['loop']}.py").is_file()


def test_benchmark_json_keeps_to_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for cell in BENCH["workloads"]:
        assert cell["chips"] == 1 and len(cell["why"]) <= 200
        assert metrics_of(BENCH, cell["name"], True)


@pytest.mark.parametrize("seed", [5, 2**31 + 3, 2**62 + 11])
def test_the_default_plugins_give_what_the_bmi_functions_give(seed):
    from cellbench.data import days
    from cellbench.generators import windows
    from cellbench.harness import plugins
    from cellbench.reference.work import flush_work
    from cellbench.tables import to_host
    from cellbench.work import days as days_work

    _, entry = find_cell(BENCH, "bmi.count")
    cfg = {**json.loads((ROOT / entry["file"]).read_text()), "users": 4000}
    mix = load_mix("bmi-count")
    mods = plugins(cfg, mix)
    assert (mods.data, mods.generator, mods.work) == (days, windows, days_work)

    data, rows = mods.data.make(cfg, seed, "cpu")
    want = to_host(make_days(cfg, seed))
    assert rows == 4000 and (data.dtype, data.shape) == (want.dtype, want.shape)
    assert data.tobytes() == want.tobytes()

    traffic, plain = mods.generator.make(mix, seed, cfg), Traffic(mix, seed, 1095)
    assert traffic.take() == plain.take()
    assert traffic.queries() == [(p, plain.agg) for p in plain.take()]
    for agg in (("count",), ("mask",)):
        members = [(p, agg) for p in plain.take()]
        assert mods.work.reckon(cfg, rows, members) == flush_work(num_words(4000), members)
