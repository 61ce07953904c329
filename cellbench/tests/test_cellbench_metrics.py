"""The metric readers on synthetic profiler events and spans: known answers,
and a union of device activity that is not a sum."""

from types import SimpleNamespace

import pytest
from _setup import ROOT  # noqa: F401

from cellbench import trace as tr
from cellbench.harness import load_reader

PEAK = {"hbm_bytes_per_s": 1000.0, "int32_ops_per_s": 1e9}
EVENTS = [
    (0.10, 0.30, "void (anonymous namespace)::mws_gather_kernel<0, 4>(...)"),
    (0.20, 0.40, "void (anonymous namespace)::mws_staged_kernel<0>(...)"),  # overlaps the first
    (0.50, 0.60, "void (anonymous namespace)::popcount_kernel<4>(...)"),
    (0.60, 0.80, "Memcpy DtoH (Device -> Pageable)"),  # a copy: busy, not a launch
]


def ctx(**kw):
    base = dict(
        t0=0.0, t1=1.0, window_s=1.0, flushes=2, answered=50, events=EVENTS,
        spans=[], counters={}, peak=PEAK, setup_s=12.5,
        work=[{"sense_bytes": 100, "reduce_bytes": 30, "payload_bytes": 20, "ops": 0}] * 2,
    )
    return SimpleNamespace(**{**base, **kw})


def read(name, **kw):
    return load_reader(name).read(ctx(**kw))


def test_idle_share_takes_the_union_not_the_sum():
    # busy: [0.1, 0.4] + [0.5, 0.8] = 0.6 of 1.0; the sum of events would say 0.7
    assert read("idle_share") == pytest.approx(40.0)
    assert tr.busy_seconds(EVENTS, 0.0, 1.0) == pytest.approx(0.6)
    assert tr.busy_seconds(EVENTS, 0.25, 0.55) == pytest.approx(0.2)


def test_rooflines_and_mfu():
    # B1: 200 bytes at 1000 B/s = 0.2 s bound over 0.4 s of B1 kernels
    assert read("b1_roofline") == pytest.approx(50.0)
    # B2: 60 bytes -> 0.06 s over 0.1 s of popcount
    assert read("b2_roofline") == pytest.approx(60.0)
    # flush bound 0.15 s each, two flushes, 1 s window
    assert read("mfu.flush") == pytest.approx(30.0)
    assert read("b1_roofline", events=[e for e in EVENTS if "mws" not in e[2]]) is None
    # a MASK flush has nothing to count: no B2 share, not 0
    masks = [{"sense_bytes": 100, "reduce_bytes": 0, "payload_bytes": 20, "ops": 0}] * 2
    assert read("b2_roofline", work=masks) is None


def test_launches_and_rates():
    assert read("launches_per_flush") == 1.5
    assert read("qps") == 50.0 and read("qps", window_s=0.0) is None
    assert read("setup_s") == 12.5


def test_span_and_counter_readers():
    spans = [("compile", "flush", "flush", 0.0, 0.01), ("dispatch", "flush", "flush", 0.01, 0.31),
             ("plan_compile", "compile", "compile", 0.0, 0.005), ("compile", "flush", "flush", 0.5, 0.53)]
    assert read("compile_ms_per_flush", spans=spans) == pytest.approx(20.0)
    assert read("dispatch_ms_per_flush", spans=spans) == pytest.approx(150.0)
    assert read("dispatch_ms_per_flush") is None
    assert read("wordlines_per_query", counters={"queries_served": 4, "wordlines_sensed": 6}) == 1.5
    assert read("wordlines_per_query") is None


def test_device_readers_are_silent_without_a_trace():
    for name in ("idle_share", "launches_per_flush", "b1_roofline", "b2_roofline"):
        assert read(name, events=None) is None
    assert read("mfu.flush", peak=None) is None


def test_work_counts_shared_days_once():
    from cellbench.reference.work import flush_work, least_seconds

    members = [(("days", 30), ("count",)), (("days", 182), ("count",)), (("days", 30), ("count",))]
    w = flush_work(10, members)
    # 182 day pages + the valid page read, 2 distinct results written, 2 counted
    assert w == {"sense_bytes": (182 + 1 + 2) * 40, "reduce_bytes": 2 * 40, "payload_bytes": 3 * 8, "ops": 183 * 10}
    m = flush_work(10, [(("days", 30), ("mask",))])
    assert m["reduce_bytes"] == 0 and m["payload_bytes"] == 40
    assert least_seconds(w, PEAK) == pytest.approx((w["sense_bytes"] + w["reduce_bytes"] + 24) / 1000.0)


def test_idle_gaps_name_the_innermost_host_span():
    host = [("client:flush", 0.0, 1.0), ("program:compile", 0.0, 0.1), ("program:reduce", 0.4, 0.5)]
    gaps = dict(tr.idle_gaps(EVENTS, 0.0, 1.0, host))
    assert gaps == {"program:compile": pytest.approx(0.1), "program:reduce": pytest.approx(0.1),
                    "client:flush": pytest.approx(0.2)}
    assert tr.top_ops(EVENTS, 1)[0][1] == pytest.approx(0.2)


@pytest.mark.cuda
def test_device_trace_aligns_to_the_host_clock(cuda):
    import time

    import torch

    dt = tr.DeviceTrace()
    x = torch.ones(1 << 24, device="cuda")
    dt.start()
    t0 = time.perf_counter()
    time.sleep(0.05)
    t1 = time.perf_counter()
    x.mul_(2)
    torch.cuda.synchronize()
    events = dt.stop()
    assert events and all(t1 - 0.005 < a for a, _, _ in events)
    assert tr.busy_seconds(events, t0, t1) < 0.005
