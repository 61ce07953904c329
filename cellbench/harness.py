"""Run one cell of ``BENCHMARK.json`` once.

Everything is found by name (:func:`plugins`): the cell names its
configuration and its traffic mix; the configuration file names its
system adapter (``systems/<system>.py``), its plain reference
(``reference/<reference>.py``), its data maker (``data/<data>.py``) and
its least-work reckoner (``work/<work>.py``); the mix names its loop
(``traffic/<loop>.py``) and its generator (``generators/<generator>.py``);
every metric is read by ``metrics/<metric>.py``.  A configuration or mix
that names no data maker, reckoner or generator gets the BMI ones
(``days``, ``days``, ``windows``).  Every query carries its own aggregate.
So a later change adds a cell, a configuration, a mix or a metric, of
any data and any aggregates, as new files and entries, and edits none of
these.

A run: the data from the seed, the program built from it through the
system's public entry, warm-up on the cell's own traffic, the measured
window, the metrics, then (with the program's state freed) every answer
of the window held against the reference.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from cellbench import trace as tr
from cellbench.record import Client, Recording
from cellbench.tables import num_words
from cellbench.traffic.generator import load_json, load_mix, rng_for

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "cellbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(bench: dict, workload: str) -> tuple[dict, dict]:
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return cell, config


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (untraced) or per-layer ones (traced):
    every metric that lists the cell, or lists no cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"cellbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plugins(config: dict, mix: dict) -> SimpleNamespace:
    """The modules a configuration and its mix name, each found by name.
    Without a ``data``, ``work`` or ``generator`` entry the BMI ones;
    ``"work": null`` names no reckoner, and the readers of least work
    then read nothing."""
    work = config.get("work", "days")
    return SimpleNamespace(
        data=importlib.import_module(f"cellbench.data.{config.get('data', 'days')}"),
        work=None if work is None else importlib.import_module(f"cellbench.work.{work}"),
        system=importlib.import_module(f"cellbench.systems.{config['system']}"),
        reference=importlib.import_module(f"cellbench.reference.{config['reference']}"),
        generator=importlib.import_module(f"cellbench.generators.{mix.get('generator', 'windows')}"),
        loop=importlib.import_module(f"cellbench.traffic.{mix['loop']}"),
    )


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def judge(rec: Recording, reference, words: int) -> tuple[dict, int]:
    """Every answer of the window against the reference, each by its own
    aggregate: wrong answers (COUNT, SUM, AVG, GROUP BY and the rest by
    equality; MASKs of the wrong length), words that differ in the kept
    MASKs, and queries never answered; with the number of queries that
    failed."""
    wrong = wrong_words = unanswered = masks_checked = masks_wrong = 0
    for i, (pred, agg, _, _, done) in enumerate(rec.queries):
        if done is None:
            unanswered += 1
            continue
        if agg[0] == "mask":
            if rec.mask_lengths[i] != words:
                wrong += 1
            got = rec.masks.get(i)
            if got is not None:
                want = reference.mask_words(pred)
                differ = int(np.count_nonzero(got != want)) if got.shape == want.shape else words
                wrong_words += differ
                masks_wrong += differ > 0
                masks_checked += 1
        elif rec.values[i] != reference.answer(pred, agg):
            wrong += 1
    log(
        f"checked {len(rec.queries) - unanswered} answers, {masks_checked} of "
        f"{len(rec.mask_lengths)} MASKs word by word"
    )
    checks = {
        "wrong_answers": {"value": wrong, "limit": 0},
        "wrong_mask_words": {"value": wrong_words, "limit": 0},
        "unanswered": {"value": unanswered, "limit": 0},
    }
    return checks, wrong + masks_wrong + unanswered


def host_peak_bytes() -> int:
    """The process's peak resident memory on the host."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def run_cell(
    workload: str,
    seed: int,
    seconds: float,
    trace: bool,
    *,
    device: str = "cuda",
    t_start: float | None = None,
    config_override: dict | None = None,
) -> dict:
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    on_card = torch.device(device).type == "cuda"
    bench = load_benchmark()
    cell, centry = find_cell(bench, workload)
    config = {**load_json(ROOT / centry["file"]), **(config_override or {})}
    mix = load_mix(cell["traffic"])
    mods = plugins(config, mix)
    traffic = mods.generator.make(mix, seed, config)

    data, rows = mods.data.make(config, seed, device)
    t_table = time.perf_counter()
    system = mods.system.System(config, data, traffic, device, telemetry_enabled=trace)
    t_built = time.perf_counter()
    warm = Client(system, Recording())
    mods.loop.warm(warm, traffic)
    t_warm = time.perf_counter()
    log(
        f"set-up: imports and data {t_table - t_start:.3f} s, store and program {t_built - t_table:.3f} s, "
        f"warm-up {t_warm - t_built:.3f} s; warm-up flushes (s): "
        + " ".join(f"{b - a:.3f}" for a, b, _ in warm.rec.flushes)
    )
    del warm

    rec = Recording(mask_offset=int(rng_for(seed, 4).integers(1 << 30)))
    client = Client(system, rec)
    device_trace = tr.DeviceTrace() if trace and on_card else None
    counters0 = system.counters()
    gc.collect()
    gc.freeze()
    if device_trace is not None:
        device_trace.start()
    t0, t1 = mods.loop.drive(client, traffic, seconds)
    if on_card:
        torch.cuda.synchronize()
    events = device_trace.stop() if device_trace is not None else None
    gc.unfreeze()
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    counters = {k: v - counters0.get(k, 0) for k, v in system.counters().items()}
    spans = [s for s in system.spans() if s[3] >= t0 and s[4] <= t1 + 1e-3]
    answered = rec.answered
    log(
        f"window: {t1 - t0:.3f} s, {len(rec.queries)} queries submitted, {answered} answered, "
        f"{len(rec.flushes)} flushes"
    )
    if rec.flushes:
        times = np.array([b - a for a, b, _ in rec.flushes]) * 1e3
        log(
            f"flush ms p50 {np.percentile(times, 50)} p95 {np.percentile(times, 95)} max {times.max()}; "
            f"device peak {memory_peak} bytes, host peak {host_peak_bytes()} bytes"
        )

    ctx = SimpleNamespace(
        cell=cell,
        config=config,
        mix=mix,
        setup_s=t0 - t_start,
        t0=t0,
        t1=t1,
        window_s=t1 - t0,
        answered=answered,
        flushes=len(rec.flushes),
        counters=counters,
        spans=spans,
        events=events,
        peak=None,
        work=None,
    )
    if trace:
        kind = torch.cuda.get_device_name(0) if on_card else "cpu"
        ctx.peak = load_json(HERE / "peaks.json").get(kind)
        if mods.work is not None:
            ctx.work = [
                mods.work.reckon(config, rows, [tuple(rec.queries[i][:2]) for i in done]) for _, _, done in rec.flushes
            ]
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = load_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result: dict = {
        "correct": False,
        "attempted": len(rec.queries),
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": memory_peak,
        },
    }
    if trace and events is not None:
        busy = tr.busy_seconds(events, t0, t1)
        result["device"]["busy_s"] = busy
        result["device"]["window_s"] = t1 - t0
        host = [(f"program:{n}", a, b) for n, _, tid, a, b in spans if tid != "tickets"]
        host += [("client:flush", a, b) for a, b, _ in rec.flushes]
        result["breakdown"] = {
            "device_ops": tr.top_ops(events),
            "idle_gaps": tr.idle_gaps(events, t0, t1, host),
        }

    # the program's state goes before the reference runs
    system.close()
    del system, client, data
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    reference = mods.reference.Reference(config, seed, traffic, device=device)
    checks, failed = judge(rec, reference, num_words(rows))
    reference.close()
    log(f"reference and check: {time.perf_counter() - t_ref:.3f} s")
    result["failed"] = failed
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result
