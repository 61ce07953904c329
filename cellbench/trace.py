"""The device trace of a traced run, and what the readers share of it.

``torch.profiler`` records the card's activity over the window (CUDA
activity only: recording every host op would slow the host-bound program
it measures), and the events stay in memory.  A tiny kernel launched just
after a synchronise ties the trace's clock to ``time.perf_counter``, so
device events and the program's telemetry spans share one time axis.
"""

from __future__ import annotations

import time

COPY_PREFIXES = ("Memcpy", "Memset")


class DeviceTrace:
    def __init__(self):
        import torch

        self._marker = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        self._marker.add_(1)
        torch.cuda.synchronize()

    def stop(self) -> list[tuple[float, float, str]]:
        """Device events as ``(start, end, name)`` on the perf_counter axis,
        the alignment marker left out."""
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.prof.stop()
        evs = sorted(
            (e.time_range.start, e.time_range.end, e.name)
            for e in self.prof.events()
            if e.device_type == DeviceType.CUDA
        )
        self.prof = None
        if not evs:
            return []
        mark = next((i for i, e in enumerate(evs[:8]) if "add" in e[2].lower()), 0)
        offset = evs[mark][0] * 1e-6 - self.t_mark
        return [(a * 1e-6 - offset, b * 1e-6 - offset, name) for i, (a, b, name) in enumerate(evs) if i != mark]


def is_kernel(name: str) -> bool:
    return not name.startswith(COPY_PREFIXES)


def busy_intervals(events, t0: float, t1: float) -> list[tuple[float, float]]:
    """The union of device activity inside ``[t0, t1]``, as disjoint
    intervals (overlapping events count once)."""
    spans = sorted((max(a, t0), min(b, t1)) for a, b, _ in events if b > t0 and a < t1)
    merged: list[list[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_seconds(events, t0: float, t1: float) -> float:
    return sum(b - a for a, b in busy_intervals(events, t0, t1))


def kernel_seconds(events, names: tuple[str, ...]) -> float:
    """Summed time of the kernels whose name holds any of ``names``."""
    return sum(b - a for a, b, n in events if any(k in n for k in names))


def top_ops(events, n: int = 10) -> list[list]:
    total: dict[str, float] = {}
    for a, b, name in events:
        total[name] = total.get(name, 0.0) + (b - a)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], secs] for name, secs in ranked]


def idle_gaps(events, t0: float, t1: float, host_spans, n: int = 10) -> list[list]:
    """Idle time of the device inside the window, summed by the innermost
    host span (``(label, start, end)``) open at each gap's middle."""
    import numpy as np

    busy = busy_intervals(events, t0, t1)
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    names = sorted({s[0] for s in host_spans})
    ids = {name: i for i, name in enumerate(names)}
    bounds = np.unique(np.array([x for s in host_spans for x in s[1:]] or [t0], dtype=np.float64))
    paint = np.full(max(len(bounds) - 1, 0), -1, np.int64)
    # longest first, so the innermost span paints last and wins
    for label, s0, s1 in sorted(host_spans, key=lambda s: s[1] - s[2]):
        paint[np.searchsorted(bounds, s0) : np.searchsorted(bounds, s1)] = ids[label]
    total: dict[str, float] = {}
    for a, b in gaps:
        k = int(np.searchsorted(bounds, (a + b) / 2, side="right")) - 1
        label = names[paint[k]] if 0 <= k < len(paint) and paint[k] >= 0 else "none"
        total[label] = total.get(label, 0.0) + (b - a)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v] for k, v in ranked]
