"""Closed loop: a client with a backlog submits the next flush's queries
every time a flush returns.

The window ends with the flush in flight when ``seconds`` have passed:
it is finished and counted, and the window's time runs to its end.
"""

from __future__ import annotations

import time

from cellbench.record import Client


def run_batches(client: Client, traffic, until: float | None, flushes: int | None) -> float:
    """Submit a flush's queries, flush until they are answered; repeat
    until the clock passes ``until`` (checked before each batch) or
    ``flushes`` batches are done.  Returns the time the last answer
    returned."""
    t_end = time.perf_counter()
    n = 0
    while (until is None or t_end < until) and (flushes is None or n < flushes):
        now = time.perf_counter()
        for pred, agg in traffic.queries():
            client.submit(pred, agg, now)
        while client.outstanding:
            if not client.flush() and not client.system.pending:
                break  # unanswered queries stay unanswered: the check counts them
        t_end = time.perf_counter()
        n += 1
    return t_end


def warm(client: Client, traffic) -> None:
    """The mix's own flushes, so every shape the window uses has run."""
    run_batches(client, traffic, None, traffic.mix["warmup_flushes"])


def drive(client: Client, traffic, seconds: float) -> tuple[float, float]:
    """The measured window; returns its start and end."""
    t0 = time.perf_counter()
    t1 = run_batches(client, traffic, t0 + seconds, None)
    return t0, t1
