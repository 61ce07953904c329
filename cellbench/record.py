"""The client side of a run: what was submitted, when, and what came back.

The loop drives the system through :class:`Client`, which stamps every
query with the time it was due and the time its answer returned to the
caller, keeps every non-MASK answer and every MASK's length for the check
after the window, and a copy of one MASK's words in ``MASK_EVERY`` (from
an offset drawn from the seed): a MASK is a whole bitmap, too large to
keep each one of a window.  Each query carries its own aggregate.
"""

from __future__ import annotations

import time

import numpy as np

MASK_EVERY = 8


class Recording:
    def __init__(self, mask_offset: int = 0):
        self.mask_offset = mask_offset % MASK_EVERY
        # per query: [pred, agg, t_due, t_submit, t_done]
        self.queries: list[list] = []
        self.values: dict[int, object] = {}  # query -> non-MASK answer
        self.masks: dict[int, np.ndarray] = {}  # query -> kept MASK words
        self.mask_lengths: dict[int, int] = {}  # query -> words of any MASK
        self.flushes: list[tuple[float, float, list[int]]] = []
        self.masks_seen = 0

    @property
    def answered(self) -> int:
        return sum(1 for q in self.queries if q[4] is not None)


class Client:
    """Submits plain query specs to a system and records answers."""

    def __init__(self, system, rec: Recording):
        self.system = system
        self.rec = rec
        self._tickets: dict[int, int] = {}  # ticket -> query index

    @property
    def outstanding(self) -> int:
        return len(self._tickets)

    def submit(self, pred, agg, t_due: float) -> None:
        t = time.perf_counter()
        ticket = self.system.submit(pred, agg)
        self._tickets[ticket] = len(self.rec.queries)
        self.rec.queries.append([pred, agg, t_due, t, None])

    def flush(self) -> int:
        """One flush of the system; returns the answers it brought."""
        rec = self.rec
        t0 = time.perf_counter()
        results = self.system.flush()
        t1 = time.perf_counter()
        done = []
        for ticket, value in results.items():
            i = self._tickets.pop(ticket)
            query = rec.queries[i]
            query[4] = t1
            done.append(i)
            if query[1][0] == "mask":
                words = value.words
                rec.mask_lengths[i] = int(np.shape(words)[-1])
                if rec.masks_seen % MASK_EVERY == rec.mask_offset:
                    rec.masks[i] = np.array(words, dtype=np.uint32)
                rec.masks_seen += 1
            else:
                rec.values[i] = value
        rec.flushes.append((t0, t1, done))
        return len(done)
