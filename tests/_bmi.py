"""The paper's BMI index at test size, built through the port alone.

One activity bitmap a day, oldest day first: each user is active on
every day of a streak that ends on the newest day, ``floor((days + 1)
v^2)`` days long for ``v`` uniform on [0, 1), and on each other day with
probability 1/2.  The store is what ``BitmapStore.ingest`` builds from
the 0/1 day columns.  Imports numpy and the port only.
"""

from __future__ import annotations

import numpy as np

import repro_torch.query as T


def day_column(d: int) -> str:
    """The column of day ``d`` (0 is the oldest)."""
    return f"day{d:04d}"


def day_bits(users: int, days: int, seed: int) -> np.ndarray:
    """The ``(days, users)`` 0/1 ``uint8`` activity bitmaps."""
    rng = np.random.default_rng(seed)
    v = rng.random(users)
    streak = np.minimum(np.floor((days + 1) * v * v).astype(np.int64), days)
    bits = rng.integers(0, 2, (days, users), dtype=np.uint8)
    bits |= np.arange(days)[:, None] >= days - streak
    return bits


def bmi_store(bits: np.ndarray) -> T.BitmapStore:
    """The store ``ingest`` builds from the day columns of ``bits``."""
    store = T.BitmapStore()
    store.ingest({day_column(d): row for d, row in enumerate(bits)})
    return store


def window(first: int, last: int) -> T.Query:
    """COUNT of the users active on every day in ``[first, last)``."""
    return T.Query(T.And([T.Eq(day_column(t), 1) for t in range(first, last)]))
