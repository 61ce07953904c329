"""The least work of a flush of BMI windows (``reference.work.flush_work``)
over pages of the data's rows."""

from __future__ import annotations

from cellbench.reference.work import flush_work
from cellbench.tables import num_words


def reckon(config: dict, rows: int, members: list[tuple]) -> dict:
    """Least bytes and operations of one flush of ``(pred, agg)`` members."""
    return flush_work(num_words(rows), members)
