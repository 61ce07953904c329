"""The BMI windows' traffic (the ``windows`` generator,
``generators/windows.py``), and what every generator shares: the seed's
random streams and the mix files.

A mix (``traffic/<mix>.json``) names its loop, the windows of the paper's
BMI query ("users active on every one of the last m months", ``months``),
and the aggregate each query asks for (``agg``: ``["count"]`` or
``["mask"]``).  A window of m months is ``round(days_per_month * m)``
days, as the port's ``flashsim.workloads.bmi_workload`` counts them.

The traffic emits plain specs: a predicate ``("days", d)`` (active on
every one of the last d days) and an aggregate tuple.  Neither the program
nor the reference is imported here.  A flush asks every window once; the
run's seed sets their order, so every seed does the same work in another
order.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def freeze(x):
    """JSON lists -> tuples, recursively (specs must be hashable)."""
    if isinstance(x, list):
        return tuple(freeze(v) for v in x)
    return x


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator per (seed, stream); any whole seed."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_mix(name: str) -> dict:
    return load_json(HERE / f"{name}.json")


def window_days(months: int, days_per_month: float) -> int:
    return round(days_per_month * months)


class Traffic:
    """A mix bound to a seed: the predicates in the seed's order, and the
    aggregate every query asks for."""

    def __init__(self, mix: dict, seed: int, days: int):
        self.mix = mix
        self.seed = seed
        windows = [window_days(m, mix["days_per_month"]) for m in mix["months"]]
        if max(windows) > days:
            raise ValueError(f"a window of {max(windows)} days is longer than the {days} days held")
        order = rng_for(seed, 0).permutation(len(windows))
        self.preds = [("days", windows[i]) for i in order]
        self.agg = freeze(mix["agg"])

    def take(self) -> list[tuple]:
        """One flush's predicates: every window once, in the seed's order."""
        return list(self.preds)

    def queries(self) -> list[tuple]:
        """One flush's queries as ``(pred, agg)`` pairs, in the seed's order."""
        return [(p, self.agg) for p in self.preds]
