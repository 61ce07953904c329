"""Plain reference for the BMI queries: plain torch over the day bitmaps.

A predicate ``("days", d)`` is "active on every one of the last d days".
The reference makes the bitmaps again from the seed (``tables.make_days``,
the benchmark's own data, never the program's pages), ANDs the days from
the newest back, and at each window's length keeps the running AND: its
bits counted with a byte table (the COUNT) and its words (the MASK).
"""

from __future__ import annotations

import numpy as np
import torch

from cellbench.tables import make_days

# set bits of every byte value
BYTE_BITS = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int64)
CHUNK = 1 << 24  # words per block of the count


def count_bits(words: torch.Tensor) -> int:
    table = BYTE_BITS.to(words.device)
    flat = words.reshape(-1)
    total = 0
    for a in range(0, flat.numel(), CHUNK):
        total += int(table[flat[a : a + CHUNK].view(torch.uint8).long()].sum())
    return total


class DaysReference:
    def __init__(self, config: dict, seed: int, windows, device="cpu"):
        days = make_days(config, seed, device)
        acc = torch.full_like(days[0], -1)
        self._counts: dict[int, int] = {}
        self._masks: dict[int, np.ndarray] = {}
        want = sorted({int(d) for d in windows})
        for n in range(1, max(want) + 1):
            acc &= days[days.shape[0] - n]
            if n in want:
                self._counts[n] = count_bits(acc)
                self._masks[n] = acc.cpu().numpy().view(np.uint32).copy()
        del days, acc

    def answer(self, pred, agg):
        if pred[0] != "days" or agg[0] != "count":
            raise ValueError(f"no answer for {pred!r} {agg!r}")
        return self._counts[int(pred[1])]

    def mask_words(self, pred) -> np.ndarray:
        return self._masks[int(pred[1])]

    def close(self) -> None:
        self._masks.clear()


def Reference(config: dict, seed: int, traffic, device="cpu") -> DaysReference:
    """The reference for a run's traffic: the windows it asks."""
    return DaysReference(config, seed, [p[1] for p in traffic.preds], device=device)
