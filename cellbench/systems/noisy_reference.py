"""The control: the plain reference put in the program's place, with one
guarantee of the configuration broken.

The configuration guarantees exact answers from ESP-programmed pages.
This system answers from the reference, then lets every result bitmap
take the raw bit errors of pages programmed without ESP (``rber`` of the
configuration's ``control`` entry): a COUNT gains and loses
Binomial-distributed users, a MASK has that many bits flipped.  The
harness's check must call it wrong.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from cellbench.reference.days import Reference
from cellbench.traffic.generator import rng_for


class System:
    def __init__(self, config: dict, bitmaps: np.ndarray, traffic, device, telemetry_enabled: bool):
        self.ref = Reference(config, traffic.seed, traffic, device=device)
        self.users = int(config["users"])
        self.rber = float(config["control"]["rber"])
        self.rng = rng_for(traffic.seed, 5)
        self._pending: list[tuple[int, tuple, tuple]] = []
        self._next = 0

    def submit(self, pred, agg) -> int:
        ticket = self._next
        self._next += 1
        self._pending.append((ticket, pred, agg))
        return ticket

    def _noisy(self, pred, agg):
        if agg[0] == "mask":
            words = self.ref.mask_words(pred).copy()
            flips = self.rng.integers(0, self.users, self.rng.binomial(self.users, self.rber))
            np.bitwise_xor.at(words, flips // 32, (np.uint32(1) << (flips % 32).astype(np.uint32)))
            return SimpleNamespace(words=words)
        exact = self.ref.answer(pred, agg)
        return exact - self.rng.binomial(exact, self.rber) + self.rng.binomial(self.users - exact, self.rber)

    def flush(self) -> dict:
        batch, self._pending = self._pending, []
        return {t: self._noisy(p, a) for t, p, a in batch}

    @property
    def pending(self) -> int:
        return len(self._pending)

    def counters(self) -> dict:
        return {}

    def spans(self) -> list:
        return []

    def close(self) -> None:
        self.ref.close()
