"""The reference against a brute-force numpy AND over unpacked bits."""

import numpy as np
import pytest
import torch
from _setup import ROOT  # noqa: F401

from cellbench.reference.days import DaysReference, count_bits
from cellbench.tables import make_days

CFG = {"users": 5000, "days": 200}


def brute(days: np.ndarray, users: int, n: int) -> np.ndarray:
    bits = np.unpackbits(days.view(np.uint8), axis=1, bitorder="little")[:, :users].astype(bool)
    return np.logical_and.reduce(bits[days.shape[0] - n :], axis=0)


@pytest.mark.parametrize("seed", [1, 2**31 + 9, 2**62 + 5])
def test_counts_and_masks_equal_brute_force(seed):
    windows = [1, 30, 182, 200]
    ref = DaysReference(CFG, seed, windows)
    days = make_days(CFG, seed).numpy().view(np.uint32)
    for n in windows:
        sel = brute(days, CFG["users"], n)
        assert ref.answer(("days", n), ("count",)) == int(sel.sum())
        span = np.zeros(ref.mask_words(("days", n)).size * 32, bool)
        span[: CFG["users"]] = sel
        assert np.array_equal(ref.mask_words(("days", n)), np.packbits(span, bitorder="little").view(np.uint32))


def test_count_bits_counts_every_bit():
    w = torch.tensor([-1, 0, 1, -(2**31), 0x0F0F0F0F], dtype=torch.int32)
    assert count_bits(w) == 32 + 0 + 1 + 1 + 16


def test_other_questions_are_refused():
    ref = DaysReference(CFG, 3, [30])
    with pytest.raises(ValueError):
        ref.answer(("days", 30), ("sum", "x"))
