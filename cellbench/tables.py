"""The data of a configuration, made from the run's seed: one activity
bitmap per day, one bit per user (the paper's BMI index).

Both sides get these bitmaps: the program programs them, the reference
works its answers out from them.  They are drawn on the run's device with
a ``torch.Generator`` in a few large calls, so the same seed gives the
same bitmaps on that device.

Activity (the configuration's ``assumed``): each user has a streak, the
number of days up to the newest on which the user was active every day,
``floor((days + 1) * v * v)`` for ``v`` uniform in [0, 1); on every other
day the user is active with probability 1/2.  So every window of the
paper keeps a different share of the users.
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32


def num_words(users: int) -> int:
    return -(-int(users) // WORD_BITS)


def tail_mask(users: int) -> int:
    """The valid bits of the last word, as a signed 32-bit pattern."""
    r = int(users) % WORD_BITS
    m = (1 << r) - 1 if r else 0xFFFFFFFF
    return m - (1 << 32) if m >= 1 << 31 else m


def make_days(config: dict, seed: int, device="cpu") -> torch.Tensor:
    """The (days, words) int32 bitmaps, oldest day first, on ``device``;
    the slack bits of the last word are 0."""
    users, days = int(config["users"]), int(config["days"])
    words = num_words(users)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    v = torch.rand(users, generator=gen, device=device, dtype=torch.float64)
    streak = ((days + 1) * v * v).floor().to(torch.int64).clamp_(max=days)
    del v
    # each user's bit set on the first day of its streak (bits of one word
    # are distinct, so adding them sets them), then carried to every later day
    out = torch.zeros((days, words), dtype=torch.int32, device=device)
    user = torch.arange(users, dtype=torch.int64, device=device)
    on = streak > 0
    bit = torch.ones_like(user[on]) << (user[on] % WORD_BITS)
    bit = torch.where(bit >= 1 << 31, bit - (1 << 32), bit).to(torch.int32)
    out.view(-1).index_add_(0, (days - streak[on]) * words + user[on] // WORD_BITS, bit)
    del streak, user, on, bit
    for t in range(1, days):
        out[t] |= out[t - 1]
    # every other day: active with probability 1/2
    block = 64
    for t in range(0, days, block):
        n = min(block, days - t)
        out[t : t + n] |= torch.randint(
            -(2**31), 2**31, (n, words), generator=gen, dtype=torch.int32, device=device
        )
    out[:, -1] &= tail_mask(users)
    return out


def to_host(days: torch.Tensor) -> np.ndarray:
    """The bitmaps as host ``uint32`` words (one copy)."""
    return days.cpu().numpy().view(np.uint32)
