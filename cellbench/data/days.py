"""The BMI data: one activity bitmap per day, one bit per user
(``tables.make_days``), handed to the adapter as host ``uint32`` words.
Its rows are the configuration's users."""

from __future__ import annotations

import numpy as np
import torch

from cellbench.tables import make_days, to_host


def make(config: dict, seed: int, device) -> tuple[np.ndarray, int]:
    """The (days, words) bitmaps on the host, and the users they span."""
    days = make_days(config, seed, device)
    bitmaps = to_host(days)
    del days
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return bitmaps, int(config["users"])
