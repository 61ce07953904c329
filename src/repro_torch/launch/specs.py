"""Demo batches per arch.

Only ``demo_batch`` is ported: the reference's ``*_input_specs`` functions
describe TPU dry-run cells (ROADMAP "Not ported, by decision").  The
modality frontends are stubs: audio frames and vision patches arrive as
precomputed embeddings.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig


def demo_batch(cfg: ArchConfig, batch: int, seq: int, seed: int = 0, device="cuda"):
    """Small concrete training batch, drawn from ``np.random.default_rng(seed)``
    in the reference's order, so a seed gives the reference's very tokens,
    ``frames`` and ``patch_embeds`` (tokens as int64, the torch index type)."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq + 1))).to(device)
    inputs = {"tokens": tokens[:, :-1]}
    if cfg.family == "audio":
        frames = rng.normal(size=(batch, seq, cfg.d_model)).astype(np.float32)
        inputs["frames"] = torch.from_numpy(frames).to(device, cfg.cdtype)
    if cfg.family == "vlm":
        patches = rng.normal(size=(batch, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
        inputs["patch_embeds"] = torch.from_numpy(patches).to(device, cfg.cdtype)
    return {"inputs": inputs, "labels": tokens[:, 1:]}
