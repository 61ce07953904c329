"""arch-family -> model implementation dispatch.

The port implements the ``dense`` family; every other family raises,
naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from types import SimpleNamespace

from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig


def get_model(cfg: ArchConfig) -> SimpleNamespace:
    if cfg.family != "dense":
        raise NotImplementedError(f"the {cfg.family!r} family is not ported yet: ROADMAP A8c")
    return SimpleNamespace(
        init_params=transformer.init_params,
        forward=transformer.forward,
        prefill=transformer.prefill,
        decode_step=transformer.decode_step,
        init_kv_cache=transformer.init_kv_cache,
    )
