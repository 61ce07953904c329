"""arch-family -> model implementation dispatch.

The port implements the ``dense``, ``vlm`` (the dense backbone with patch
embeddings prepended) and ``moe`` families; ``ssm``, ``hybrid`` and
``audio`` raise, naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from types import SimpleNamespace

from repro_torch.models import moe, transformer
from repro_torch.models.config import ArchConfig

_FAMILY_MODULES = {
    "dense": transformer,
    "vlm": transformer,
    "moe": moe,
}


def get_model(cfg: ArchConfig) -> SimpleNamespace:
    mod = _FAMILY_MODULES.get(cfg.family)
    if mod is None:
        raise NotImplementedError(f"the {cfg.family!r} family is not ported yet: ROADMAP A8c")
    return SimpleNamespace(
        init_params=mod.init_params,
        forward=mod.forward,
        prefill=mod.prefill,
        decode_step=mod.decode_step,
        init_kv_cache=mod.init_kv_cache,
    )
