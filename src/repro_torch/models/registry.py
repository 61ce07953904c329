"""arch-family -> model implementation dispatch: every family of the
reference has its counterpart."""

from __future__ import annotations

from types import SimpleNamespace

from repro_torch.models import encdec, moe, rglru, transformer, xlstm
from repro_torch.models.config import ArchConfig

_FAMILY_MODULES = {
    "dense": transformer,
    "vlm": transformer,  # + patch-embedding stub inputs
    "moe": moe,
    "ssm": xlstm,
    "hybrid": rglru,
    "audio": encdec,  # + frame-embedding stub inputs
}


def get_model(cfg: ArchConfig) -> SimpleNamespace:
    mod = _FAMILY_MODULES[cfg.family]
    return SimpleNamespace(
        init_params=mod.init_params,
        forward=mod.forward,
        prefill=mod.prefill,
        decode_step=mod.decode_step,
        init_kv_cache=mod.init_kv_cache,
        param_specs=mod.param_specs,
        kv_cache_specs=mod.kv_cache_specs,
    )
