"""Assigned architecture configs (public-literature numbers, per task table).

``get_config(arch_id)`` returns the full-size config; ``--arch`` ids match
the assignment.  The modules are data, copied from the reference package
so the port never imports it.
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "xlstm-350m",
    "starcoder2-3b",
    "yi-34b",
    "granite-8b",
    "command-r-plus-104b",
    "whisper-medium",
    "deepseek-v2-lite-16b",
    "kimi-k2-1t-a32b",
    "internvl2-26b",
    "recurrentgemma-2b",
]


def get_config(arch_id: str):
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_")
    )
    return mod.CONFIG
