"""Input specs (meta-device stand-ins) and demo batches per arch x shape.

The ``*_input_specs`` feed the dry-run: meta tensors (shapes and dtypes,
no memory) and the reference's logical partition specs for them.  Token
ids are int32 and a decode step's offset a 0-d int32, as the reference
declares them (the port's data pipeline hands int64 ids, and its decode
offsets are host ints).  ``demo_batch`` builds small real batches for
tests.  The modality frontends are stubs: audio frames and vision patches
arrive as precomputed embeddings.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.sharding import P
from repro_torch.models.config import ArchConfig, ShapeConfig

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _stub_inputs(cfg: ArchConfig, B: int, S: int):
    inputs = {"tokens": _meta((B, S), torch.int32)}
    specs = {"tokens": P("data", None)}
    if cfg.family == "audio":
        inputs["frames"] = _meta((B, S, cfg.d_model), cfg.cdtype)
        specs["frames"] = P("data", None, None)
    if cfg.family == "vlm":
        inputs["patch_embeds"] = _meta((B, cfg.num_patch_tokens, cfg.d_model), cfg.cdtype)
        specs["patch_embeds"] = P("data", None, None)
    return inputs, specs


def train_input_specs(cfg: ArchConfig, shape: ShapeConfig):
    B, S = shape.global_batch, shape.seq_len
    inputs, specs = _stub_inputs(cfg, B, S)
    batch = {"inputs": inputs, "labels": _meta((B, S), torch.int32)}
    return batch, {"inputs": specs, "labels": P("data", None)}


def prefill_input_specs(cfg: ArchConfig, shape: ShapeConfig):
    inputs, specs = _stub_inputs(cfg, shape.global_batch, shape.seq_len)
    return {"inputs": inputs}, {"inputs": specs}


def decode_input_specs(cfg: ArchConfig, shape: ShapeConfig):
    """(cache, tokens, offset) and their specs for one decode step at kv
    length ``seq_len``; an audio cache holds ``seq_len`` encoder frames."""
    from repro_torch.models.registry import get_model

    B, S = shape.global_batch, shape.seq_len
    model = get_model(cfg)
    kwargs = {"enc_len": S} if cfg.family == "audio" else {}
    cache = model.init_kv_cache(cfg, B, S, device=META, **kwargs)
    tok, off = _meta((B, 1), torch.int32), _meta((), torch.int32)
    return (cache, tok, off), (model.kv_cache_specs(cfg), P("data", None), P())


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
