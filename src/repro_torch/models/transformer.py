"""Dense decoder-only transformer (starcoder2 / yi / granite / command-r).

Parameters mirror the reference's pytree leaf for leaf: every per-layer
weight is ONE stacked ``(L, ...)`` tensor (the reference's ``lax.scan``
layout), and layer ``i`` reads its slice.  The forward unbinds each stack
once, so autograd stacks the per-layer gradients back into one
``(L, ...)`` gradient per leaf.  With ``cfg.remat`` each layer runs under
``torch.utils.checkpoint`` (non-reentrant), which keeps only the layer's
input, as the reference's ``nothing_saveable`` policy does.  The
reference's sharding constraints have no counterpart on one device.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    attention_fwd,
    embed_fwd,
    init_attention,
    init_embedding,
    init_layernorm,
    init_mlp,
    init_rmsnorm,
    layernorm_fwd,
    mlp_fwd,
    rmsnorm_fwd,
    unembed_fwd,
)
from repro_torch.models.state import flatten, unflatten_into

_SERVING = "LM serving (prefill/decode) is not ported yet: ROADMAP A8b"


def _init_norm(cfg, d, dtype, device, leading=()):
    init = init_rmsnorm if cfg.norm == "rmsnorm" else init_layernorm
    return init(d, dtype, device, leading=leading)


def _norm_fwd(cfg, p, x):
    return rmsnorm_fwd(p, x) if cfg.norm == "rmsnorm" else layernorm_fwd(p, x)


def layer_fwd(cfg: ArchConfig, lp, x):
    h = _norm_fwd(cfg, lp["norm1"], x)
    x = x + attention_fwd(
        lp["attn"],
        h,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        rope_theta=cfg.rope_theta,
        use_rope=cfg.use_rope,
        impl=cfg.attention_impl,
    )
    h = _norm_fwd(cfg, lp["norm2"], x)
    return x + mlp_fwd(lp["mlp"], h, cfg.activation)


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda"):
    """Random parameters from ``seed`` (a torch generator on ``device``;
    not the reference's numbers — cross over with
    :func:`repro_torch.models.state.params_from_reference`)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L, d, dt = (cfg.n_layers,), cfg.d_model, cfg.pdtype
    layers = {
        "attn": init_attention(
            gen,
            d,
            cfg.n_heads,
            cfg.n_kv_heads,
            cfg.resolved_head_dim,
            dt,
            device,
            bias=cfg.attn_bias,
            leading=L,
        ),
        "mlp": init_mlp(
            gen,
            d,
            cfg.d_ff,
            dt,
            device,
            gated=(cfg.activation == "silu"),
            bias=cfg.mlp_bias,
            leading=L,
        ),
        "norm1": _init_norm(cfg, d, dt, device, leading=L),
        "norm2": _init_norm(cfg, d, dt, device, leading=L),
    }
    return {
        "embed": init_embedding(gen, cfg.vocab, d, dt, device),
        "layers": layers,
        "final_norm": _init_norm(cfg, d, dt, device),
    }


def _unstack(stacked) -> list:
    """One dict of layer-``i`` views per layer, from the stacked leaves."""
    flat = flatten(stacked)
    slices = {k: v.unbind(0) for k, v in flat.items()}
    n = len(next(iter(slices.values())))
    return [unflatten_into(stacked, {k: s[i] for k, s in slices.items()}) for i in range(n)]


def forward(cfg: ArchConfig, params, tokens):
    """Training forward: tokens (B, S) -> logits (B, S, vocab) in f32.
    (The VLM backbone's patch embeddings wait for ROADMAP A8c.)"""
    x = embed_fwd(params["embed"], tokens, cfg.cdtype)
    for lp in _unstack(params["layers"]):
        if cfg.remat:
            x = checkpoint(layer_fwd, cfg, lp, x, use_reentrant=False)
        else:
            x = layer_fwd(cfg, lp, x)
    x = _norm_fwd(cfg, params["final_norm"], x)
    return unembed_fwd(params["embed"], x)


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int):
    raise NotImplementedError(_SERVING)


def decode_step(cfg: ArchConfig, params, cache, tokens, offset):
    raise NotImplementedError(_SERVING)


def prefill(cfg: ArchConfig, params, tokens, max_len, patch_embeds=None):
    raise NotImplementedError(_SERVING)
