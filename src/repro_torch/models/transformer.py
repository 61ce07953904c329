"""Dense decoder-only transformer (starcoder2 / yi / granite / command-r),
and the VLM backbone (internvl2: patch embeddings prepended).

Parameters mirror the reference's pytree leaf for leaf: every per-layer
weight is ONE stacked ``(L, ...)`` tensor (the reference's ``lax.scan``
layout), and layer ``i`` reads its slice.  The forward unbinds each stack
once, so autograd stacks the per-layer gradients back into one
``(L, ...)`` gradient per leaf.  With ``cfg.remat`` each layer runs under
``torch.utils.checkpoint`` (non-reentrant), which keeps only the layer's
input, as the reference's ``nothing_saveable`` policy does.
:func:`param_specs` and :func:`kv_cache_specs` give the reference's
logical partition specs, and ``constrain`` sits where the reference's
does (a no-op on plain tensors and one-rank meshes).

Serving keeps the reference's ``{"k", "v"}`` cache of shape
``(L, B, max_len, n_kv, hd)``, but writes each step's K/V into it in
place and hands back the same dict (ROADMAP C11): a cache passed to
``decode_step`` is not the cache it was before.  Offsets are host ints.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import P, constrain, lay_out_like, stacked
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    attention_fwd,
    attention_specs,
    embed_fwd,
    embedding_specs,
    init_attention,
    init_embedding,
    init_generator,
    init_layernorm,
    init_mlp,
    init_rmsnorm,
    layernorm_fwd,
    layernorm_specs,
    mlp_fwd,
    mlp_specs,
    rmsnorm_fwd,
    rmsnorm_specs,
    unembed_fwd,
)
from repro_torch.models.state import unstack


def _init_norm(cfg, d, dtype, device, leading=()):
    init = init_rmsnorm if cfg.norm == "rmsnorm" else init_layernorm
    return init(d, dtype, device, leading=leading)


def _norm_specs(cfg):
    return rmsnorm_specs() if cfg.norm == "rmsnorm" else layernorm_specs()


def _norm_fwd(cfg, p, x):
    return rmsnorm_fwd(p, x) if cfg.norm == "rmsnorm" else layernorm_fwd(p, x)


def layer_fwd(cfg: ArchConfig, lp, x, *, kv_cache=None, cache_offset=None, window=None):
    h = _norm_fwd(cfg, lp["norm1"], x)
    h = constrain(h, "data", None, None)
    x = x + attention_fwd(
        lp["attn"],
        h,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        rope_theta=cfg.rope_theta,
        use_rope=cfg.use_rope,
        window=window,
        kv_cache=kv_cache,
        cache_offset=cache_offset,
        impl=cfg.attention_impl,
    )
    # the attention's output arrives partial over "model": the residual
    # and the MLP's input on "data", whole, so the MLP splits over both
    # axes, forward and backward (ROADMAP C23)
    x = constrain(x, "data", None, None)
    h = _norm_fwd(cfg, lp["norm2"], x)
    h = constrain(h, "data", None, None)
    x = x + mlp_fwd(lp["mlp"], h, cfg.activation)
    return constrain(x, "data", None, None)


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda"):
    """Random parameters from ``seed`` (a torch generator on ``device``;
    not the reference's numbers — cross over with
    :func:`repro_torch.models.state.params_from_reference`)."""
    gen = init_generator(seed, device)
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


def layer_specs(cfg: ArchConfig):
    return {
        "attn": attention_specs(bias=cfg.attn_bias),
        "mlp": mlp_specs(gated=(cfg.activation == "silu"), bias=cfg.mlp_bias),
        "norm1": _norm_specs(cfg),
        "norm2": _norm_specs(cfg),
    }


def param_specs(cfg: ArchConfig):
    """The reference's logical partition specs of :func:`init_params`' tree."""
    return {
        "embed": embedding_specs(),
        "layers": stacked(layer_specs(cfg)),
        "final_norm": _norm_specs(cfg),
    }


def _embed(cfg, params, tokens, patch_embeds):
    x = embed_fwd(params["embed"], tokens, cfg.cdtype)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(cfg.cdtype), x], dim=1)
    return x


def forward(cfg: ArchConfig, params, tokens, patch_embeds=None):
    """Training forward: tokens (B, S) -> logits (B, S, vocab) in f32.

    ``patch_embeds`` (the VLM's stub frontend): (B, N_patch, d) embeddings
    prepended to the token embeddings; logits only for the token
    positions (the patch positions are dropped before the unembedding,
    which is per position)."""
    x = constrain(_embed(cfg, params, tokens, patch_embeds), "data", None, None)
    for lp in unstack(params["layers"]):
        if cfg.remat:
            x = checkpoint(layer_fwd, cfg, lp, x, use_reentrant=False)
        else:
            x = layer_fwd(cfg, lp, x)
    x = x[:, x.shape[1] - tokens.shape[1] :]
    x = _norm_fwd(cfg, params["final_norm"], x)
    return constrain(unembed_fwd(params["embed"], x), "data", None, "model")


# ---------------------------------------------------------------------------
# Serving: KV cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda"):
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.cdtype, device=device),
    }


def kv_cache_specs(cfg: ArchConfig):
    kv = P(None, "data", None, "model", None)
    return {"k": kv, "v": kv}


def _cached_layers(cfg, params, x, cache, offset):
    for i, lp in enumerate(unstack(params["layers"])):
        kv = (cache["k"][i], cache["v"][i])
        x = layer_fwd(cfg, lp, x, kv_cache=kv, cache_offset=offset)
    return x


@torch.no_grad()
def decode_step(cfg: ArchConfig, params, cache, tokens, offset):
    """One decode step: tokens (B, 1) at absolute cache slot ``offset`` (a
    host int) -> (logits (B, 1, vocab), cache written in place)."""
    x = constrain(embed_fwd(params["embed"], tokens, cfg.cdtype), "data", None, None)
    x = _cached_layers(cfg, params, x, cache, offset)
    x = _norm_fwd(cfg, params["final_norm"], x)
    return constrain(unembed_fwd(params["embed"], x), "data", None, "model"), cache


@torch.no_grad()
def prefill(cfg: ArchConfig, params, tokens, max_len, patch_embeds=None):
    """Run the whole prompt, filling a new cache; returns the logits of the
    last position and the cache.  VLM: the patch embeddings occupy the
    first ``num_patch_tokens`` cache slots, so decode offsets are absolute
    cache positions (n_patch + tokens seen)."""
    cache = lay_out_like(init_kv_cache(cfg, tokens.shape[0], max_len, tokens.device), kv_cache_specs(cfg), tokens)
    x = constrain(_embed(cfg, params, tokens, patch_embeds), "data", None, None)
    x = _cached_layers(cfg, params, x, cache, 0)
    x = _norm_fwd(cfg, params["final_norm"], x[:, -1:, :])
    return unembed_fwd(params["embed"], x), cache
