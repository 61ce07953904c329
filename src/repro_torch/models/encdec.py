"""Whisper-style encoder-decoder backbone (whisper-medium, the ``audio``
family).

The conv/mel frontend is a stub: callers pass precomputed frame
embeddings (B, S_enc, d).  The encoder is a bidirectional self-attention
stack; the decoder is causal self-attention, then cross-attention over
the encoder's output.  Absolute positions (sinusoidal in the encoder,
learned in the decoder), LayerNorm, ungated GELU MLP, MHA with biases.

Parameters mirror the reference's tree leaf for leaf (``enc_layers`` and
``dec_layers`` stacked ``(L, ...)``).  The cache is ``{"k", "v",
"enc_out"}``; decode writes the self-attention K/V in place and returns
the same dict (ROADMAP C11).  The reference's docstring speaks of
precomputed cross-K/V, but its code projects ``enc_out`` through every
layer's ``wk``/``wv`` at every decode step; the port follows the code
(ROADMAP C, "cross-K/V").  A decoder position past the learned table
raises (C14) where the reference's ``dynamic_slice`` clamps.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import P, constrain, lay_out_like, stacked
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    FSDP,
    attention_fwd,
    attention_specs,
    embed_fwd,
    embedding_specs,
    host_offset,
    init_attention,
    init_embedding,
    init_generator,
    init_layernorm,
    init_mlp,
    layernorm_fwd,
    layernorm_specs,
    mlp_fwd,
    mlp_specs,
    unembed_fwd,
)
from repro_torch.models.state import unstack

MAX_DEC_POS = 33024  # learned decoder positions: the reference's table (448 in Whisper)


@functools.lru_cache(maxsize=None)
def _sinusoid(max_len: int, d: int, device: torch.device) -> torch.Tensor:
    """The reference's table in f32 on ``device``, built once per (length,
    d, device): a pageable host copy per ``encode`` would stall the host
    on the card.  Never written to."""
    pos = np.arange(max_len)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10_000.0, 2 * dim / d)
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(table).to(device)


def _attn(gen, cfg, device, leading):
    kw = dict(bias=True, leading=leading)
    return init_attention(
        gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, None, cfg.pdtype, device, **kw
    )


def _mlp(gen, cfg, device, leading):
    kw = dict(gated=False, bias=True, leading=leading)
    return init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.pdtype, device, **kw)


def init_enc_layer(gen, cfg, device=None, leading=()):
    return {
        "attn": _attn(gen, cfg, device, leading),
        "mlp": _mlp(gen, cfg, device, leading),
        "norm1": init_layernorm(cfg.d_model, cfg.pdtype, device, leading),
        "norm2": init_layernorm(cfg.d_model, cfg.pdtype, device, leading),
    }


def init_dec_layer(gen, cfg, device=None, leading=()):
    return {
        "self": _attn(gen, cfg, device, leading),
        "cross": _attn(gen, cfg, device, leading),
        "mlp": _mlp(gen, cfg, device, leading),
        "norm1": init_layernorm(cfg.d_model, cfg.pdtype, device, leading),
        "norm2": init_layernorm(cfg.d_model, cfg.pdtype, device, leading),
        "norm3": init_layernorm(cfg.d_model, cfg.pdtype, device, leading),
    }


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda"):
    """Random parameters from ``seed`` (a torch generator on ``device``;
    not the reference's numbers)."""
    gen = init_generator(seed, device)
    d = cfg.d_model
    dec_pos = torch.randn((MAX_DEC_POS, d), generator=gen, device=device)
    return {
        "embed": init_embedding(gen, cfg.vocab, d, cfg.pdtype, device),
        "enc_layers": init_enc_layer(gen, cfg, device, (cfg.encoder_layers,)),
        "dec_layers": init_dec_layer(gen, cfg, device, (cfg.n_layers,)),
        "dec_pos": dec_pos.mul_(0.01).to(cfg.pdtype),
        "enc_norm": init_layernorm(d, cfg.pdtype, device),
        "dec_norm": init_layernorm(d, cfg.pdtype, device),
    }


def _attn_specs():
    return attention_specs(bias=True)


def param_specs(cfg: ArchConfig):
    """The reference's logical partition specs of :func:`init_params`' tree."""
    mlp = mlp_specs(gated=False, bias=True)
    enc = {"attn": _attn_specs(), "mlp": mlp, "norm1": layernorm_specs(), "norm2": layernorm_specs()}
    dec = {
        "self": _attn_specs(),
        "cross": _attn_specs(),
        "mlp": mlp,
        **{f"norm{i}": layernorm_specs() for i in (1, 2, 3)},
    }
    return {
        "embed": embedding_specs(),
        "enc_layers": stacked(enc),
        "dec_layers": stacked(dec),
        "dec_pos": P(None, FSDP),
        "enc_norm": layernorm_specs(),
        "dec_norm": layernorm_specs(),
    }


def _enc_layer(cfg, lp, h):
    a = layernorm_fwd(lp["norm1"], h)
    h = h + attention_fwd(
        lp["attn"], a, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, use_rope=False, causal=False
    )
    # the attention's output arrives partial over "model": the MLP's input
    # on "data", whole (the decoder's cross-attention's and MLP's too, C23)
    m = constrain(layernorm_fwd(lp["norm2"], h), "data", None, None)
    return constrain(h + mlp_fwd(lp["mlp"], m, "gelu"), "data", None, None)


def encode(cfg: ArchConfig, params, frames):
    """frames: (B, S_enc, d) precomputed embeddings (the frontend stub)."""
    x = frames.to(cfg.cdtype)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device)[None].to(cfg.cdtype)
    x = constrain(x, "data", None, None)
    for lp in unstack(params["enc_layers"]):
        if cfg.remat:
            x = checkpoint(_enc_layer, cfg, lp, x, use_reentrant=False)
        else:
            x = _enc_layer(cfg, lp, x)
    return layernorm_fwd(params["enc_norm"], x)


def _dec_layer(cfg, lp, x, enc_out, kv_cache=None, cache_offset=None):
    a = layernorm_fwd(lp["norm1"], x)
    x = x + attention_fwd(
        lp["self"],
        a,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        use_rope=False,
        kv_cache=kv_cache,
        cache_offset=cache_offset,
    )
    c = constrain(layernorm_fwd(lp["norm2"], x), "data", None, None)
    x = x + attention_fwd(
        lp["cross"],
        c,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        use_rope=False,
        causal=False,
        kv_x=enc_out,
    )
    m = constrain(layernorm_fwd(lp["norm3"], x), "data", None, None)
    return constrain(x + mlp_fwd(lp["mlp"], m, "gelu"), "data", None, None)


def _dec_positions(params, offset: int, S: int):
    """Rows offset..offset+S of the learned table.  The reference's
    ``dynamic_slice_in_dim`` clamps a start past ``MAX_DEC_POS - S`` and
    reuses the last rows; this raises (C14)."""
    n = params["dec_pos"].shape[0]
    if not 0 <= offset <= n - S:
        raise ValueError(f"decoder positions {offset}..{offset + S - 1} outside a table of {n}")
    return params["dec_pos"][offset : offset + S]


def decode_stack(cfg, params, tokens, enc_out, cache=None, offset=0, last_only=False):
    """The decoder over tokens (B, S) at absolute position ``offset`` (a
    host int): logits (B, S, vocab) f32, or only the last position's
    with ``last_only`` (the unembedding is per position).  With a
    ``cache`` each layer's self K/V are written into it in place."""
    offset = host_offset(offset)
    S = tokens.shape[1]
    x = embed_fwd(params["embed"], tokens, cfg.cdtype)
    x = x + _dec_positions(params, offset, S)[None].to(cfg.cdtype)
    x = constrain(x, "data", None, None)
    for i, lp in enumerate(unstack(params["dec_layers"])):
        if cache is not None:
            kv = (cache["k"][i], cache["v"][i])
            x = _dec_layer(cfg, lp, x, enc_out, kv_cache=kv, cache_offset=offset)
        elif cfg.remat:
            x = checkpoint(_dec_layer, cfg, lp, x, enc_out, use_reentrant=False)
        else:
            x = _dec_layer(cfg, lp, x, enc_out)
    if last_only:
        x = x[:, -1:]
    x = layernorm_fwd(params["dec_norm"], x)
    return constrain(unembed_fwd(params["embed"], x), "data", None, "model")


def forward(cfg: ArchConfig, params, tokens, frames):
    """Training forward: tokens (B, S), frames (B, S_enc, d) -> logits
    (B, S, vocab) in f32."""
    return decode_stack(cfg, params, tokens, encode(cfg, params, frames))


def kv_cache_specs(cfg: ArchConfig):
    kv = P(None, "data", None, "model", None)
    return {"k": kv, "v": kv, "enc_out": P("data", None, None)}


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, enc_len: int = 0, device="cuda"):
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.cdtype, device=device),
        "enc_out": torch.zeros((batch, enc_len, cfg.d_model), dtype=cfg.cdtype, device=device),
    }


@torch.no_grad()
def prefill(cfg: ArchConfig, params, tokens, frames, max_len):
    """Encode ``frames`` and run the prompt into a new cache; returns the
    last position's logits and the cache.  Frames take no cache slot:
    decode offsets count tokens only."""
    cache = init_kv_cache(cfg, tokens.shape[0], max_len, frames.shape[1], tokens.device)
    cache = lay_out_like(cache, kv_cache_specs(cfg), tokens)
    cache["enc_out"].copy_(encode(cfg, params, frames))
    logits = decode_stack(cfg, params, tokens, cache["enc_out"], cache, 0, last_only=True)
    return logits, cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, params, cache, tokens, offset):
    """One token (B, 1) at absolute position ``offset`` (a host int) ->
    (logits (B, 1, vocab), cache written in place)."""
    logits = decode_stack(cfg, params, tokens, cache["enc_out"].to(cfg.cdtype), cache, offset)
    return logits, cache
