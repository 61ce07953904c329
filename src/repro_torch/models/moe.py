"""Mixture-of-Experts decoder (deepseek-v2-lite, kimi-k2) with optional MLA.

* Routing: top-k softmax gating with per-group capacity (GShard-style
  drops), computed with a sort-free rank: position-in-expert comes from a
  cumulative one-hot count per group (groups are sequences).
* Expert compute: batched einsum over the (E, C) dispatch buffer, so every
  expert's weights are read whatever the routing (a decode step reads all
  of them, as the reference's does).
* Shared experts: a dense SwiGLU MLP applied to every token (DeepSeek).
* MLA (DeepSeek): low-rank compressed KV (kv_lora_rank) + decoupled RoPE
  head; the decode cache stores the compressed c_kv + k_pe only.

Parameters and caches mirror the reference's trees leaf for leaf.  As in
``transformer``, the cache is written in place (ROADMAP C11) and offsets
are host ints.  ``torch.topk`` may order exact ties differently from
``jax.lax.top_k``; with an f32 softmax over random routers they do not
occur.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import P, constrain, lay_out_like, local_map_specs, stacked, split_dim
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    _init_dense,
    _mask_bias,
    apply_rope,
    FSDP,
    TP,
    attention_fwd,
    attention_specs,
    embed_fwd,
    embedding_specs,
    host_offset,
    init_attention,
    init_embedding,
    init_generator,
    init_mlp,
    init_rmsnorm,
    mlp_fwd,
    mlp_specs,
    rmsnorm_fwd,
    rmsnorm_specs,
    unembed_fwd,
    write_cache,
)
from repro_torch.models.state import unstack

# ---------------------------------------------------------------------------
# MoE FFN
# ---------------------------------------------------------------------------


def init_moe_ffn(gen, cfg: ArchConfig, device=None, leading=()):
    m = cfg.moe
    d, E, f = cfg.d_model, m.num_experts, m.d_ff_expert
    kw = dict(dtype=cfg.pdtype, device=device, leading=(*leading, E))
    p = {
        "router": _init_dense(gen, d, E, torch.float32, device, leading=leading),
        "w_gate": _init_dense(gen, d, f, **kw),
        "w_up": _init_dense(gen, d, f, **kw),
        "w_down": _init_dense(gen, f, d, **kw),
    }
    if m.num_shared:
        p["shared"] = init_mlp(
            gen, d, f * m.num_shared, cfg.pdtype, device, gated=True, leading=leading
        )
    return p


def moe_ffn_specs(cfg: ArchConfig):
    s = {
        "router": P(FSDP, None),
        "w_gate": P(TP, FSDP, None),
        "w_up": P(TP, FSDP, None),
        "w_down": P(TP, None, FSDP),
    }
    if cfg.moe.num_shared:
        s["shared"] = mlp_specs(gated=True)
    return s


def one_hot(ids, n: int):
    """``jax.nn.one_hot(ids, n, dtype=int32)``: (..., n) int32.  A
    comparison with an ``arange`` lowers alike on every device, where
    ``F.one_hot`` checks its range on the CPU and not on meta (ROADMAP
    C21)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(torch.int32)


def _dispatch(x, eidx, *, E: int, C: int, mode: str):
    """The (B, E, C, d) expert buffer of one group (sequence) per row of
    ``x``, and each assignment's slot ``pos`` (B, S*k) and ``keep`` flag."""
    B, S, d = x.shape
    k = eidx.shape[-1]
    cdt, dev = x.dtype, x.device
    # position-in-expert within each group: cumulative count over the S*k
    # assignments in order
    flat_e = eidx.reshape(B, S * k)
    pos = torch.cumsum(one_hot(flat_e, E), dim=1, dtype=torch.int32) - 1  # count before + self
    pos = torch.gather(pos, -1, flat_e[..., None])[..., 0].long()
    keep = pos < C  # capacity drop (B, S*k)

    b_ix = torch.arange(B, device=dev)[:, None].expand(B, S * k)
    pos_c = torch.where(keep, pos, C)  # dropped -> scratch slot C

    if mode == "gather":
        # scatter only the slot -> assignment indices, then gather tokens
        a_ix = torch.arange(S * k, device=dev)[None].expand(B, S * k)
        slot_src = torch.full((B, E, C + 1), S * k, dtype=torch.long, device=dev)
        slot_src[b_ix, flat_e, pos_c] = a_ix
        slot_src = slot_src[:, :, :C]
        valid = slot_src < S * k
        tok_src = torch.clamp(slot_src // k, max=S - 1)
        x_g = x[torch.arange(B, device=dev)[:, None, None], tok_src]  # (B, E, C, d)
        buf = torch.where(valid[..., None], x_g, torch.zeros((), dtype=cdt, device=dev))
    else:
        # the reference's baseline: scatter-add of token vectors; each kept
        # slot receives exactly one assignment, so only the discarded
        # scratch slot's sum depends on the order of the adds
        xk = torch.repeat_interleave(x, k, dim=1)  # (B, S*k, d) token per assignment
        buf = torch.zeros((B, E, C + 1, d), dtype=cdt, device=dev)
        buf = buf.index_put((b_ix, flat_e, pos_c), xk, accumulate=True)
        buf = buf[:, :, :C, :]
    return buf, pos, keep


def _combine(out_buf, gate_vals, eidx, pos, keep):
    """Gather each assignment's expert output, weight it, sum over k."""
    B, S, k = eidx.shape
    C, d = out_buf.shape[2], out_buf.shape[3]
    b_ix = torch.arange(B, device=out_buf.device)[:, None].expand(B, S * k)
    gathered = out_buf[b_ix, eidx.reshape(B, S * k), torch.clamp(pos, max=C - 1)]  # (B, S*k, d)
    w = (gate_vals.reshape(B, S * k) * keep.float()).to(out_buf.dtype)
    return (gathered * w[..., None]).reshape(B, S, k, d).sum(dim=2)


def _experts(buf, w_gate, w_up, w_down):
    """Each expert's SwiGLU FFN over its buffer rows: (B, E, C, d)."""
    cdt = buf.dtype
    g = torch.einsum("becd,edf->becf", buf, w_gate.to(cdt))
    u = torch.einsum("becd,edf->becf", buf, w_up.to(cdt))
    h = F.silu(g) * u
    return torch.einsum("becf,efd->becd", h, w_down.to(cdt))


def moe_ffn_fwd(p, x, cfg: ArchConfig):
    """x: (B, S, d).  Groups = sequences; capacity per group."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    C = max(1, int(math.ceil(m.capacity_factor * S * k / E)))

    # (B, S, E) f32, whole over "model" before the softmax (as mla_fwd's ckv_pe)
    logits = constrain(torch.einsum("bsd,de->bse", x.float(), p["router"]), "data", None, None)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, eidx = torch.topk(probs, k, dim=-1)  # (B, S, k), descending
    gate_vals = gate_vals / (gate_vals.sum(dim=-1, keepdim=True) + 1e-9)

    # routing is per group (sequence): on DTensors each rank routes its own
    row = P("data")
    dispatch = functools.partial(_dispatch, E=E, C=C, mode=cfg.moe_dispatch)
    buf, pos, keep = local_map_specs(dispatch, (x, eidx), (row, row), (row, row, row))
    buf = constrain(buf, "data", "model", None, None)

    # expert compute (EP over the model axis), per row and expert: on
    # DTensors each rank runs its own (op by op, the batched matmuls leave
    # local strides DTensor's views cannot take)
    ep, bec = P("model", None, None), P("data", "model", None, None)
    out_buf = local_map_specs(
        _experts, (buf, p["w_gate"], p["w_up"], p["w_down"]), (bec, ep, ep, ep), (bec,)
    )

    out = local_map_specs(_combine, (out_buf, gate_vals, eidx, pos, keep), (row,) * 5, (row,))

    if "shared" in p:
        out = out + mlp_fwd(p["shared"], x, "silu")
    return out


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V2)
# ---------------------------------------------------------------------------


def init_mla(gen, cfg: ArchConfig, device=None, leading=()):
    a = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    r, rd, nd, vd = a.kv_lora_rank, a.rope_head_dim, a.nope_head_dim, a.v_head_dim
    kw = dict(dtype=cfg.pdtype, device=device, leading=leading)
    return {
        "w_dkv": _init_dense(gen, d, r + rd, **kw),
        "w_uk": _init_dense(gen, r, H * nd, **kw),
        "w_uv": _init_dense(gen, r, H * vd, **kw),
        "w_q": _init_dense(gen, d, H * (nd + rd), **kw),
        "w_o": _init_dense(gen, H * vd, d, **kw),
        "kv_norm": torch.ones((*leading, r), dtype=cfg.pdtype, device=device),
    }


def mla_specs():
    return {
        "w_dkv": P(FSDP, None),
        "w_uk": P(None, TP),
        "w_uv": P(None, TP),
        "w_q": P(FSDP, TP),
        "w_o": P(TP, FSDP),
        "kv_norm": P(None),
    }


def _mla_core(q_nope, q_pe, k_nope, k_pe, v, *, offset):
    """Causal attention over the decompressed heads plus the shared RoPE
    key: q_nope (B, S, H, nd), q_pe (B, S, H, rd), k_nope (B, T, H, nd),
    k_pe (B, T, rd), v (B, T, H, vd) -> (B, S, H * vd)."""
    B, S, H, nd = q_nope.shape
    scale = 1.0 / math.sqrt(nd + q_pe.shape[-1])
    logits = (
        torch.einsum("bshn,bthn->bhst", q_nope, k_nope)
        + torch.einsum("bshr,btr->bhst", q_pe, k_pe)
    ) * scale
    logits = logits.float() + _mask_bias(S, k_nope.shape[1], offset, None, q_nope.device)
    attn = torch.softmax(logits, dim=-1).to(q_nope.dtype)
    return torch.einsum("bhst,bthv->bshv", attn, v).reshape(B, S, -1)


def mla_fwd(p, x, cfg: ArchConfig, kv_cache=None, cache_offset=None):
    """MLA attention; the cache holds (c_kv normed, k_pe), (B, S_max, r)
    and (B, S_max, rd), written in place at ``cache_offset``."""
    a = cfg.mla
    B, S, d = x.shape
    H = cfg.n_heads
    r, rd, nd, vd = a.kv_lora_rank, a.rope_head_dim, a.nope_head_dim, a.v_head_dim
    cdt = x.dtype
    offset = 0 if cache_offset is None else host_offset(cache_offset)
    positions = (torch.arange(S, device=x.device) + offset)[None, :].expand(B, S)

    # whole over "model" before it is sliced: the slices' gradient then
    # comes back split as the matmul's output was (ROADMAP C23)
    ckv_pe = constrain(torch.einsum("bsd,dr->bsr", x, p["w_dkv"].to(cdt)), "data", None, None)
    c_kv, k_pe = ckv_pe[..., :r], ckv_pe[..., r:]
    c_kv = rmsnorm_fwd({"scale": p["kv_norm"]}, c_kv)
    k_pe = apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]

    if kv_cache is not None:
        cc, cp = kv_cache
        c_kv = write_cache(cc, c_kv, offset).to(cdt)
        k_pe = write_cache(cp, k_pe, offset).to(cdt)

    q = split_dim(torch.einsum("bsd,dh->bsh", x, p["w_q"].to(cdt)), -1, (H, nd + rd))
    q_nope, q_pe = q[..., :nd], q[..., nd:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)

    k_nope = split_dim(torch.einsum("btr,rh->bth", c_kv, p["w_uk"].to(cdt)), -1, (H, nd))
    v = split_dim(torch.einsum("btr,rh->bth", c_kv, p["w_uv"].to(cdt)), -1, (H, vd))

    # per batch row and head: on DTensors each rank runs its own
    heads = P("data", None, "model")
    core = functools.partial(_mla_core, offset=offset)
    out = local_map_specs(
        core, (q_nope, q_pe, k_nope, k_pe, v), (heads, heads, heads, P("data"), heads), (heads,)
    )
    return torch.einsum("bsh,hd->bsd", out, p["w_o"].to(cdt))


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def _init_attn(gen, cfg, device, leading):
    if cfg.mla is not None:
        return init_mla(gen, cfg, device, leading)
    return init_attention(
        gen,
        cfg.d_model,
        cfg.n_heads,
        cfg.n_kv_heads,
        cfg.resolved_head_dim,
        cfg.pdtype,
        device,
        bias=cfg.attn_bias,
        leading=leading,
    )


def _attn_fwd(cfg, p, x, kv_cache=None, cache_offset=None):
    if cfg.mla is not None:
        return mla_fwd(p, x, cfg, kv_cache, cache_offset)
    return attention_fwd(
        p,
        x,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        rope_theta=cfg.rope_theta,
        use_rope=cfg.use_rope,
        kv_cache=kv_cache,
        cache_offset=cache_offset,
    )


def init_moe_layer(gen, cfg: ArchConfig, dense: bool, device=None, leading=()):
    """One layer's tree, every leaf with ``leading`` stacked axes.  Leaves
    are drawn one at a time, so one f32 temporary is alive at once."""
    attn = _init_attn(gen, cfg, device, leading)
    if dense:
        d_ff = cfg.moe.d_ff_dense or cfg.d_ff
        ffn = init_mlp(gen, cfg.d_model, d_ff, cfg.pdtype, device, gated=True, leading=leading)
    else:
        ffn = init_moe_ffn(gen, cfg, device, leading)
    return {
        "attn": attn,
        "ffn": ffn,
        "norm1": init_rmsnorm(cfg.d_model, cfg.pdtype, device, leading),
        "norm2": init_rmsnorm(cfg.d_model, cfg.pdtype, device, leading),
    }


def moe_layer_specs(cfg: ArchConfig, dense: bool):
    return {
        "attn": mla_specs() if cfg.mla is not None else attention_specs(bias=cfg.attn_bias),
        "ffn": mlp_specs(gated=True) if dense else moe_ffn_specs(cfg),
        "norm1": rmsnorm_specs(),
        "norm2": rmsnorm_specs(),
    }


def moe_layer_fwd(cfg, lp, x, dense: bool, kv_cache=None, cache_offset=None):
    h = rmsnorm_fwd(lp["norm1"], x)
    # the residual on "data", whole over "model" (as in transformer.layer_fwd)
    x = constrain(x + _attn_fwd(cfg, lp["attn"], h, kv_cache, cache_offset), "data", None, None)
    h = rmsnorm_fwd(lp["norm2"], x)
    if dense:
        x = x + mlp_fwd(lp["ffn"], h, cfg.activation)
    else:
        x = x + moe_ffn_fwd(lp["ffn"], h, cfg)
    return constrain(x, "data", None, None)


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda"):
    """Random parameters from ``seed`` (a torch generator on ``device``;
    not the reference's numbers).  ``dense_layers`` keeps a leading axis
    of 1 when there is one dense layer, as the reference's tree does."""
    gen = init_generator(seed, device)
    nd = cfg.moe.first_dense_layers
    params = {"embed": init_embedding(gen, cfg.vocab, cfg.d_model, cfg.pdtype, device)}
    if nd:
        params["dense_layers"] = init_moe_layer(gen, cfg, True, device, (nd,))
    params["layers"] = init_moe_layer(gen, cfg, False, device, (cfg.n_layers - nd,))
    params["final_norm"] = init_rmsnorm(cfg.d_model, cfg.pdtype, device)
    return params


def param_specs(cfg: ArchConfig):
    """The reference's logical partition specs of :func:`init_params`' tree."""
    specs = {"embed": embedding_specs()}
    if cfg.moe.first_dense_layers:
        specs["dense_layers"] = stacked(moe_layer_specs(cfg, dense=True))
    specs["layers"] = stacked(moe_layer_specs(cfg, dense=False))
    specs["final_norm"] = rmsnorm_specs()
    return specs


def _stacks(params):
    """(per-layer trees, dense?) in layer order: the dense layers first."""
    out = [(lp, True) for lp in unstack(params["dense_layers"])] if "dense_layers" in params else []
    return out + [(lp, False) for lp in unstack(params["layers"])]


def forward(cfg: ArchConfig, params, tokens):
    """Training forward: tokens (B, S) -> logits (B, S, vocab) in f32."""
    x = constrain(embed_fwd(params["embed"], tokens, cfg.cdtype), "data", None, None)
    for lp, dense in _stacks(params):
        if cfg.remat:
            x = checkpoint(moe_layer_fwd, cfg, lp, x, dense, use_reentrant=False)
        else:
            x = moe_layer_fwd(cfg, lp, x, dense)
    x = rmsnorm_fwd(params["final_norm"], x)
    return constrain(unembed_fwd(params["embed"], x), "data", None, "model")


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda"):
    def zeros(*tail):
        return torch.zeros((cfg.n_layers, batch, max_len, *tail), dtype=cfg.cdtype, device=device)

    if cfg.mla is not None:
        return {"c_kv": zeros(cfg.mla.kv_lora_rank), "k_pe": zeros(cfg.mla.rope_head_dim)}
    hd = cfg.resolved_head_dim
    return {"k": zeros(cfg.n_kv_heads, hd), "v": zeros(cfg.n_kv_heads, hd)}


def kv_cache_specs(cfg: ArchConfig):
    if cfg.mla is not None:
        return {"c_kv": P(None, "data", None, None), "k_pe": P(None, "data", None, None)}
    kv = P(None, "data", None, "model", None)
    return {"k": kv, "v": kv}


def _cache_names(cfg):
    return ("c_kv", "k_pe") if cfg.mla is not None else ("k", "v")


def _cached_forward(cfg: ArchConfig, params, tokens, cache, offset, last_only: bool):
    x = constrain(embed_fwd(params["embed"], tokens, cfg.cdtype), "data", None, None)
    a, b = (cache[n] for n in _cache_names(cfg))
    for i, (lp, dense) in enumerate(_stacks(params)):
        x = moe_layer_fwd(cfg, lp, x, dense, kv_cache=(a[i], b[i]), cache_offset=offset)
    if last_only:
        x = x[:, -1:]
    x = rmsnorm_fwd(params["final_norm"], x)
    return constrain(unembed_fwd(params["embed"], x), "data", None, "model"), cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, params, cache, tokens, offset):
    """One decode step: tokens (B, 1) at absolute cache slot ``offset`` (a
    host int) -> (logits (B, 1, vocab), cache written in place)."""
    return _cached_forward(cfg, params, tokens, cache, offset, last_only=False)


@torch.no_grad()
def prefill(cfg: ArchConfig, params, tokens, max_len):
    """Run the whole prompt into a new cache; the last position's logits
    (the unembedding runs on that position only) and the cache."""
    cache = lay_out_like(init_kv_cache(cfg, tokens.shape[0], max_len, tokens.device), kv_cache_specs(cfg), tokens)
    return _cached_forward(cfg, params, tokens, cache, 0, last_only=True)
