"""RecurrentGemma / Griffin hybrid (recurrentgemma-2b, the ``hybrid``
family): RG-LRU recurrent blocks and local MQA attention in a 2:1
pattern, a gated GELU MLP after every temporal block.

* RG-LRU: the gated linear recurrence h_t = a_t * h_{t-1} + b_t with
  a_t = exp(-c * softplus(lam) * r_t).  The reference solves it with
  ``jax.lax.associative_scan``; torch has no counterpart, so
  ``_rglru_scan`` is a Hillis-Steele scan over time with the reference's
  own combine, ceil(log2(S + 1)) rounds of out-of-place elementwise ops
  (a loop of S steps would be S launches per layer on the card).  The
  order of the sums differs from XLA's; the recurrence is contractive
  (0 < a <= 1), so f32 results agree to about 1e-6.  Sequences longer
  than ``RGLRU_CHUNK`` run chunk by chunk, padded with identity steps.
* Local attention: sliding-window MQA through the port's
  ``attention_fwd``; decode reads a ring buffer of
  W = min(max_len, window) slots, ``pos`` -1 where a slot is empty.

Parameters mirror the reference's tree leaf for leaf: the (rec, rec,
attn) triples stacked ``(n_triples, ...)``, the remainder recurrent
layers unrolled as ``rem{i}``; ``lam`` is f32 whatever ``pdtype`` is.
The state is the cache, ``{"triples": (h1, c1, h2, c2, {"k", "v",
"pos"}), "rem": [(h, conv), ...]}``: carries f32, conv tails and ring
K/V in ``cdtype``, ``pos`` int32.  ``prefill`` and ``decode_step`` write
it in place and return the same dict (ROADMAP C13).  Offsets, and so
ring slots, are host ints.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import P, constrain, lay_out_like, local_map_specs, stacked, split_dim
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    _ACTIVATIONS,
    FSDP,
    TP,
    _init_dense,
    apply_rope,
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
)
from repro_torch.models.state import flatten, unflatten_into, unstack

LRU_C = 8.0
RGLRU_CHUNK = 4096  # longer sequences run chunk by chunk, the carry passed on


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) with no linear cutoff."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# RG-LRU recurrent block
# ---------------------------------------------------------------------------


def init_recurrent_block(gen, cfg: ArchConfig, device=None, leading=()):
    d = cfg.d_model
    dr = cfg.hybrid.lru_dim or d
    cw = cfg.hybrid.conv_width
    kw = dict(dtype=cfg.pdtype, device=device, leading=leading)
    # lam init: a ~ uniform(0.9, 0.999) as in Griffin
    u = torch.rand((*leading, dr), generator=gen, device=device) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / LRU_C))  # softplus^-1(-ln u / c)
    conv = torch.randn((*leading, cw, dr), generator=gen, device=device)
    return {
        "w_gate": _init_dense(gen, d, dr, **kw),
        "w_rec": _init_dense(gen, d, dr, **kw),
        "conv": conv.div_(math.sqrt(cw)).to(cfg.pdtype),
        "w_a": _init_dense(gen, dr, dr, scale=0.01, **kw),
        "w_x": _init_dense(gen, dr, dr, scale=0.01, **kw),
        "lam": lam,
        "w_down": _init_dense(gen, dr, d, **kw),
        "norm": torch.ones((*leading, d), dtype=cfg.pdtype, device=device),
    }


def _rglru(p, u, h0):
    """u: (B, S, dr) f32 inputs; h0: (B, dr) carry.  Returns (y, h_last)."""
    r = torch.sigmoid(torch.einsum("bsd,de->bse", u, p["w_a"].to(u.dtype)).float())
    i = torch.sigmoid(torch.einsum("bsd,de->bse", u, p["w_x"].to(u.dtype)).float())
    log_a = -LRU_C * _softplus(p["lam"]) * r  # (B, S, dr), <= 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u.float())
    B, S, dr = a.shape
    if S <= RGLRU_CHUNK:
        return _rglru_scan(a, gated, h0)
    pad = (-S) % RGLRU_CHUNK
    if pad:  # identity steps (a = 1, b = 0): the state passes through

        def identity_steps(a, gated):
            return F.pad(a, (0, 0, 0, pad), value=1.0), F.pad(gated, (0, 0, 0, pad))

        # on DTensors each rank pads its own rows and channels (C24)
        ch = P("data", None, "model")
        a, gated = local_map_specs(identity_steps, (a, gated), (ch, ch), (ch, ch))
    h, ys = h0, []
    for c0 in range(0, S + pad, RGLRU_CHUNK):
        y, h = _rglru_scan(a[:, c0 : c0 + RGLRU_CHUNK], gated[:, c0 : c0 + RGLRU_CHUNK], h)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], h


def _rglru_scan(a, gated, h0):
    """Solve h_t = a_t h_{t-1} + b_t over one chunk in log depth: the carry
    prepended as step 0, then Hillis-Steele rounds of the reference's
    combine((a1, b1), (a2, b2)) = (a1 a2, a2 b1 + b2), each element with
    the one ``k`` before it, k = 1, 2, 4, ..."""
    A = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
    Bv = torch.cat([h0[:, None], gated], dim=1)
    T = A.shape[1]
    k = 1
    while k < T:
        Bv = torch.cat([Bv[:, :k], A[:, k:] * Bv[:, :-k] + Bv[:, k:]], dim=1)
        if 2 * k < T:  # the last round needs no products
            A = torch.cat([A[:, :k], A[:, :-k] * A[:, k:]], dim=1)
        k *= 2
    return Bv[:, 1:], Bv[:, -1]


def _causal_conv(u, w, conv_state=None):
    """The causal depthwise conv of ``u`` (B, S, dr) with ``w`` (cw, dr),
    from ``conv_state`` (B, cw-1, dr; zeros when None); returns the conv
    and its last cw-1 inputs, the next state."""
    cw, S = w.shape[0], u.shape[1]
    if conv_state is None:
        upad = F.pad(u, (0, 0, cw - 1, 0))
    else:
        upad = torch.cat([conv_state.to(u.dtype), u], dim=1)
    conv = sum(upad[:, i : i + S, :] * w[i].to(u.dtype) for i in range(cw))
    return conv, upad[:, upad.shape[1] - (cw - 1) :, :]


def recurrent_block_fwd(p, x, cfg, h0, conv_state=None):
    """Returns (out, (h_last, new conv state)).  ``conv_state``: (B, cw-1,
    dr), the last cw-1 conv inputs (decode); None starts from zeros.
    Nothing given is written."""
    cdt = x.dtype
    cw = cfg.hybrid.conv_width
    xn = rmsnorm_fwd({"scale": p["norm"]}, x)
    gate = _ACTIVATIONS["gelu"](torch.einsum("bsd,de->bse", xn, p["w_gate"].to(cdt)))
    u = torch.einsum("bsd,de->bse", xn, p["w_rec"].to(cdt))

    # causal depthwise conv (width cw) along S, which is never sharded: on
    # DTensors each rank convolves its own rows and channels (DTensor's
    # pad fails on torch 2.11, ROADMAP C24)
    ch = P("data", None, "model")
    args, specs = (u, p["conv"]), (ch, P(None, "model"))
    if conv_state is not None:
        args, specs = (*args, conv_state), (*specs, ch)
    conv, tail = local_map_specs(_causal_conv, args, specs, (ch, ch))
    new_conv_state = tail if cw > 1 else None

    y, h_last = _rglru(p, conv.float(), h0)
    out = y.to(cdt) * gate
    out = torch.einsum("bse,ed->bsd", out, p["w_down"].to(cdt))
    return constrain(x + out, "data", None, None), (h_last, new_conv_state)


# ---------------------------------------------------------------------------
# Local attention block (MQA, sliding window, ring-buffer decode cache)
# ---------------------------------------------------------------------------


def recurrent_block_specs():
    return {
        "w_gate": P(FSDP, TP),
        "w_rec": P(FSDP, TP),
        "conv": P(None, TP),
        "w_a": P(FSDP, TP),
        "w_x": P(FSDP, TP),
        "lam": P(None),
        "w_down": P(TP, FSDP),
        "norm": P(None),
    }


def init_attention_block(gen, cfg: ArchConfig, device=None, leading=()):
    return {
        "attn": init_attention(
            gen,
            cfg.d_model,
            cfg.n_heads,
            cfg.n_kv_heads,
            cfg.resolved_head_dim,
            cfg.pdtype,
            device,
            leading=leading,
        ),
        "norm": init_rmsnorm(cfg.d_model, cfg.pdtype, device, leading),
    }


def _ring_attention_step(p, x, cfg, cache, offset: int):
    """One decode token against a ring-buffer window cache, written in
    place: {k, v: (B, W, kv, hd), pos: (B, W) int32 (absolute, -1 =
    empty)}.  ``offset`` is a host int, so the slot is too."""
    B, S, d = x.shape
    assert S == 1
    cdt = x.dtype
    H, KV = cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    W = cache["k"].shape[1]
    positions = torch.full((B, 1), offset, dtype=torch.long, device=x.device)

    q = split_dim(torch.einsum("bsd,dh->bsh", x, p["wq"].to(cdt)), -1, (H, hd))
    k = split_dim(torch.einsum("bsd,dh->bsh", x, p["wk"].to(cdt)), -1, (KV, hd))
    v = split_dim(torch.einsum("bsd,dh->bsh", x, p["wv"].to(cdt)), -1, (KV, hd))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    slot = offset % W
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    cpos[:, slot] = offset

    qg = split_dim(q, 2, (KV, H // KV))
    logits = torch.einsum("bsngh,btnh->bngst", qg, ck.to(cdt)) / math.sqrt(hd)
    valid = (cpos >= 0) & (cpos <= offset) & (cpos > offset - W)
    logits = logits.float().masked_fill(
        ~valid[:, None, None, None, :], torch.finfo(torch.float32).min
    )
    attn = torch.softmax(logits, dim=-1).to(cdt)
    out = torch.einsum("bngst,btnh->bsngh", attn, cv.to(cdt)).reshape(B, 1, -1)
    return torch.einsum("bsh,hd->bsd", out, p["wo"].to(cdt))


def _fill_ring_cache(p, h_norm, cfg, cache):
    """Write the ring cache from a parallel pass's last min(W, S) positions,
    in place: h_norm (B, S, d) is the attention block's normed input;
    position t lands in slot t % W.  Those slots are distinct and run on
    from the first one, wrapping at W once at most: two slice writes
    (DTensor on torch 2.11 has no index_put_ with a slot tensor)."""
    cdt = h_norm.dtype
    B, S, d = h_norm.shape
    KV = cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    W = cache["k"].shape[1]
    Wt = min(W, S)
    hh = h_norm[:, S - Wt :]
    pos = torch.arange(S - Wt, S, device=h_norm.device)
    k = split_dim(torch.einsum("bsd,dh->bsh", hh, p["wk"].to(cdt)), -1, (KV, hd))
    v = split_dim(torch.einsum("bsd,dh->bsh", hh, p["wv"].to(cdt)), -1, (KV, hd))
    k = apply_rope(k, pos[None].expand(B, Wt), cfg.rope_theta)
    first = (S - Wt) % W
    n = min(Wt, W - first)  # up to the ring's end, the rest from slot 0
    for name, src in (("k", k), ("v", v), ("pos", pos.to(torch.int32)[None].expand(B, Wt))):
        dst = cache[name]
        dst[:, first : first + n] = src[:, :n].to(dst.dtype)
        dst[:, : Wt - n] = src[:, n:].to(dst.dtype)


def attention_block_fwd(p, x, cfg, cache=None, offset=None, build_cache=False):
    """The windowed attention over ``x`` (and, with ``build_cache``, the
    ring filled from it), or with a ``cache`` one decode step at
    ``offset``.  The cache is written in place."""
    h = rmsnorm_fwd(p["norm"], x)
    if cache is None or build_cache:
        out = attention_fwd(
            p["attn"],
            h,
            n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            rope_theta=cfg.rope_theta,
            window=cfg.hybrid.window,
            impl=cfg.attention_impl,
        )
        if build_cache:
            _fill_ring_cache(p["attn"], h, cfg, cache)
        return constrain(x + out, "data", None, None)
    return x + _ring_attention_step(p["attn"], h, cfg, cache, offset)


# ---------------------------------------------------------------------------
# Full model: stacked (rec+mlp, rec+mlp, attn+mlp) triples + remainder
# ---------------------------------------------------------------------------


def init_triple(gen, cfg, device=None, leading=()):
    def mlp():
        return init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.pdtype, device, leading=leading)

    def norm():
        return init_rmsnorm(cfg.d_model, cfg.pdtype, device, leading)

    return {
        "rec1": init_recurrent_block(gen, cfg, device, leading),
        "rec2": init_recurrent_block(gen, cfg, device, leading),
        "attn": init_attention_block(gen, cfg, device, leading),
        "mlp1": mlp(),
        "mlp2": mlp(),
        "mlp3": mlp(),
        "mnorm1": norm(),
        "mnorm2": norm(),
        "mnorm3": norm(),
    }


def triple_specs():
    return {
        "rec1": recurrent_block_specs(),
        "rec2": recurrent_block_specs(),
        "attn": {"attn": attention_specs(), "norm": rmsnorm_specs()},
        **{f"mlp{i}": mlp_specs() for i in (1, 2, 3)},
        **{f"mnorm{i}": rmsnorm_specs() for i in (1, 2, 3)},
    }


def _n_triples(cfg):
    return cfg.n_layers // len(cfg.hybrid.pattern)


def _n_rem(cfg):
    return cfg.n_layers - _n_triples(cfg) * len(cfg.hybrid.pattern)


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda"):
    """Random parameters from ``seed`` (a torch generator on ``device``;
    not the reference's numbers)."""
    gen = init_generator(seed, device)
    params = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, cfg.pdtype, device),
        "triples": init_triple(gen, cfg, device, (_n_triples(cfg),)),
    }
    for i in range(_n_rem(cfg)):  # remainder layers: recurrent blocks (+ MLP), unrolled
        params[f"rem{i}"] = {
            "rec": init_recurrent_block(gen, cfg, device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.pdtype, device),
            "mnorm": init_rmsnorm(cfg.d_model, cfg.pdtype, device),
        }
    params["final_norm"] = init_rmsnorm(cfg.d_model, cfg.pdtype, device)
    return params


def param_specs(cfg: ArchConfig):
    """The reference's logical partition specs of :func:`init_params`' tree."""
    specs = {"embed": embedding_specs(), "triples": stacked(triple_specs())}
    for i in range(_n_rem(cfg)):
        specs[f"rem{i}"] = {
            "rec": recurrent_block_specs(),
            "mlp": mlp_specs(),
            "mnorm": rmsnorm_specs(),
        }
    specs["final_norm"] = rmsnorm_specs()
    return specs


def kv_cache_specs(cfg: ArchConfig):
    """Every state leaf ``P(None, "data")``, as the reference's are (its
    remainder layers' ``(batch, ...)`` leaves included)."""
    state = init_state(cfg, 1, 1, "meta")
    return unflatten_into(state, {k: P(None, "data") for k in flatten(state)})


def _mlp_res(norm_p, mlp_p, x):
    # every block's residual on "data", whole over "model" (ROADMAP C23)
    return constrain(x + mlp_fwd(mlp_p, rmsnorm_fwd(norm_p, x), "gelu"), "data", None, None)


def _triple_fwd(cfg, tp, x, state, decode=False, offset=None, build_cache=False):
    """One triple; returns (x, new state).  The ring cache in ``state`` is
    written in place when decoding or building it; nothing else given is."""
    h1, c1, h2, c2, attn_cache = state
    x, (h1, c1) = recurrent_block_fwd(tp["rec1"], x, cfg, h1, c1 if decode else None)
    x = _mlp_res(tp["mnorm1"], tp["mlp1"], x)
    x, (h2, c2) = recurrent_block_fwd(tp["rec2"], x, cfg, h2, c2 if decode else None)
    x = _mlp_res(tp["mnorm2"], tp["mlp2"], x)
    x = attention_block_fwd(
        tp["attn"], x, cfg, attn_cache if (decode or build_cache) else None, offset, build_cache
    )
    x = _mlp_res(tp["mnorm3"], tp["mlp3"], x)
    return x, (h1, c1, h2, c2)


def init_state(cfg: ArchConfig, batch: int, max_len: int, device="cuda"):
    nt = _n_triples(cfg)
    dr = cfg.hybrid.lru_dim or cfg.d_model
    cw = cfg.hybrid.conv_width
    W = min(max_len, cfg.hybrid.window)
    hd = cfg.resolved_head_dim

    def rec_state(*lead):
        return (
            torch.zeros((*lead, batch, dr), dtype=torch.float32, device=device),
            torch.zeros((*lead, batch, cw - 1, dr), dtype=cfg.cdtype, device=device),
        )

    kv = (nt, batch, W, cfg.n_kv_heads, hd)
    attn = {
        "k": torch.zeros(kv, dtype=cfg.cdtype, device=device),
        "v": torch.zeros(kv, dtype=cfg.cdtype, device=device),
        "pos": torch.full((nt, batch, W), -1, dtype=torch.int32, device=device),
    }
    return {
        "triples": (*rec_state(nt), *rec_state(nt), attn),
        "rem": [rec_state() for _ in range(_n_rem(cfg))],
    }


def _run(cfg, params, x, state, decode=False, offset=None, build_cache=False):
    """Every layer over ``x`` from ``state``.  Serving (``decode`` or
    ``build_cache``) writes the new carries, conv tails and ring into
    ``state`` in place (C13); the training forward writes nothing."""
    write = decode or build_cache
    h1, c1, h2, c2, attn = state["triples"]
    for i, tp in enumerate(unstack(params["triples"])):
        st = (h1[i], c1[i], h2[i], c2[i], {k: t[i] for k, t in attn.items()})
        if cfg.remat and not write:
            x, new = checkpoint(_triple_fwd, cfg, tp, x, st, use_reentrant=False)
        else:
            x, new = _triple_fwd(cfg, tp, x, st, decode, offset, build_cache)
        if write:
            for dst, src in zip(st[:4], new):
                dst.copy_(src)
    for i, (h0, cs) in enumerate(state["rem"]):
        rp = params[f"rem{i}"]
        x, (h_new, cs_new) = recurrent_block_fwd(rp["rec"], x, cfg, h0, cs if decode else None)
        x = _mlp_res(rp["mnorm"], rp["mlp"], x)
        if write:
            h0.copy_(h_new)
            cs.copy_(cs_new)
    return x


def forward(cfg: ArchConfig, params, tokens):
    """Training forward: tokens (B, S) -> logits (B, S, vocab) in f32."""
    x = constrain(embed_fwd(params["embed"], tokens, cfg.cdtype), "data", None, None)
    x = _run(cfg, params, x, init_state(cfg, tokens.shape[0], 1, tokens.device))
    x = rmsnorm_fwd(params["final_norm"], x)
    return constrain(unembed_fwd(params["embed"], x), "data", None, "model")


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda"):
    return init_state(cfg, batch, max_len, device)


@torch.no_grad()
def prefill(cfg: ArchConfig, params, tokens, max_len):
    """One parallel pass over the prompt that also fills a new state: the
    carries and conv tails fall out of the recurrent blocks, and each
    ring is filled from the last ``W`` positions (everything older is out
    of the window).  Returns the last position's logits and the state."""
    state = lay_out_like(init_state(cfg, tokens.shape[0], max_len, tokens.device), kv_cache_specs(cfg), tokens)
    x = constrain(embed_fwd(params["embed"], tokens, cfg.cdtype), "data", None, None)
    x = _run(cfg, params, x, state, offset=0, build_cache=True)
    x = rmsnorm_fwd(params["final_norm"], x[:, -1:])
    return unembed_fwd(params["embed"], x), state


@torch.no_grad()
def decode_step(cfg: ArchConfig, params, state, tokens, offset):
    """One token (B, 1) at absolute position ``offset`` (a host int) ->
    (logits (B, 1, vocab), state written in place)."""
    offset = host_offset(offset)
    x = constrain(embed_fwd(params["embed"], tokens, cfg.cdtype), "data", None, None)
    x = _run(cfg, params, x, state, decode=True, offset=offset)
    x = rmsnorm_fwd(params["final_norm"], x)
    return unembed_fwd(params["embed"], x), state
