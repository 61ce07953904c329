"""xLSTM (sLSTM + mLSTM) blocks: the ``ssm`` family (xlstm-350m).

Layers alternate mLSTM / sLSTM blocks, stacked as pairs: every leaf of
``params["pairs"]`` is one ``(n_pairs, ...)`` tensor, as the reference's
``lax.scan`` layout is, and pair ``i`` reads its slice.  d_ff = 0: the
blocks carry only their own projections.

* mLSTM: matrix memory C (hd x hd per head) with an exponential input
  gate and a log-space stabiliser.  Training and prefill run the
  chunkwise-parallel form (``CHUNK`` tokens at a time, a Python loop over
  chunks carrying (C, n, m)); decode runs the O(1) recurrent step.  The
  step-by-step form ``mlstm_recurrent`` is the tests' oracle.
* sLSTM: scalar memory with head-block-diagonal recurrent mixing.  It is
  sequential by design: a Python loop over time, about 20 launches per
  token per layer on the card (a fused scan kernel is an item after the
  port).

The recurrent state is the cache: ``{"m": (C, n, m), "s": (c, n, m, h)}``,
every leaf stacked ``(n_pairs, B, ...)`` in f32, the stabilisers starting
at -1e30.  ``prefill`` and ``decode_step`` write each pair's new state
into it in place and return the same dict (ROADMAP C13): a state passed
to ``decode_step`` is not the state it was before.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import P, constrain, lay_out_like, local_map_specs, stacked, split_dim
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    FSDP,
    TP,
    _init_dense,
    embed_fwd,
    embedding_specs,
    init_embedding,
    init_generator,
    init_rmsnorm,
    rmsnorm_fwd,
    rmsnorm_specs,
    unembed_fwd,
)
from repro_torch.models.state import flatten, unflatten_into, unstack

CHUNK = 128  # chunkwise-parallel block length
M_INIT = -1e30  # the stabilisers' start


# ---------------------------------------------------------------------------
# mLSTM cell
# ---------------------------------------------------------------------------


def init_mlstm_block(gen, cfg: ArchConfig, device=None, leading=()):
    d, H = cfg.d_model, cfg.n_heads
    kw = dict(dtype=cfg.pdtype, device=device, leading=leading)
    return {
        "w_up": _init_dense(gen, d, 2 * d, **kw),
        "w_q": _init_dense(gen, d, d, **kw),
        "w_k": _init_dense(gen, d, d, **kw),
        "w_v": _init_dense(gen, d, d, **kw),
        "w_i": _init_dense(gen, d, H, scale=0.01, **kw),
        "w_f": _init_dense(gen, d, H, scale=0.01, **kw),
        "b_i": torch.zeros((*leading, H), dtype=cfg.pdtype, device=device),
        "b_f": torch.full((*leading, H), 3.0, dtype=cfg.pdtype, device=device),
        "w_down": _init_dense(gen, d, d, **kw),
        "norm": torch.ones((*leading, d), dtype=cfg.pdtype, device=device),
    }


def mlstm_block_specs():
    return {
        "w_up": P(FSDP, TP),
        "w_q": P(FSDP, TP),
        "w_k": P(FSDP, TP),
        "w_v": P(FSDP, TP),
        "w_i": P(FSDP, None),
        "w_f": P(FSDP, None),
        "b_i": P(None),
        "b_f": P(None),
        "w_down": P(TP, FSDP),
        "norm": P(None),
    }


_BSHD = P("data", None, "model", None)  # (B, S, H, hd)
_BSH = P("data", None, "model")  # (B, S, H) gates, or (B, S, H·hd) heads merged
_M_STATE = (P("data", "model", None, None), P("data", "model", None), P("data", "model"))  # C, n, m
_S_STATE = (P("data", "model", None),) * 4  # c, n, m, h


def _mlstm_gates(p, xin, H):
    """log input gate (pre-stabiliser) and log forget gate, (B, S, H) f32."""
    cdt = xin.dtype
    i_pre = torch.einsum("bsd,dh->bsh", xin, p["w_i"].to(cdt)) + p["b_i"].to(cdt)
    f_pre = torch.einsum("bsd,dh->bsh", xin, p["w_f"].to(cdt)) + p["b_f"].to(cdt)
    return i_pre.float(), F.logsigmoid(f_pre.float())


def _mlstm_qkv(p, xin, H):
    d = xin.shape[-1]
    hd = d // H
    cdt = xin.dtype
    q = torch.einsum("bsd,de->bse", xin, p["w_q"].to(cdt))
    k = torch.einsum("bsd,de->bse", xin, p["w_k"].to(cdt))
    v = torch.einsum("bsd,de->bse", xin, p["w_v"].to(cdt))
    return (
        split_dim(q, -1, (H, hd)).float(),
        split_dim(k, -1, (H, hd)).float() / math.sqrt(hd),
        split_dim(v, -1, (H, hd)).float(),
    )


def mlstm_recurrent_step(q, k, v, log_i, log_f, state):
    """One-token recurrent update.  q/k/v: (B, H, hd); gates (B, H); state
    (C, n, m) with C (B, H, hd, hd), n (B, H, hd), m (B, H).  Returns
    (h, new state); the state given is not written."""
    C, n, m = state
    m_new = torch.maximum(log_f + m, log_i)
    a = torch.exp(log_f + m - m_new)[..., None]
    b = torch.exp(log_i - m_new)[..., None]
    C = a[..., None] * C + (b * k)[..., None] * v[..., None, :]
    n = a * n + b * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)), torch.exp(-m_new))[..., None]
    return num / den, (C, n, m_new)


def mlstm_recurrent(q, k, v, log_i, log_f, state):
    """Oracle: the one-step recurrence over time.  q: (B, S, H, hd)."""
    hs = []
    for t in range(q.shape[1]):
        h, state = mlstm_recurrent_step(q[:, t], k[:, t], v[:, t], log_i[:, t], log_f[:, t], state)
        hs.append(h)
    return torch.stack(hs, dim=1), state


def mlstm_chunkwise(q, k, v, log_i, log_f, state):
    """Chunkwise-parallel mLSTM (training and prefill).

    Splits S into chunks of ``CHUNK``; a loop over chunks carries (C, n,
    m); the work inside a chunk is parallel einsums.  Matches
    ``mlstm_recurrent``.
    """
    B, S, H, hd = q.shape
    L = CHUNK
    if S % L:
        raise ValueError(f"sequence length {S} is not a multiple of {L}")
    C, n, m = state
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()[None, :, :, None]
    hs = []
    for c0 in range(0, S, L):
        qt, kt, vt = q[:, c0 : c0 + L], k[:, c0 : c0 + L], v[:, c0 : c0 + L]
        li, lf = log_i[:, c0 : c0 + L], log_f[:, c0 : c0 + L]  # (B, L, H)
        b = torch.cumsum(lf, dim=1)  # cumulative log-forget
        # running stabiliser: m_t = max(m_prev + b_t, max_{s<=t}(b_t - b_s + li_s))
        m_t = torch.maximum(m[:, None] + b, b + torch.cummax(li - b, dim=1).values)
        # inter-chunk term
        inter_scale = torch.exp(m[:, None] + b - m_t)  # (B, L, H)
        num_inter = torch.einsum("blhd,bhde->blhe", qt, C) * inter_scale[..., None]
        den_inter = torch.einsum("blhd,bhd->blh", qt, n) * inter_scale
        # intra-chunk term: weight(t, s) = exp(b_t - b_s + li_s - m_t), s <= t
        w = b[:, :, None, :] - b[:, None, :, :] + li[:, None, :, :] - m_t[:, :, None, :]
        w = w.masked_fill(~causal, -math.inf).exp()  # (B, L, L, H), 0 above the diagonal
        scores = torch.einsum("blhd,bshd->blsh", qt, kt) * w
        num_intra = torch.einsum("blsh,bshe->blhe", scores, vt)
        den_intra = torch.sum(scores, dim=2)  # (B, L, H)
        den = torch.maximum(torch.abs(den_inter + den_intra), torch.exp(-m_t))
        hs.append((num_inter + num_intra) / den[..., None])
        # state to the next chunk
        bL = b[:, -1]  # (B, H)
        m_new = torch.maximum(m + bL, torch.amax(li - b + bL[:, None], dim=1))
        carry_scale = torch.exp(m + bL - m_new)  # (B, H)
        kv_w = torch.exp(bL[:, None] - b + li - m_new[:, None])  # (B, L, H)
        C = carry_scale[..., None, None] * C + torch.einsum("blhd,blhe,blh->bhde", kt, vt, kv_w)
        n = carry_scale[..., None] * n + torch.einsum("blhd,blh->bhd", kt, kv_w)
        m = m_new
    return torch.cat(hs, dim=1), (C, n, m)


def init_mlstm_state(cfg, batch, device=None, leading=()):
    H = cfg.n_heads
    hd = cfg.d_model // H
    kw = dict(dtype=torch.float32, device=device)
    return (
        torch.zeros((*leading, batch, H, hd, hd), **kw),
        torch.zeros((*leading, batch, H, hd), **kw),
        torch.full((*leading, batch, H), M_INIT, **kw),
    )


def mlstm_block_fwd(p, x, cfg, state, *, step_mode=False):
    """Returns (x + block(x), new state); the state given is not written."""
    cdt = x.dtype
    h = rmsnorm_fwd({"scale": p["norm"]}, x)
    up = torch.einsum("bsd,de->bse", h, p["w_up"].to(cdt))
    # whole over "model" before it is split: the halves' gradient then
    # comes back split as the matmul's output was (ROADMAP C23)
    xin, gate = constrain(up, "data", None, None).chunk(2, dim=-1)
    H = cfg.n_heads
    q, k, v = _mlstm_qkv(p, xin, H)
    log_i, log_f = _mlstm_gates(p, xin, H)

    def cell(q, k, v, log_i, log_f, C, n, m):
        if step_mode:
            h, st = mlstm_recurrent_step(q[:, 0], k[:, 0], v[:, 0], log_i[:, 0], log_f[:, 0], (C, n, m))
            return (h[:, None].flatten(2), *st)
        h, st = mlstm_chunkwise(q, k, v, log_i, log_f, (C, n, m))
        return (h.flatten(2), *st)

    # per batch row and head: on DTensors each rank runs its own (C19);
    # heads are merged inside, where the backward's split is local
    out, *state = local_map_specs(
        cell, (q, k, v, log_i, log_f, *state), (_BSHD,) * 3 + (_BSH,) * 2 + _M_STATE, (_BSH, *_M_STATE)
    )
    state = tuple(state)
    out = out.to(cdt) * F.silu(gate)
    out = torch.einsum("bse,ed->bsd", out, p["w_down"].to(cdt))
    return x + out, state


# ---------------------------------------------------------------------------
# sLSTM cell
# ---------------------------------------------------------------------------


def init_slstm_block(gen, cfg: ArchConfig, device=None, leading=()):
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    kw = dict(dtype=cfg.pdtype, device=device, leading=leading)
    r = torch.randn((*leading, H, hd, 4 * hd), generator=gen, device=device)
    b = torch.zeros((*leading, 4 * d), dtype=cfg.pdtype, device=device)
    b[..., d : 2 * d] = 3.0  # i, f, z, o pre-activations: open forget gates at init
    return {
        "w_x": _init_dense(gen, d, 4 * d, **kw),
        "r": r.div_(math.sqrt(hd)).to(cfg.pdtype),  # block-diagonal recurrent mixing
        "b": b,
        "w_down": _init_dense(gen, d, d, **kw),
        "norm": torch.ones((*leading, d), dtype=cfg.pdtype, device=device),
    }


def slstm_block_specs():
    return {
        "w_x": P(FSDP, TP),
        "r": P(TP, None, None),
        "b": P(None),
        "w_down": P(TP, FSDP),
        "norm": P(None),
    }


def init_slstm_state(cfg, batch, device=None, leading=()):
    H = cfg.n_heads
    shape = (*leading, batch, H, cfg.d_model // H)
    kw = dict(dtype=torch.float32, device=device)
    return (
        torch.zeros(shape, **kw),
        torch.zeros(shape, **kw),
        torch.full(shape, M_INIT, **kw),
        torch.zeros(shape, **kw),
    )


def slstm_step(pre_x, r, b, state, H, hd):
    """pre_x: (B, 4d) one token's pre-activations; state (c, n, m, h).
    Returns the new state; the state given is not written."""
    c, n, m, h = state
    B = pre_x.shape[0]
    rec = torch.einsum("bhd,hde->bhe", h, r.float())  # (B, H, 4hd)
    pre = (
        pre_x.reshape(B, 4, H, hd).float()
        + rec.reshape(B, H, 4, hd).movedim(2, 1)
        + b.reshape(4, H, hd)[None]
    )
    i_p, f_p, z_p, o_p = pre.unbind(1)
    log_i = i_p
    log_f = F.logsigmoid(f_p)
    m_new = torch.maximum(log_f + m, log_i)
    a = torch.exp(log_f + m - m_new)
    bb = torch.exp(log_i - m_new)
    c = a * c + bb * torch.tanh(z_p)
    n = a * n + bb
    h_new = torch.sigmoid(o_p) * c / torch.clamp(n, min=1.0)
    return (c, n, m_new, h_new)


def slstm_block_fwd(p, x, cfg, state, *, step_mode=False):
    """Returns (x + block(x), new state); the state given is not written.
    Over S tokens this is a loop of S ``slstm_step`` calls."""
    cdt = x.dtype
    S, d = x.shape[1:]
    H = cfg.n_heads
    hd = d // H
    hn = rmsnorm_fwd({"scale": p["norm"]}, x)
    pre = torch.einsum("bsd,de->bse", hn, p["w_x"].to(cdt))  # (B, S, 4d)
    r = p["r"].float()  # once, not per token

    def scan(pre, r, b, *state):
        Bl, _, _, Hl, _ = pre.shape  # this rank's rows and heads
        hs = []
        for t in range(1 if step_mode else S):
            state = slstm_step(pre[:, t].reshape(Bl, -1), r, b.reshape(-1), state, Hl, hd)
            hs.append(state[3])
        return (torch.stack(hs, dim=1).flatten(2), *state)

    # per batch row and head: on DTensors each rank runs its own (C19)
    out, *state = local_map_specs(
        scan,
        (split_dim(pre, -1, (4, H, hd)), r, p["b"].reshape(4, H, hd), *state),
        (P("data", None, None, "model", None), P("model", None, None), P(None, "model", None)) + _S_STATE,
        (_BSH, *_S_STATE),
    )
    state = tuple(state)
    out = out.to(cdt)
    out = torch.einsum("bse,ed->bsd", out, p["w_down"].to(cdt))
    return x + out, state


# ---------------------------------------------------------------------------
# Full model: alternating (mLSTM, sLSTM) pairs
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda"):
    """Random parameters from ``seed`` (a torch generator on ``device``;
    not the reference's numbers), every pair leaf stacked ``(n_pairs, ...)``."""
    if cfg.n_layers % 2:
        raise ValueError("the xLSTM config uses (mLSTM, sLSTM) pairs: n_layers must be even")
    gen = init_generator(seed, device)
    lead = (cfg.n_layers // 2,)
    return {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, cfg.pdtype, device),
        "pairs": {
            "m": init_mlstm_block(gen, cfg, device, lead),
            "s": init_slstm_block(gen, cfg, device, lead),
        },
        "final_norm": init_rmsnorm(cfg.d_model, cfg.pdtype, device),
    }


def param_specs(cfg: ArchConfig):
    """The reference's logical partition specs of :func:`init_params`' tree."""
    return {
        "embed": embedding_specs(),
        "pairs": stacked({"m": mlstm_block_specs(), "s": slstm_block_specs()}),
        "final_norm": rmsnorm_specs(),
    }


def kv_cache_specs(cfg: ArchConfig):
    """Every state leaf ``P(None, "data")``, as the reference's are."""
    state = init_state(cfg, 1, "meta")
    return unflatten_into(state, {k: P(None, "data") for k in flatten(state)})


def init_state(cfg: ArchConfig, batch: int, device="cuda"):
    lead = (cfg.n_layers // 2,)
    return {
        "m": init_mlstm_state(cfg, batch, device, lead),
        "s": init_slstm_state(cfg, batch, device, lead),
    }


def _pair_fwd(cfg, lp, x, mst, sst, step_mode):
    # each block's output arrives partial over "model": the residual on
    # "data", whole, before the next block (ROADMAP C23)
    x, mst = mlstm_block_fwd(lp["m"], x, cfg, mst, step_mode=step_mode)
    x, sst = slstm_block_fwd(lp["s"], constrain(x, "data", None, None), cfg, sst, step_mode=step_mode)
    return constrain(x, "data", None, None), mst, sst


def _run(cfg, params, x, state, step_mode, write=False):
    """Every pair over ``x`` from ``state``.  With ``write`` (serving) each
    pair's new state is copied into ``state`` in place (C13)."""
    remat = cfg.remat and not step_mode and not write
    for i, lp in enumerate(unstack(params["pairs"])):
        mst = tuple(t[i] for t in state["m"])
        sst = tuple(t[i] for t in state["s"])
        if remat:
            x, new_m, new_s = checkpoint(
                _pair_fwd, cfg, lp, x, mst, sst, step_mode, use_reentrant=False
            )
        else:
            x, new_m, new_s = _pair_fwd(cfg, lp, x, mst, sst, step_mode)
        if write:
            for dst, src in zip((*mst, *sst), (*new_m, *new_s)):
                dst.copy_(src)
    return x


def forward(cfg: ArchConfig, params, tokens):
    """Training forward: tokens (B, S) -> logits (B, S, vocab) in f32.  The
    sequence is padded with token 0 to a multiple of ``CHUNK``; the pad
    positions come after every real one, so they change no real logit."""
    B, S = tokens.shape
    pad = (-S) % CHUNK
    if pad:  # on DTensors each rank pads its own rows (DTensor's pad fails on torch 2.11, C24)
        tokens = local_map_specs(lambda t: F.pad(t, (0, pad)), (tokens,), (P("data"),), (P("data"),))
    x = constrain(embed_fwd(params["embed"], tokens, cfg.cdtype), "data", None, None)
    state = lay_out_like(init_state(cfg, B, tokens.device), kv_cache_specs(cfg), tokens)
    x = _run(cfg, params, x, state, step_mode=False)
    x = rmsnorm_fwd(params["final_norm"], x[:, :S])
    return constrain(unembed_fwd(params["embed"], x), "data", None, "model")


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda"):
    """The recurrent state plays the role of the KV cache (O(1) in
    ``max_len``)."""
    return init_state(cfg, batch, device)


@torch.no_grad()
def prefill(cfg: ArchConfig, params, tokens, max_len=None):
    """Run the prompt into a new state: the largest multiple of ``CHUNK``
    chunkwise, the ragged tail token by token (pad tokens would corrupt
    the state).  Returns the last position's logits and the state."""
    B, S = tokens.shape
    state = lay_out_like(init_state(cfg, B, tokens.device), kv_cache_specs(cfg), tokens)
    x = constrain(embed_fwd(params["embed"], tokens, cfg.cdtype), "data", None, None)
    aligned = S - S % CHUNK
    if aligned:
        x_last = _run(cfg, params, x[:, :aligned], state, False, write=True)[:, -1:]
    for t in range(aligned, S):
        x_last = _run(cfg, params, x[:, t : t + 1], state, True, write=True)
    x_last = rmsnorm_fwd(params["final_norm"], x_last)
    return unembed_fwd(params["embed"], x_last), state


@torch.no_grad()
def decode_step(cfg: ArchConfig, params, state, tokens, offset=None):
    """One token (B, 1) -> (logits (B, 1, vocab), state written in place).
    ``offset`` is ignored: the state holds all the history there is."""
    x = constrain(embed_fwd(params["embed"], tokens, cfg.cdtype), "data", None, None)
    x = _run(cfg, params, x, state, True, write=True)
    x = rmsnorm_fwd(params["final_norm"], x)
    return unembed_fwd(params["embed"], x), state
