"""Shared model layers: norms, embeddings, RoPE, GQA attention, MLPs.

Functional style, as in the reference: ``init_*`` builds a dict of
tensors, ``*_fwd`` applies it.  Weights keep the reference's
``(d_in, d_out)`` orientation, so a reference parameter crosses over as
a plain copy.  Matmul-bearing layers compute in the dtype of their
input (bf16 on the card, f32 in the tests); norms and logits run in f32.
Attention is written out in plain torch ops (the naive and the
online-softmax paths) to mirror the reference, not a fused library call.

Each ``init_*`` has a ``*_specs`` beside it that gives the reference's
logical partition specs for the same tree (``fsdp`` / ``model``, resolved
by :mod:`repro_torch.distributed.sharding`).
"""

from __future__ import annotations

import functools
import math
import operator

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import P, constrain, grad_in_place, is_dtensor, local_map_specs, split_dim

Params = dict[str, torch.Tensor]

# Logical sharding axes, as in the reference: "fsdp" = ("pod", "data")
# where the mesh has them, "model" = tensor parallel.
FSDP = "fsdp"
TP = "model"


def init_generator(seed: int, device) -> torch.Generator | None:
    """A generator seeded with ``seed`` on ``device``; none on the meta
    device, where initialization builds shapes only."""
    if torch.device(device).type == "meta":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _init_dense(gen, d_in, d_out, dtype, device, scale=None, leading=()):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((*leading, d_in, d_out), generator=gen, device=device)
    return w.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d, dtype=torch.float32, device=None, leading=()) -> Params:
    return {"scale": torch.ones((*leading, d), dtype=dtype, device=device)}


def rmsnorm_specs():
    return {"scale": P(None)}


def rmsnorm_fwd(p, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p["scale"].float()).to(dt)


def init_layernorm(d, dtype=torch.float32, device=None, leading=()) -> Params:
    return {
        "scale": torch.ones((*leading, d), dtype=dtype, device=device),
        "bias": torch.zeros((*leading, d), dtype=dtype, device=device),
    }


def layernorm_specs():
    return {"scale": P(None), "bias": P(None)}


def layernorm_fwd(p, x, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * p["scale"].float() + p["bias"].float()).to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding (tied)
# ---------------------------------------------------------------------------


def init_embedding(gen, vocab, d, dtype=torch.float32, device=None) -> Params:
    emb = torch.randn((vocab, d), generator=gen, device=device)
    return {"embedding": emb.mul_(0.02).to(dtype)}


def embedding_specs():
    return {"embedding": P(TP, FSDP)}  # vocab on the TP axis


def embed_fwd(p, tokens, compute_dtype):
    table = grad_in_place(p["embedding"])  # tied: unembed_fwd reads it too
    if is_dtensor(table):
        # DTensor cannot look up a table laid out (vocab on model, d on
        # data) with ids sharded on data (GSPMD resolves that conflict, a
        # mask-shape IndexError here): look up with replicated ids, and
        # the caller's constrain() lays the rows out on the batch again
        from torch.distributed.tensor import DTensor, Replicate

        rep = (Replicate(),) * table.device_mesh.ndim
        tokens = (
            tokens.redistribute(table.device_mesh, rep)
            if is_dtensor(tokens)
            else DTensor.from_local(tokens, table.device_mesh, rep, run_check=False)
        )
    x = F.embedding(tokens, table).to(compute_dtype)
    if is_dtensor(x):
        # the vocab-sharded lookup is a masked partial sum: reduce it at
        # once, while its mask still fits (a later op that re-lays it
        # out, a concat, cannot, and the mask needs real data)
        from torch.distributed.tensor import Partial, Replicate

        settled = [Replicate() if isinstance(pl, Partial) else pl for pl in x.placements]
        x = x.redistribute(x.device_mesh, settled)
    return x


def unembed_fwd(p, x):
    # logits in f32 for loss stability
    return torch.einsum("bsd,vd->bsv", x.float(), grad_in_place(p["embedding"]).float())


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10_000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_inv(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The reference's frequencies on ``device``, copied there once: a copy
    from pageable host memory per call would stall the host on the card
    at every layer of every decode step.  Never written to."""
    return torch.from_numpy(rope_frequencies(head_dim, theta)).to(device)


def apply_rope(x, positions, theta=10_000.0):
    """x: (B, S, H, hd); positions: (B, S) integer."""
    hd = x.shape[-1]
    inv = _rope_inv(hd, float(theta), x.device)  # (hd/2,)
    ang = positions[..., None].float() * inv  # (B, S, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (full / causal / sliding-window; train + cached decode)
# ---------------------------------------------------------------------------


def init_attention(
    gen,
    d_model,
    n_heads,
    n_kv_heads,
    head_dim=None,
    dtype=torch.float32,
    device=None,
    bias=False,
    leading=(),
) -> Params:
    head_dim = head_dim or d_model // n_heads
    kw = dict(dtype=dtype, device=device, leading=leading)
    p = {
        "wq": _init_dense(gen, d_model, n_heads * head_dim, **kw),
        "wk": _init_dense(gen, d_model, n_kv_heads * head_dim, **kw),
        "wv": _init_dense(gen, d_model, n_kv_heads * head_dim, **kw),
        "wo": _init_dense(gen, n_heads * head_dim, d_model, **kw),
    }
    if bias:
        for name, d in (
            ("bq", n_heads * head_dim),
            ("bk", n_kv_heads * head_dim),
            ("bv", n_kv_heads * head_dim),
            ("bo", d_model),
        ):
            p[name] = torch.zeros((*leading, d), dtype=dtype, device=device)
    return p


def attention_specs(bias=False):
    s = {"wq": P(FSDP, TP), "wk": P(FSDP, TP), "wv": P(FSDP, TP), "wo": P(TP, FSDP)}
    if bias:
        s |= {"bq": P(TP), "bk": P(TP), "bv": P(TP), "bo": P(None)}
    return s


def _mask_bias(q_len, kv_len, offset, window, device):
    """Causal (+ optional sliding-window) additive f32 mask bias; query
    ``i`` sits at absolute position ``offset + i``."""
    q_pos = torch.arange(q_len, device=device)[:, None] + offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    ok = kv_pos <= q_pos
    if window is not None:
        ok &= kv_pos > q_pos - window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, torch.finfo(torch.float32).min)


def host_offset(offset) -> int:
    """A cache offset as a host int.  A tensor is refused: reading a CUDA
    one would make the host wait for the card on every decode step."""
    if isinstance(offset, torch.Tensor):
        raise TypeError("a cache offset is a host int, not a tensor")
    return operator.index(offset)


def write_cache(cache: torch.Tensor, new: torch.Tensor, offset: int) -> torch.Tensor:
    """Write ``new`` (B, S, ...) into ``cache`` (B, S_max, ...) at slot
    ``offset``, in place (ROADMAP C11), and return ``cache``.  The
    reference's ``dynamic_update_slice`` clamps a start past
    ``S_max - S`` and overwrites the last slots; this raises (C12)."""
    S, S_max = new.shape[1], cache.shape[1]
    if not 0 <= offset <= S_max - S:
        raise ValueError(f"cache write of {S} slots at offset {offset} outside a cache of {S_max}")
    cache[:, offset : offset + S] = new.to(cache.dtype)
    return cache


BLOCKWISE_KV_BLOCK = 1024
BLOCKWISE_MIN_KV = 4096  # use the online-softmax path above this kv length


def _blockwise_attention(qg, k, v, *, offset, window, causal, scale):
    """Online softmax over KV blocks, never materializing the (Sq, Skv)
    scores.  qg: (B, Sq, n_kv, group, hd); k/v: (B, Skv, n_kv, hd); query
    ``i`` sits at absolute position ``offset + i``.  Accumulates in f32;
    the loop over blocks is the reference's scan."""
    B, Sq, NKV, G, hd = qg.shape
    Skv = k.shape[1]
    blk = min(BLOCKWISE_KV_BLOCK, Skv)
    pad = (-Skv) % blk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nblk = k.shape[1] // blk
    dev = qg.device

    q32 = qg.float() * scale
    q_pos = torch.arange(Sq, device=dev) + offset
    m = torch.full((B, NKV, G, Sq), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, NKV, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, NKV, G, Sq, hd), dtype=torch.float32, device=dev)
    for i in range(nblk):
        start = i * blk
        kblk = k[:, start : start + blk].float()
        vblk = v[:, start : start + blk].float()
        s = torch.einsum("bsngh,btnh->bngst", q32, kblk)  # (B, NKV, G, Sq, blk)
        kv_pos = start + torch.arange(blk, device=dev)
        ok = torch.ones((Sq, blk), dtype=torch.bool, device=dev)
        if causal:
            ok &= kv_pos[None, :] <= q_pos[:, None]
        if window is not None:
            ok &= kv_pos[None, :] > q_pos[:, None] - window
        s = s.masked_fill(~ok, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new = -inf)
        safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - safe_m[..., None]).masked_fill(~ok, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bngst,btnh->bngsh", p, vblk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, NKV, G, Sq, hd)
    return out.movedim(3, 1).reshape(B, Sq, NKV * G * hd)


def _attention_core(qg, k, v, *, offset, window, causal, blockwise):
    """Scores, softmax and the weighted sum over V: qg (B, Sq, n_kv, group,
    hd), k/v (B, Skv, n_kv, hd) -> (B, Sq, n_kv * group * hd) in qg's dtype."""
    B, S, _, _, hd = qg.shape
    if blockwise:
        return _blockwise_attention(
            qg, k, v, offset=offset, window=window, causal=causal, scale=1.0 / math.sqrt(hd)
        ).to(qg.dtype)
    logits = torch.einsum("bsngh,btnh->bngst", qg, k) / math.sqrt(hd)
    logits = logits.float()
    if causal:
        logits = logits + _mask_bias(S, k.shape[1], offset, window, qg.device)
    attn = torch.softmax(logits, dim=-1).to(qg.dtype)
    return torch.einsum("bngst,btnh->bsngh", attn, v).reshape(B, S, -1)


def attention_fwd(
    p,
    x,
    *,
    n_heads,
    n_kv_heads,
    positions=None,
    rope_theta=10_000.0,
    use_rope=True,
    window=None,
    causal=True,
    kv_cache=None,  # (k, v) each (B, S_max, n_kv, hd), written in place
    cache_offset=None,  # host int: the slot of x's first position
    kv_x=None,  # cross-attention source (enc-dec)
    impl="auto",  # "naive" | "blockwise" | "auto"
):
    """Attention over ``x`` (B, S, D) -> (B, S, D).

    With ``kv_cache`` this step's K/V are written into the cache at
    ``cache_offset`` in place (ROADMAP C11) and the queries attend over
    the whole cache, as the reference's do; the reference returns the
    updated cache beside the output, here the caller already holds it.
    With ``kv_x``, K/V are projected from ``kv_x`` and k gets no RoPE.
    """
    B, S, D = x.shape
    hd = p["wq"].shape[-1] // n_heads
    cdt = x.dtype

    def proj(w, b, src, nh):
        y = torch.einsum("bsd,dh->bsh", src, w.to(cdt))
        if b is not None:
            y = y + b.to(cdt)
        return split_dim(y, -1, (nh, hd))

    src_kv = x if kv_x is None else kv_x
    q = proj(p["wq"], p.get("bq"), x, n_heads)
    k = proj(p["wk"], p.get("bk"), src_kv, n_kv_heads)
    v = proj(p["wv"], p.get("bv"), src_kv, n_kv_heads)

    start = 0 if cache_offset is None else host_offset(cache_offset)
    offset = start if kv_cache is not None else 0  # the mask's query offset
    if positions is None:
        positions = (torch.arange(S, device=x.device) + start)[None, :].expand(B, S)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        if kv_x is None:
            k = apply_rope(k, positions, rope_theta)

    if kv_cache is not None:
        ck, cv = kv_cache
        k = write_cache(ck, k, offset).to(cdt)
        v = write_cache(cv, v, offset).to(cdt)

    group = n_heads // n_kv_heads
    qg = split_dim(q, 2, (n_kv_heads, group))
    is_causal = causal or kv_cache is not None
    use_blockwise = impl == "blockwise" or (impl == "auto" and k.shape[1] >= BLOCKWISE_MIN_KV)
    core = functools.partial(
        _attention_core,
        offset=offset,
        window=window,
        causal=is_causal,
        blockwise=use_blockwise,
    )
    # per batch row and KV head: on DTensors each rank runs its own rows
    # and heads (op by op, the batched matmuls would fold a data-sharded
    # batch dim into a model-sharded head dim, a strided layout whose
    # redistribution plans take seconds to search)
    heads = P("data", None, "model")
    if n_kv_heads == 1:  # MQA: every rank reads the one KV head and runs its own query heads
        specs = (P("data", None, None, "model"), P("data"), P("data"))
    else:
        specs = (heads,) * 3
    out = local_map_specs(core, (qg, k, v), specs, (heads,))
    # the heads on "model" even where the core ran them whole (heads the
    # axis does not divide, C20), as the output projection's rows are
    out = torch.einsum("bsh,hd->bsd", constrain(out, "data", None, "model"), p["wo"].to(cdt))
    if p.get("bo") is not None:
        out = out + p["bo"].to(cdt)
    return out


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(
    gen, d_model, d_ff, dtype=torch.float32, device=None, gated=True, bias=False, leading=()
) -> Params:
    kw = dict(dtype=dtype, device=device, leading=leading)
    p = {
        "up": _init_dense(gen, d_model, d_ff, **kw),
        "down": _init_dense(gen, d_ff, d_model, **kw),
    }
    if gated:
        p["gate"] = _init_dense(gen, d_model, d_ff, **kw)
    if bias:
        p["b_up"] = torch.zeros((*leading, d_ff), dtype=dtype, device=device)
        p["b_down"] = torch.zeros((*leading, d_model), dtype=dtype, device=device)
    return p


def mlp_specs(gated=True, bias=False):
    s = {"up": P(FSDP, TP), "down": P(TP, FSDP)}
    if gated:
        s["gate"] = P(FSDP, TP)
    if bias:
        s |= {"b_up": P(TP), "b_down": P(None)}
    return s


_ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda h: F.gelu(h, approximate="tanh"),  # jax.nn.gelu's default
    "relu": F.relu,
}


def mlp_fwd(p, x, activation="silu"):
    cdt = x.dtype
    act = _ACTIVATIONS[activation]
    h = torch.einsum("bsd,df->bsf", x, p["up"].to(cdt))
    if p.get("b_up") is not None:
        h = h + p["b_up"].to(cdt)
    if "gate" in p:
        g = torch.einsum("bsd,df->bsf", x, p["gate"].to(cdt))
        h = act(g) * h
    else:
        h = act(h)
    out = torch.einsum("bsf,fd->bsd", h, p["down"].to(cdt))
    if p.get("b_down") is not None:
        out = out + p["b_down"].to(cdt)
    return out
