"""AdamW and signSGD on parameter trees, mirroring the reference's
arithmetic (f32 math, results cast back to each leaf's dtype).

Unlike the reference's pure functions these update the parameters and
the moments in place, leaf by leaf, so no second copy of the model or
its optimizer state is ever alive; each returns the same objects.
Parameters may be DTensors (a sharded trainer): the moments are then
DTensors laid out like them, and the gradients must come in the
parameters' placements.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.distributed.sharding import P, is_dtensor
from repro_torch.models.state import flatten, unflatten_into


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # "bfloat16" halves optimizer memory
    mode: str = "adamw"  # or "signsgd" (majority-voted sign updates)


def init_opt_state(params: Any, cfg: OptimizerConfig) -> Any:
    """Zero moments laid out like ``params`` (a DTensor parameter gets
    DTensor moments; allocated in signSGD mode too, as in the reference)
    and a step count."""
    dt = getattr(torch, cfg.state_dtype)
    flat = flatten(params)

    def zeros():
        return unflatten_into(params, {k: torch.zeros_like(p, dtype=dt) for k, p in flat.items()})

    return {"mu": zeros(), "nu": zeros(), "step": 0}


def opt_state_specs(param_specs: Any) -> Any:
    """Optimizer moments shard exactly like their parameters (ZeRO)."""
    return {"mu": param_specs, "nu": param_specs, "step": P()}


def _sum_squares(g: torch.Tensor) -> torch.Tensor:
    s = torch.sum(torch.square(g.float()))
    return s.full_tensor() if is_dtensor(s) else s  # the sum over every shard


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float):
    """Scale ``grads`` in place to a global L2 norm of at most
    ``max_norm``; returns them and the norm before clipping (a 0-d f32
    tensor; over every shard of sharded grads)."""
    gnorm = torch.sqrt(sum(_sum_squares(g) for g in grads))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return grads, gnorm


def adamw_update(params, grads, state, cfg: OptimizerConfig):
    """One AdamW step; ``grads`` is a tree like ``params`` or a list in
    :func:`flatten` order."""
    step = state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    # bias corrections in f32, as the reference computes b ** step
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
    ps = list(flatten(params).values())
    gs = grads if isinstance(grads, list) else list(flatten(grads).values())
    mus = list(flatten(state["mu"]).values())
    nus = list(flatten(state["nu"]).values())
    for p, g, mu, nu in zip(ps, gs, mus, nus, strict=True):
        g32 = g.float()
        mu32 = mu.float() * b1 + (1 - b1) * g32
        nu32 = nu.float() * b2 + (1 - b2) * g32 * g32
        delta = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
        p32 = p.float()
        p.copy_(p32 - cfg.lr * (delta + cfg.weight_decay * p32))
        mu.copy_(mu32)
        nu.copy_(nu32)
    state["step"] = step
    return params, state


def signsgd_leaf(p: torch.Tensor, s: torch.Tensor, cfg: OptimizerConfig) -> None:
    """``p <- p - lr * (s + wd * p)`` in f32, cast to ``p``'s dtype.

    ``s`` is an f32 buffer the caller gives up: it holds the f32 result
    on the way, so the update allocates nothing."""
    s.add_(p, alpha=cfg.weight_decay)
    s.mul_(-cfg.lr).add_(p)
    p.copy_(s)


def signsgd_update(params, sign_grads, state, cfg: OptimizerConfig):
    """signSGD: ``sign_grads`` are the (scaled) ±1 votes, f32 buffers that
    this update consumes.  The moments are carried unchanged."""
    gs = sign_grads if isinstance(sign_grads, list) else list(flatten(sign_grads).values())
    for p, s in zip(flatten(params).values(), gs, strict=True):
        signsgd_leaf(p, s, cfg)
    state["step"] += 1
    return params, state
