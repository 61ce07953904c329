"""Train / prefill / decode step factories, generic over architecture."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import get_model
from repro_torch.models.state import flatten
from repro_torch.train.optimizer import (
    OptimizerConfig,
    adamw_update,
    clip_by_global_norm,
)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy; logits (B, S, V) f32, labels (B, S)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])
    if is_dtensor(gold):
        # a gather over vocab-sharded logits is a masked partial sum:
        # reduce it while it still has the shape its mask was made for
        from torch.distributed.tensor import Partial, Replicate

        settled = [Replicate() if isinstance(pl, Partial) else pl for pl in gold.placements]
        gold = gold.redistribute(gold.device_mesh, settled)
    return torch.mean(logz - gold[..., 0])


def make_loss_fn(cfg: ArchConfig) -> Callable:
    model = get_model(cfg)

    def loss_fn(params, batch):
        logits = model.forward(cfg, params, **batch["inputs"])
        # the next-token shift happens in the data pipeline; labels align
        # to logits positions directly
        return softmax_xent(logits, batch["labels"])

    return loss_fn


def loss_and_grads(loss_fn: Callable, params, batch):
    """The loss (a 0-d tensor) and the gradient of every leaf of
    ``params``, as a list in :func:`~repro_torch.models.state.flatten`
    order.  A DTensor leaf's gradient comes in that leaf's placements
    (reduced over the ranks that computed parts of it), and a DTensor
    loss comes back whole."""
    leaves = list(flatten(params).values())
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(params, batch)
        grads = list(torch.autograd.grad(loss, leaves))
    for i, (p, g) in enumerate(zip(leaves, grads)):
        if is_dtensor(g) and g.placements != p.placements:
            grads[i] = g.redistribute(p.device_mesh, p.placements)
    loss = loss.detach()
    return (loss.full_tensor() if is_dtensor(loss) else loss), grads


def make_train_step(cfg: ArchConfig, opt_cfg: OptimizerConfig) -> Callable:
    """AdamW step with global-norm clipping; updates in place and returns
    ``(params, opt_state, metrics)``."""
    loss_fn = make_loss_fn(cfg)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(loss_fn, params, batch)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
            params, opt_state = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ArchConfig, max_len: int) -> Callable:
    model = get_model(cfg)

    def prefill_step(params, batch):
        return model.prefill(cfg, params, max_len=max_len, **batch["inputs"])

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    """``decode_step(params, cache, tokens, offset)``; ``offset`` is a host
    int and the cache is written in place (ROADMAP C11)."""
    model = get_model(cfg)

    def decode_step(params, cache, tokens, offset):
        return model.decode_step(cfg, params, cache, tokens, offset)

    return decode_step
