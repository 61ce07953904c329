"""Parameter trees: flattening, and the carry-across to and from the
reference package.

A tree is nested dicts (and lists/tuples) of tensors, as the reference's
pytrees are.  :func:`flatten` keys each leaf by its ``/``-joined path in
the reference's leaf order (``jax.tree.leaves`` sorts dict keys), so the
port's gradient leaves line up one for one with the reference's.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

SEP = "/"


def flatten(tree: Any, prefix: str = "", is_leaf=None) -> dict[str, Any]:
    """``{path: leaf}`` in the reference's leaf order; ``is_leaf(x)`` marks
    containers to keep whole (a sharding spec is a tuple)."""
    out: dict[str, Any] = {}
    if is_leaf is not None and is_leaf(tree):
        out[prefix[: -len(SEP)]] = tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            out |= flatten(tree[k], f"{prefix}{k}{SEP}", is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out |= flatten(v, f"{prefix}{i}{SEP}", is_leaf)
    else:
        out[prefix[: -len(SEP)]] = tree
    return out


def unflatten_into(skeleton: Any, flat: dict[str, Any], prefix: str = "", is_leaf=None) -> Any:
    """The structure of ``skeleton`` with its leaves taken from ``flat``."""
    if is_leaf is not None and is_leaf(skeleton):
        return flat[prefix[: -len(SEP)]]
    if isinstance(skeleton, dict):
        return {
            k: unflatten_into(v, flat, f"{prefix}{k}{SEP}", is_leaf) for k, v in skeleton.items()
        }
    if isinstance(skeleton, (list, tuple)):
        vals = [
            unflatten_into(v, flat, f"{prefix}{i}{SEP}", is_leaf) for i, v in enumerate(skeleton)
        ]
        return type(skeleton)(vals) if isinstance(skeleton, tuple) else vals
    return flat[prefix[: -len(SEP)]]


def _unbind(v: torch.Tensor) -> tuple:
    """``v.unbind(0)``.  A DTensor (its stacked dim 0 is never sharded) is
    unbound on its local shard and each slice wrapped back, so the
    backward is plain ``unbind``'s, which zero-fills a slice that got no
    gradient (DTensor's own raises then, mixing tensors and DTensors)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(v, DTensor):
        return v.unbind(0)
    if any(isinstance(pl, Shard) and pl.dim == 0 for pl in v.placements):
        raise ValueError("the stacked layer dim of a DTensor is sharded")
    pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p for p in v.placements)
    shape, stride = v.shape[1:], v.stride()[1:]
    return tuple(
        DTensor.from_local(t, v.device_mesh, pl, run_check=False, shape=shape, stride=stride)
        for t in v.to_local().unbind(0)
    )


def unstack(stacked) -> list:
    """One tree of layer-``i`` views per layer, from a tree of stacked
    ``(L, ...)`` leaves (the reference's ``lax.scan`` layout)."""
    flat = flatten(stacked)
    slices = {k: _unbind(v) for k, v in flat.items()}
    n = len(next(iter(slices.values())))
    return [unflatten_into(stacked, {k: s[i] for k, s in slices.items()}) for i in range(n)]


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: widen exactly, narrow back
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_reference(tree: Any, device="cuda") -> Any:
    """The reference's parameter pytree (numpy or JAX arrays) as the
    port's parameters on ``device``: same structure, leaves and dtypes."""
    flat = {k: _to_torch(v, device) for k, v in flatten(tree).items()}
    return unflatten_into(tree, flat)


def params_to_reference(params: Any) -> Any:
    """The port's parameters as a tree of numpy arrays (bf16 widened to
    float32, which is exact), for comparison with the reference."""
    flat = {
        k: v.detach().cpu().float().numpy()
        if v.dtype == torch.bfloat16
        else v.detach().cpu().numpy()
        for k, v in flatten(params).items()
    }
    return unflatten_into(params, flat)
