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


def flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """``{path: leaf}`` in the reference's leaf order."""
    out: dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out |= flatten(tree[k], f"{prefix}{k}{SEP}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out |= flatten(v, f"{prefix}{i}{SEP}")
    else:
        out[prefix[: -len(SEP)]] = tree
    return out


def unflatten_into(skeleton: Any, flat: dict[str, Any], prefix: str = "") -> Any:
    """The structure of ``skeleton`` with its leaves taken from ``flat``."""
    if isinstance(skeleton, dict):
        return {
            k: unflatten_into(v, flat, f"{prefix}{k}{SEP}") for k, v in skeleton.items()
        }
    if isinstance(skeleton, (list, tuple)):
        vals = [unflatten_into(v, flat, f"{prefix}{i}{SEP}") for i, v in enumerate(skeleton)]
        return type(skeleton)(vals) if isinstance(skeleton, tuple) else vals
    return flat[prefix[: -len(SEP)]]


def unstack(stacked) -> list:
    """One tree of layer-``i`` views per layer, from a tree of stacked
    ``(L, ...)`` leaves (the reference's ``lax.scan`` layout)."""
    flat = flatten(stacked)
    slices = {k: v.unbind(0) for k, v in flat.items()}
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
