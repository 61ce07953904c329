"""Logical-axis sharding rules resolved against the active mesh.

Model code annotates parameters and activations with *logical* axes
("fsdp", "model", "data"); this module rewrites them to the physical axes
of a ``torch.distributed.device_mesh.DeviceMesh``, with the reference's
rules:

* ``fsdp``  -> ("pod", "data") on the multi-pod mesh, "data" on a single
  pod, dropped on meshes without a data axis.
* ``model`` -> "model" when present, else dropped.
* ``data``  -> ("pod", "data") / "data" for activation batch dims.

Dropping an axis replicates along it, so the same model code runs on one
device and on a 512-rank mesh.  A resolved spec becomes DTensor
placements (:func:`placements`); :func:`shard_tree` lays a parameter tree
out by its specs and :func:`constrain` is the counterpart of
``with_sharding_constraint``.

Specs are :class:`P`, a tuple of per-dim entries (``None``, an axis name
or a tuple of axis names).  :class:`AbstractMesh` carries a mesh's axis
names and sizes only, for dry-runs and tests that need no process group.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any

import torch

from repro_torch.models.state import flatten, unflatten_into

LOGICAL_FSDP = "fsdp"
LOGICAL_TP = "model"
LOGICAL_DP = "data"


class P(tuple):
    """A partition spec: one entry per tensor dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    return isinstance(x, P)


def map_specs(fn, spec_tree: Any) -> Any:
    """``fn`` applied to every :class:`P` leaf of ``spec_tree``."""
    flat = flatten(spec_tree, is_leaf=is_spec)
    return unflatten_into(spec_tree, {k: fn(s) for k, s in flat.items()}, is_leaf=is_spec)


class AbstractMesh:
    """Axis names and sizes of a mesh, without devices or ranks."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} does not match axes {axis_names}")
        self.mesh_shape = tuple(shape)
        self.mesh_dim_names = tuple(axis_names)

    def size(self, dim: int | None = None) -> int:
        return math.prod(self.mesh_shape) if dim is None else self.mesh_shape[dim]

    def __repr__(self) -> str:
        return f"AbstractMesh({self.mesh_shape}, {self.mesh_dim_names})"


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or :class:`AbstractMesh`."""
    names = tuple(mesh.mesh_dim_names)
    return {n: mesh.size(i) for i, n in enumerate(names)}


_ACTIVE_MESH: list = []


@contextlib.contextmanager
def active_mesh(mesh):
    """Make ``mesh`` the one :func:`constrain` and the models resolve
    against."""
    _ACTIVE_MESH.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.pop()


def current_mesh():
    return _ACTIVE_MESH[-1] if _ACTIVE_MESH else None


def _physical(entry, axes: tuple[str, ...]):
    if entry is None:
        return None
    entries = entry if isinstance(entry, tuple) else (entry,)
    out: list[str] = []
    for e in entries:
        if e in (LOGICAL_FSDP, LOGICAL_DP):
            if "pod" in axes and "data" in axes:
                out.extend(["pod", "data"])
            elif "data" in axes:
                out.append("data")
        elif e == LOGICAL_TP:
            if "model" in axes:
                out.append("model")
        elif e in axes:
            out.append(e)
    if not out:
        return None
    return tuple(out) if len(out) > 1 else out[0]


def resolve_spec(spec: P, mesh) -> P:
    axes = tuple(mesh.mesh_dim_names)
    return P(*[_physical(e, axes) for e in spec])


def resolve_tree(spec_tree: Any, mesh) -> Any:
    return map_specs(lambda s: resolve_spec(s, mesh), spec_tree)


def stacked(spec_tree: Any) -> Any:
    """Prepend an unsharded leading (layer-stack) dim to every spec."""
    return map_specs(lambda s: P(None, *s), spec_tree)


def sanitize(spec: P, shape, mesh) -> P:
    """Replicate every dim of a resolved ``spec`` that its mesh axes do not
    divide (the reference's ``_sanitized_shardings``), so no shard is
    ragged."""
    sizes = mesh_axes(mesh)
    out = []
    for i, e in enumerate(spec):
        if e is None or i >= len(shape):
            out.append(e)
            continue
        names = e if isinstance(e, tuple) else (e,)
        out.append(e if shape[i] % math.prod(sizes[a] for a in names) == 0 else None)
    return P(*out)


def drop_data_axis(spec: P) -> P:
    """A spec with every entry that names data/fsdp replicated (batch-1
    shapes cannot shard the batch)."""

    def hits(e):
        names = e if isinstance(e, tuple) else (e,)
        return any(x in (LOGICAL_DP, LOGICAL_FSDP) for x in names)

    return P(*[None if e is not None and hits(e) else e for e in spec])


def local_shape(shape, spec: P, mesh) -> tuple[int, ...]:
    """One rank's shard shape of a tensor of ``shape`` laid out by a
    resolved, sanitized ``spec`` on ``mesh``."""
    sizes = mesh_axes(mesh)
    out = list(shape)
    for i, e in enumerate(spec):
        if e is None or i >= len(shape):
            continue
        names = e if isinstance(e, tuple) else (e,)
        out[i] //= math.prod(sizes[a] for a in names)
    return tuple(out)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of a resolved ``spec``: a mesh dim that shards
    tensor dim ``i`` is ``Shard(i)``, every other mesh dim ``Replicate()``.
    A tuple entry shards one tensor dim over several mesh dims, major to
    minor; those mesh dims must come in mesh order (JAX's order is then
    DTensor's default left-to-right sharding)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for i, e in enumerate(spec):
        if e is None:
            continue
        dims = [names.index(a) for a in (e if isinstance(e, tuple) else (e,))]
        if dims != sorted(dims):
            raise NotImplementedError(f"entry {e} is not in mesh order {names}")
        for d in dims:
            if not isinstance(out[d], Replicate):
                raise ValueError(f"mesh axis {names[d]!r} used twice in {spec}")
            out[d] = Shard(i)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


@functools.cache
def register_strategies() -> None:
    """Teach DTensor the elementwise ops the models need and it lacks:
    ``log_sigmoid_backward`` (the xLSTM's forget gates) keeps its input's
    shards.  Its ``buffer`` is the input's shape on the CPU and empty on
    CUDA, where it is replicated.  Called once, before the first DTensor
    is laid out."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.log_sigmoid_backward.default)
    def _log_sigmoid_backward(grad_output, x, buffer):
        def buf(pl):
            return pl if buffer.shape == x.shape else Replicate()

        rep = Replicate()
        out = [([rep], [rep, rep, rep])]
        out += [([Shard(d)], [Shard(d), Shard(d), buf(Shard(d))]) for d in range(len(x.shape))]
        return out


def shard_leaf(t: torch.Tensor, spec: P, mesh):
    """``t`` (the full tensor, the same on every rank) as a DTensor laid
    out by its logical ``spec``; each rank keeps its own shard, no data
    moves between ranks."""
    from torch.distributed.tensor import distribute_tensor

    register_strategies()
    pl = placements(sanitize(resolve_spec(spec, mesh), t.shape, mesh), mesh)
    return distribute_tensor(t.detach(), mesh, pl, src_data_rank=None)


def shard_tree(tree: Any, spec_tree: Any, mesh) -> Any:
    """Every leaf of ``tree`` laid out by the spec at the same path of
    ``spec_tree`` (the counterpart of ``shardings_tree`` + ``device_put``).
    Leaves are replaced one at a time, so a full copy of one leaf at most
    is alive beside the tree."""
    specs = flatten(spec_tree, is_leaf=is_spec)
    flat = flatten(tree)
    out = {}
    for k in list(flat):
        out[k] = shard_leaf(flat.pop(k), specs[k], mesh)
    return unflatten_into(tree, out)


def lay_out_like(tree: Any, spec_tree: Any, like) -> Any:
    """A new cache or state ``tree`` (plain tensors of global shape) laid
    out by ``spec_tree`` on the mesh of ``like`` (the step's input) when
    that is a DTensor on more than one rank, so that writes into it keep
    their shards (the reference's jit shards it by propagation);
    unchanged otherwise."""
    if not is_dtensor(like) or like.device_mesh.size() == 1:
        return tree
    return shard_tree(tree, spec_tree, like.device_mesh)


def grad_in_place(t):
    """``t`` unchanged, but a DTensor's gradient through this use arrives
    in ``t``'s own placements.  A leaf used twice (the tied embedding:
    looked up, and unembedded) gets one gradient per use; each in its
    own layout, their sum can need a redistribution DTensor lacks (a
    ``Shard`` into a ``Partial`` on torch 2.11), so each use's gradient is
    laid out like the leaf before they are added."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor

    local = t.to_local(grad_placements=t.placements)
    return DTensor.from_local(local, t.device_mesh, t.placements, run_check=False, shape=t.shape, stride=t.stride())


def split_dim(x, dim: int, sizes: tuple[int, ...]):
    """``x`` with ``dim`` split into ``sizes`` (``unflatten``).  A DTensor
    whose shards of ``dim`` would not split evenly (its mesh axes do not
    divide ``sizes[0]``, e.g. 24 heads on a 16-way model axis) has
    ``dim`` replicated first: DTensor refuses an uneven split, where GSPMD
    pads."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        dim = dim % x.dim()
        ways = math.prod(x.device_mesh.size(i) for i, pl in enumerate(x.placements) if pl.is_shard(dim))
        if sizes[0] % ways:
            rep = [Replicate() if pl.is_shard(dim) else pl for pl in x.placements]
            x = x.redistribute(x.device_mesh, rep)
    return x.unflatten(dim, sizes)


def _names(e) -> tuple:
    return () if e is None else e if isinstance(e, tuple) else (e,)


def local_map_specs(fn, args, specs, out_specs):
    """``fn(*args)`` on each rank's own shards.  ``specs`` lays out each
    tensor of ``args`` (logical specs, resolved against the mesh of the
    DTensors among them) and ``out_specs`` each tensor ``fn`` returns; a
    mesh axis that does not divide some dim it shards is replicated in
    every spec.  Plain tensors call ``fn`` as it is.  For computations
    that are independent per row and per head (attention, MoE routing),
    which DTensor would otherwise trace op by op."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    sizes = mesh_axes(mesh)
    ins = [resolve_spec(s, mesh) for s in specs]
    outs = [resolve_spec(s, mesh) for s in out_specs]
    drop = {
        n
        for a, r in zip(args, ins)
        for i, e in enumerate(r)
        if e is not None and a.shape[i] % math.prod(sizes[n] for n in _names(e))
        for n in _names(e)
    }

    def keep(r: P) -> tuple:
        kept = [tuple(n for n in _names(e) if n not in drop) for e in r]
        return placements(P(*[k if len(k) > 1 else (k[0] if k else None) for k in kept]), mesh)

    in_pl = tuple(keep(r) for r in ins)
    # an input whole over a mesh axis that another input is split over
    # (a weight beside data-split rows, the one KV head beside
    # model-split query heads) gets from each rank only that rank's
    # share of its gradient: the sum over the axis, not a copy
    split = {i for pl in in_pl for i, p in enumerate(pl) if p.is_shard()}
    grad_pl = tuple(
        tuple(Partial() if i in split and p.is_replicate() else p for i, p in enumerate(pl)) for pl in in_pl
    )
    return local_map(
        fn,
        out_placements=tuple(keep(r) for r in outs),
        in_placements=in_pl,
        in_grad_placements=grad_pl,
        device_mesh=mesh,
        redistribute_inputs=True,
    )(*args)


def constrain(x, *entries):
    """Lay ``x`` out by logical ``entries`` (a ``redistribute``), every
    axis that does not divide its dim replicated (no shard is ragged);
    the identity on a plain tensor, outside a mesh and on a one-rank
    mesh.  As ``with_sharding_constraint``'s transpose does, the gradient
    through it is laid out the same way (a partial one is reduced here),
    so the backward matmuls below it split as the forward's do."""
    mesh = current_mesh()
    if mesh is None or mesh.size() == 1 or not is_dtensor(x):
        return x
    spec = sanitize(resolve_spec(P(*entries), mesh), x.shape, mesh)
    return grad_in_place(x.redistribute(x.device_mesh, placements(spec, mesh)))
