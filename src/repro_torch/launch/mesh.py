"""Process groups and device meshes.

Functions, not module-level objects, so importing this module touches no
process group or device.  The device type is always explicit: ``cuda``
runs NCCL, ``cpu`` runs gloo (tests, CPU rehearsals), and nothing falls
back from one to the other.

A process group comes up from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), or, run alone, as a
single rank over a file store in a fresh temporary directory (no port is
taken).  :func:`fake_mesh` brings up a mesh of any size in one process
over PyTorch's ``"fake"`` backend, whose collectives move nothing: the
roofline counts a production mesh's per-rank program on it.
"""

from __future__ import annotations

import contextlib
import math
import os
import tempfile

import torch

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def _backend(device_type: str) -> str:
    if device_type not in BACKENDS:
        raise ValueError(f"unsupported device type {device_type!r}")
    return BACKENDS[device_type]


def init_process_group(device_type: str = "cuda", init_method: str | None = None) -> int:
    """Bring up the default process group for ``device_type`` (or check
    the one that is up); returns this rank.  On ``cuda`` each rank takes
    the card ``LOCAL_RANK`` names."""
    import torch.distributed as dist

    backend = _backend(device_type)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} group is up, {device_type} needs {backend}")
        return dist.get_rank()
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device_type='cpu' for gloo")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if init_method is None and "WORLD_SIZE" not in os.environ:
        init_method = f"file://{tempfile.mkdtemp()}/pg"
    if init_method is None:
        dist.init_process_group(backend)
    else:
        rank = int(os.environ.get("RANK", 0))
        world = int(os.environ.get("WORLD_SIZE", 1))
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return dist.get_rank()


def _mesh(device_type: str, shape: tuple[int, ...], axes: tuple[str, ...]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    init_process_group(device_type)
    n = dist.get_world_size()
    if n != math.prod(shape):
        raise ValueError(f"a {shape} mesh over {n} ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's 16x16 ("data", "model") mesh, or 2x16x16 ("pod",
    "data", "model") with ``multi_pod``, over 256 / 512 ranks."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return _mesh(device_type, shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A ("data", "model") mesh over the ranks that exist: ``data`` is cut
    to the world size and ``model`` to what is left, and their product
    must then be the world size."""
    import torch.distributed as dist

    init_process_group(device_type)
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, n // data)
    return _mesh(device_type, (data, model), ("data", "model"))


@contextlib.contextmanager
def fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over ``prod(shape)`` ranks of the
    ``"fake"`` backend, this process rank 0; the group is destroyed on
    exit.  Raises if a process group is already up: it never reuses a
    group of another backend or size.  The ``FakeStore`` lives in
    ``torch.testing._internal``; a torch without it fails here."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(f"a {dist.get_backend()} group is up; a fake mesh needs its own process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))
    finally:
        dist.destroy_process_group()
