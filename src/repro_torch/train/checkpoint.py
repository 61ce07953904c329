"""Fault-tolerant checkpointing: atomic commits, async writes, elastic
restore onto a different mesh.

Layout, as in the reference:

    <dir>/step_<N>/
        manifest.json     step, the flattened keys, each leaf's dtype and
                          logical partition spec
        arrays.npz        one entry per leaf (``/``-joined path keys)
    <dir>/step_<N>.tmp-*  staging, renamed atomically on commit

numpy has no bfloat16, so a bf16 tensor is stored as its 16-bit pattern
(``int16``) and the manifest records ``bfloat16`` for it.

Sharded leaves (DTensors) are gathered whole before they are written, so
the layout on disk is the unsharded one whatever the mesh: every rank
takes part in the gather, rank 0 writes, and a blocking save holds the
other ranks until the write is committed.  A restore puts every leaf on
its skeleton leaf's device and dtype and, given ``mesh`` and
``spec_tree``, re-shards it by its logical spec on that mesh, which
need not be the mesh it was saved from (elastic re-mesh).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.distributed.sharding import is_dtensor, is_spec, shard_leaf
from repro_torch.models.state import flatten, unflatten_into


def _to_host(v) -> tuple[np.ndarray, str]:
    if isinstance(v, torch.Tensor):
        if is_dtensor(v):
            v = v.full_tensor()
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.asarray(v, dtype=np.int32) if isinstance(v, int) else np.asarray(v)
    return a, a.dtype.name


def _from_host(a: np.ndarray, dtype: str, like):
    if isinstance(like, int):
        return int(a)
    t = torch.from_numpy(np.array(a))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device=like.device, dtype=like.dtype)


def _spec_to_json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, spec_tree: Any = None, *, block=True):
        """Copy ``tree`` to the host now (sharded leaves gathered whole, on
        every rank); rank 0 writes it now (``block``) or on a background
        thread, one write in flight at a time."""
        self.wait()
        host = {k: _to_host(v) for k, v in flatten(tree).items()}
        if _rank() != 0:
            if block:
                _barrier()
            return
        specs = (
            {k: _spec_to_json(s) for k, s in flatten(spec_tree, is_leaf=is_spec).items()}
            if spec_tree is not None
            else {}
        )

        def _write():
            manifest = {
                "step": step,
                "keys": sorted(host),
                "dtypes": {k: dt for k, (_, dt) in host.items()},
                "specs": specs,
            }
            staging = tempfile.mkdtemp(prefix=f"step_{step}.tmp-", dir=self.dir)
            np.savez(os.path.join(staging, "arrays.npz"), **{k: a for k, (a, _) in host.items()})
            with open(os.path.join(staging, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = os.path.join(self.dir, f"step_{step}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(staging, final)  # atomic commit
            self._gc()

        if block:
            _write()
            _barrier()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"))

    # -- restore ---------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp-" not in name:
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(
        self, skeleton: Any, step: int | None = None, *, mesh=None, spec_tree: Any = None
    ) -> Any:
        """Restore into the structure of ``skeleton``: a tensor leaf comes
        back on its skeleton leaf's device and dtype, an int as an int.
        With ``mesh`` and ``spec_tree`` each tensor leaf is laid out on
        ``mesh`` by its logical spec, whatever mesh saved it."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            dtypes = json.load(f)["dtypes"]
        like = flatten(skeleton)
        specs = flatten(spec_tree, is_leaf=is_spec) if mesh is not None and spec_tree is not None else {}
        flat = {}
        with np.load(os.path.join(path, "arrays.npz")) as z:
            for k in like:
                v = _from_host(z[k], dtypes[k], like[k])
                flat[k] = shard_leaf(v, specs[k], mesh) if k in specs and isinstance(v, torch.Tensor) else v
        return unflatten_into(skeleton, flat)
