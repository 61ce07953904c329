"""Fault-tolerant checkpointing: atomic commits, async writes.

Layout, as in the reference:

    <dir>/step_<N>/
        manifest.json     step, the flattened keys, each leaf's dtype
        arrays.npz        one entry per leaf (``/``-joined path keys)
    <dir>/step_<N>.tmp-*  staging, renamed atomically on commit

numpy has no bfloat16, so a bf16 tensor is stored as its 16-bit pattern
(``int16``) and the manifest records ``bfloat16`` for it.  The
reference's sharding specs and elastic re-mesh have no counterpart on
one device; a restore puts every leaf on the device and dtype of the
skeleton it restores into.
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

from repro_torch.models.state import flatten, unflatten_into


def _to_host(v) -> tuple[np.ndarray, str]:
    if isinstance(v, torch.Tensor):
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


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, *, block=True):
        """Copy ``tree`` to the host now; write it now (``block``) or on a
        background thread, one write in flight at a time."""
        self.wait()
        host = {k: _to_host(v) for k, v in flatten(tree).items()}

        def _write():
            manifest = {
                "step": step,
                "keys": sorted(host),
                "dtypes": {k: dt for k, (_, dt) in host.items()},
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

    def restore(self, skeleton: Any, step: int | None = None) -> Any:
        """Restore into the structure of ``skeleton``: a tensor leaf comes
        back on its skeleton leaf's device and dtype, an int as an int."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            dtypes = json.load(f)["dtypes"]
        like = flatten(skeleton)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: _from_host(z[k], dtypes[k], like[k]) for k in like}
        return unflatten_into(skeleton, flat)
