"""The training loop: eager steps, on one device or sharded over a
``DeviceMesh``, checkpoint/restart, straggler watchdog, optional 1-bit
sign-compressed gradients.

* **sharding** — with ``mesh=`` the parameters, moments and error
  feedback are DTensors laid out by the model's logical specs
  (``param_specs``, resolved by :mod:`repro_torch.distributed.sharding`)
  and each batch is sharded on ``data``; the step runs under that mesh.
* **checkpoint/restart** — atomic async checkpoints every ``ckpt_every``
  steps; on (re)start the trainer restores the latest complete
  checkpoint and resumes, re-sharded onto the trainer's own mesh
  (elastic re-mesh).
* **straggler watchdog** — per-step wall time EWMA; steps slower than
  ``straggler_factor ×`` the EWMA fire a callback.
* **grad compression** — ``compress_grads="signsgd"`` runs scaled signSGD
  with error feedback: each gradient's signs are packed 1-bit with the
  pack kernel (B5) and unpacked as ±1 with the unpack kernel (B6).

The signSGD step works leaf by leaf and in place, so the memory it needs
beyond the model, its optimizer state and the error feedback is one
leaf's ``acc`` and ``signs`` (f32) plus its packed words: for
starcoder2-3b's largest leaf, 2 x 4.5 GB, where keeping every leaf's
temporaries alive at once would not fit on an 80 GB card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.distributed.sharding import (
    P,
    active_mesh,
    is_dtensor,
    shard_leaf,
    shard_tree,
)
from repro_torch.kernels.signcomp import compress_signs, decompress_signs
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import get_model
from repro_torch.models.state import flatten, unflatten_into
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import (
    OptimizerConfig,
    init_opt_state,
    opt_state_specs,
    signsgd_leaf,
)
from repro_torch.train.steps import loss_and_grads, make_loss_fn, make_train_step


@dataclass
class TrainerConfig:
    opt: OptimizerConfig = field(default_factory=OptimizerConfig)
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    ckpt_async: bool = True
    straggler_factor: float = 3.0
    straggler_warmup: int = 3
    compress_grads: str = "none"  # "none" | "signsgd"


class StragglerWatchdog:
    def __init__(self, factor: float, warmup: int, on_straggler: Callable):
        self.factor = factor
        self.warmup = warmup
        self.on_straggler = on_straggler
        self.ewma: float | None = None
        self.count = 0
        self.events: list[tuple[int, float, float]] = []

    def observe(self, step: int, dt: float):
        self.count += 1
        if self.ewma is None:
            self.ewma = dt
            return
        if self.count > self.warmup and dt > self.factor * self.ewma:
            self.events.append((step, dt, self.ewma))
            self.on_straggler(step, dt, self.ewma)
        else:
            self.ewma = 0.9 * self.ewma + 0.1 * dt


# called per leaf of a signSGD step as hook(name, acc, words, signs)
LeafHook = Callable[[str, torch.Tensor, torch.Tensor, torch.Tensor], None]


def _l1_sum(flat: torch.Tensor, like) -> torch.Tensor:
    """sum(|acc|) over the whole leaf: ``flat`` is this rank's shard of
    ``like`` (a DTensor parameter) or the whole leaf.  A sharded sum is
    one all-reduce over the mesh in which only the ranks at coordinate 0
    of every replicated mesh dim contribute, so no copy counts twice."""
    s = torch.linalg.vector_norm(flat, ord=1)
    if not is_dtensor(like):
        return s
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    mesh = like.device_mesh
    coord = mesh.get_coordinate()
    own = all(c == 0 for c, pl in zip(coord, like.placements) if not isinstance(pl, Shard))
    if not own:
        s = torch.zeros_like(s)
    dist.all_reduce(s, group=_mesh_group(mesh))
    return s


def _mesh_group(mesh):
    """The process group of every rank of ``mesh``."""
    if mesh.ndim == 1:
        return mesh.get_group()
    import torch.distributed as dist

    if mesh.size() != dist.get_world_size():
        raise ValueError("a sharded trainer's mesh must span every rank")
    return dist.group.WORLD


def _signsgd_step(cfg: ArchConfig, opt_cfg: OptimizerConfig):
    """Train step with 1-bit sign compression and error feedback.

    Per leaf, as the reference's ``trainer.py`` computes it:
    ``acc = g.float() + ef``; ``signs = decompress(compress(acc))``;
    ``scaled = signs * mean(|acc|)``; ``ef = acc - scaled``; then the
    signSGD update with ``scaled``.  No gradient clipping on this path.
    Each leaf's gradient is dropped as soon as it is used, and ``signs``
    is scaled and then spent by the update in place.

    Sharded leaves (DTensors) run the same arithmetic on each rank's
    shard: the gradient arrives reduced into the parameter's placements,
    ``acc`` and the error feedback are laid out like the parameter, the
    pack and unpack kernels see the local shard (the sign rule is
    elementwise, so the signs are the whole leaf's; the packed words are
    per rank), and ``mean(|acc|)`` is the whole leaf's (:func:`_l1_sum`).
    """
    loss_fn = make_loss_fn(cfg)

    def step(params, opt_state, ef, batch, leaf_hook: LeafHook | None = None):
        loss, grads = loss_and_grads(loss_fn, params, batch)
        flat_ef = flatten(ef)
        with torch.no_grad():
            for i, (name, p) in enumerate(flatten(params).items()):
                e, g, leaf = flat_ef[name], grads[i], p
                if is_dtensor(p):  # this rank's shards, written in place
                    e, g, p = e.to_local(), g.to_local(), p.to_local()
                # f32 g.float() + ef, laid out like ef (a gradient may
                # come back with transposed strides)
                acc = torch.add(g, e, out=torch.empty_like(e))
                grads[i] = g = None
                flat = acc.view(-1)
                words = compress_signs(flat)
                signs = decompress_signs(words, flat.numel())
                if leaf_hook is not None:
                    leaf_hook(name, acc, words, signs)
                del words
                signs.mul_(_l1_sum(flat, leaf) / leaf.numel())  # scaled
                torch.sub(flat, signs, out=e.view(-1))  # error feedback
                del acc, flat
                signsgd_leaf(p, signs.view(p.shape), opt_cfg)
                del signs
            opt_state["step"] += 1
        return params, opt_state, ef, {"loss": loss}

    return step


class Trainer:
    def __init__(
        self,
        cfg: ArchConfig,
        tcfg: TrainerConfig,
        *,
        device="cuda",
        mesh=None,
        rng_seed: int = 0,
    ):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a {self.device.type} trainer")
        self.mesh = mesh
        self.model = get_model(cfg)
        self.param_specs = self.model.param_specs(cfg)
        self.opt_specs = opt_state_specs(self.param_specs)
        self.params = self.model.init_params(cfg, rng_seed, self.device)
        if mesh is not None:
            self.params = shard_tree(self.params, self.param_specs, mesh)
        self.opt_state = init_opt_state(self.params, tcfg.opt)
        self.step_num = 0
        self.ckpt = CheckpointManager(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
        self.watchdog = StragglerWatchdog(
            tcfg.straggler_factor,
            tcfg.straggler_warmup,
            self._on_straggler,
        )
        self.straggler_log: list[int] = []
        # signSGD only: called for every leaf of every step (checks, probes)
        self.leaf_hook: LeafHook | None = None

        if tcfg.compress_grads == "signsgd":
            self.ef = {  # laid out like the parameters
                k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in flatten(self.params).items()
            }
            self._step = _signsgd_step(cfg, tcfg.opt)
        elif tcfg.compress_grads == "none":
            self.ef = None
            self._step = make_train_step(cfg, tcfg.opt)
        else:
            raise ValueError(f"unknown compress_grads {tcfg.compress_grads!r}")

    def _on_straggler(self, step, dt, ewma):
        self.straggler_log.append(step)

    # -- checkpoint/restart ------------------------------------------------
    def maybe_restore(self) -> bool:
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        state = self.ckpt.restore(
            {"params": self.params, "opt": self.opt_state},
            mesh=self.mesh,
            spec_tree={"params": self.param_specs, "opt": self.opt_specs},
        )
        with torch.no_grad():
            for dst, src in zip(flatten(self.params).values(), flatten(state["params"]).values()):
                dst.copy_(src)
        self.opt_state = state["opt"]
        self.step_num = int(self.ckpt.latest_step())
        return True

    def save(self, block=True):
        if self.ckpt is None:
            return
        self.ckpt.save(
            self.step_num,
            {"params": self.params, "opt": self.opt_state},
            {"params": self.param_specs, "opt": self.opt_specs},
            block=block or not self.tcfg.ckpt_async,
        )

    def shard_batch(self, batch):
        """``batch`` (whole, the same on every rank) sharded on ``data``
        as the reference's batch specs say; unchanged without a mesh."""
        if self.mesh is None:
            return batch
        flat = flatten(batch)
        return unflatten_into(
            batch,
            {k: shard_leaf(t, P("data", *[None] * (t.dim() - 1)), self.mesh) for k, t in flat.items()},
        )

    def _run_step(self, batch):
        if self.mesh is None:
            return self._call_step(batch)
        from torch.distributed.tensor.experimental import implicit_replication

        # plain tensors the model builds (masks, positions, RoPE tables,
        # fresh recurrent states) are the same on every rank: replicated
        with active_mesh(self.mesh), implicit_replication():
            return self._call_step(self.shard_batch(batch))

    def _call_step(self, batch):
        if self.ef is not None:
            self.params, self.opt_state, self.ef, metrics = self._step(
                self.params, self.opt_state, self.ef, batch, self.leaf_hook
            )
        else:
            self.params, self.opt_state, metrics = self._step(self.params, self.opt_state, batch)
        return metrics

    # -- loop ----------------------------------------------------------------
    def train(self, batches, num_steps: int, log_every: int = 10):
        history = []
        it = iter(batches)
        for _ in range(num_steps):
            batch = next(it)
            t0 = time.perf_counter()
            metrics = self._run_step(batch)
            loss = float(metrics["loss"])  # waits for the step's device work
            dt = time.perf_counter() - t0
            self.step_num += 1
            self.watchdog.observe(self.step_num, dt)
            history.append(loss)
            if self.ckpt and self.step_num % self.tcfg.ckpt_every == 0:
                self.save(block=not self.tcfg.ckpt_async)
            if log_every and self.step_num % log_every == 0:
                print(f"step {self.step_num:5d}  loss {loss:.4f}  dt {dt*1e3:.1f}ms")
        if self.ckpt:
            self.save(block=True)
            self.ckpt.wait()
        return history
