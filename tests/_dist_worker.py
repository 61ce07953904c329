"""The 4-rank gloo job behind ``tests/test_torch_sharding.py``.

Spawned once per test module (``torch.multiprocessing``, one CPU process
per rank, a ``file://`` store under the test's temporary directory).  It
reads the reference's parameters and batches from ``inputs.pkl``, runs
the port sharded over a 2x2 ("data", "model") mesh, and rank 0 writes
what the tests check into ``results.pkl``.  A rank that fails writes its
traceback to ``error<rank>.txt``.  Imports torch and the port only.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback

import torch
import torch.distributed as dist

# one per family: dense (two), MoE + MLA, RG-LRU hybrid, xLSTM, encoder-decoder
ARCHS = ("granite-8b", "starcoder2-3b", "deepseek-v2-lite-16b", "recurrentgemma-2b", "xlstm-350m", "whisper-medium")


def cfg_of(arch: str):
    """The reduced configs of the job (granite-8b cut to 2 layers)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced()
    return cfg.with_(n_layers=2) if arch == "granite-8b" else cfg


def _full(t):
    from repro_torch.distributed.sharding import is_dtensor

    return (t.full_tensor() if is_dtensor(t) else t).detach().numpy().copy()


def _trainer(cfg, opt, compress, params_np, mesh, ckpt_dir=None):
    """A port trainer that starts from the reference's parameters."""
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.models.state import flatten, params_from_reference
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    tcfg = TrainerConfig(opt=opt, compress_grads=compress, ckpt_dir=ckpt_dir, ckpt_async=False)
    tr = Trainer(cfg, tcfg, device="cpu", mesh=mesh)
    params = params_from_reference(params_np, device="cpu")
    tr.params = shard_tree(params, tr.param_specs, mesh) if mesh is not None else params
    tr.opt_state = init_opt_state(tr.params, opt)
    if tr.ef is not None:
        tr.ef = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in flatten(tr.params).items()}
    return tr


def _batch(b, cfg):
    inputs = {"tokens": torch.from_numpy(b["tokens"])}
    if "frames" in b:  # the audio family's encoder frames
        inputs["frames"] = torch.from_numpy(b["frames"]).to(cfg.cdtype)
    return {"inputs": inputs, "labels": torch.from_numpy(b["labels"])}


def _losses_and_grads(inp, mesh, out):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import active_mesh
    from repro_torch.models.state import flatten
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.steps import loss_and_grads, make_loss_fn

    for arch in ARCHS:
        cfg = cfg_of(arch)
        tr = _trainer(cfg, OptimizerConfig(), "none", inp[arch]["params"], mesh)
        with active_mesh(mesh), implicit_replication():
            batch = tr.shard_batch(_batch(inp[arch]["batch"], cfg))
            loss, grads = loss_and_grads(make_loss_fn(cfg), tr.params, batch)
        out[f"{arch}/loss"] = float(loss)
        out[f"{arch}/placements_match"] = all(
            g.placements == p.placements for g, p in zip(grads, flatten(tr.params).values())
        )
        out[f"{arch}/grads"] = {k: _full(g) for k, g in zip(flatten(tr.params), grads)}


def _steps(inp, mesh, ckpt_dir, out):
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.kernels.signcomp.ref import sign_bits
    from repro_torch.models.state import flatten
    from repro_torch.train.optimizer import OptimizerConfig

    runs = {
        "signsgd": ("starcoder2-3b", OptimizerConfig(lr=1e-2, mode="signsgd"), "signsgd"),
        "adamw": ("granite-8b", OptimizerConfig(lr=1e-3), "none"),
    }
    for name, (arch, opt, compress) in runs.items():
        cfg = cfg_of(arch)
        res = {}
        for label, m in (("sharded", mesh), ("plain", None)):
            keep = ckpt_dir if m is not None and name == "signsgd" else None
            tr = _trainer(cfg, opt, compress, inp[arch]["params"], m, keep)
            leaves = flatten(tr.params)
            seen = {}

            def hook(key, acc, words, signs, leaves=leaves, seen=seen, m=m):
                p = leaves[key]
                if m is not None and is_dtensor(p):
                    from torch.distributed.tensor import DTensor

                    def whole(t):
                        t = t.view(p.to_local().shape)
                        return DTensor.from_local(
                            t, m, p.placements, run_check=False, shape=p.shape, stride=p.stride()
                        ).full_tensor()

                    acc, signs = whole(acc), whole(signs)
                seen[key] = (acc.detach().numpy().copy(), signs.detach().numpy().reshape(acc.shape).copy())

            tr.leaf_hook = hook if compress == "signsgd" else None
            # train() ends with a blocking save when there is a ckpt_dir:
            # every rank gathers, rank 0 writes
            res[f"{label}/loss"] = tr.train(iter([_batch(inp[arch]["batch"], cfg)]), 1, log_every=0)[0]
            res[f"{label}/params"] = {k: _full(v) for k, v in flatten(tr.params).items()}
            res[f"{label}/leaves"] = seen
            if name == "signsgd" and label == "sharded":
                res["sign_rule_mismatches"] = sum(
                    int((s != 2 * sign_bits(torch.from_numpy(a)).numpy() - 1).sum())
                    for a, s in seen.values()
                )
                res["ef_is_dtensor"] = all(is_dtensor(e) for e in tr.ef.values())
                res["ef_placements_match"] = all(
                    e.placements == leaves[k].placements for k, e in tr.ef.items()
                )
                res["saved"] = {
                    "params": res["sharded/params"],
                    "mu": {k: _full(v) for k, v in flatten(tr.opt_state["mu"]).items()},
                }
        out[name] = res


def _restore(ckpt_dir, out):
    """The 2x2 checkpoint onto a 1x2 mesh (ranks 0 and 1) and onto no mesh
    (rank 0)."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.models.state import flatten
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = cfg_of("starcoder2-3b")
    tcfg = TrainerConfig(
        opt=OptimizerConfig(lr=1e-2, mode="signsgd"), compress_grads="signsgd", ckpt_dir=ckpt_dir
    )
    small = DeviceMesh("cpu", torch.tensor([[0, 1]]), mesh_dim_names=("data", "model"))
    rank = dist.get_rank()
    for label, m in (("1x2", small), ("none", None)):
        if (m is not None and m.get_coordinate() is None) or (m is None and rank != 0):
            continue
        tr = Trainer(cfg, tcfg, device="cpu", mesh=m, rng_seed=1)
        restored = tr.maybe_restore()
        out[f"restore/{label}"] = {
            "restored": restored,
            "step": tr.step_num,
            "params": {k: _full(v) for k, v in flatten(tr.params).items()},
            "mu": {k: _full(v) for k, v in flatten(tr.opt_state["mu"]).items()},
            "placements": sorted({str(getattr(v, "placements", None)) for v in flatten(tr.params).values()}),
        }
    dist.barrier()


def run(rank: int, world: int, init_method: str, workdir: str) -> None:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        ckpt_dir = os.path.join(workdir, "ckpt")
        out: dict = {}
        _losses_and_grads(inp, mesh, out)
        _steps(inp, mesh, ckpt_dir, out)
        _restore(ckpt_dir, out)
        if rank == 0:
            with open(os.path.join(workdir, "results.pkl"), "wb") as f:
                pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(workdir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def start(workdir: str, world: int = 4):
    """Start the job in the background; :func:`wait` joins it."""
    import torch.multiprocessing as mp

    return mp.spawn(run, args=(world, f"file://{workdir}/store", workdir), nprocs=world, join=False)


def wait(ctx, timeout_s: float = 600.0) -> None:
    """Join the job; a rank still running after ``timeout_s`` (a hung
    collective) is killed and the wait raises ``TimeoutError``."""
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {len(ctx.processes)}-rank job ran past {timeout_s} s")

