"""Training launcher.

CPU scale:  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
                --reduced --device cpu --steps 5 --signsgd
Sharded:    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
                --device cpu --reduced --mesh 2,2
            (gloo on the CPU; on GPUs drop --device cpu and --reduced: NCCL,
            one card per rank)
On a GPU:   the first command without --reduced and --device; the model
            trains on one card at its published widths.

``--mesh data,model`` shards the parameters, the optimizer state and the
batch over a ("data", "model") mesh by the logical rules of
:mod:`repro_torch.distributed.sharding`; the process group comes up from
``torchrun``'s environment, or as a single rank when run alone.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def _mesh_arg(text: str) -> tuple[int, int]:
    data, model = (int(v) for v in text.split(","))
    return data, model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite-8b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config (CPU scale)")
    ap.add_argument("--signsgd", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default, NCCL) or cpu (gloo)")
    ap.add_argument("--mesh", type=_mesh_arg, default=None, help="data,model: shard over a mesh")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainerConfig(
        opt=OptimizerConfig(lr=args.lr, mode="signsgd" if args.signsgd else "adamw"),
        ckpt_dir=args.ckpt_dir,
        compress_grads="signsgd" if args.signsgd else "none",
    )
    mesh, rank, device = None, 0, args.device
    if args.mesh is not None:
        import torch
        import torch.distributed as dist

        from repro_torch.launch.mesh import init_process_group, make_host_mesh

        rank = init_process_group(args.device)
        mesh = make_host_mesh(*args.mesh, device_type=args.device)
        if args.device == "cuda":
            device = f"cuda:{torch.cuda.current_device()}"
    try:
        trainer = Trainer(cfg, tcfg, device=device, mesh=mesh)
        if trainer.maybe_restore() and rank == 0:
            print(f"restored at step {trainer.step_num}")
        corpus = SyntheticCorpus(vocab=cfg.vocab, seq_len=args.seq, num_samples=2048, device=device)
        hist = trainer.train(
            corpus.batches(args.batch), num_steps=args.steps, log_every=5 if rank == 0 else 0
        )
        if rank == 0:
            shape = "x".join(map(str, mesh.mesh.shape)) if mesh is not None else "none"
            print(f"final loss {hist[-1]:.4f} (mesh {shape})")
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    return hist


if __name__ == "__main__":
    main()
