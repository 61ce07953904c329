"""Training launcher.

CPU scale:  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
                --reduced --device cpu --steps 5 --signsgd
On a GPU:   the same command without --reduced and --device; the model
            trains on one card at its published widths.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


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
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainerConfig(
        opt=OptimizerConfig(lr=args.lr, mode="signsgd" if args.signsgd else "adamw"),
        ckpt_dir=args.ckpt_dir,
        compress_grads="signsgd" if args.signsgd else "none",
    )
    trainer = Trainer(cfg, tcfg, device=args.device)
    if trainer.maybe_restore():
        print(f"restored at step {trainer.step_num}")
    corpus = SyntheticCorpus(
        vocab=cfg.vocab, seq_len=args.seq, num_samples=2048, device=args.device
    )
    hist = trainer.train(corpus.batches(args.batch), num_steps=args.steps, log_every=5)
    print(f"final loss {hist[-1]:.4f}")
    return hist


if __name__ == "__main__":
    main()
