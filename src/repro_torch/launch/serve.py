"""Serving launcher: prefill a batch of synthetic prompts, decode N tokens.

CPU scale:  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
                --reduced --device cpu
On a GPU:   the same command without --reduced and --device; the model
            serves on one card at its published widths.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.engine import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import get_model
from repro_torch.train.steps import make_decode_step, make_prefill_step


def serve(cfg: ArchConfig, params, prompts, tokens: int, extra=None, device="cuda", on_step=None):
    """Greedy decoding: prefill ``prompts`` (B, S), then ``tokens - 1``
    decode steps; returns the ``tokens`` generated ids (B, tokens) on the
    device.  ``extra`` holds the family's stub inputs: ``patch_embeds``
    for the VLM, which take the first cache slots, or ``frames`` for the
    audio family, which the encoder reads and which take no slot.
    ``on_step(i, logits)``, if given, sees the prefill's last-position logits (i = 0)
    and each decode step's (i >= 1), (B, 1, vocab) f32."""
    extra = extra or {}
    n_patch = extra["patch_embeds"].shape[1] if "patch_embeds" in extra else 0
    n_ctx = n_patch + prompts.shape[1]  # decode offsets are absolute cache slots
    prefill = make_prefill_step(cfg, max_len=n_ctx + tokens + 1)
    decode = make_decode_step(cfg)
    dev = resolve_device(device)
    prompts = prompts.to(dev)
    extra = {k: v.to(dev) for k, v in extra.items()}
    with torch.inference_mode():
        logits, cache = prefill(params, {"inputs": {"tokens": prompts, **extra}})
        if on_step is not None:
            on_step(0, logits)
        nxt = torch.argmax(logits[:, -1:], dim=-1)
        out = [nxt]
        for i in range(tokens - 1):
            logits, cache = decode(params, cache, nxt, n_ctx + i)
            if on_step is not None:
                on_step(i + 1, logits)
            nxt = torch.argmax(logits[:, -1:], dim=-1)
            out.append(nxt)
        return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite-8b")
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config (CPU scale)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = get_model(cfg)
    dev = resolve_device(args.device)
    params = model.init_params(cfg, 0, dev)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)))
    extra = {}
    if cfg.family == "audio":  # drawn after the tokens and before the patches, as the reference does
        frames = rng.normal(size=(args.batch, args.prompt_len, cfg.d_model))
        extra["frames"] = torch.from_numpy(frames).to(dev, cfg.cdtype)
    if cfg.family == "vlm":
        patches = rng.normal(size=(args.batch, cfg.num_patch_tokens, cfg.d_model))
        extra["patch_embeds"] = torch.from_numpy(patches).to(dev, cfg.cdtype)

    marks = {}

    def on_step(i, logits):
        if i in (0, args.tokens - 1):  # wait for the card only where timed
            if dev.type == "cuda":
                torch.cuda.synchronize()
            marks[i] = time.perf_counter()

    t0 = time.perf_counter()
    ids = serve(cfg, params, prompts, args.tokens, extra, dev, on_step).cpu()
    print(f"prefill {args.prompt_len} tokens: {marks[0] - t0:.2f}s")
    dt = marks[args.tokens - 1] - marks[0]
    print(
        f"decoded {args.tokens} tokens x{args.batch}: {dt:.2f}s "
        f"({args.tokens * args.batch / max(dt, 1e-9):.1f} tok/s)"
    )
    print("sample:", ids[0][:12].tolist())
    return ids


if __name__ == "__main__":
    main()
