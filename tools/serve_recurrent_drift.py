#!/usr/bin/env python3
"""Why the xLSTM's cached path is checked in f32: bf16 differences grow
with depth, on one NVIDIA GPU.

Run from the repository root:

    python3 tools/serve_recurrent_drift.py [--prompt 500] [--batch 8]

For xlstm-350m at its published widths (random weights from seed 0) it
runs ``chip_smoke.py``'s ``check_cached_path``: the prefill (chunkwise
up to the last multiple of 128, then token by token) and 4 decode steps
(the recurrent step), each held against the full forward over the same
tokens (chunkwise throughout), per step the worst batch row's RMS
difference over the forward logits' spread.  It does so in bf16 with
the model cut to its first 2, 4, 8, 16 and 24 layers (the same weights:
the first pairs of the full model), and in f32 at full depth.  The two
paths compute the same function but round bf16 at different points
(matmuls of another shape, the cell in another form); a ratio that
grows with depth in bf16 while f32 agrees shows the layers amplifying
those roundings, not a wrong state.  Then, in f32, it scales the
embedding of each row's first token by 1 + 2^-8 (one bf16 rounding
step) and reports the same ratio at later positions: how far such a
difference travels along the sequence.  Prints the card's name and
power limit, then one JSON line.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEPTHS = (2, 4, 8, 16, 24)
POSITIONS = (0, 1, 4, 16, 64, 128, 256, 384, 499)


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", type=int, default=500)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_recurrent_drift: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.models import xlstm
    from repro_torch.models.layers import embed_fwd, rmsnorm_fwd, unembed_fwd

    print(smoke._card(), flush=True)
    base = get_config("xlstm-350m")
    out = {"arch": base.name, "batch": args.batch, "prompt": args.prompt, "bf16_by_depth": {}}
    prompts, extra = smoke._serve_inputs(base, args.batch, args.prompt, smoke.SEED, "cuda")

    params = xlstm.init_params(base, smoke.SEED, "cuda")
    for depth in DEPTHS:
        cut = {**params, "pairs": {b: {k: v[: depth // 2] for k, v in blk.items()}
                                   for b, blk in params["pairs"].items()}}
        cfg = base.with_(n_layers=depth)
        out["bf16_by_depth"][depth] = smoke.check_cached_path(cfg, cut, prompts, extra, "cuda")
    del params, cut
    smoke._free("cuda")

    cfg = base.with_(param_dtype="float32", compute_dtype="float32")
    params = xlstm.init_params(cfg, smoke.SEED, "cuda")
    out["f32_full_depth"] = smoke.check_cached_path(cfg, params, prompts, extra, "cuda")
    pos = [p for p in POSITIONS if p < args.prompt]
    with torch.inference_mode():
        x = embed_fwd(params["embed"], prompts, cfg.cdtype)
        bumped = x.clone()
        bumped[:, 0] *= 1 + 2.0**-8
        logits = []
        for v in (x, bumped):
            v = F.pad(v, (0, 0, 0, (-args.prompt) % xlstm.CHUNK))
            h = xlstm._run(cfg, params, v, xlstm.init_state(cfg, args.batch, "cuda"), False)
            h = rmsnorm_fwd(params["final_norm"], h[:, pos])
            logits.append(unembed_fwd(params["embed"], h))
        want, got = logits
        rms = (got - want).pow(2).mean(-1).sqrt()
        ratio = (rms / want.std(-1)).amax(0)
    out["f32_first_token_bump"] = {"positions": pos, "worst_row_ratio": ratio.tolist()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
