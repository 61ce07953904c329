#!/usr/bin/env python3
"""Why an MoE's cached path is checked in f32: router flips, on one NVIDIA GPU.

Run from the repository root:

    python3 tools/serve_route_flips.py

For deepseek-v2-lite-16b at its published widths and depth (random
weights from seed 0, batch 8 x 512 prompt tokens, the no-drop capacity
E / top_k of ``chip_smoke.serve_check_config``), in bf16 and in f32, it
serves the prefill and 4 decode steps and holds each step's logits
against the full forward over the same tokens, as ``chip_smoke.py``'s
``check_cached_path`` does.  Per step and batch row it prints the RMS
difference over the forward logits' spread, and in how many MoE layers
the compared token's top-k expert set differs between the cached step
and the forward.  The routing is read by wrapping
``models.moe.moe_ffn_fwd``; what that computes is unchanged.  Prints the
card's name and power limit, then one JSON line per dtype.  Exits 2
without a CUDA device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS = 4


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("serve_route_flips: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import moe

    routes: list = []  # the compared (last) token's sorted top-k, one per MoE layer
    real = moe.moe_ffn_fwd

    def recording(p, x, cfg):
        logits = torch.einsum("bsd,de->bse", x[:, -1:].float(), p["router"])
        top = torch.topk(torch.softmax(logits, dim=-1), cfg.moe.top_k, dim=-1)[1]
        routes.append(top[:, 0].sort(dim=-1)[0].cpu())
        return real(p, x, cfg)

    moe.moe_ffn_fwd = recording
    print(smoke._card(), flush=True)
    base = smoke.serve_check_config(get_config("deepseek-v2-lite-16b"))
    for dtype in ("bfloat16", "float32"):
        cfg = base.with_(param_dtype=dtype, compute_dtype=dtype)
        params = moe.init_params(cfg, smoke.SEED, "cuda")
        prompts, extra = smoke._serve_inputs(cfg, 8, 512, smoke.SEED, "cuda")
        kept, cached = {}, {}

        def on_step(i, logits):
            kept[i], cached[i] = logits[:, -1].clone(), list(routes)
            routes.clear()

        routes.clear()
        ids = serve(cfg, params, prompts, STEPS + 1, extra, "cuda", on_step)
        steps = []
        with torch.inference_mode():
            for i in range(STEPS + 1):
                routes.clear()
                want = moe.forward(cfg, params, torch.cat([prompts, ids[:, :i]], 1))[:, -1].float()
                ratio = (kept[i].float() - want).pow(2).mean(-1).sqrt() / want.std(-1)
                flips = sum((a != b).any(-1).long() for a, b in zip(cached[i], routes))
                steps.append({"row_ratio": ratio.tolist(), "layers_rerouted": flips.tolist()})
        print(json.dumps({"arch": cfg.name, "dtype": dtype, "moe_layers": len(routes),
                          "steps": steps}), flush=True)
        del params, kept, want
        smoke._free("cuda")
    moe.moe_ffn_fwd = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
