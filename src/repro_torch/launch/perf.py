"""The reference's three roofline experiments (``launch/perf.py``), counted
on fake meshes (``launch/roofline.py``'s method).

1. yi-34b x prefill_32k: naive against blockwise attention.  H1: the
   naive path materializes the (Sq, Skv) f32 scores; the online softmax
   removes that traffic from the memory term.
2. kimi-k2-1t-a32b x train_4k: scatter dispatch, gather dispatch, and
   gather plus blockwise attention.  H2's premise (the f32 dispatch
   scatter-add makes GSPMD all-reduce the whole (B, E, C, d) buffer over
   the expert axis) is GSPMD's; here the collectives are DTensor's, and
   they are recorded as they come.
3. The starcoder2-3b-sized gradient exchange (the paper's bulk-bitwise
   operations as a distributed primitive): the f32 all-reduce against
   1-bit sign planes (pack -> all-gather -> bitwise majority -> unpack),
   flat on 16x16 and hierarchical on 2x16x16 (f32 inside a pod, sign
   planes across pods).  Built from ``torch.distributed``'s functional
   collectives on each rank's local meta tensors, with the plain
   ``*_ref`` pack, majority and unpack, as the reference uses its
   ``*_ref``.

Usage: PYTHONPATH=src python -m repro_torch.launch.perf [--exp yi|kimi|grad|all] [--out DIR]

Each variant prints one JSON line, and each experiment's rows are written
as ``<exp>.json`` under ``results/torch/perf/`` (or ``--out``), as the
reference writes them under ``results/perf/``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs import get_config
from repro_torch.kernels.signcomp.ref import majority_ref, pack_signs_ref, unpack_signs_ref
from repro_torch.launch.dryrun import RESULTS_ROOT, save_cell
from repro_torch.launch.hlo_analysis import roofline_from_count
from repro_torch.launch.mesh import PRODUCTION_SHAPES, fake_mesh
from repro_torch.launch.roofline import cell_terms
from repro_torch.models.config import SHAPES

GRAD_PARAMS = 3_030_000_000  # starcoder2-3b-sized
LANES = 512
RESULTS_DIR = os.path.join(RESULTS_ROOT, "perf")


def _rows(exp: str, variants, shape: str, mesh) -> list[dict]:
    return [
        {"exp": exp, "variant": name, "roofline": cell_terms(cfg, SHAPES[shape], mesh)[0].as_dict()}
        for name, cfg in variants
    ]


def exp_yi_prefill(mesh, cfg=None) -> list[dict]:
    cfg = cfg or get_config("yi-34b")
    variants = [
        ("baseline(naive-attn)", cfg.with_(attention_impl="naive")),
        ("blockwise-attention", cfg.with_(attention_impl="blockwise")),
    ]
    return _rows("yi34b_prefill32k", variants, "prefill_32k", mesh)


def exp_kimi_train(mesh, cfg=None) -> list[dict]:
    cfg = cfg or get_config("kimi-k2-1t-a32b")
    variants = [
        ("baseline(scatter-dispatch)", cfg),
        ("gather-dispatch", cfg.with_(moe_dispatch="gather")),
        ("gather+blockwise-attn", cfg.with_(moe_dispatch="gather", attention_impl="blockwise")),
    ]
    return _rows("kimi_train4k", variants, "train_4k", mesh)


def grad_shape(n_params: int, lanes: int = LANES) -> tuple[int, int]:
    """One replica's gradient as (32·rows, lanes) f32, zero-padded to
    whole sign words."""
    rows = -(-n_params // (32 * lanes))
    return rows * 32, lanes


def exchange_variants(mesh) -> list:
    """``(name, fn)`` per variant; ``fn`` takes this rank's gradient
    slice (1, 32·rows, lanes) f32 and returns the exchanged gradient."""
    from torch.distributed import _functional_collectives as funcol

    data = mesh.get_group("data")

    def baseline(g):
        return funcol.all_reduce(g, "sum", data)

    def compressed(g):
        packed = pack_signs_ref(g[0])  # (rows, lanes) words, local signs
        allp = funcol.all_gather_tensor(packed[None], 0, data)  # (D, rows, lanes)
        return unpack_signs_ref(majority_ref(allp))

    if "pod" not in mesh.mesh_dim_names:
        return [("baseline(f32-psum)", baseline), ("1bit-majority-allgather", compressed)]
    pod = mesh.get_group("pod")

    def multipod_baseline(g):
        return funcol.all_reduce(funcol.all_reduce(g, "sum", data), "sum", pod)

    def hierarchical(g):
        # f32 within the pod, 1-bit majority across pods: only sign
        # planes cross the scarce pod links
        local = funcol.all_reduce(g[0], "sum", data)
        allp = funcol.all_gather_tensor(pack_signs_ref(local)[None], 0, pod)  # (2, rows, lanes)
        return unpack_signs_ref(majority_ref(allp))

    return [("multipod-baseline(f32-psum)", multipod_baseline), ("multipod-hierarchical-1bit", hierarchical)]


def exp_grad_exchange(mesh, n_params: int = GRAD_PARAMS) -> list[dict]:
    g = torch.empty((1, *grad_shape(n_params)), dtype=torch.float32, device="meta")
    return [
        {"exp": "grad_exchange", "variant": name, "roofline": roofline_from_count(fn, (g,), mesh.size()).as_dict()}
        for name, fn in exchange_variants(mesh)
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", choices=["yi", "kimi", "grad", "all"], default="all")
    ap.add_argument("--out", default=RESULTS_DIR, help="where each experiment's JSON file goes")
    args = ap.parse_args(argv)
    t0 = time.time()

    def emit(rows):
        for r in rows:
            print(json.dumps(r), flush=True)
        return rows

    grad = []
    with fake_mesh(*PRODUCTION_SHAPES[False]) as mesh:
        if args.exp in ("yi", "all"):
            save_cell(args.out, "yi34b_prefill32k", emit(exp_yi_prefill(mesh)))
        if args.exp in ("kimi", "all"):
            save_cell(args.out, "kimi_train4k", emit(exp_kimi_train(mesh)))
        if args.exp in ("grad", "all"):
            grad += emit(exp_grad_exchange(mesh))
    if args.exp in ("grad", "all"):
        with fake_mesh(*PRODUCTION_SHAPES[True]) as mesh:
            grad += emit(exp_grad_exchange(mesh))
        save_cell(args.out, "grad_exchange", grad)
    print(json.dumps({"done_s": round(time.time() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
