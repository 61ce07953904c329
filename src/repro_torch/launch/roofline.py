"""Roofline terms for every (arch x shape) cell on the 16x16 mesh.

The counterpart of the reference's ``launch/roofline.py``.  A cell's step
(the dry-run's :func:`~repro_torch.launch.dryrun.build_cell`, every
argument a DTensor whose local shard is a meta tensor) runs on a 16x16
mesh of the ``"fake"`` backend (:func:`~repro_torch.launch.mesh.fake_mesh`),
once uncounted and once under
:class:`~repro_torch.launch.hlo_analysis.OpMeter`, which counts rank 0's
local program; the counts are globalized by the 256 chips.

Method — full depth: the reference lowers 1- and 2-unit variants and
extrapolates, because ``cost_analysis`` does not multiply a scanned
loop's body by its trip count.  Eager layers are a Python loop, and every
op of every layer is dispatched and counted, so every cell is counted at
full depth.  The exception is the xLSTM: its sLSTM loops over time in
Python, about 15 ms of dispatch per token per layer, so ``train_4k`` and
``prefill_32k`` are counted at S = 128 and 256 (one and two mLSTM
chunks) and extrapolated affinely in S with the reference's
``_extrapolate`` arithmetic, one unit per chunk.  At a fixed chunk every
term is affine in S, so this is exact; eager counts carry no fusion
noise, so the reference's proportional fallback is not needed.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--arch A] [--shape S] [--out DIR]

Each cell prints one JSON line, and each ``ok`` cell is written as
``<arch>_<shape>.json`` under ``results/torch/roofline/`` (or ``--out``),
as the reference writes its cells under ``results/roofline/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.sharding import active_mesh, placements, register_strategies
from repro_torch.launch.dryrun import RESULTS_ROOT, build_cell, cell_is_skipped, save_cell
from repro_torch.launch.hlo_analysis import RooflineTerms, model_flops, roofline_from_count
from repro_torch.launch.mesh import PRODUCTION_SHAPES, fake_mesh
from repro_torch.launch.specs import demo_batch
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig
from repro_torch.models.registry import get_model
from repro_torch.models.state import flatten, unflatten_into
from repro_torch.models.xlstm import CHUNK
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.steps import make_decode_step, make_prefill_step, make_train_step

SEQ_UNITS = (CHUNK, 2 * CHUNK)  # the xLSTM's two counted lengths
RESULTS_DIR = os.path.join(RESULTS_ROOT, "roofline")


def count_params(cfg: ArchConfig) -> tuple[int, int]:
    """(total, active) parameter counts from meta tensors (no allocation)."""
    flat = flatten(get_model(cfg).init_params(cfg, 0, "meta"))
    total = active = 0
    for path, leaf in flat.items():
        n = math.prod(leaf.shape)
        total += n
        keys = path.split("/")
        if cfg.moe and any(w in keys for w in ("w_gate", "w_up", "w_down")) and "ffn" in keys:
            active += n * cfg.moe.top_k / cfg.moe.num_experts
        else:
            active += n
    return int(total), int(active)


def _dtensor(t: torch.Tensor, spec, mesh):
    """A DTensor of ``t``'s global shape laid out by ``spec``, its local
    shard a meta tensor."""
    from torch.distributed.tensor import DTensor

    pl = placements(spec, mesh)
    local = list(t.shape)
    for d, p in zip(range(mesh.ndim), pl):
        if p.is_shard():
            local[p.dim] //= mesh.size(d)
    stride = torch.empty(t.shape, device="meta").stride()
    return DTensor.from_local(
        torch.empty(local, dtype=t.dtype, device="meta"),
        mesh,
        pl,
        run_check=False,
        shape=t.shape,
        stride=stride,
    )


def layout_cell(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """``(step, args)``: the cell's step and its arguments laid out on
    ``mesh`` as the dry-run lays them out.  Token ids become int64 (the
    port's index type), the optimizer's step and a decode offset host
    ints (the last cache slot)."""
    register_strategies()
    names, args, resolved = build_cell(cfg, shape, mesh)
    laid = {}
    for name, tree, specs in zip(names, args, resolved):
        flat = {}
        for k, t in flatten(tree).items():
            if t.dtype == torch.int32 and t.dim() > 0:
                t = torch.empty(t.shape, dtype=torch.int64, device="meta")
            flat[k] = _dtensor(t, specs[k], mesh) if t.dim() else t
        laid[name] = unflatten_into(tree, flat)
    if shape.kind == "train":
        laid["opt"]["step"] = 0
        step = make_train_step(cfg, OptimizerConfig(state_dtype=cfg.optimizer_dtype))
        return step, (laid["params"], laid["opt"], laid["batch"])
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, shape.seq_len + cfg.num_patch_tokens)
        return step, (laid["params"], laid["batch"])
    step = make_decode_step(cfg)
    return step, (laid["params"], laid["cache"], laid["tokens"], shape.seq_len - 1)


def plain_cell(cfg: ArchConfig, shape: ShapeConfig, device="meta", seed: int = 0):
    """``(step, (params, opt, batch))``: a train cell's AdamW step off any
    mesh, the counterpart of :func:`layout_cell`, on ``device`` (random
    weights from seed 0, tokens from ``seed``; on meta, shapes only)."""
    opt_cfg = OptimizerConfig(state_dtype=cfg.optimizer_dtype)
    params = get_model(cfg).init_params(cfg, 0, device)
    batch = demo_batch(
        cfg, shape.global_batch, shape.seq_len, seed=seed, device="cpu" if device == "meta" else device
    )
    if device == "meta":
        batch = {
            "inputs": {k: torch.empty_like(v, device="meta") for k, v in batch["inputs"].items()},
            "labels": torch.empty_like(batch["labels"], device="meta"),
        }
    return make_train_step(cfg, opt_cfg), (params, init_opt_state(params, opt_cfg), batch)


def count_cell(cfg: ArchConfig, shape: ShapeConfig, mesh) -> RooflineTerms:
    """One step of the cell counted on ``mesh``, globalized over its ranks."""
    from torch.distributed.tensor.experimental import implicit_replication

    step, args = layout_cell(cfg, shape, mesh)
    grad = torch.enable_grad() if shape.kind == "train" else torch.no_grad()
    with active_mesh(mesh), implicit_replication(), grad:
        return roofline_from_count(step, args, mesh.size())


def seq_is_affine(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    """Cells whose prompt runs the sLSTM's loop over time."""
    return cfg.family == "ssm" and shape.kind in ("train", "prefill") and shape.seq_len > SEQ_UNITS[1]


def _extrapolate(t1: RooflineTerms, t2: RooflineTerms, units: float) -> RooflineTerms:
    """``t1 + (t2 - t1) · (units − 1)``, term by term."""

    def ext(a, b):
        return a + (b - a) * (units - 1)

    def merged(key):
        d1, d2 = t1.collective_detail[key], t2.collective_detail[key]
        return {k: int(ext(d1.get(k, 0), d2.get(k, 0))) for k in set(d1) | set(d2)}

    return RooflineTerms(
        flops=ext(t1.flops, t2.flops),
        bytes_accessed=ext(t1.bytes_accessed, t2.bytes_accessed),
        collective_bytes=ext(t1.collective_bytes, t2.collective_bytes),
        chips=t1.chips,
        collective_detail={"bytes": merged("bytes"), "count": merged("count")},
    )


def cell_terms(cfg: ArchConfig, shape: ShapeConfig, mesh) -> tuple[RooflineTerms, str]:
    """The cell's terms and how they were counted."""
    if not seq_is_affine(cfg, shape):
        return count_cell(cfg, shape, mesh), "full depth"
    t1, t2 = (count_cell(cfg, dataclasses.replace(shape, seq_len=s), mesh) for s in SEQ_UNITS)
    note = f"full depth; affine in S from S={SEQ_UNITS[0]} and {SEQ_UNITS[1]} (the sLSTM loops over time)"
    return _extrapolate(t1, t2, shape.seq_len / SEQ_UNITS[0]), note


def run_cell(
    arch: str, shape_name: str, *, cfg: ArchConfig | None = None, mesh=None, out_dir: str | None = None
) -> dict:
    """One cell on ``mesh`` (default: a fake 16x16 mesh brought up and
    torn down here); ``cfg`` overrides the arch's published config.  An
    ``ok`` cell is written as ``<out_dir>/<arch>_<shape>.json`` when
    ``out_dir`` is given."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    skip = cell_is_skipped(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "status": "skip", "reason": skip}
    t0 = time.time()
    if mesh is None:
        with fake_mesh(*PRODUCTION_SHAPES[False]) as mesh:
            terms, method = cell_terms(cfg, shape, mesh)
            mesh_name = "x".join(map(str, mesh.shape))
    else:
        terms, method = cell_terms(cfg, shape, mesh)
        mesh_name = "x".join(map(str, mesh.shape))
    total_p, active_p = count_params(cfg)
    mf = model_flops(cfg, shape, total_p, active_p)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "ok",
        "method": method,
        "units": cfg.n_layers,
        "elapsed_s": round(time.time() - t0, 1),
        "params_total": total_p,
        "params_active": active_p,
        "model_flops": mf,
        "useful_ratio": mf / terms.flops if terms.flops else None,
        "roofline": terms.as_dict(),
    }
    if out_dir is not None:
        save_cell(out_dir, f"{arch}_{shape_name}", result)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--out", default=RESULTS_DIR, help="where each cell's JSON file goes")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    failures = 0
    for arch in archs:
        for shape in shapes:
            try:
                r = run_cell(arch, shape, out_dir=args.out)
            except Exception as e:  # a failing cell is a bug: report it, go on
                traceback.print_exc()
                r = {"arch": arch, "shape": shape, "status": "FAIL", "reason": f"{type(e).__name__}: {e}"}
                failures += 1
            print(json.dumps(r), flush=True)
    if failures:
        raise SystemExit(f"{failures} roofline cells FAILED")


if __name__ == "__main__":
    main()
