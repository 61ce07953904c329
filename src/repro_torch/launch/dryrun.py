"""Multi-pod dry-run: every (arch x shape x mesh) cell's per-rank arguments.

The counterpart of the reference's ``build_cell`` / ``_drop_data_axis`` /
``_sanitized_shardings``, run on meta tensors: for the 16x16 ("data",
"model") mesh and the 2x16x16 ("pod", "data", "model") mesh it lays out
every argument of the cell's step (train: parameters, optimizer state,
batch, and with signSGD the error feedback; prefill: parameters, batch;
decode: parameters, cache, tokens, offset) by its logical spec and gives
each rank's shard shape and the argument bytes one rank holds, against a
card's memory.  Nothing is allocated.  Each cell also carries the
reference's ``roofline`` entry: the step counted on a ``"fake"`` mesh of
the cell's shape, as ``launch/roofline.py`` counts it
(``launch/hlo_analysis.py``); ``roofline=False`` skips it.

Eager PyTorch compiles no step, so there is no counterpart of XLA's
``memory_analysis`` temp bytes: a cell reports ``temp_bytes: null`` and
says why.  Importing this module sets nothing global.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-only] [--device-bytes N] [--out DIR]

Each cell prints one JSON line, and each cell that ran is written as
``<arch>_<shape>_<mesh>.json`` under ``results/torch/dryrun/`` (or
``--out``), as the reference writes its cells under ``results/dryrun/``.
"""

from __future__ import annotations

import argparse
import json
import math
import os

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.sharding import (
    AbstractMesh,
    drop_data_axis,
    is_spec,
    local_shape,
    map_specs,
    mesh_axes,
    resolve_spec,
    sanitize,
)
from repro_torch.launch.mesh import PRODUCTION_SHAPES, fake_mesh
from repro_torch.launch.specs import (
    decode_input_specs,
    prefill_input_specs,
    train_input_specs,
)
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig
from repro_torch.models.registry import get_model
from repro_torch.models.state import flatten
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state, opt_state_specs

RESULTS_ROOT = os.path.join(os.path.dirname(__file__), "../../../results/torch")
RESULTS_DIR = os.path.join(RESULTS_ROOT, "dryrun")

NO_TEMP = "eager PyTorch compiles no step: no temp-buffer analysis (XLA's memory_analysis)"


def save_cell(out_dir: str, name: str, cell) -> None:
    """``cell`` as ``<out_dir>/<name>.json``, indented as the reference
    writes its cells."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(cell, f, indent=1)


def production_mesh(multi_pod: bool = False) -> AbstractMesh:
    return AbstractMesh(*PRODUCTION_SHAPES[multi_pod])


def cell_is_skipped(cfg: ArchConfig, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return "long_500k needs sub-quadratic attention (full-attention arch)"
    return None


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *, compress_grads: str = "none"):
    """``(names, args, specs)``: the step's argument groups, their meta
    trees, and each leaf's resolved spec with every axis that does not
    divide its dim dropped (the reference's boundary shardings)."""
    model = get_model(cfg)
    params = model.init_params(cfg, 0, "meta")
    param_specs = model.param_specs(cfg)

    if shape.kind == "train":
        batch, batch_specs = train_input_specs(cfg, shape)
        opt = init_opt_state(params, OptimizerConfig(state_dtype=cfg.optimizer_dtype))
        opt["step"] = torch.empty((), dtype=torch.int32, device="meta")  # a host int in the port
        names = ["params", "opt"]
        args = [params, opt]
        specs = [param_specs, opt_state_specs(param_specs)]
        if compress_grads == "signsgd":
            names.append("ef")
            args.append({k: torch.empty_like(p, dtype=torch.float32) for k, p in flatten(params).items()})
            specs.append(flatten(param_specs, is_leaf=is_spec))
        names.append("batch")
        args.append(batch)
        specs.append(batch_specs)
    elif shape.kind == "prefill":
        batch, batch_specs = prefill_input_specs(cfg, shape)
        names, args, specs = ["params", "batch"], [params, batch], [param_specs, batch_specs]
    else:
        (cache, tok, off), (cache_spec, tok_spec, off_spec) = decode_input_specs(cfg, shape)
        names = ["params", "cache", "tokens", "offset"]
        args = [params, cache, tok, off]
        specs = [param_specs, cache_spec, tok_spec, off_spec]

    axes = mesh_axes(mesh)
    if shape.global_batch % (axes.get("pod", 1) * axes["data"]) != 0:
        specs = [map_specs(drop_data_axis, s) for s in specs]
    resolved = []
    for a, s in zip(args, specs):
        leaves, leaf_specs = flatten(a), flatten(s, is_leaf=is_spec)
        resolved.append(
            {k: sanitize(resolve_spec(leaf_specs[k], mesh), t.shape, mesh) for k, t in leaves.items()}
        )
    return names, args, resolved


def per_rank(args, resolved, mesh) -> list[list[tuple]]:
    """Per group, each leaf's ``(path, global shape, per-rank shape,
    per-rank bytes)`` in flatten order."""
    out = []
    for a, specs in zip(args, resolved):
        rows = []
        for k, t in flatten(a).items():
            local = local_shape(t.shape, specs[k], mesh)
            rows.append((k, tuple(t.shape), local, math.prod(local) * t.element_size()))
        out.append(rows)
    return out


def device_bytes_default() -> int | None:
    """The card's memory where there is one."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return None


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    *,
    device_bytes: int | None = None,
    compress_grads: str = "none",
    roofline: bool = True,
    out_dir: str | None = None,
) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = production_mesh(multi_pod)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(map(str, mesh.mesh_shape)),
        "status": "skip",
        "reason": cell_is_skipped(cfg, shape),
    }
    if result["reason"]:
        return result
    names, args, resolved = build_cell(cfg, shape, mesh, compress_grads=compress_grads)
    groups = per_rank(args, resolved, mesh)
    by_group = {n: sum(r[3] for r in rows) for n, rows in zip(names, groups)}
    total = sum(by_group.values())
    result |= {
        "status": "ok",
        "ranks": mesh.size(),
        "compress_grads": compress_grads,
        "argument_bytes": total,
        "bytes_by_group": by_group,
        "device_bytes": device_bytes,
        "fits": None if device_bytes is None else total <= device_bytes,
        "temp_bytes": None,
        "temp_note": NO_TEMP,
    }
    if roofline:
        from repro_torch.launch.roofline import cell_terms

        with fake_mesh(*PRODUCTION_SHAPES[multi_pod]) as fake:
            result["roofline"] = cell_terms(cfg, shape, fake)[0].as_dict()
    if out_dir is not None:
        save_cell(out_dir, f"{arch}_{shape_name}_{result['mesh']}", result)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--signsgd", action="store_true", help="train cells carry the error feedback")
    ap.add_argument(
        "--device-bytes",
        type=int,
        default=None,
        help="one card's memory (default: this machine's card, if any)",
    )
    ap.add_argument("--out", default=RESULTS_DIR, help="where each cell's JSON file goes")
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.shape):
        ap.error("name --arch and/or --shape, or --all")

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True]
    if args.multi_pod or args.multi_pod_only:
        meshes = [True]
    elif args.single_pod_only:
        meshes = [False]
    device_bytes = args.device_bytes if args.device_bytes is not None else device_bytes_default()
    compress = "signsgd" if args.signsgd else "none"
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                r = run_cell(
                    arch, shape, mp, device_bytes=device_bytes, compress_grads=compress, out_dir=args.out
                )
                print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
