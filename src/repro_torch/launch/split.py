"""Does a sharded step split its matmuls across the ranks?

The reference's GSPMD gives every rank of a ("data", "model") mesh its
share of every matmul.  DTensor picks its layouts op by op, and where an
input arrives partial over "model" it may run a matmul whole on every
rank instead.  This module counts, on a 2x2 ``"fake"`` mesh, rank 0's
matmul FLOPs of one reduced train step by the model line that issued
them (:class:`LineMeter`): the forward's by the line on the stack, the
backward's by the forward line of the autograd node (anomaly mode
records it).  Times the 4 ranks, each line must equal the same step
unsharded, and so must the whole step.  It also runs reduced roofline
cells (``launch/roofline.py::run_cell``) on the same mesh.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.split [--families A ...] [--cells A ...] [--grads A ...]

With ``--grads A ...`` it also runs each arch's reduced loss and
gradients on a real 4-rank gloo 2x2 mesh and holds every leaf against
the unsharded step's (:func:`grad_check`).  With no arguments it checks
the six families of :data:`FAMILIES` and runs no cell and no gradient.
It prints one JSON line per family, cell and gradient check, then the
kernels' launches in this process, and exits 1 if any line does not
split, any cell is not ``ok``, any gradient leaf or loss is off or any
kernel launched.
"""

from __future__ import annotations

import argparse
import json
import re
import time
import traceback
from collections import Counter

import torch

from repro_torch import kernels
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.sharding import active_mesh
from repro_torch.launch import roofline
from repro_torch.launch.hlo_analysis import OpMeter, count_step
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.models.state import flatten
from repro_torch.train.steps import make_loss_fn

# one arch id per model family: dense, VLM, MoE + MLA, RG-LRU hybrid,
# encoder-decoder, xLSTM
FAMILIES = (
    "starcoder2-3b",
    "internvl2-26b",
    "deepseek-v2-lite-16b",
    "recurrentgemma-2b",
    "whisper-medium",
    "xlstm-350m",
)
# the arch ids whose reduced cells run on the 2x2 mesh, every shape; the
# xLSTM's cells count its sLSTM loop token by token and run apart
# (tests/test_torch_roofline_xlstm.py)
CELL_ARCHS = tuple(a for a in ARCH_IDS if a != "xlstm-350m")
MESH = ((2, 2), ("data", "model"))
SHAPE = ShapeConfig("split", 16, 4, "train")  # 4 rows: the data axis divides them

_FRAME = re.compile(r'File "([^"]*repro_torch/models/[^"]*)", line (\d+), in (\w+)')


def _model_line(frames) -> str:
    """``"<file>:<line> <function>"`` of the innermost frame under
    ``repro_torch/models`` in ``frames`` (``(path, line, function)``,
    outermost first), or ``"other"``."""
    for path, line, fn in reversed(frames):
        if "repro_torch/models/" in path:
            return f"{path.rsplit('/', 1)[-1]}:{line} {fn}"
    return "other"


class LineMeter(OpMeter):
    """An :class:`OpMeter` that also files each op's FLOPs under
    ``"forward <line>"`` or ``"backward <line>"`` in ``by_line``."""

    def __init__(self):
        super().__init__()
        self.by_line: Counter = Counter()

    def _count(self, func, args, kwargs, out) -> None:
        before = self.flops
        super()._count(func, args, kwargs, out)
        if self.flops == before:
            return
        node = torch._C._current_autograd_node()
        if node is None:
            frames = [(f.filename, f.lineno, f.name) for f in traceback.extract_stack()]
            site = "forward " + _model_line(frames)
        else:
            text = "".join(node.metadata.get("traceback_", []))
            site = "backward " + _model_line([(m[0], m[1], m[2]) for m in _FRAME.findall(text)])
        self.by_line[site] += self.flops - before


def line_flops(loss_fn, params, batch) -> Counter:
    """Matmul FLOPs by model line of one loss and its gradients."""
    leaves = list(flatten(params).values())
    for p in leaves:
        p.requires_grad_(True)
    meter = LineMeter()
    with meter, torch.enable_grad(), torch.autograd.set_detect_anomaly(True, check_nan=False):
        torch.autograd.grad(loss_fn(params, batch), leaves)
    return meter.by_line


def family_split(arch: str, mesh) -> dict:
    """``arch``'s reduced train step at :data:`SHAPE` on ``mesh`` against
    the same step unsharded: ``by_line`` maps each model line to (rank
    0's FLOPs x ranks, the unsharded FLOPs), ``step`` is the same pair
    for the whole step (forward, backward and update)."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = get_config(arch).reduced()
    loss_fn = make_loss_fn(cfg)
    ranks = mesh.size()
    step, args = roofline.layout_cell(cfg, SHAPE, mesh)
    with active_mesh(mesh), implicit_replication():
        step(*args)  # DTensor's sharding, inferred once
        sharded = line_flops(loss_fn, args[0], args[2])
        sharded_step = count_step(step, args).flops
    step, args = roofline.plain_cell(cfg, SHAPE)
    step(*args)  # the RoPE table's copy, once
    plain = line_flops(loss_fn, args[0], args[2])
    plain_step_flops = count_step(step, args).flops
    lines = sorted(set(sharded) | set(plain))
    return {
        "by_line": {k: (ranks * sharded[k], plain[k]) for k in lines},
        "step": (ranks * sharded_step, plain_step_flops),
    }


def summary(arch: str, split: dict) -> dict:
    """The JSON line of one family: lines checked, FLOPs above the
    unsharded count (forward, backward, whole step), unsplit lines."""
    excess = {"forward": 0, "backward": 0}
    for line, (got, want) in split["by_line"].items():
        excess[line.split(" ", 1)[0]] += got - want
    got, want = split["step"]
    return {
        "arch": arch,
        "lines": {p: sum(k.startswith(p) for k in split["by_line"]) for p in ("forward", "backward")},
        "excess": {**excess, "step": got - want},
        "unsplit": sorted(k for k, (g, w) in split["by_line"].items() if g != w),
    }


# a gradient leaf of the sharded step against the unsharded step's, as
# the reference holds its own (tests/test_distributed.py:67,99)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


def _grads_rank(rank: int, archs, store: str, out: str) -> None:
    """One rank of :func:`grad_check` (gloo, a ``file://`` store)."""
    import pickle

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import P, is_dtensor, shard_leaf, shard_tree
    from repro_torch.launch.specs import demo_batch
    from repro_torch.models.registry import get_model
    from repro_torch.models.state import unflatten_into
    from repro_torch.train.steps import loss_and_grads

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=4)
    try:
        mesh = init_device_mesh("cpu", *MESH[:1], mesh_dim_names=MESH[1])
        res = {}
        for arch in archs:
            cfg = get_config(arch).reduced()
            model = get_model(cfg)
            loss_fn = make_loss_fn(cfg)
            batch = demo_batch(cfg, SHAPE.global_batch, SHAPE.seq_len, seed=1, device="cpu")
            plain = model.init_params(cfg, 0, "cpu")
            loss0, g0 = loss_and_grads(loss_fn, plain, batch)
            params = shard_tree(model.init_params(cfg, 0, "cpu"), model.param_specs(cfg), mesh)
            flat = flatten(batch)
            sharded = unflatten_into(
                batch, {k: shard_leaf(t, P("data", *[None] * (t.dim() - 1)), mesh) for k, t in flat.items()}
            )
            with active_mesh(mesh), implicit_replication():
                loss1, g1 = loss_and_grads(loss_fn, params, sharded)
            worst = (0.0, "")
            for name, a, b in zip(flatten(plain), g1, g0):
                a = a.full_tensor() if is_dtensor(a) else a
                ratio = float(((a - b).abs() / (GRAD_TOL["atol"] + GRAD_TOL["rtol"] * b.abs())).max())
                worst = max(worst, (ratio, name))
            res[arch] = {"loss": [float(loss1), float(loss0)], "worst_leaf": worst[1], "worst_over_tol": worst[0]}
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def grad_check(archs) -> dict:
    """Each arch's reduced loss and gradients on a real 4-rank gloo 2x2
    mesh (one CPU process per rank) against the same step unsharded, from
    the same weights and batch: ``{arch: {"loss": [sharded, plain],
    "worst_leaf", "worst_over_tol"}}``, the last the largest |sharded -
    plain| / (atol + rtol |plain|) over every element of every leaf (at
    most 1 passes).  The FLOP counts above see layouts, not values: a
    gradient that sums only one rank's share shows here."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as work:
        out = f"{work}/grads.pkl"
        mp.spawn(_grads_rank, args=(tuple(archs), f"{work}/store", out), nprocs=4)
        with open(out, "rb") as f:
            return pickle.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", nargs="*", default=list(FAMILIES))
    ap.add_argument("--cells", nargs="*", default=[], help="arch ids whose reduced cells run, every shape")
    ap.add_argument("--grads", nargs="*", default=[], help="arch ids whose gradients run on 4 gloo ranks")
    args = ap.parse_args(argv)
    failed = 0
    with fake_mesh(*MESH) as mesh:
        for arch in args.families:
            t0 = time.time()
            line = summary(arch, family_split(arch, mesh))
            line["elapsed_s"] = round(time.time() - t0, 1)
            failed += bool(line["unsplit"] or any(line["excess"].values()))
            print(json.dumps({"family": line}), flush=True)
        for arch in args.cells:
            for shape in SHAPES:
                cell = roofline.run_cell(arch, shape, cfg=get_config(arch).reduced(), mesh=mesh)
                failed += cell["status"] not in ("ok", "skip")
                print(json.dumps({"cell": cell}), flush=True)
    if args.grads:
        for arch, rec in grad_check(args.grads).items():
            failed += not (rec["worst_over_tol"] <= 1 and abs(rec["loss"][0] - rec["loss"][1]) <= 1e-4)
            print(json.dumps({"grads": {"arch": arch, **rec}}), flush=True)
    launches = {name: fn.launches for name, fn in kernels.wrappers().items()}
    print(json.dumps({"launches": launches}), flush=True)  # meta tensors: every count 0
    return 1 if failed or any(launches.values()) else 0


if __name__ == "__main__":
    raise SystemExit(main())
