"""The port's roofline analysis against the reference's conventions.

``launch/hlo_analysis.py`` counts the ATen ops one rank dispatches where
the reference reads XLA's cost analysis and per-device HLO, so the
checks are on what both must share:

* parameter counts and model FLOPs equal the reference's for every arch
  id and shape (its ``count_params`` on ``jax.eval_shape``);
* a collective meters exactly what the reference's ``collective_bytes()``
  gives for an HLO line with the same result type;
* a step counted on meta tensors equals the same step counted on CPU
  tensors (FLOPs, bytes, ops, op by op), each after one uncounted call
  (the RoPE table is copied to a device once, by its first call);
* globalized per-rank matmul FLOPs on a 2x2 mesh equal the unsharded
  count;
* ``perf.py``'s exchange gives the 1-bit variant exactly 4x fewer
  collective bytes than the f32 all-reduce; blockwise attention does
  naive's matmuls (and, eagerly, moves more bytes).

Every count on a mesh runs on the ``"fake"`` backend, one group per test
(the ``mesh22`` fixture tears it down).  ``repro.launch.roofline`` sets
``XLA_FLAGS`` when it is imported, so it is imported only inside a
fixture, after JAX's backend is up, and the variable is put back.
Tolerance: none — every comparison is exact.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import hlo_analysis, perf, roofline
from repro_torch.launch.mesh import fake_mesh
from repro_torch.launch.specs import demo_batch
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.models.registry import get_model
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.steps import make_train_step


@pytest.fixture
def mesh22():
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        yield mesh


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax

    jax.devices()  # the backend is up before the import sets its flag
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import hlo_analysis as ref_hlo
        from repro.launch.roofline import count_params
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    from repro.configs import get_config as ref_get_config

    return count_params, ref_hlo, ref_get_config


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_and_model_flops_equal_the_reference(ref, arch):
    ref_count, ref_hlo, ref_get_config = ref
    want = ref_count(ref_get_config(arch))
    got = roofline.count_params(get_config(arch))
    assert got == want
    for shape in SHAPES.values():
        assert hlo_analysis.model_flops(None, shape, *got) == ref_hlo.model_flops(None, shape, *want)


def test_the_wire_factors_are_the_references(ref):
    assert hlo_analysis._WIRE_FACTOR == ref[1]._WIRE_FACTOR


_HLO_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int32: "s32"}


def _hlo_line(kind: str, result: torch.Tensor) -> str:
    dims = ",".join(map(str, result.shape))
    layout = ",".join(map(str, reversed(range(result.dim()))))
    dt = _HLO_DTYPES[result.dtype]
    return f"  %{kind}.7 = {dt}[{dims}]{{{layout}}} {kind}({dt}[1]{{0}} %p.1), channel_id=3"


def _funcol_calls(mesh):
    from torch.distributed import _functional_collectives as funcol

    data, model = mesh.get_group("data"), mesh.get_group("model")
    return {
        "all-reduce": lambda x: funcol.all_reduce(x, "sum", data),
        "all-gather": lambda x: funcol.all_gather_tensor(x, 0, model),
        "reduce-scatter": lambda x: funcol.reduce_scatter_tensor(x, "sum", 0, data),
        "all-to-all": lambda x: funcol.all_to_all_single(x, None, None, model),
    }


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "reduce-scatter", "all-to-all"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_an_explicit_collective_meters_the_references_bytes(ref, mesh22, kind, dtype):
    x = torch.empty((6, 10), dtype=dtype, device="meta")
    meter = hlo_analysis.OpMeter()
    with meter:
        out = _funcol_calls(mesh22)[kind](x)
    want = ref[1].collective_bytes(_hlo_line(kind, out))
    assert meter.collectives.bytes_by_kind == want.bytes_by_kind
    assert meter.collectives.count_by_kind == want.count_by_kind
    assert meter.bytes == 0 and meter.flops == 0  # collectives count on their own term


def test_an_implicit_redistribution_meters_the_references_bytes(ref, mesh22):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    local = torch.empty((4, 8), dtype=torch.float32, device="meta")
    x = DTensor.from_local(local, mesh22, [Shard(0), Partial()], run_check=False)
    meter = hlo_analysis.OpMeter()
    with meter:
        x.redistribute(mesh22, [Replicate(), Replicate()])
    gathered = torch.empty((8, 8), dtype=torch.float32, device="meta")
    lines = [_hlo_line("all-reduce", local), _hlo_line("all-gather", gathered)]
    want = ref[1].collective_bytes("\n".join(lines))
    assert meter.collectives.bytes_by_kind == want.bytes_by_kind
    assert meter.collectives.count_by_kind == want.count_by_kind


def test_an_unmetered_collective_raises(mesh22):
    import torch.distributed as dist

    meter = hlo_analysis.OpMeter()
    with pytest.raises(ValueError, match="unmetered collective"):
        with meter:
            dist.broadcast(torch.zeros(4), src=0, group=mesh22.get_group("data"))


def _train_args(cfg, device, batch=2, seq=16):
    params = get_model(cfg).init_params(cfg, 0, device)
    opt = init_opt_state(params, OptimizerConfig(state_dtype=cfg.optimizer_dtype))
    data = demo_batch(cfg, batch, seq, seed=0, device="cpu")
    if device == "meta":
        data = {
            "inputs": {k: torch.empty_like(v, device="meta") for k, v in data["inputs"].items()},
            "labels": torch.empty_like(data["labels"], device="meta"),
        }
    return make_train_step(cfg, OptimizerConfig(state_dtype=cfg.optimizer_dtype)), (params, opt, data)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "xlstm-350m", "recurrentgemma-2b", "whisper-medium"])
def test_a_train_step_counts_the_same_on_meta_and_cpu(arch):
    cfg = get_config(arch).reduced()
    counts = []
    for device in ("meta", "cpu"):
        step, args = _train_args(cfg, device)
        step(*args)  # fills the per-device RoPE table cache once
        m = hlo_analysis.count_step(step, args)
        counts.append((m.flops, m.bytes, m.ops, dict(m.by_op)))
    assert counts[0] == counts[1]
    assert counts[0][0] > 0 and counts[0][1] > 0


def _matmul_sites(cfg, args_fn):
    """Matmul FLOPs of one forward by the model line that issued them:
    ``{(file, function, line): flops}``."""
    import traceback

    sites = {}
    meter = hlo_analysis.OpMeter()
    count = meter._count

    def by_site(func, args, kwargs, out):
        before = meter.flops
        count(func, args, kwargs, out)
        if meter.flops > before:
            frame = next(f for f in reversed(traceback.extract_stack()) if "repro_torch/models" in f.filename)
            key = (os.path.basename(frame.filename), frame.name, frame.line)
            sites[key] = sites.get(key, 0) + meter.flops - before

    meter._count = by_site
    with meter:
        args_fn()
    return sites, meter


# the one matmul torch 2.13's DTensor runs on every data rank (its input
# arrives partial over "model"), so rank 0 computes twice its share;
# torch 2.11's splits it (ROADMAP C22)
_REPLICATED = {("layers.py", "mlp_fwd", 'h = torch.einsum("bsd,df->bsf", x, p["up"].to(cdt))'): 2}


def test_per_rank_matmul_flops_globalize_to_the_unsharded_count(mesh22):
    """A reduced dense train step on 2x2 (4 heads, 2 KV heads: the model
    axis divides both): per model line, rank 0's forward matmul FLOPs
    times 4 equal the unsharded forward's, but at the line named in
    ``_REPLICATED``; the whole step's (forward and backward, which
    multiplies a matmul's work by 3) differs by exactly 3x that line's
    excess."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import active_mesh
    from repro_torch.train.steps import make_loss_fn

    cfg = get_config("starcoder2-3b").reduced()
    shape = ShapeConfig("t", 16, 4, "train")
    loss_fn = make_loss_fn(cfg)
    step, (params, opt, batch) = roofline.layout_cell(cfg, shape, mesh22)
    with active_mesh(mesh22), implicit_replication():
        step(params, opt, batch)  # DTensor's sharding, inferred once
        sharded, _ = _matmul_sites(cfg, lambda: loss_fn(params, batch))
    plain_step, (p0, _, b0) = _train_args(cfg, "meta", batch=4, seq=16)
    plain, _ = _matmul_sites(cfg, lambda: loss_fn(p0, b0))
    assert sharded.keys() == plain.keys() and len(plain) >= 5
    excess = 0
    for site, flops in plain.items():
        assert 4 * sharded[site] == _REPLICATED.get(site, 1) * flops, site
        excess += 4 * sharded[site] - flops
    assert excess > 0
    whole = roofline.count_cell(cfg, shape, mesh22).flops
    plain_step(*_train_args(cfg, "meta", batch=4, seq=16)[1])  # the RoPE table's copy, once
    assert whole - hlo_analysis.count_step(plain_step, _train_args(cfg, "meta", batch=4, seq=16)[1]).flops == 3 * excess


def test_a_counted_step_counts_the_same_again(mesh22):
    """After its first call (DTensor's sharding inference, the RoPE
    table's copy), a step counts the same every time."""
    cfg = get_config("granite-8b").reduced()
    step, args = roofline.layout_cell(cfg, ShapeConfig("t2", 16, 4, "train"), mesh22)
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import active_mesh

    with active_mesh(mesh22), implicit_replication():
        first, second, third = (hlo_analysis.count_step(step, args) for _ in range(3))
    assert first.bytes > second.bytes  # the first call's own work
    assert (second.flops, second.bytes, second.ops, second.by_op) == (third.flops, third.bytes, third.ops, third.by_op)


def test_the_one_bit_exchange_moves_a_quarter_of_the_f32_bytes():
    n = 16384 * 48  # whole sign words: no padding
    assert np.prod(perf.grad_shape(n)) == n
    with fake_mesh((16, 16), ("data", "model")) as mesh:
        base, packed = perf.exp_grad_exchange(mesh, n)
    assert base["variant"] == "baseline(f32-psum)" and packed["variant"] == "1bit-majority-allgather"
    b, p = base["roofline"], packed["roofline"]
    assert b["collective_detail"]["bytes"] == {"all-reduce": 2 * 4 * n}
    assert b["collective_bytes"] == 4 * p["collective_bytes"]
    with fake_mesh((2, 16, 16), ("pod", "data", "model")) as mesh:
        flat, hier = perf.exp_grad_exchange(mesh, n)
    assert flat["roofline"]["collective_detail"]["count"] == {"all-reduce": 2}
    assert hier["roofline"]["collective_detail"]["bytes"]["all-gather"] == 2 * n // 8


def test_blockwise_attention_does_the_same_matmuls_and_moves_more_bytes(mesh22):
    """H1 of ``perf.py`` (the online softmax removes the (Sq, Skv)
    scores' traffic) rests on XLA fusing the loop body.  Eagerly, every
    KV block's (B, H, Sq, 1024) f32 scores are written and read by
    several elementwise ops, so the blockwise path moves more bytes than
    the naive one for the very same matmul FLOPs."""
    naive, blockwise = perf.exp_yi_prefill(mesh22, get_config("yi-34b").reduced())
    assert blockwise["roofline"]["flops"] == naive["roofline"]["flops"] > 0
    assert blockwise["roofline"]["bytes_accessed"] > naive["roofline"]["bytes_accessed"]


def test_fake_mesh_refuses_a_second_group(mesh22):
    with pytest.raises(RuntimeError, match="group is up"):
        with fake_mesh((1, 1), ("data", "model")):
            pass
