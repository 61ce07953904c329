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
  (the RoPE table is copied to a device once, by its first call); the
  MoE's one-hot is the reference's;
* for every family, rank 0's matmul FLOPs on a 2x2 mesh times 4 equal
  the unsharded count, per model line (forward and backward) and for
  the whole step (``launch/split.py``);
* the launch tools' cell files pass ``tests/test_results_artifacts.py``'s
  checks;
* ``perf.py``'s exchange gives the 1-bit variant exactly 4x fewer
  collective bytes than the f32 all-reduce; blockwise attention does
  naive's matmuls (and, eagerly, moves more bytes).

Every count on a mesh runs on the ``"fake"`` backend, one group per test
(the ``mesh22`` fixture tears it down).  ``repro.launch.roofline`` sets
``XLA_FLAGS`` when it is imported, so it is imported only inside a
fixture, after JAX's backend is up, and the variable is put back.
Tolerance: none — every comparison is exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun, hlo_analysis, perf, roofline, split
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.models.moe import one_hot


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


@pytest.mark.parametrize(
    "arch", ["starcoder2-3b", "xlstm-350m", "recurrentgemma-2b", "whisper-medium", "deepseek-v2-lite-16b"]
)
def test_a_train_step_counts_the_same_on_meta_and_cpu(arch):
    cfg = get_config(arch).reduced()
    counts = []
    for device in ("meta", "cpu"):
        step, args = roofline.plain_cell(cfg, ShapeConfig("t", 16, 2, "train"), device)
        step(*args)  # fills the per-device RoPE table cache once
        m = hlo_analysis.count_step(step, args)
        counts.append((m.flops, m.bytes, m.ops, dict(m.by_op)))
    assert counts[0] == counts[1]
    assert counts[0][0] > 0 and counts[0][1] > 0


def test_the_moe_one_hot_is_the_references():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    E = 6
    ids = np.random.default_rng(0).integers(0, E, size=(3, 17))
    ids[1, :E] = np.arange(E)  # every id, E - 1 among them
    got = one_hot(torch.from_numpy(ids), E)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.nn.one_hot(ids, E, dtype=jnp.int32)))


@pytest.mark.parametrize("arch", split.FAMILIES)
def test_per_rank_matmul_flops_globalize_to_the_unsharded_count(mesh22, arch):
    """A reduced train step on 2x2 (the model axis divides the heads, or
    one KV head is read whole by every rank): per model line, rank 0's
    matmul FLOPs times 4 equal the unsharded step's, in the forward and
    in the backward, and so do the whole step's.  No line runs unsplit
    on a rank (ROADMAP C23)."""
    res = split.family_split(arch, mesh22)
    lines = res["by_line"]
    assert sum(k.startswith("forward ") for k in lines) >= 5
    assert sum(k.startswith("backward ") for k in lines) >= 5
    assert not any(k.endswith(" other") for k in lines)
    for line, (got, want) in lines.items():
        assert got == want, line
    assert res["step"][0] == res["step"][1] > 0
    assert split.summary(arch, res)["excess"] == {"forward": 0, "backward": 0, "step": 0}


def test_the_launch_tools_cell_files_pass_the_artifact_checks(mesh22, tmp_path, monkeypatch):
    """Cells written as the port's launch tools write them (to
    ``results/torch/`` by default, here to ``tmp_path``) pass the
    reference's checks of its own cell files, with the reference's
    roofline keys."""
    import test_results_artifacts as artifacts

    cell = roofline.run_cell(
        "starcoder2-3b", "decode_32k", cfg=get_config("starcoder2-3b").reduced(), mesh=mesh22,
        out_dir=str(tmp_path / "roofline"),
    )
    for mp in (False, True):
        dryrun.run_cell("granite-8b", "decode_32k", mp, roofline=False, out_dir=str(tmp_path / "dryrun"))
    written = sorted(p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("*.json"))
    assert written == [
        "dryrun/granite-8b_decode_32k_16x16.json",
        "dryrun/granite-8b_decode_32k_2x16x16.json",
        "roofline/starcoder2-3b_decode_32k.json",
    ]
    with open(tmp_path / "roofline" / "starcoder2-3b_decode_32k.json") as f:
        assert json.load(f) == cell
    assert set(cell) == {
        "arch", "shape", "mesh", "status", "method", "units", "elapsed_s",
        "params_total", "params_active", "model_flops", "useful_ratio", "roofline",
    }
    monkeypatch.setattr(artifacts, "RESULTS", str(tmp_path))
    artifacts.test_all_dryrun_cells_ok()
    artifacts.test_dryrun_covers_both_meshes()
    artifacts.test_roofline_terms_sane()
    assert roofline.RESULTS_DIR.endswith("results/torch/roofline")
    assert dryrun.RESULTS_DIR.endswith("results/torch/dryrun") and perf.RESULTS_DIR.endswith("results/torch/perf")


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
