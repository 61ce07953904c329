"""The port's dry-run against the reference's at published widths.

For starcoder2-3b, deepseek-v2-lite-16b, xlstm-350m and whisper-medium,
``train_4k`` and ``decode_32k``, on the 16x16 and the 2x16x16 meshes,
every argument's per-rank shape and the total argument bytes of one rank
equal the reference's: its ``build_cell`` on a ``jax.sharding.AbstractMesh``
and ``NamedSharding.shard_shape`` (no devices, nothing compiled).

``repro.launch.dryrun`` sets ``XLA_FLAGS`` when it is imported, so it is
imported only inside the fixture, after JAX's backend is up, and the
variable is put back.
"""

import json
import math
import os

import pytest

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models.config import SHAPES

ARCHS = ("starcoder2-3b", "deepseek-v2-lite-16b", "xlstm-350m", "whisper-medium")
CELLS = [(a, s, mp) for a in ARCHS for s in ("train_4k", "decode_32k") for mp in (False, True)]


@pytest.fixture(scope="module")
def ref_build_cell():
    pytest.importorskip("jax")
    import jax

    jax.devices()  # the backend is up before the import sets its flag
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import build_cell
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return build_cell


def _ref_cell(build_cell, arch, shape, multi_pod):
    """Per-leaf (per-rank shape, bytes) of the reference's cell."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as ref_get_config

    shape_, axes = dryrun.PRODUCTION_SHAPES[multi_pod]
    _, args, shardings = build_cell(
        ref_get_config(arch), SHAPES[shape], AbstractMesh(shape_, axes)
    )
    rows = []
    for a, s in zip(jax.tree.leaves(args), jax.tree.leaves(shardings)):
        local = tuple(s.shard_shape(a.shape))
        rows.append((local, math.prod(local) * a.dtype.itemsize))
    return rows


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_per_rank_bytes_equal_the_reference(ref_build_cell, arch, shape, multi_pod):
    want = _ref_cell(ref_build_cell, arch, shape, multi_pod)
    cfg = get_config(arch)
    mesh = dryrun.production_mesh(multi_pod)
    names, args, resolved = dryrun.build_cell(cfg, SHAPES[shape], mesh)
    got = [(local, nbytes) for rows in dryrun.per_rank(args, resolved, mesh) for _, _, local, nbytes in rows]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)
    total = sum(b for _, b in want)
    cell = dryrun.run_cell(arch, shape, multi_pod, device_bytes=80 * 2**30, roofline=False)
    assert cell["argument_bytes"] == total
    assert cell["temp_bytes"] is None and cell["fits"] == (total <= 80 * 2**30)


def test_the_error_feedback_adds_one_f32_copy_of_the_parameters():
    base = dryrun.run_cell("starcoder2-3b", "train_4k", False, roofline=False)
    sign = dryrun.run_cell("starcoder2-3b", "train_4k", False, compress_grads="signsgd", roofline=False)
    ef = 2 * base["bytes_by_group"]["params"]  # f32 beside bf16 parameters
    assert sign["bytes_by_group"]["ef"] == ef
    assert sign["argument_bytes"] == base["argument_bytes"] + ef


def test_cli_prints_one_json_line_per_cell(capsys, tmp_path):
    before = dict(os.environ)
    dryrun.main(["--arch", "xlstm-350m", "--shape", "long_500k", "--device-bytes", "1", "--out", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    cells = [json.loads(line) for line in lines]
    assert [c["mesh"] for c in cells] == ["16x16", "2x16x16"]
    assert all(c["status"] == "ok" and c["fits"] is False for c in cells)
    assert [c["roofline"]["chips"] for c in cells] == [256, 512]
    assert dict(os.environ) == before  # nothing global is set
