"""Every (arch x shape) cell of the roofline runs at reduced size (the
xLSTM's cells, the slowest to dispatch, are in
``tests/test_torch_roofline_xlstm.py``).

Each arch id's ``.reduced()`` config, at every shape of the reference's
table (full batch and length: the count dispatches ops, it computes
nothing), is counted on a 2x2 ``"fake"`` mesh through
``launch/roofline.py::run_cell``: it comes out ``ok`` with every term
finite and ``0 < useful_ratio <= 1.2`` (as
``tests/test_results_artifacts.py`` holds the reference's cells), or it
is skipped by the reference's rule (``long_500k`` needs sub-quadratic
attention).  The xLSTM's ``train_4k`` and ``prefill_32k`` run its affine
count in S.
"""

import math

import pytest

from repro_torch.configs import get_config
from repro_torch.launch import roofline, split
from repro_torch.launch.dryrun import cell_is_skipped
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models.config import SHAPES


@pytest.fixture
def mesh22():
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        yield mesh


def check_cell(mesh, arch: str, shape: str) -> dict:
    cfg = get_config(arch).reduced()
    cell = roofline.run_cell(arch, shape, cfg=cfg, mesh=mesh)
    skip = cell_is_skipped(get_config(arch), SHAPES[shape])
    if skip:
        assert cell == {"arch": arch, "shape": shape, "status": "skip", "reason": skip}
        return cell
    assert cell["status"] == "ok" and cell["mesh"] == "2x2"
    ro = cell["roofline"]
    assert ro["chips"] == 4
    assert all(math.isfinite(ro[k]) and ro[k] >= 0 for k in ("flops", "bytes_accessed", "collective_bytes"))
    assert ro["memory_s"] > 0 and ro["dominant"] in ("compute", "memory", "collective")
    assert 0 < cell["useful_ratio"] <= 1.2, cell["useful_ratio"]
    affine = roofline.seq_is_affine(cfg, SHAPES[shape])
    assert cell["method"].startswith("full depth") and ("affine in S" in cell["method"]) == affine
    return cell


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", split.CELL_ARCHS)
def test_every_cell_runs_at_reduced_size(mesh22, arch, shape):
    check_cell(mesh22, arch, shape)
