"""The xLSTM's roofline cells, counted affinely in S.

The sLSTM loops over time in Python, so ``launch/roofline.py`` counts
the xLSTM's ``train_4k`` and ``prefill_32k`` at S = 128 and 256 (one and
two mLSTM chunks) and extrapolates.  Here that affine count equals the
fully dispatched count at a third length, exactly, and each of the
xLSTM's four cells runs at reduced size on a 2x2 ``"fake"`` mesh
(``tests/test_torch_roofline_cells.py`` runs the other arch ids').
"""

import dataclasses

import pytest
from test_torch_roofline_cells import check_cell

from repro_torch.configs import get_config
from repro_torch.launch import roofline
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models.config import SHAPES, ShapeConfig


@pytest.fixture
def mesh22():
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        yield mesh


def test_the_slstm_affine_count_equals_the_full_dispatch(mesh22):
    cfg = get_config("xlstm-350m").reduced()
    base = ShapeConfig("p", roofline.SEQ_UNITS[0], 4, "prefill")
    t1, t2, t3 = (
        roofline.count_cell(cfg, dataclasses.replace(base, seq_len=k * base.seq_len), mesh22) for k in (1, 2, 3)
    )
    assert roofline._extrapolate(t1, t2, 3).as_dict() == t3.as_dict()
    assert roofline.seq_is_affine(get_config("xlstm-350m"), SHAPES["train_4k"])
    assert not roofline.seq_is_affine(get_config("xlstm-350m"), SHAPES["decode_32k"])


@pytest.mark.parametrize("shape", list(SHAPES))
def test_every_xlstm_cell_runs_at_reduced_size(mesh22, shape):
    check_cell(mesh22, "xlstm-350m", shape)
