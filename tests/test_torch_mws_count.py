"""The port's one-pass reduce + count (B4, ``mws_count``) against the Pallas
kernel it replaces.

On the CPU the wrapper runs its plain PyTorch version; these tests hold it
equal to the reference's ``mws_count`` (Pallas in interpret mode, as
``tests/test_kernel_mws_count.py`` runs it) for every op on ragged
shapes, and to numpy on the paper's BMI query.  The cases marked ``cuda``
hold the CUDA kernel against its plain version and run only on the card.
Tolerance: none — counts are integers and compare exactly.

The reference (JAX) is imported only by the fixture that needs it, so the
``cuda`` cases also run on a GPU machine without JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mws_count.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core.bitops import BitOp, to_words
from repro_torch.kernels.mws_count import mws_count, mws_count_ref
from _hypothesis_compat import given, settings, st  # hypothesis optional

OPS = list(BitOp)
SHAPES = [(1, 1), (3, 200), (48, 2048), (70, 2049)]


def _words(rng, n, w) -> np.ndarray:
    return rng.integers(0, 2**32, (n, w), dtype=np.uint32)


@pytest.fixture(scope="module")
def ref():
    """The reference package's count (skips where JAX is missing)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core.bitops import BitOp
    from repro.kernels.mws_count import mws_count, mws_count_ref

    return SimpleNamespace(jnp=jnp, BitOp=BitOp, mws_count=mws_count, mws_count_ref=mws_count_ref)


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    return torch.device("cuda")


# -- the plain version vs the Pallas kernel (interpret mode) ------------------


@pytest.mark.parametrize("op", OPS, ids=lambda o: o.value)
@pytest.mark.parametrize("n,w", SHAPES)
def test_plain_matches_pallas(ref, op, n, w):
    x = _words(np.random.default_rng(n * 7 + w), n, w)
    want = int(ref.mws_count(ref.jnp.asarray(x), ref.BitOp(op.value)))
    got = mws_count(to_words(x), op)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == want


@settings(max_examples=6, deadline=None)
@given(
    n=st.integers(1, 40),
    w=st.integers(1, 300),
    seed=st.integers(0, 2**31 - 1),
    op=st.sampled_from(OPS),
)
def test_plain_matches_reference_property(ref, n, w, seed, op):
    x = _words(np.random.default_rng(seed), n, w)
    want = int(ref.mws_count_ref(ref.jnp.asarray(x), ref.BitOp(op.value)))
    assert int(mws_count(to_words(x), op)) == want


def test_bmi_query_one_pass():
    """The paper's BMI query: users active on every one of 48 days."""
    rng = np.random.default_rng(0)
    users, days = 65536, 48
    daily = rng.random((days, users)) < 0.95
    stack = np.packbits(daily, axis=1, bitorder="little").view(np.uint32)
    assert int(mws_count(to_words(stack), BitOp.AND)) == int(daily.all(axis=0).sum())


def test_rejects_counts_past_int32():
    """32 * W >= 2^31 raises before any dispatch: checked on tensors that
    hold no data (meta) or none of their own (an expanded CPU view)."""
    for t in (
        torch.empty((2, 2**26), dtype=torch.int32, device="meta"),
        torch.zeros((1, 1), dtype=torch.int32).expand(3, 2**26),
    ):
        with pytest.raises(ValueError, match="overflow an int32 count"):
            mws_count(t, BitOp.AND)
    with pytest.raises(ValueError, match="non-empty"):
        mws_count(torch.zeros((0, 4), dtype=torch.int32), BitOp.OR)


# -- the CUDA kernel vs its plain version (on the card) ------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("op", OPS, ids=lambda o: o.value)
@pytest.mark.parametrize("n,w", SHAPES + [(5, 1024), (130, 4097)])
def test_kernel_matches_plain(cuda, op, n, w):
    g = torch.Generator(device=cuda)
    g.manual_seed(n * 7 + w)
    x = torch.randint(-(2**31), 2**31, (n, w), generator=g, dtype=torch.int32, device=cuda)
    before = mws_count.launches
    got = mws_count(x, op)
    assert mws_count.launches == before + 1
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(mws_count_ref(x, op))


@pytest.mark.cuda
def test_kernel_past_2_31_words(cuda):
    """70 x 31,000,001 words (2.17e9, 8.7 GB): 64-bit offsets and the
    one-word path of a width that is not a multiple of four."""
    n, w = 70, 31_000_001
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    x = torch.empty((n, w), dtype=torch.int32, device=cuda)
    loyal = torch.randint(-(2**31), 2**31, (w,), generator=g, dtype=torch.int32, device=cuda)
    for d in range(n):
        x[d] = torch.randint(-(2**31), 2**31, (w,), generator=g, dtype=torch.int32, device=cuda) | loyal
    assert n * w > 2**31
    for op in (BitOp.AND, BitOp.NAND, BitOp.XOR):
        assert int(mws_count(x, op)) == int(mws_count_ref(x, op))
