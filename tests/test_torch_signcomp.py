"""The port's sign-compression kernels (B5 pack, B6 unpack, B7 majority)
against the Pallas kernels they replace.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
it bit for bit against the reference's jnp oracles and its Pallas kernels
in interpret mode, on the shapes of ``tests/test_kernel_popcount_signcomp.py``
plus signed zeros, NaN, infinities and ragged lengths.  The cases marked
``cuda`` hold each CUDA kernel against its plain version on the card.
Tolerance: none — words compare bit for bit on the uint32 view, ±1
vectors exactly.

The reference (JAX) is imported only by the fixture that needs it, so the
``cuda`` cases also run on a GPU machine without JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_signcomp.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core.bitops import to_uint32, to_words
from repro_torch.kernels.signcomp import (
    compress_signs,
    decompress_signs,
    majority_ref,
    majority_vote,
    pack_signs_ref,
    sign_layout,
    unpack_signs_ref,
)

from _hypothesis_compat import given, settings, st

RAGGED = (1, 31, 16383, 16384, 16385, 50_001)


@pytest.fixture(scope="module")
def ref():
    """The reference package's sign kernels (skips where JAX is missing)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import signcomp
    from repro.kernels.signcomp.signcomp import (
        majority_pallas,
        pack_signs_pallas,
        unpack_signs_pallas,
    )

    return SimpleNamespace(
        jnp=jnp,
        sc=signcomp,
        pack_pallas=pack_signs_pallas,
        unpack_pallas=unpack_signs_pallas,
        majority_pallas=majority_pallas,
    )


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    return torch.device("cuda")


def _grads(n: int, seed: int) -> np.ndarray:
    """Normal floats with the awkward values planted: ±0.0, NaN, ±inf."""
    x = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    special = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, -1e-45], np.float32)
    x[: min(n, special.size)] = special[: min(n, special.size)]
    if n > 64:
        x[n // 2 : n // 2 + special.size] = special
    return x


def _signs(x: np.ndarray) -> np.ndarray:
    """The reference's sign rule: ``x >= 0`` with subnormals flushed to
    zero (XLA does so on the CPU and the TPU), NaN negative."""
    return np.where(x > -np.finfo(np.float32).tiny, 1.0, -1.0)


def _words_np(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2**32, shape, dtype=np.uint32)


# -- plain versions vs the reference ------------------------------------------


@pytest.mark.parametrize("rows,words", [(8, 512), (16, 1024), (4, 512)])
def test_pack_unpack_match_pallas(ref, rows, words):
    x = _grads(32 * rows * words, rows).reshape(32 * rows, words)
    jx = ref.jnp.asarray(x)
    want = np.asarray(ref.pack_pallas(jx, block_rows=min(8, rows), block_words=512))
    np.testing.assert_array_equal(want, np.asarray(ref.sc.pack_signs_ref(jx)))
    got = pack_signs_ref(torch.from_numpy(x))
    np.testing.assert_array_equal(to_uint32(got), want)

    unpacked = np.asarray(
        ref.unpack_pallas(ref.jnp.asarray(want), block_rows=min(8, rows), block_words=512)
    )
    np.testing.assert_array_equal(unpack_signs_ref(got).numpy(), unpacked)


@pytest.mark.parametrize("n", RAGGED)
def test_compress_roundtrip_matches_reference(ref, n):
    """Ragged n: the padding packs to 1 in both; the round trip is the
    sign rule (-0.0 and -1e-45 -> +1, NaN -> -1)."""
    x = _grads(n, n)
    want = np.asarray(ref.sc.compress_signs(ref.jnp.asarray(x)))
    got = compress_signs(torch.from_numpy(x))
    np.testing.assert_array_equal(to_uint32(got), want)
    layout = sign_layout(n)
    assert got.shape == (layout.rows, layout.words)
    assert vars(layout) == vars(ref.sc.sign_layout(n))

    back = decompress_signs(got, n)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref.sc.decompress_signs(ref.jnp.asarray(want), n))
    )
    np.testing.assert_array_equal(back.numpy(), _signs(x))


@settings(max_examples=5, deadline=None)
@given(n=st.integers(1, 40_000), seed=st.integers(0, 2**31 - 1))
def test_sign_roundtrip_property(n, seed):
    x = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    back = decompress_signs(compress_signs(torch.from_numpy(x)), n)
    np.testing.assert_array_equal(back.numpy(), _signs(x))


@pytest.mark.parametrize("k", range(1, 10))
def test_majority_matches_pallas(ref, k):
    s = _words_np(np.random.default_rng(k), k, 8, 512)
    want = np.asarray(ref.sc.majority_vote(ref.jnp.asarray(s)))
    np.testing.assert_array_equal(want, np.asarray(ref.sc.majority_ref(ref.jnp.asarray(s))))
    np.testing.assert_array_equal(to_uint32(majority_vote(to_words(s))), want)


def test_majority_semantics_small():
    """Odd K: strict majority per bit."""
    k = 3
    raw = np.random.default_rng(0).integers(0, 2, size=(k, 64)).astype(np.uint8)
    stacks = to_words(np.packbits(raw, axis=1, bitorder="little").view(np.uint32))
    got = np.unpackbits(
        to_uint32(majority_vote(stacks[:, None, :]))[0].view(np.uint8), bitorder="little"
    )
    np.testing.assert_array_equal(got, (raw.sum(axis=0) * 2 >= k).astype(np.uint8))


def test_majority_ties_vote_positive():
    """Even K: a 2-2 split sets the bit."""
    a, b = 0x0000FFFF, 0x00FF00FF
    s = to_words(np.array([a, b, ~a & 0xFFFFFFFF, ~b & 0xFFFFFFFF], np.uint32))
    assert to_uint32(majority_vote(s.reshape(4, 1, 1)))[0, 0] == 0xFFFFFFFF


def test_majority_is_signsgd_vote():
    """Majority of compressed sign planes == sign of the sum of signs (odd K)."""
    k, n = 5, 3000
    grads = np.random.default_rng(42).normal(size=(k, n)).astype(np.float32)
    packed = torch.stack([compress_signs(torch.from_numpy(g)) for g in grads])
    got = decompress_signs(majority_vote(packed), n)
    votes = np.where(grads >= 0, 1, -1).sum(axis=0)
    np.testing.assert_array_equal(got.numpy(), np.where(votes >= 0, 1.0, -1.0))


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        compress_signs(torch.zeros(0))
    with pytest.raises(ValueError):
        compress_signs(torch.zeros(4, 4))
    with pytest.raises(ValueError):
        decompress_signs(torch.zeros((1, 512), dtype=torch.int32), 16385)
    with pytest.raises(ValueError):
        majority_vote(torch.zeros((0, 1, 512), dtype=torch.int32))


# -- the CUDA kernels vs their plain versions (on the card) ------------------------


def _cuda_grads(n, cuda, seed):
    return torch.from_numpy(_grads(n, seed)).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("n", RAGGED + (3 * 16384 * 7 + 5,))
@pytest.mark.parametrize("lanes", [512, 7])
def test_pack_unpack_kernels_match_plain(cuda, n, lanes):
    x = _cuda_grads(n, cuda, n + lanes)
    words = compress_signs(x, lanes=lanes)
    layout = sign_layout(n, lanes)
    padded = torch.nn.functional.pad(x, (0, layout.rows * 32 * lanes - n))
    want = pack_signs_ref(padded.reshape(-1, lanes))
    assert torch.equal(words, want)
    back = decompress_signs(words, n)
    assert torch.equal(back, unpack_signs_ref(want).reshape(-1)[:n])
    assert torch.equal(back.cpu(), torch.from_numpy(_signs(x.cpu().numpy())).float())


@pytest.mark.cuda
def test_pack_kernel_past_the_grid_y_limit(cuda):
    """R > 65,535 packed rows: a 1-D grid and 64-bit offsets."""
    n = 65_537 * 16384 + 1001
    x = torch.randn(n, device=cuda)
    words = compress_signs(x)
    assert words.shape[0] == 65_538
    tail = x[65_536 * 16384 :]
    want_tail = pack_signs_ref(
        torch.nn.functional.pad(tail, (0, 2 * 16384 - tail.numel())).reshape(-1, 512)
    )
    assert torch.equal(words[65_536:], want_tail)
    assert torch.equal(words[:4096], pack_signs_ref(x[: 4096 * 16384].reshape(-1, 512)))
    back = decompress_signs(words, n)
    assert torch.equal(back[-(2 << 20) :], torch.where(x[-(2 << 20) :] >= 0, 1.0, -1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 9])
@pytest.mark.parametrize("r,w", [(8, 512), (3, 7), (1, 1)])
def test_majority_kernel_matches_plain(cuda, k, r, w):
    s = torch.randint(-(2**31), 2**31, (k, r, w), dtype=torch.int32, device=cuda)
    assert torch.equal(majority_vote(s), majority_ref(s))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 17, 255, 256, 1000, 65535])
def test_majority_kernel_wide_votes(cuda, k):
    """Each bit-sliced counter width at and past its edge (4, 8 and 16
    planes), with words planted at the vote's threshold: floor(K/2) ones
    (a tie for even K, which votes 1), ceil(K/2) ones, and all K ones."""
    s = torch.randint(-(2**31), 2**31, (k, 2, 7), dtype=torch.int32, device=cuda)
    for col, ones in ((0, k // 2), (1, (k + 1) // 2), (2, k)):
        s[:, 0, col] = 0
        s[:ones, 0, col] = -1
    got = majority_vote(s)
    assert torch.equal(got, majority_ref(s))
    assert to_uint32(got.cpu())[0, 0] == (0xFFFFFFFF if k % 2 == 0 else 0)
    assert to_uint32(got.cpu())[0, 1] == to_uint32(got.cpu())[0, 2] == 0xFFFFFFFF


@pytest.mark.cuda
def test_majority_kernel_rejects_more_voters_than_its_counter(cuda):
    with pytest.raises(ValueError, match="65535"):
        majority_vote(torch.zeros((65536, 1, 1), dtype=torch.int32, device=cuda))
