"""The port's kernels (B1 mws, B2 popcount, B3 threshold) against the Pallas
kernels they replace.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that plain version bit-exact against the reference Pallas kernel run in
interpret mode (as ``tests/test_kernel_mws.py`` runs it), on small ragged
shapes, every op and every k, and check which of B1's two variants
(streaming, staged) the wrapper picks from a launch's shapes.  The cases
marked ``cuda`` hold the CUDA kernel itself, each variant of B1 included,
against its plain version and run only on the card.  Every wrapper of
B1-B7 raises on a tensor that is neither on the CPU nor on the card (a
meta tensor, as the roofline's counted steps hold).
Tolerance: none — packed words compare bit for bit on the uint32 view.

The reference (JAX) is imported only by the fixture that needs it, so the
``cuda`` cases also run on a GPU machine without JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core.bitops import BitOp, to_uint32, to_words
from repro_torch.kernels.mws import (
    mws_gather,
    mws_gather_ref,
    mws_reduce,
    mws_reduce_ref,
    parabit_reduce,
)
from repro_torch.kernels.mws.ops import _MAX_GRID_Y, choose_variant, staged_fits
from repro_torch.kernels.mws_count import mws_count
from repro_torch.kernels.popcount import popcount, popcount_ref
from repro_torch.kernels.signcomp import compress_signs, decompress_signs, majority_vote
from repro_torch.kernels.threshold import threshold_reduce, threshold_ref

OPS = list(BitOp)


def _words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2**32, shape, dtype=np.uint32)


@pytest.fixture(scope="module")
def ref():
    """The reference package's kernels (skips where JAX is missing)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core.bitops import BitOp, reduce_words
    from repro.kernels.mws import mws_reduce
    from repro.kernels.mws.ops import parabit_reduce
    from repro.kernels.popcount.popcount import popcount_pallas
    from repro.kernels.threshold import bitslice_threshold, threshold_reduce

    return SimpleNamespace(
        jnp=jnp,
        BitOp=BitOp,
        reduce_words=reduce_words,
        mws_reduce=mws_reduce,
        parabit_reduce=parabit_reduce,
        popcount_pallas=popcount_pallas,
        bitslice_threshold=bitslice_threshold,
        threshold_reduce=threshold_reduce,
    )


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")
    return torch.device("cuda")


# -- plain versions vs the Pallas kernels (interpret mode) --------------------


@pytest.mark.parametrize("op", OPS, ids=lambda o: o.value)
@pytest.mark.parametrize("n,w", [(1, 127), (3, 2049), (65, 33)])
def test_mws_plain_matches_pallas(ref, op, n, w):
    rng = np.random.default_rng(n * 1000 + w)
    stack = _words(rng, n, w)
    if n > 2:
        stack[1] = 0xFFFFFFFF  # all-ones and all-zeros rows
        stack[2] = 0
    want = np.asarray(
        ref.mws_reduce(ref.jnp.asarray(stack), ref.BitOp(op.value), interpret=True)
    )
    got = to_uint32(mws_reduce(to_words(stack), op))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(to_uint32(mws_reduce_ref(to_words(stack), op)), want)


@pytest.mark.parametrize("op", OPS, ids=lambda o: o.value)
def test_parabit_matches_mws_and_the_reference(ref, op):
    """tests/test_kernel_mws.py::test_parabit_matches_mws: the serial
    ParaBit fold equals the one-pass MWS reduce, and the reference's
    ParaBit baseline, on a (31, 777) stack."""
    x = _words(np.random.default_rng(3), 31, 777)
    got = parabit_reduce(to_words(x), op)
    np.testing.assert_array_equal(to_uint32(got), to_uint32(mws_reduce(to_words(x), op)))
    want = ref.parabit_reduce(ref.jnp.asarray(x), getattr(ref.BitOp, op.name))
    np.testing.assert_array_equal(to_uint32(got), np.asarray(want))
    with pytest.raises(ValueError):
        parabit_reduce(to_words(x[:0]), op)


def test_mws_gather_plain_matches_reference_cube(ref):
    """The gathering form equals the reference's gather-then-reduce: AND
    within blocks, OR across, substituted spill and shared rows spliced
    in (``query/device.py:plan_step_fn``), inverse read last."""
    rng = np.random.default_rng(7)
    src, ext, shr = _words(rng, 9, 70), _words(rng, 3, 2, 70), _words(rng, 2, 70)
    idx = np.array(
        [[[0, 3, -1], [5, -3, 8]], [[-2, 4, 4], [1, 2, -4]], [[7, -1, 6], [0, 0, 0]]],
        dtype=np.int32,
    )
    m = ext.shape[1]
    for inverse in (False, True):
        for outer_or in (True, False):
            want = []
            for b in range(idx.shape[0]):
                rows = [
                    [
                        src[r] if r >= 0 else (ext[b, -1 - r] if -1 - r < m else shr[-1 - r - m])
                        for r in blk
                    ]
                    for blk in idx[b]
                ]
                per = np.stack(
                    [np.asarray(ref.reduce_words(ref.jnp.asarray(np.stack(r)), ref.BitOp.AND))
                     for r in rows]
                )
                if outer_or:
                    out = np.asarray(ref.reduce_words(ref.jnp.asarray(per), ref.BitOp.OR))
                else:
                    out = per
                want.append(~out if inverse else out)
            got = mws_gather(
                to_words(src), torch.from_numpy(idx), BitOp.AND,
                outer_or=outer_or, invert=inverse,
                ext=to_words(ext), shr=to_words(shr),
            )
            np.testing.assert_array_equal(to_uint32(got), np.stack(want))


@pytest.mark.parametrize("r,w", [(1, 1), (5, 2049), (8, 4096), (3, 77)])
def test_popcount_plain_matches_pallas(ref, r, w):
    rng = np.random.default_rng(r + w)
    words = _words(rng, r, w)
    words[0, : w // 2] = 0xFFFFFFFF
    rp, wp = -(-r // 8) * 8, -(-w // 2048) * 2048
    padded = np.zeros((rp, wp), np.uint32)
    padded[:r, :w] = words
    want = np.asarray(ref.popcount_pallas(ref.jnp.asarray(padded), interpret=True))[:r]
    np.testing.assert_array_equal(popcount(to_words(words)).numpy(), want)
    np.testing.assert_array_equal(popcount_ref(to_words(words)).numpy(), want)
    assert int(popcount(to_words(words[0]))) == int(want[0])  # (W,) -> ()


@pytest.mark.parametrize("k", range(1, 9))
def test_threshold_plain_matches_pallas_all_k(ref, k):
    """Every k of an 8-row threshold against the Pallas kernel."""
    rng = np.random.default_rng(k)
    x = _words(rng, 8, 2049)
    x[3] = 0xFFFFFFFF
    want = np.asarray(ref.threshold_reduce(ref.jnp.asarray(x), k, interpret=True))
    np.testing.assert_array_equal(to_uint32(threshold_reduce(to_words(x), k)), want)
    np.testing.assert_array_equal(
        to_uint32(threshold_reduce(to_words(x), k, invert=True)), ~want
    )


@pytest.mark.parametrize("n", range(1, 9))
def test_threshold_plain_matches_reference_every_k(ref, n):
    """Every 1 <= k <= n against the reference's shared counter, batched."""
    rng = np.random.default_rng(100 + n)
    x = _words(rng, 3, n, 45)
    for k in range(1, n + 1):
        want = np.stack(
            [np.asarray(ref.bitslice_threshold(ref.jnp.asarray(x[b]), k, n))[0]
             for b in range(3)]
        )
        np.testing.assert_array_equal(to_uint32(threshold_ref(to_words(x), k)), want)
        np.testing.assert_array_equal(to_uint32(threshold_reduce(to_words(x), k)), want)


def test_wrappers_reject_bad_arguments():
    x = torch.zeros((9, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        threshold_reduce(x, 2)  # more than 8 rows
    with pytest.raises(ValueError):
        threshold_reduce(x[:3], 4)  # k > n
    with pytest.raises(ValueError):
        mws_gather(x, torch.zeros((1, 1, 1), dtype=torch.int32), BitOp.NAND)
    with pytest.raises(ValueError):
        mws_reduce(x[:0], BitOp.AND)


def _meta(*shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


_META_CALLS = {
    "B1 mws_gather": lambda: mws_gather(_meta(4, 8), _meta(1, 1, 2)),
    "B2 popcount": lambda: popcount(_meta(2, 8)),
    "B3 threshold_reduce": lambda: threshold_reduce(_meta(3, 8), 2),
    "B4 mws_count": lambda: mws_count(_meta(3, 8), BitOp.AND),
    "B5 compress_signs": lambda: compress_signs(_meta(1000, dtype=torch.float32)),
    "B6 decompress_signs": lambda: decompress_signs(_meta(1, 512), 1000),
    "B7 majority_vote": lambda: majority_vote(_meta(3, 1, 512)),
}


@pytest.mark.parametrize("name", list(_META_CALLS))
def test_every_wrapper_raises_on_a_meta_tensor(name):
    """Only ``cpu`` (the plain version) and ``cuda`` (the kernel) run: a
    meta tensor, as the roofline's steps hold, never reaches a launch."""
    with pytest.raises(ValueError, match="cpu or cuda"):
        _META_CALLS[name]()


# (S, B, K, N, m_ext, m_shr, outer_or[, vec]) -> the variant B1's wrapper launches
_VARIANT_CASES = [
    ((365, 1, 1, 365, 0, 0, True), "streaming"),  # mws_reduce at d = 365 (B1 + B2)
    ((30, 1, 1, 30, 0, 0, True), "streaming"),  # mws_reduce at d = 30: one output row
    ((64, 45, 2, 2, 0, 0, True), "staged"),  # the flush's largest COUNT group
    ((52, 22, 2, 2, 0, 0, True), "staged"),  # the same group, optimizer on
    ((64, 12, 1, 1, 0, 0, True), "staged"),  # 12 plans, one row each
    ((64, 12, 1, 1, 1, 0, True), "streaming"),  # 12 plans, each its own spill row
    ((64, 1, 5, 1, 2, 1, False), "staged"),  # a threshold's per-block form: 5 outputs
    ((64, 1, 1, 1, 0, 0, True), "streaming"),  # one plan, one row
    ((64, 1, 3, 2, 0, 0, True), "streaming"),  # one output; its rows needn't repeat
    ((4, 1, 4, 3, 0, 0, True), "staged"),  # one output naming 12 rows of 4
    ((20_000, 45, 2, 2, 0, 0, True), "streaming"),  # a store too wide to stage
    ((64, 2, 1, 2049, 0, 0, True), "streaming"),  # an output's entries past the table
    ((9, _MAX_GRID_Y // 5, 5, 1, 0, 0, False), "staged"),  # B*K at the grid limit
    ((64, 45, 2, 2, 0, 0, True, 1), "streaming"),  # the largest group at a ragged W
    ((9, 40, 2, 2, 0, 0, False, 1), "streaming"),  # many plans over few rows, ragged W
]


@pytest.mark.parametrize("shape,variant", _VARIANT_CASES, ids=lambda c: str(c))
def test_mws_variant_is_chosen_from_shapes(shape, variant):
    assert choose_variant(*shape) == variant


def test_staged_fits_at_its_capacity():
    """The stages hold 128 words for each of up to 217 rows beside the
    2,048-entry table and the row map: 214 slots and 3 shared rows fit,
    one more does not, and fewer entries than slots size the stage."""
    assert staged_fits(214, 3, 1 << 20, 4)
    assert not staged_fits(215, 3, 1 << 20, 4)
    assert staged_fits(4000, 0, 180, 4)
    assert not staged_fits(64, 0, 180, 2049)


# -- the CUDA kernels against their plain versions (on the card only) ---------


@pytest.mark.cuda
@pytest.mark.parametrize("n,w", [(1, 1), (3, 127), (64, 2049), (65, 4096), (130, 33)])
def test_mws_kernel_matches_plain(cuda, n, w):
    x = torch.randint(-(2**31), 2**31, (n, w), dtype=torch.int32, device=cuda)
    for op in OPS:
        assert torch.equal(mws_reduce(x, op), mws_reduce_ref(x, op))


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 127, 4096])
def test_mws_gather_kernel_matches_plain(cuda, w):
    g = torch.Generator(device=cuda)
    g.manual_seed(w)

    def words(*shape):
        return torch.randint(-(2**31), 2**31, shape, generator=g, dtype=torch.int32, device=cuda)

    src, ext, shr = words(9, w), words(3, 2, w), words(2, w)
    idx = torch.tensor(
        [[[0, 3, -1], [5, -3, 8]], [[-2, 4, 4], [1, 2, -4]], [[7, -1, 6], [0, 0, 0]]],
        dtype=torch.int32, device=cuda,
    )
    for op in (BitOp.AND, BitOp.OR, BitOp.XOR):
        for outer_or in (True, False):
            kw = dict(outer_or=outer_or, invert=True, ext=ext, shr=shr)
            assert torch.equal(mws_gather(src, idx, op, **kw), mws_gather_ref(src, idx, op, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("r,w", [(1, 1), (5, 2049), (67, 4096)])
def test_popcount_kernel_matches_plain(cuda, r, w):
    x = torch.randint(-(2**31), 2**31, (r, w), dtype=torch.int32, device=cuda)
    x[0] = -1
    assert torch.equal(popcount(x), popcount_ref(x))


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 127, 2049])
def test_threshold_kernel_matches_plain(cuda, w):
    for n in range(1, 9):
        x = torch.randint(-(2**31), 2**31, (2, n, w), dtype=torch.int32, device=cuda)
        for k in range(1, n + 1):
            for inv in (False, True):
                assert torch.equal(
                    threshold_reduce(x, k, invert=inv), threshold_ref(x, k, invert=inv)
                )


def _staged_cases(cuda, w):
    """Launches of B1's staged variant at width ``w`` (as chip_smoke.py's
    check_kernels has them): many plans over few rows, every slot and
    shared row at the stages' capacity, spill and shared rows together,
    and B*K at the launch grid's limit."""
    g = torch.Generator(device=cuda)
    g.manual_seed(w)
    rng = np.random.default_rng(w)

    def words(*shape):
        return torch.randint(-(2**31), 2**31, shape, generator=g, dtype=torch.int32, device=cuda)

    def ix(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=cuda)

    S, m_shr = 214, 3
    every = np.concatenate([np.arange(S), -1 - np.arange(m_shr)])
    cap = rng.integers(-m_shr, S, 4 * 56)
    cap[: every.size] = rng.permutation(every)
    return {
        "few rows": (words(9, w), ix(rng.choice([0, 4, 7], (40, 2, 2))), None, None),
        "capacity": (words(S, w), ix(cap.reshape(56, 2, 2)), None, words(m_shr, w)),
        "ext+shr": (words(9, w), ix(rng.integers(-5, 9, (30, 2, 3))), words(30, 2, w), words(3, w)),
        "grid limit": (words(9, w), ix(rng.integers(0, 9, (_MAX_GRID_Y // 5, 5, 1))), None, None),
    }


_STAGED_CASES = ["few rows", "capacity", "ext+shr", "grid limit"]
_FULL_WIDTH = 4_194_304  # one 16 MiB page


def _check_variant(cuda, w, case, variant):
    src, idx, ext, shr = _staged_cases(cuda, w)[case]
    for op in (BitOp.AND, BitOp.OR, BitOp.XOR):
        for outer_or in (True, False) if case != "grid limit" else (False,):
            kw = dict(outer_or=outer_or, invert=op is BitOp.OR, ext=ext, shr=shr)
            before = dict(mws_gather.variant_launches)
            total = mws_gather.launches
            got = mws_gather(src, idx, op, **kw)
            assert mws_gather.variant_launches == before | {variant: before[variant] + 1}
            assert mws_gather.launches == total + 1
            assert torch.equal(got, mws_gather_ref(src, idx, op, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "w,case",
    [(4100, c) for c in _STAGED_CASES] + [(_FULL_WIDTH, c) for c in _STAGED_CASES[:3]],
)
def test_mws_staged_kernel_matches_plain(cuda, w, case):
    """A ragged last tile (4100) and a full page (its B*K grid-limit case
    would write 1 TB); the per-block form; each launch moves the staged
    counter."""
    _check_variant(cuda, w, case, "staged")


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 127, 2049])
@pytest.mark.parametrize("case", _STAGED_CASES)
def test_mws_staged_shapes_at_a_ragged_width_stream(cuda, w, case):
    """The staged shapes at a W that is not a multiple of 4 take the
    streaming kernel (the stages fill with 16-byte copies) and move only
    its counter."""
    _check_variant(cuda, w, case, "streaming")


@pytest.mark.cuda
def test_mws_reduce_launches_the_streaming_variant(cuda):
    """Identity indices (one output row) take the streaming kernel and
    move only its counter; a many-plan gather over the same rows moves
    only the staged one; the total counts both."""
    x = torch.randint(-(2**31), 2**31, (30, 4100), dtype=torch.int32, device=cuda)
    before = dict(mws_gather.variant_launches)
    total = mws_gather.launches
    assert torch.equal(mws_reduce(x, BitOp.AND), mws_reduce_ref(x, BitOp.AND))
    assert mws_gather.variant_launches == before | {"streaming": before["streaming"] + 1}
    idx = torch.randint(0, 30, (8, 2, 2), dtype=torch.int32, device=cuda)
    assert torch.equal(mws_gather(x, idx), mws_gather_ref(x, idx))
    assert mws_gather.variant_launches == {
        "streaming": before["streaming"] + 1,
        "staged": before["staged"] + 1,
    }
    assert mws_gather.launches == total + 2
