"""The port's core (bit algebra, planner copies, engine, reliability model)
against the JAX reference on identical inputs.

Inputs are made from a numpy seed and handed to both packages; packed
words compare bit for bit on the uint32 view.  The one exception is the
modelled read noise of non-ESP pages: the two packages draw their flips
from different generators, so the port is held to the flip RATE,
``rber()``, within a binomial tolerance stated in the test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.bitops as rb
import repro.core.engine as re_
import repro.core.expr as rx
import repro.core.placement as rp
import repro.core.planner as rpl
import repro.core.reliability as rr
import repro_torch.core.bitops as tb
import repro_torch.core.engine as te
import repro_torch.core.expr as tx
import repro_torch.core.placement as tp
import repro_torch.core.planner as tpl
import repro_torch.core.reliability as tr
from repro_torch.core.bitops import to_uint32, to_words
from repro_torch.core.store import IDENTITY_SLOT, ZERO_SLOT, PackedStore

W = 16  # words per page, as in tests/test_planner.py

_PKG = {
    "ref": (rx, rp, rpl, re_),
    "port": (tx, tp, tpl, te),
}


def _words(rng, *shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint32)


# -- bitops -------------------------------------------------------------------


@pytest.mark.parametrize("length", [1, 31, 32, 33, 100])
def test_pack_unpack_match_reference(length):
    rng = np.random.default_rng(length)
    bits = rng.integers(0, 2, (3, length), dtype=np.uint8)
    want = np.asarray(rb.pack_bits(jnp.asarray(bits)))
    got = tb.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_uint32(got), want)
    np.testing.assert_array_equal(tb.unpack_bits(got, length).numpy(), bits)
    np.testing.assert_array_equal(tb.valid_mask(length), rb.valid_mask(length))
    bv = tb.BitVector.from_bits(torch.from_numpy(bits[0]))
    np.testing.assert_array_equal(bv.to_bits().numpy(), bits[0])
    ref_bv = rb.BitVector.from_bits(jnp.asarray(bits[0]))
    np.testing.assert_array_equal(
        to_uint32(bv.masked().words), np.asarray(ref_bv.masked().words)
    )


@pytest.mark.parametrize("op", list(tb.BitOp), ids=lambda o: o.value)
def test_reduce_words_matches_reference(op):
    rng = np.random.default_rng(len(op.value))
    stack = _words(rng, 5, 40)
    want = np.asarray(rb.reduce_words(jnp.asarray(stack), rb.BitOp(op.value)))
    np.testing.assert_array_equal(to_uint32(tb.reduce_words(to_words(stack), op)), want)
    assert op.identity_word == rb.BitOp(op.value).identity_word


# -- planner corpus: equal CommandPlans, equal execution ------------------------
#
# The scenarios of tests/test_planner.py (layout + expression), built the
# same way in both packages, plus seeded random expressions under
# auto_layout (the property test's generator, driven by numpy).


def _fig16(x, p, arr):
    for blk, (prefix, inv) in enumerate([("A", False), ("B", False), ("C", True), ("D", True)]):
        for wl in range(4):
            arr.layout.place(f"{prefix}{wl + 1}", blk, wl, inverted=inv)
    P = x.Page
    bs = x.and_(*(P(f"B{i}") for i in range(1, 5)))
    return x.and_(x.or_(P("A1"), bs), x.or_(P("C1"), P("C3")), x.or_(P("D2"), P("D4")))


def _eq1(x, p, arr):
    for wl in range(4):
        arr.layout.place(f"A{wl}", 0, wl)
        arr.layout.place(f"B{wl}", 1, wl)
    P = x.Page
    return x.or_(x.and_(*(P(f"A{i}") for i in range(4))), x.and_(*(P(f"B{i}") for i in range(4))))


def _distinct_blocks(x, p, arr):
    arr.layout.place_colocated(["c1", "c2"], inverted=True)
    arr.layout.place_colocated(["d1", "d2"], inverted=True)
    arr.layout.place_colocated(["e1"], inverted=False)
    P = x.Page
    return x.and_(x.or_(P("c1"), P("c2")), x.or_(P("d1"), P("d2")), P("e1"))


def _same_block_spill(x, p, arr):
    for wl, n in enumerate(["c1", "c2", "c3", "c4"]):
        arr.layout.place(n, 0, wl, inverted=True)
    P = x.Page
    return x.and_(x.or_(P("c1"), P("c2")), x.or_(P("c3"), P("c4")))


def _flat(fn_name, n, place):
    def build(x, p, arr):
        names = [f"a{i}" for i in range(n)]
        if place == "inverted":
            arr.layout.place_colocated(names, inverted=True)
        elif place == "spread":
            arr.layout.place_spread(names)
        else:
            arr.layout.place_colocated(names)
        return getattr(x, fn_name)(*map(x.Page, names))

    return build


def _random_expr(seed):
    def build(x, p, arr):
        rng = np.random.default_rng(seed)
        names = ["and_", "or_", "xor_", "nand_", "nor_", "xnor_"]
        ops = [names[i] for i in rng.integers(0, 6, rng.integers(1, 4))]
        counter = [0]

        def rec(depth):
            kids = []
            for _ in range(int(rng.integers(2, 5))):
                if depth + 1 < len(ops) and rng.integers(0, 2):
                    kids.append(rec(depth + 1))
                else:
                    counter[0] += 1
                    kids.append(x.Page(f"p{counter[0]}"))
            return getattr(x, ops[depth % len(ops)])(*kids)

        e = rec(0)
        arr.layout = p.auto_layout(e)
        return e

    return build


def _threshold(x, p, arr):
    P = x.Page
    e = x.Threshold(2, (P("t1"), x.and_(P("t2"), P("t3")), P("t4")))
    p.auto_layout(e, arr.layout)
    return e


SCENARIOS = {
    "and48": _flat("and_", 48, "colocated"),
    "or48_demorgan": _flat("or_", 48, "inverted"),
    "nand5": _flat("nand_", 5, "colocated"),
    "or6_spread": _flat("or_", 6, "spread"),
    "and60_two_blocks": _flat("and_", 60, "colocated"),
    "xor4": _flat("xor_", 4, "colocated"),
    "xnor4": _flat("xnor_", 4, "colocated"),
    "fig16": _fig16,
    "eq1": _eq1,
    "distinct_blocks": _distinct_blocks,
    "same_block_spill": _same_block_spill,
    "threshold": _threshold,
    **{f"random{s}": _random_expr(s) for s in range(8)},
}


def _build(pkg, scenario, seed):
    x, p, pl, eng = _PKG[pkg]
    arr = eng.FlashArray(device="cpu") if pkg == "port" else eng.FlashArray()
    expr = SCENARIOS[scenario](x, p, arr)
    rng = np.random.default_rng(seed)
    logical = {}
    for leaf in sorted({lf.name for lf in x.leaves(expr)}):
        words = _words(rng, W)
        logical[leaf] = words
        arr.fc_write(leaf, words if pkg == "port" else jnp.asarray(words))
    return arr, expr, logical


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_command_plans_and_execution_match_reference(scenario):
    ra, rexpr, rlog = _build("ref", scenario, 5)
    ta, texpr, tlog = _build("port", scenario, 5)
    rplan = rpl.Planner(ra.layout).compile(rexpr)
    tplan = tpl.Planner(ta.layout).compile(texpr)
    assert repr(tplan) == repr(rplan)
    want = np.asarray(ra.execute(rplan))
    got = to_uint32(ta.execute(tplan))
    np.testing.assert_array_equal(got, want)
    assert ta.pec == ra.pec and ta.esp_programs == ra.esp_programs
    # the port's oracle agrees, and fc_read plans + executes the same
    oracle = te.eval_expr(texpr, tlog)
    ref_oracle = re_.eval_expr(rexpr, {k: jnp.asarray(v) for k, v in rlog.items()})
    np.testing.assert_array_equal(to_uint32(oracle), np.asarray(ref_oracle))
    np.testing.assert_array_equal(got, to_uint32(oracle))
    np.testing.assert_array_equal(to_uint32(ta.fc_read(texpr)), got)


# -- packed store ----------------------------------------------------------------


def test_packed_store_layout_and_epochs():
    s = PackedStore(planes=4)
    rng = np.random.default_rng(1)
    a, b = _words(rng, 10), _words(rng, 10)
    s["col=1"] = a
    s["col#0"] = b
    s["__scratch0"] = a
    snap = s.snapshot("cpu")
    assert snap.dtype == torch.int32 and snap.shape == (5, 12)
    assert to_uint32(snap[IDENTITY_SLOT]).tolist() == [0xFFFFFFFF] * 12
    assert to_uint32(snap[ZERO_SLOT]).tolist() == [0] * 12
    np.testing.assert_array_equal(to_uint32(s["col=1"]), a)
    assert s.epoch == 2 and s.region_epochs == {"col": 2}  # scratch: no bump
    assert s.snapshot("cpu") is snap and s.snapshot_uploads == 1
    # a rewrite lands in the cached snapshot in place: no second upload
    s["col=1"] = b
    assert s.snapshot("cpu") is snap and s.snapshot_uploads == 1
    np.testing.assert_array_equal(to_uint32(snap[s.slot("col=1"), :10]), b)
    with pytest.raises(ValueError):
        s["x"] = _words(rng, 11)


def test_packed_store_plane_view_matches_reference():
    """tests/test_query.py::test_packed_store_roundtrip_and_planes, both
    packages: 10 words pad to 12 over 4 planes -> 3 words per plane, and
    the plane view holds the same words as the reference's."""
    from repro.core.store import PackedStore as RPackedStore

    rng = np.random.default_rng(0)
    got, want = PackedStore(planes=4), RPackedStore(planes=4)
    for i in range(5):
        w = _words(rng, 10)
        got[f"p{i}"] = want[f"p{i}"] = w
        np.testing.assert_array_equal(to_uint32(got[f"p{i}"]), w)
    assert got.padded_words == 12 and got.words_per_plane == 3
    pv = got.plane_view("cpu")
    assert pv.shape == (4, got.num_slots, 3)
    np.testing.assert_array_equal(to_uint32(pv), np.asarray(want.plane_view()))
    assert to_uint32(got.snapshot("cpu"))[0].min() == 0xFFFFFFFF


def test_bind_moves_the_snapshot_into_a_view():
    """``bind`` makes a caller's tensor the device buffer: an unbound
    store uploads into it (counted), a bound one copies on the device
    (not counted), and later writes land in the view in place until a
    slot outgrows it."""
    rng = np.random.default_rng(2)
    s = PackedStore(planes=2)
    for i in range(3):
        s[f"c={i}"] = _words(rng, 6)
    slab = torch.zeros((2, s.capacity, 6), dtype=torch.int32)
    assert s.bind(slab[0]) == s.num_slots * 6 * 4
    assert s.snapshot_uploads == 1 and s.bound_to(slab[0]) is False  # a new view object
    view = slab[1]
    s.bind(view)  # on the device already: a device-to-device copy
    assert s.snapshot_uploads == 1 and s.bound_to(view)
    w = _words(rng, 6)
    s["c=1"] = w
    np.testing.assert_array_equal(to_uint32(slab[1, s.slot("c=1")]), w)
    assert s.snapshot("cpu").data_ptr() == view.data_ptr()
    rows = view.shape[0]
    while s.num_slots <= rows:  # outgrow the view: a tensor of its own
        s[f"d={s.num_slots}"] = _words(rng, 6)
    assert not s.bound_to(view) and s.snapshot_uploads == 1
    np.testing.assert_array_equal(to_uint32(s.snapshot("cpu")), s._buf[: s.num_slots])
    with pytest.raises(ValueError):
        s.bind(torch.zeros((2, 6), dtype=torch.int32))


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        assert te.FlashArray().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            te.FlashArray()
    assert te.FlashArray(device="cpu").device.type == "cpu"


# -- reliability ------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["SLC", "MLC", "TLC"])
@pytest.mark.parametrize("tesp,levels", [(1.0, 1), (1.6, 1), (1.9, 1), (2.0, 2), (3.7, 3)])
def test_rber_matches_reference(mode, tesp, levels):
    for randomized in (False, True):
        for pec in (1, 1000, 10_000):
            kw = dict(randomized=randomized, tesp_ratio=tesp, levels=levels)
            want = rr.rber(rr.ProgramConfig(rr.CellMode[mode], **kw), pec=pec)
            got = tr.rber(tr.ProgramConfig(tr.CellMode[mode], **kw), pec=pec)
            assert got == want
            t_cfg = tr.ProgramConfig(tr.CellMode[mode], **kw)
            assert t_cfg.is_esp == rr.ProgramConfig(rr.CellMode[mode], **kw).is_esp
    assert tr.esp_log_drop(tesp, levels) == rr.esp_log_drop(tesp, levels)
    assert tr.block_quality_quantile(0.9) == rr.block_quality_quantile(0.9)


def test_noisy_reads_hold_the_flip_rate():
    """Non-ESP reads flip bits at rber() (binomial, 6 sigma); ESP reads are
    exact.  The bits themselves differ from the reference's generator."""
    rng = np.random.default_rng(9)
    words = _words(rng, 4096)
    arr = te.FlashArray(device="cpu")
    arr.fc_write("good", words, esp=True)
    arr.fc_write("bad", words, esp=False)
    arr.pec[arr.layout["bad"].block] = 10_000
    np.testing.assert_array_equal(to_uint32(arr.fc_read(tx.Page("good"))), words)
    noisy = to_uint32(arr.fc_read(tx.Page("bad")))
    flips = int(np.unpackbits((noisy ^ words).view(np.uint8)).sum())
    p = tr.rber(arr.program_configs["bad"], pec=10_000)
    n = words.size * 32
    assert abs(flips - n * p) <= 6 * np.sqrt(n * p * (1 - p)), (flips, n * p)
    twice = tr.randomize_words(tr.randomize_words(to_words(words), 3), 3)
    np.testing.assert_array_equal(to_uint32(twice), words)
