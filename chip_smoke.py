#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/csrc``, holds every
kernel bit-exact against its plain PyTorch version on ragged shapes, then
drives the port's three paths on the card:

1. FlashQL: the paper's BMI workload (COUNT and MASK queries through
   ``BatchScheduler``) over a 2^27-row bitmap index, then the same flush
   with SUM/AVG/MIN/MAX/TOP-K/GROUP BY queries beside it, every answer
   checked against numpy (kernels mws, popcount, threshold); then the
   live index at the same page size: appends, coalesced appends, deletes,
   an update, a delete wave and a compaction, with the flush served and
   checked against numpy after every step and the device snapshot
   written in place (``mutation_path``); and the sharded fleet: the
   same table striped over 4 devices whose snapshots share one fleet
   tensor, served lockstep and pipelined, appended to and deleted from,
   then a range-striped fleet that prunes shards (``shard_path``);
2. the one-pass BMI count (kernel mws_count): users active on every one
   of the last 30 and 365 days at the paper's 800M users, held against
   the plain version and against mws + popcount, run when nothing else is
   resident on the card (the 365-day stack takes 36.5 GB);
3. training: starcoder2-3b at its published widths and depth, bf16, with
   signSGD on 1-bit packed gradients (kernels pack_signs and
   unpack_signs, once per gradient leaf per step), fed by the
   bitmap-index filtered corpus (mws, popcount), every loss finite and
   every leaf's packed words of the first step equal to the plain
   version's; then the same training through ``Trainer(mesh=...)`` on a
   one-rank NCCL ("data", "model") mesh, every parameter a DTensor
   (``dist_train_path``): its first losses bit-equal to the unsharded
   run's, its words checked the same way, the memory its init allocates
   equal to ``launch/dryrun.py``'s count, and the dry-run's per-rank
   bytes of starcoder2-3b and granite-8b ``train_4k`` on the 16x16 and
   2x16x16 meshes against the card's memory; then the roofline
   (``roofline_path``): starcoder2-3b's AdamW step counted op by op on
   meta tensors (``launch/hlo_analysis.py``) and the same step run and
   counted on the card, the two counts equal, its p50 against the
   count's bound and its MFU, and one 16x16 ``launch/roofline.py`` cell
   in its own process; then the sharded counts on this machine's torch
   (``sharded_count_path``): every family's reduced train step on a 2x2
   "fake" mesh splits each matmul line over the 4 ranks, forward and
   backward, and every reduced roofline cell comes out ``ok``, in
   processes of ``launch/split.py`` started together;

then votes packed planes of the largest gradient leaf's layout with the
majority kernel, shows that each path launched its kernels, and prints
each kernel's time, its plain version's time and its bound;

4. LM serving through ``launch/serve.py::serve`` at published widths and
   depths, bf16, random weights from the seed: granite-8b (batch 8 x 512
   prompt tokens, and batch 1 x 8192 under blockwise attention),
   internvl2-26b (256 patch embeddings + 128 tokens),
   deepseek-v2-lite-16b (MoE + MLA), xlstm-350m (batch 8 x 500),
   recurrentgemma-2b (batch 8 x 512, and batch 1 x 8192 under blockwise
   attention) and whisper-medium (1500 encoder frames + 128 tokens),
   every prefill and the first decode steps held against the port's
   full forward, every logit finite, and each family's reduced f32
   config served on the card equal to the CPU; it launches none of the
   kernels above (``serve_path``).
The last line is ``{"ok": true, "device": {...}}``; any failure raises and
exits non-zero.  Without a CUDA device, or outside a checkout, it exits 2
and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROWS = 1 << 27  # the paper's BMI bitmap is 800M users; cut for the time limit
PAPER_ROWS = 800_000_000  # src/repro/flashsim/workloads.py:77
BMI_DAYS = (30, 365)  # the one-pass count at the paper's full size
NUM_PRICES = 16  # distinct price points of the aggregate column
NUM_COUNT = 64
SEED = 0
TIMED_FLUSHES = 20
KERNEL_REPS = 20
FLUSH_REPS = 10  # replays of one flush's B1 calls, in its order

# the bounds are for the H100 SXM (NVIDIA data sheet): its HBM3 rate, and
# its non-tensor 32-bit peak (67 TFLOP/s fp32) for the integer/logic ops,
# which run on the CUDA cores, not the tensor cores
CARD = "H100 80GB HBM3"
_HBM_BYTES_PER_S = 3.35e12
_OPS_PER_S = 67e12

REPLACES = {
    "mws": "src/repro/kernels/mws/mws.py:89",
    "mws_optimizer_off": "src/repro/kernels/mws/mws.py:89",
    "mws_fleet": "src/repro/kernels/mws/mws.py:89",
    "popcount": "src/repro/kernels/popcount/popcount.py:54",
    "popcount_aggregates": "src/repro/kernels/popcount/popcount.py:54",
    "mws_count": "src/repro/kernels/mws_count/mws_count.py:84",
    "threshold": "src/repro/kernels/threshold/threshold.py:66",
    "pack_signs": "src/repro/kernels/signcomp/signcomp.py:60",
    "unpack_signs": "src/repro/kernels/signcomp/signcomp.py:88",
    "majority": "src/repro/kernels/signcomp/signcomp.py:113",
}
SOURCES = {
    "mws": "src/repro_torch/csrc/mws.cu",
    "mws_optimizer_off": "src/repro_torch/csrc/mws.cu",
    "mws_fleet": "src/repro_torch/csrc/mws.cu",
    "popcount": "src/repro_torch/csrc/popcount.cu",
    "popcount_aggregates": "src/repro_torch/csrc/popcount.cu",
    "mws_count": "src/repro_torch/csrc/mws_count.cu",
    "threshold": "src/repro_torch/csrc/threshold.cu",
    "pack_signs": "src/repro_torch/csrc/signcomp.cu",
    "unpack_signs": "src/repro_torch/csrc/signcomp.cu",
    "majority": "src/repro_torch/csrc/signcomp.cu",
}

# the training path: examples/train_lm.py's data and optimizer on the
# full starcoder2-3b configuration
TRAIN_ARCH = "starcoder2-3b"
TRAIN_BATCH = 8
TRAIN_SEQ = 256
TRAIN_SAMPLES = 4096
TRAIN_FILTER = ("lang_en", "quality_high")
TRAIN_LR = 3e-3
WARMUP_STEPS = 2
TIMED_STEPS = 8
VOTERS = (4, 5)  # majority votes at the largest leaf's layout


# the hardware-independent counters reported per run (stats() keys)
_COUNTERS = (
    "flushes",
    "host_transfers",
    "fused_dispatches",
    "mws_commands",
    "vmap_batches",
    "plan_cache_hits",
    "plan_cache_misses",
    "threshold_senses",
    "cse_plan_hits",
)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- workload ---------------------------------------------------------------


def make_table(rows: int, seed: int) -> dict[str, np.ndarray]:
    """The BMI user table: country in 0..7, device in 0..3, and a price
    from NUM_PRICES points drawn once in 1..9,999, all from a seed."""
    rng = np.random.default_rng(seed)
    table = {
        "country": rng.integers(0, 8, rows, dtype=np.uint8),
        "device": rng.integers(0, 4, rows, dtype=np.uint8),
    }
    points = np.sort(rng.choice(np.arange(1, 10_000, dtype=np.uint16), NUM_PRICES, replace=False))
    table["price"] = points[rng.integers(0, NUM_PRICES, rows)]
    return table


def build_queries(q, seed: int) -> list:
    """64 COUNTs with the traffic shape of benchmarks/flashql_throughput.py,
    4 MASKs, one Range deep enough to spill, and two k-of-n thresholds."""
    rng = np.random.default_rng(seed + 1)
    qs = []
    while len(qs) < NUM_COUNT:
        c = int(rng.integers(0, 8))
        d = int(rng.integers(0, 4))
        qs.append(q.Query(q.Eq("country", c) & q.Eq("device", d)))
        qs.append(q.Query(q.Eq("country", c), agg=q.Agg.COUNT))
        qs.append(q.Query(q.In("device", [d, (d + 1) % 4]), agg=q.Agg.COUNT))
    qs = qs[:NUM_COUNT]
    qs += [
        q.Query(q.Eq("country", 5), agg=q.Agg.MASK),
        q.Query(q.In("device", [0, 2]), agg=q.Agg.MASK),
        q.Query(q.Eq("country", 2) & q.Eq("device", 3), agg=q.Agg.MASK),
        q.Query(q.Not(q.Eq("device", 1)), agg=q.Agg.MASK),
        q.Query(q.Range("country", 1, 6)),  # 5 spills, 14 sensings
        q.Query(q.AtLeast(2, [q.Eq("country", 1), q.Eq("device", 2), q.Eq("country", 4)])),
        # the optimizer turns 2-of-3 into a chain; 3-of-5 keeps its native
        # threshold sense under both optimizer settings
        q.Query(
            q.AtLeast(
                3,
                [
                    q.In("country", [1, 2, 3]),
                    q.Eq("device", 2),
                    q.In("country", [2, 3, 5]),
                    q.In("device", [2, 3]),
                    q.Not(q.Eq("country", 2)),
                ],
            )
        ),
    ]
    return qs


def build_aggregates(q, seed: int) -> list:
    """20 aggregates over the price column, with predicates shaped like
    build_queries' COUNTs: 8 SUM, 4 AVG, 2 MIN, 2 MAX, 2 TOP-K by country,
    2 GROUP BY device of SUM; one MIN selects no row."""
    rng = np.random.default_rng(seed + 5)
    aggs = (
        [q.Sum("price")] * 8
        + [q.Avg("price")] * 4
        + [q.Min("price")] * 2
        + [q.Max("price")] * 2
        + [q.TopK("country", 3)] * 2
        + [q.GroupBy("device", q.Sum("price"))] * 2
    )
    qs = []
    for i, a in enumerate(aggs):
        c = int(rng.integers(0, 8))
        d = int(rng.integers(0, 4))
        where = (
            q.Eq("country", c) & q.Eq("device", d),
            q.Eq("country", c),
            q.In("device", [d, (d + 1) % 4]),
        )[i % 3]
        qs.append(q.Query(where, agg=a))
    qs[12] = q.Query(q.Eq("country", 3) & q.Not(q.Eq("country", 3)), agg=q.Min("price"))
    return qs


class Oracle:
    """numpy answers.  Every predicate here depends only on the (country,
    device) pair, so every aggregate follows from the live rows' joint
    (country, device, price) histogram over 8 countries x ``devices``
    devices x the price ``points``; ``add`` keeps it up to date as rows
    are appended (+1) or deleted (-1).  Masks are checked on sampled word
    slices of the resident rows (``resident``), where tombstoned rows and
    the reserved tail past the last row must read zero."""

    def __init__(self, table, words: int, devices: int | None = None, points=None):
        self.words = words
        self.nd = int(table["device"].max()) + 1 if devices is None else devices
        self.points = np.unique(table["price"]) if points is None else np.sort(points)
        self.hist3 = np.zeros((8 * self.nd, len(self.points)), np.int64)
        cells = np.arange(8 * self.nd)
        self.cells = {"country": cells // self.nd, "device": cells % self.nd}
        self.resident(table)
        self.add(table)

    def resident(self, table, live=None) -> None:
        """The rows MASKs cover, in row order; ``live`` False marks a
        tombstoned row (None: every row is live)."""
        self.table, self.live = table, live
        self.rows = len(table["country"])

    def add(self, rows, sign: int = 1) -> None:
        """Count ``rows`` into the live histogram (``sign=-1`` removes)."""
        price_ix = np.searchsorted(self.points, rows["price"])
        cell = (rows["country"].astype(np.int64) * self.nd + rows["device"]) * len(self.points) + price_ix
        self.hist3 += sign * np.bincount(cell, minlength=self.hist3.size).reshape(self.hist3.shape)

    def answer(self, query):
        """The exact answer of a COUNT/SUM/AVG/MIN/MAX/TOP-K/GROUP BY query
        over (country, device) predicates and the price column."""
        from repro_torch.query.ast import Avg, Count, GroupBy, Max, Min, Sum, TopK, normalize_agg
        from repro_torch.query.oracle import np_select

        spec = normalize_agg(query.agg)
        sel = np_select(query.where, self.cells, 8 * self.nd)
        h = np.where(sel[:, None], self.hist3, 0)  # (cells, P)
        points = [int(v) for v in self.points]

        def inner(hp, agg):  # hp: (P,) counts per price point
            n = int(hp.sum())
            total = sum(int(c) * v for c, v in zip(hp, points))
            if isinstance(agg, Count):
                return n
            if isinstance(agg, Sum):
                return total
            if isinstance(agg, Avg):
                return total / n if n else None
            present = [v for c, v in zip(hp, points) if c]
            if isinstance(agg, Min):
                return min(present) if present else None
            if isinstance(agg, Max):
                return max(present) if present else None
            raise TypeError(f"no oracle for {agg!r}")

        if isinstance(spec, (TopK, GroupBy)):
            col = spec.column if isinstance(spec, TopK) else spec.key
            per = h.reshape(8, self.nd, -1).sum(axis=1 if col == "country" else 0)  # (values, P)
            if isinstance(spec, TopK):
                ranked = sorted(
                    ((v, int(c)) for v, c in enumerate(per.sum(axis=1))), key=lambda vc: (-vc[1], vc[0])
                )
                return tuple(vc for vc in ranked if vc[1] > 0)[: spec.k]
            return {v: inner(hp, spec.value) for v, hp in enumerate(per) if hp.sum()}
        return inner(h.sum(axis=0), spec)

    def check_mask(self, pred, words: np.ndarray, start_word: int, n_words: int):
        from repro_torch.query.oracle import np_select

        lo = start_word * 32
        hi = min(self.rows, (start_word + n_words) * 32)
        want = np.zeros(n_words * 32, bool)
        if hi > lo:
            part = {c: v[lo:hi] for c, v in self.table.items()}
            want[: hi - lo] = np_select(pred, part, hi - lo)
            if self.live is not None:
                want[: hi - lo] &= self.live[lo:hi]
        got = np.unpackbits(
            np.ascontiguousarray(words[start_word : start_word + n_words]).view(np.uint8),
            bitorder="little",
        ).astype(bool)
        if not np.array_equal(got, want):
            raise AssertionError(f"MASK words differ from numpy for {pred!r}")


# -- timing -----------------------------------------------------------------


def hold_card(host_s: float) -> None:
    """Queue a sleep on the card longer than ``host_s`` seconds of host
    work, so that work's launches are all enqueued before the card runs
    them and a timing window then holds the device's time only."""
    import torch

    torch.cuda._sleep(int(min(2e9 * (2 * host_s + 1e-3), 4e9)))  # cycles, about 2 GHz


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    with CUDA events around the whole run.  The card first sleeps for
    longer than the host takes to enqueue the runs, so the window holds
    the device's time only: a wrapper's host overhead (tens of
    microseconds) would otherwise count against a kernel that takes ten.
    A ``fn`` that waits for the card inside (the plain versions) still
    counts its host time."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold_card(reps * host_s)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def hbm_rate(name: str) -> float:
    if CARD not in name:
        raise ValueError(f"bounds are known for the {CARD} only, not {name!r}")
    return _HBM_BYTES_PER_S


# -- phase 2: every kernel against its plain version --------------------------


WIDTHS = (1, 127, 2049, 4100, 4_194_304)
GRID_LIMIT_WIDTH = 4100  # the widest W of the B*K = 65,535 staged cases


def staged_cases(w: int, words, device) -> list:
    """Launches that B1's wrapper sends to its staged variant where W is a
    multiple of 4 (to the streaming one otherwise), at width ``w``: many
    plans over few rows; every slot and shared row named, at the stages'
    capacity; spill and shared rows together; and, for W up to
    GRID_LIMIT_WIDTH, B*K at the launch grid's limit.  Each is
    ``(label, src, idx, ext, shr, outer_or values)``."""
    import torch

    from repro_torch.kernels.mws.ops import _MAX_GRID_Y, staged_fits

    g = np.random.default_rng(w)

    def ix(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    cases = [("few rows", words(9, w), ix(g.choice([0, 4, 7], (40, 2, 2))), None, None, (True, False))]
    m_shr = 3
    S = max(s for s in range(1, 512) if staged_fits(s, m_shr, 1 << 20, 4))
    names = S + m_shr
    B = names // 4 + 2
    every = np.concatenate([np.arange(S), -1 - np.arange(m_shr)])
    idx = g.integers(-m_shr, S, B * 4)
    idx[: every.size] = g.permutation(every)
    cases.append(("capacity", words(S, w), ix(idx.reshape(B, 2, 2)), None, words(m_shr, w), (True, False)))
    cases.append(
        (
            "ext+shr",
            words(9, w),
            ix(g.integers(-5, 9, (30, 2, 3))),
            words(30, 2, w),
            words(3, w),
            (True, False),
        )
    )
    if w <= GRID_LIMIT_WIDTH:
        cases.append(("grid limit", words(9, w), ix(g.integers(0, 9, (_MAX_GRID_Y // 5, 5, 1))), None, None, (False,)))
        cases.append(("grid limit", words(9, w), ix(g.integers(0, 9, (_MAX_GRID_Y, 1, 2))), None, None, (True,)))
    return cases



def check_kernels(device, widths=WIDTHS) -> int:
    """Bit-exact kernel vs plain version on ragged shapes; returns cases."""
    import torch

    from repro_torch.core.bitops import BitOp
    from repro_torch.kernels._build import vec_width
    from repro_torch.kernels.mws import mws_gather, mws_gather_ref, mws_reduce, mws_reduce_ref
    from repro_torch.kernels.mws.ops import choose_variant
    from repro_torch.kernels.mws_count import mws_count, mws_count_ref
    from repro_torch.kernels.popcount import popcount, popcount_ref
    from repro_torch.kernels.threshold import threshold_reduce, threshold_ref

    on_card = torch.device(device).type == "cuda"
    g = torch.Generator(device=device)
    g.manual_seed(SEED)

    def words(*shape):
        return torch.randint(
            -(2**31), 2**31, shape, generator=g, dtype=torch.int32, device=device
        )

    def same(a, b, what):
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"kernel != plain version: {what}")

    cases = 0
    for w in widths:
        for n in (1, 3, 64, 65, 130):
            stack = words(n, w)
            if n > 2:
                stack[1] = -1  # an all-ones row
            if n > 3:
                stack[2] = 0  # an all-zeros row
            for op in BitOp:
                same(mws_reduce(stack, op), mws_reduce_ref(stack, op), f"mws {op} {n}x{w}")
                same(mws_count(stack, op), mws_count_ref(stack, op), f"mws_count {op} {n}x{w}")
                cases += 2
            same(popcount(stack), popcount_ref(stack), f"popcount {n}x{w}")
            cases += 1
            del stack
        ones = torch.full((3, w), -1, dtype=torch.int32, device=device)
        same(popcount(ones), popcount_ref(ones), f"popcount ones {w}")
        for n in range(1, 9):
            x = words(2, n, w)
            for k in range(1, n + 1):
                for inv in (False, True):
                    same(
                        threshold_reduce(x, k, invert=inv),
                        threshold_ref(x, k, invert=inv),
                        f"threshold k={k} n={n} w={w}",
                    )
                    cases += 1
        # the gathering form: slot indices, spilled and shared rows
        src = words(9, w)
        ext = words(3, 2, w)
        shr = words(2, w)
        idx = torch.tensor(
            [
                [[0, 3, -1], [5, -3, 8]],
                [[-2, 4, 4], [1, 2, -4]],
                [[7, -1, 6], [0, 0, 0]],
            ],
            dtype=torch.int32,
            device=device,
        )
        for op in (BitOp.AND, BitOp.OR, BitOp.XOR):
            for outer_or in (True, False):
                for inv in (False, True):
                    kw = dict(outer_or=outer_or, invert=inv, ext=ext, shr=shr)
                    same(
                        mws_gather(src, idx, op, **kw),
                        mws_gather_ref(src, idx, op, **kw),
                        f"gather {op} outer={outer_or} inv={inv} w={w}",
                    )
                    cases += 1
        # B1's staged variant (the streaming one at a ragged W)
        for label, src, idx, ext, shr, outer in staged_cases(w, words, device):
            B, K, N = idx.shape
            m_ext = 0 if ext is None else ext.shape[1]
            m_shr = 0 if shr is None else shr.shape[0]
            vec = vec_width(w, src, ext, shr)
            want = "staged" if w % 4 == 0 else "streaming"
            if any(choose_variant(src.shape[0], B, K, N, m_ext, m_shr, o, vec) != want for o in outer):
                raise AssertionError(f"staged case {label} w={w} would not run {want}")
            for op in (BitOp.AND, BitOp.OR, BitOp.XOR):
                for outer_or in outer:
                    kw = dict(outer_or=outer_or, invert=op is BitOp.OR, ext=ext, shr=shr)
                    before = mws_gather.variant_launches[want]
                    same(
                        mws_gather(src, idx, op, **kw),
                        mws_gather_ref(src, idx, op, **kw),
                        f"staged {label} {op} outer={outer_or} w={w}",
                    )
                    if on_card and mws_gather.variant_launches[want] != before + 1:
                        raise AssertionError(f"staged case {label} w={w} did not launch {want}")
                    cases += 1
            del src, idx, ext, shr
    for n, w in ((1, 1), (3, 200), (48, 2048), (70, 2049)):  # the reference's test shapes
        stack = words(n, w)
        for op in BitOp:
            same(mws_count(stack, op), mws_count_ref(stack, op), f"mws_count {op} {n}x{w}")
            cases += 1
    if on_card:
        torch.cuda.synchronize()  # a fault during the runs surfaces here
    return cases


SIGN_LENGTHS = (1, 31, 16383, 16385, 3 * 16384 + 7, 1_000_003)
BIG_SIGN_N = 65_537 * 16384 + 1001  # 65,538 packed rows: past grid-y's 65,535
VOTE_K = (*range(1, 10), 16, 17, 255, 256, 1000)  # each counter width, both sides of its edge
VOTE_SHAPES = ((3, 512), (70, 512), (5, 7), (9, 131))


def sign_rule(x):
    """±1 by the reference's sign test: ``x >= 0`` with subnormals flushed
    to zero (XLA does so on the CPU and the TPU), so -0.0 and negative
    subnormals give +1 and NaN gives -1."""
    import torch

    return torch.where(x > -torch.finfo(torch.float32).tiny, 1.0, -1.0)


def check_signcomp(device, lengths=SIGN_LENGTHS + (BIG_SIGN_N,)) -> int:
    """Bit-exact pack/unpack/majority kernels vs plain versions: ragged n,
    ±0.0, ±subnormal, NaN and ±inf planted, K in VOTE_K; returns cases."""
    import torch

    from repro_torch.kernels.signcomp import (
        LANES,
        compress_signs,
        compress_signs_ref,
        decompress_signs,
        decompress_signs_ref,
        majority_ref,
        majority_vote,
    )

    g = torch.Generator(device=device)
    g.manual_seed(SEED + 2)
    special = torch.tensor(
        [0.0, -0.0, float("nan"), float("inf"), -float("inf"), -1e-45, 1e-45, -1.17549435e-38],
        device=device,
    )

    def same(a, b, what):
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"kernel != plain version: {what}")

    cases = 0
    for n in lengths:
        x = torch.randn(n, generator=g, device=device)
        k = min(n, special.numel())
        x[:k] = special[:k]
        if n >= 2 * special.numel():
            x[n // 2 : n // 2 + k] = special
        words = compress_signs(x)
        same(words, compress_signs_ref(x, LANES), f"pack n={n}")
        back = decompress_signs(words, n)
        same(back, decompress_signs_ref(words, n), f"unpack n={n}")
        same(back, sign_rule(x), f"round trip n={n}")
        cases += 3
        del x, words, back
    for k in VOTE_K:
        for r, w in VOTE_SHAPES:
            stacks = torch.randint(
                -(2**31), 2**31, (k, r, w), generator=g, dtype=torch.int32, device=device
            )
            same(majority_vote(stacks), majority_ref(stacks), f"majority K={k} {r}x{w}")
            cases += 1
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return cases


# -- phase 3: the main path ----------------------------------------------------


class Recorder:
    """Keeps the calls of each kernel wrapper on the main path during the
    first flush of each mix (``tag``: optimizer setting and mix), so the
    kernels can be checked and timed at the shapes that flush gave them:
    every call of a wrapper wrapped without ``size``, else the largest."""

    def __init__(self):
        self.calls: dict[str, list] = {}
        self.tag = ""
        self.active = False

    def wrap(self, name, fn, size=None):
        def rec(*args, **kwargs):
            if self.active:
                kept = self.calls.setdefault(name + self.tag, [])
                if size is None:
                    kept.append((args, kwargs))
                elif not kept or size(*args, **kwargs) > size(*kept[0][0], **kept[0][1]):
                    kept[:] = [(args, kwargs)]
            return fn(*args, **kwargs)

        return rec

    def largest(self, key, size):
        """The largest recorded call under ``key``, as ``(args, kwargs)``."""
        return max(self.calls[key], key=lambda c: size(*c[0], **c[1]))


def check_results(queries, results, oracle, mask_sample: int = 0) -> None:
    """Every COUNT and aggregate against numpy; with ``mask_sample``, every
    MASK's shape and three sampled word slices (start, middle, end)."""
    for q, r in zip(queries, results):
        if r.mask is None:
            want = oracle.answer(q)
            if r.value != want:
                raise AssertionError(f"{q.agg!r} of {q.where!r}: {r.value!r} != numpy {want!r}")
        elif mask_sample:
            words = np.asarray(r.value.words)
            if words.shape != (oracle.words,):
                raise AssertionError(f"MASK has shape {words.shape}")
            n = min(mask_sample, oracle.words)
            for start in (0, (oracle.words - n) // 2, oracle.words - n):
                oracle.check_mask(q.where, words, start, n)


def serve_mix(q, dev, store, queries, oracle, optimize: bool, device, rec=None) -> dict:
    """Serve ``queries`` in one flush through a fresh ``BatchScheduler``:
    a first flush (kernel launches counted from 0 just before it, its
    kernel calls kept by ``rec``), then TIMED_FLUSHES warm ones; every
    answer checked against numpy."""
    import torch

    from repro_torch.kernels.mws import mws_gather
    from repro_torch.kernels.popcount import popcount
    from repro_torch.kernels.threshold import threshold_reduce

    kernels = {"mws": mws_gather, "threshold": threshold_reduce, "popcount": popcount}
    sched = q.BatchScheduler(dev, store, optimize=optimize, max_batch=256)
    for fn in kernels.values():
        fn.launches = 0
    mws_gather.variant_launches = dict.fromkeys(mws_gather.variant_launches, 0)
    if rec is not None:
        rec.active = True
    t1 = time.perf_counter()
    results = sched.serve(queries)
    first_s = time.perf_counter() - t1
    if rec is not None:
        rec.active = False
    launches = {k: fn.launches for k, fn in kernels.items()}
    variants = dict(mws_gather.variant_launches)
    check_results(queries, results, oracle, mask_sample=4096)
    st = sched.stats()
    first_stats = {k: st[k] for k in _COUNTERS}
    for k, v in launches.items():
        if v < 1 and torch.device(device).type == "cuda":
            raise AssertionError(f"kernel {k} never launched on the main path")
    # warm flushes: the same batch again (a flush ends in its host
    # transfer, so the host clock covers the device work)
    lat = []
    for _ in range(TIMED_FLUSHES):
        t2 = time.perf_counter()
        results = sched.serve(queries)
        lat.append(time.perf_counter() - t2)
        check_results(queries, results, oracle)
    st = sched.stats()
    if not st["host_transfers"] == st["fused_dispatches"] == st["flushes"]:
        raise AssertionError(f"not one host transfer per fused flush: {st}")
    out = {
        "queries": len(queries),
        "first_flush_s": first_s,
        "warm_flush_p50_s": statistics.median(lat),
        "qps": len(queries) * TIMED_FLUSHES / sum(lat),
        "launches_first_flush": launches,
        "mws_variants_first_flush": variants,
        "host_transfers_per_flush": st["host_transfers"] / st["flushes"],
        "stats": first_stats,  # counters of the first flush
    }
    if torch.device(device).type == "cuda":
        out["profile"] = profile_flush(sched, queries)
    return out


def main_path(device, rows: int, log=log) -> dict:
    """FlashQL on the card: the COUNT/MASK flush of build_queries, then the
    same flush with build_aggregates beside it, each with the optimizer on
    and off."""
    from repro_torch import query as q
    from repro_torch.kernels.mws import mws_gather
    from repro_torch.kernels.popcount import popcount
    from repro_torch.kernels.threshold import threshold_reduce
    from repro_torch.query import aggregate as agg_mod
    from repro_torch.query import device as dev_mod

    t0 = time.perf_counter()
    table = make_table(rows, SEED)
    store = q.BitmapStore()
    store.ingest(table)
    queries = build_queries(q, SEED)
    mixed = queries + build_aggregates(q, SEED)
    dev = q.FlashDevice(num_planes=4, device=device)
    store.program(dev, warmup=queries[:3])
    dev.store.snapshot(dev.device)
    oracle = Oracle(table, store.words)
    log(
        f"ingest+program: {rows} rows, {store.words} words/page, "
        f"{dev.store.num_slots} slots, price: {len(oracle.points)} points, "
        f"{store.columns['price'].bits} BSI slices, {time.perf_counter() - t0:.3f} s"
    )

    # keep the kernel calls of each mix's first flush
    rec = Recorder()
    orig = (dev_mod.mws_gather, dev_mod.threshold_reduce, agg_mod.popcount)
    dev_mod.mws_gather = rec.wrap("mws", mws_gather)
    dev_mod.threshold_reduce = rec.wrap(
        "threshold", threshold_reduce, lambda x, *a, **k: x.numel()
    )
    agg_mod.popcount = rec.wrap("popcount", popcount, lambda x: x.numel())

    out = {"rows": rows, "words": store.words}
    try:
        for name, optimize in (("optimize", True), ("plain", False)):
            for mix, qs, tag in (("count_mask", queries, ""), ("aggregates", mixed, "_aggregates")):
                rec.tag = f"_{name}{tag}"
                r = serve_mix(q, dev, store, qs, oracle, optimize, device, rec)
                out[f"{name}{tag}"] = r
                log(
                    f"main path [{name}, {mix}]: {r['queries']} queries/flush, first flush "
                    f"{r['first_flush_s']:.4f} s, warm flush p50 {r['warm_flush_p50_s'] * 1e3:.3f} ms "
                    f"({r['qps']:.1f} q/s over {TIMED_FLUSHES} flushes), launches per flush "
                    f"{r['launches_first_flush']} (mws by variant "
                    f"{r['mws_variants_first_flush']}), host transfers per flush "
                    f"{r['host_transfers_per_flush']}"
                )
                if "profile" in r:
                    log(f"  one warm flush under torch.profiler [{name}, {mix}]: {r['profile']}")
    finally:
        dev_mod.mws_gather, dev_mod.threshold_reduce, agg_mod.popcount = orig
    out["recorded"] = rec
    return out


# -- phase 3b: the live index ---------------------------------------------------

NEW_DEVICE = 4  # first-seen in append 4: a new equality page, device's BSI 2 -> 3
NEW_PRICE = 20_000  # first-seen in append 4: price's BSI 14 -> 15
DELETE_FRAC = 0.40  # benchmarks/flashql_compaction.py:44


def make_batch(rng, b: int, points, devices: int = 4) -> dict[str, np.ndarray]:
    """``b`` appended rows drawn as make_table draws its rows: countries
    0..7, devices below ``devices``, prices from ``points``."""
    return {
        "country": rng.integers(0, 8, b, dtype=np.uint8),
        "device": rng.integers(0, devices, b, dtype=np.uint8),
        "price": points[rng.integers(0, len(points), b)],
    }


def mutation_path(device, rows: int, card: str | None = None, log=log) -> dict:
    """FlashQL's live index: pages of ``rows`` rows (the main path's), a
    table of 7/8 of them ingested with the last 1/8 reserved, then, under
    one optimizing BatchScheduler: eight appends of rows/128 (the fourth
    brings device NEW_DEVICE and price NEW_PRICE: four new pages), four
    coalesced appends of rows/512, a delete of rows/128 live rows, an
    update of rows/2048, a delete wave up to DELETE_FRAC, compact(), and
    one more append of rows/128.  After every step the COUNT/MASK flush
    of build_queries is served (with build_aggregates after append 4,
    compact() and the last append) and checked against numpy on the live
    rows; every B1 call of the first flush after append 4 and after
    compact() is held against its plain version.  One JSON line per step
    gives the mutation's seconds, the bytes it programmed and wrote into
    the device snapshot, the snapshot's whole uploads and the flush; then
    the reference's design (a whole upload per write) is timed against
    the delta writes of one append.  Kernel launch counts are set to 0
    just before the phase; those of the checks are left out."""
    import torch

    from repro_torch import query as q
    from repro_torch.core.bitops import to_words
    from repro_torch.core.store import PackedStore
    from repro_torch.kernels.mws import mws_gather
    from repro_torch.kernels.popcount import popcount
    from repro_torch.kernels.threshold import threshold_reduce
    from repro_torch.query import aggregate as agg_mod
    from repro_torch.query import device as dev_mod

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    reserve = rows // 8
    n0 = rows - reserve
    unit = rows // 128
    rng = np.random.default_rng(SEED + 7)
    t0 = time.perf_counter()
    table = make_table(n0, SEED + 7)
    points = np.unique(table["price"])
    store = q.BitmapStore()
    store.ingest(table, reserve_rows=reserve)
    queries = build_queries(q, SEED)
    mixed = queries + build_aggregates(q, SEED)
    dev = q.FlashDevice(num_planes=4, device=device)
    store.program(dev, warmup=queries[:3])
    dev.store.snapshot(dev.device)
    sched = q.BatchScheduler(dev, store, optimize=True, max_batch=256)
    # the resident rows at capacity, and which are live, for numpy
    res = {c: np.zeros(rows, v.dtype) for c, v in table.items()}
    for c, v in table.items():
        res[c][:n0] = v
    live = np.zeros(rows, bool)
    live[:n0] = True
    oracle = Oracle(table, store.words, devices=NEW_DEVICE + 1, points=np.append(points, NEW_PRICE))
    del table
    n = n0
    log(
        f"mutation path: {n0} rows + {reserve} reserved, {store.words} words/page, "
        f"{dev.store.num_slots} slots, {time.perf_counter() - t0:.3f} s"
    )

    # in-place snapshot writes (words and host seconds), and the aggregate
    # extras each flush uploads
    wt = {"words": 0, "s": 0.0}
    fetched = {"bytes": 0}
    orig = (PackedStore._write_through, agg_mod.fetch_pages, dev_mod.mws_gather)

    def write_through(self, slot, start, stop):
        t = time.perf_counter()
        orig[0](self, slot, start, stop)
        if self._dev_buf is not None:
            sync()
            wt["words"] += stop - start
            wt["s"] += time.perf_counter() - t

    def fetch_pages(store_, names, device_):
        out = orig[1](store_, names, device_)
        fetched["bytes"] += out.numel() * 4
        return out

    rec = Recorder()
    PackedStore._write_through = write_through
    agg_mod.fetch_pages = fetch_pages
    dev_mod.mws_gather = rec.wrap("mws", mws_gather)
    kernels = {"mws": mws_gather, "threshold": threshold_reduce, "popcount": popcount}
    launches = dict.fromkeys(kernels, 0)

    def take_launches(keep: bool):
        for k, fn in kernels.items():
            if keep:
                launches[k] += fn.launches
            fn.launches = 0

    def serve(label, qs, check_b1):
        st0 = sched.stats()
        up0 = fetched["bytes"]
        rec.tag, rec.active = f"_{label}", check_b1
        t = time.perf_counter()
        results = sched.serve(qs)
        first = time.perf_counter() - t
        rec.active = False
        take_launches(True)
        oracle.resident({c: v[:n] for c, v in res.items()}, live[:n])
        check_results(qs, results, oracle, mask_sample=4096)
        st = sched.stats()
        out = {
            "queries": len(qs),
            "first_flush_s": first,
            **{k: st[k] - st0[k] for k in ("plan_cache_hits", "plan_cache_misses", "mws_commands")},
            "extras_upload_bytes": fetched["bytes"] - up0,
        }
        if check_b1:
            calls = rec.calls.pop(f"mws_{label}")
            for i, (args, kwargs) in enumerate(calls):
                c = mws_call(args, kwargs)
                if not torch.equal(c["kern"](), c["plain"]()):
                    raise AssertionError(f"{label}: mws call {i} ({c['shape']}): kernel != plain version")
            sync()
            take_launches(False)
            out["b1_calls_checked"] = len(calls)
        return out

    steps = []
    clock = {"s": 0.0}

    def timed(call, *args):
        """Run one mutation call, its seconds added to the step's."""
        t = time.perf_counter()
        out = call(*args)
        sync()
        clock["s"] += time.perf_counter() - t
        return out

    def step(name, fn, qs=queries, check_b1=False):
        st0 = sched.stats()
        wp0, wt0 = int(sched.words_programmed), dict(wt)
        clock["s"] = 0.0
        extra = fn() or {}
        wt1 = dict(wt)
        flush = serve(name, qs, check_b1)
        st = sched.stats()
        line = {
            "step": name,
            "seconds": clock["s"],
            "bytes_programmed": (int(sched.words_programmed) - wp0) * 4,
            # written into the snapshot by the mutation calls, and by the
            # flush (coalesced appends, rebuilt materialized pages)
            "snapshot_bytes_written": (wt1["words"] - wt0["words"]) * 4,
            "snapshot_write_s": wt1["s"] - wt0["s"],
            "flush_snapshot_bytes_written": (wt["words"] - wt1["words"]) * 4,
            "snapshot_uploads": dev.store.snapshot_uploads,
            "esp_delta_programs": st["esp_delta_programs"] - st0["esp_delta_programs"],
            "rows": store.num_rows,
            "live_rows": store.live_rows,
            "slots": dev.store.num_slots,
            **flush,
            **extra,
        }
        steps.append(line)
        log(json.dumps({"mutation_step": line, **({"card": card} if card else {})}))
        return line

    def append(b, devices=NEW_DEVICE + 1, first_seen=False):
        nonlocal n
        batch = make_batch(rng, b, np.append(points, NEW_PRICE) if devices > 4 else points, devices)
        if first_seen:
            batch["device"][::8] = NEW_DEVICE
            batch["price"][::16] = NEW_PRICE
        timed(sched.append, batch)
        for c, v in batch.items():
            res[c][n : n + b] = v
        live[n : n + b] = True
        n += b
        oracle.add(batch)

    def delete(ids):
        timed(sched.delete, ids)
        live[ids] = False
        oracle.add({c: v[ids] for c, v in res.items()}, -1)

    try:
        take_launches(False)
        uploads0 = dev.store.snapshot_uploads
        for i in range(8):
            first_seen = i == 3
            step(
                f"append_{i + 1}",
                lambda: append(unit, 4 if i < 3 else NEW_DEVICE + 1, first_seen),
                mixed if first_seen else queries,
                check_b1=first_seen,
            )
        if store.columns["device"].bits != 3 or store.columns["price"].bits != 15:
            raise AssertionError(f"BSI widths after append 4: {store.columns}")

        def coalesced():
            sched.coalesce_appends = True
            for _ in range(4):
                append(unit // 4)
            if sched.appends_queued != 4:
                raise AssertionError("a coalesced append was programmed before the flush")

        step("coalesced_appends_4", coalesced)
        sched.coalesce_appends = False
        if sched.appends_queued:
            raise AssertionError("queued appends left after the flush")
        doomed = rng.choice(np.flatnonzero(live[:n]), unit, replace=False)
        step("delete", lambda: delete(doomed))
        updated = rng.choice(np.flatnonzero(live[:n]), unit // 16, replace=False)

        def update():
            nonlocal n
            ids, b = updated, len(updated)
            batch = make_batch(rng, b, np.append(points, NEW_PRICE), NEW_DEVICE + 1)
            timed(sched.update, ids, batch)
            live[ids] = False
            oracle.add({c: v[ids] for c, v in res.items()}, -1)
            for c, v in batch.items():
                res[c][n : n + b] = v
            live[n : n + b] = True
            n += b
            oracle.add(batch)

        step("update", update)
        wave = int(np.ceil(DELETE_FRAC * store.num_rows)) - store.deleted_rows
        doomed = rng.choice(np.flatnonzero(live[:n]), wave, replace=False)
        step("delete_wave", lambda: delete(doomed))
        del doomed
        if store.tombstone_density < DELETE_FRAC:
            raise AssertionError(f"tombstone density {store.tombstone_density}")
        if dev.store.snapshot_uploads != uploads0:
            raise AssertionError("an append, delete or update uploaded the whole snapshot")

        def compact():
            nonlocal n
            st = timed(sched.compact)
            t = time.perf_counter()
            dev.store.snapshot(dev.device)
            sync()
            upload_s = time.perf_counter() - t
            keep = live[:n]
            k = int(keep.sum())
            for c in res:
                res[c][:k] = res[c][:n][keep]
            live[:] = False
            live[:k] = True
            n = k
            keys = ("rows_dropped", "blocks_erased", "words_reprogrammed", "to_table_s", "rebuild_s", "program_s")
            return {**{k_: st[k_] for k_ in keys}, "upload_s": upload_s}

        line = step("compact", compact, mixed, check_b1=True)
        if dev.store.snapshot_uploads != uploads0 + 1 or store.deleted_rows:
            raise AssertionError(f"compact(): {dev.store.snapshot_uploads} uploads, {store.deleted_rows} tombstones")
        last = step("append_after_compact", lambda: append(unit), mixed)
        if dev.store.snapshot_uploads != uploads0 + 1:
            raise AssertionError("an append after compact() uploaded the whole snapshot")
    finally:
        PackedStore._write_through, agg_mod.fetch_pages, dev_mod.mws_gather = orig
    if on_card:
        for k, v in launches.items():
            if v < 1:
                raise AssertionError(f"kernel {k} never launched on the mutation path")

    # the reference's design: every write re-uploads the whole store
    ps = dev.store
    t = time.perf_counter()
    whole = to_words(ps._buf[: ps.num_slots], device)
    sync()
    first = steps[0]
    upload = {
        "whole_upload_s": time.perf_counter() - t,
        "whole_upload_bytes": whole.numel() * 4,
        "append_rows": unit,
        # the snapshot writes of the first append and of the last one
        "delta_write_s": [first["snapshot_write_s"], last["snapshot_write_s"]],
        "delta_write_bytes": [first["snapshot_bytes_written"], last["snapshot_bytes_written"]],
        "compact_upload_s": line["upload_s"],
    }
    del whole
    log(json.dumps({"mutation_upload_vs_delta": upload, **({"card": card} if card else {})}))
    out = {"rows": rows, "steps": steps, "upload_vs_delta": upload, "launches": launches}
    del sched, dev, store, rec, res, live, oracle
    return out


# -- phase 3c: the sharded fleet -------------------------------------------------

SHARDS = 4
SHARD_TIMED_FLUSHES = 2  # each flush un-stripes its MASKs over every row on the host (3-4 s)
ROUTED_ROWS = 1 << 25  # fleet B, cut for the time limit


def shard_path(device, rows: int, routed_rows: int, card: str | None = None, log=log) -> dict:
    """FlashQL over a fleet of SHARDS devices on one card, every shard's
    snapshot a slab of one fleet tensor.  Fleet A stripes the main path's
    table round-robin and serves build_queries, then build_queries with
    build_aggregates beside it, lockstep (each signature group one launch
    sequence over the fleet tensor) and then pipelined (one fused program
    per shard), every answer checked against numpy; the kernel launch
    counts are set to 0 just before each mode's first flush and read just
    after, and every B1, B2 and B3 call of that flush is held against its
    plain version; one warm COUNT/MASK flush per mode runs under
    torch.profiler.  Host transfers per flush: one per reduce signature
    lockstep, one per shard program pipelined.  Then an append of
    rows/128 rows (each stripe's reserve) and a delete of as many random
    rows, each followed by the checked COUNT/MASK flush, with every
    shard's snapshot_uploads flat.  Fleet B (``routed_rows``, range
    striping on ``country``, pipelined) drives stripe pruning and routed
    depths."""
    import torch

    from repro_torch import query as q
    from repro_torch.core.bitops import num_words
    from repro_torch.core.store import PackedStore
    from repro_torch.kernels.mws import mws_gather
    from repro_torch.kernels.popcount import popcount, popcount_ref
    from repro_torch.kernels.threshold import threshold_reduce, threshold_ref
    from repro_torch.query import aggregate as agg_mod
    from repro_torch.query import device as dev_mod
    from repro_torch.query import shard as shard_mod

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    reserve = rows // 128  # 2^20 at the main path's rows
    t0 = time.perf_counter()
    table = make_table(rows, SEED)
    queries = build_queries(q, SEED)
    mixed = queries + build_aggregates(q, SEED)
    sq = q.build_sharded_flashql(
        table, SHARDS, policy="roundrobin", reserve_rows=reserve, warmup=queries[:3], device=device
    )
    oracle = Oracle(table, num_words(rows))
    st0 = sq.store.shards[0]
    ingest_s = time.perf_counter() - t0
    log(
        f"shard path: fleet A, {rows} rows over {SHARDS} shards ({st0.num_rows} rows + "
        f"{reserve} reserved each), {st0.words} words/page, "
        f"{sq.devices[0].store.num_slots} slots, ingest+program {ingest_s:.3f} s"
    )

    kernels = {"mws": mws_gather, "threshold": threshold_reduce, "popcount": popcount}
    rec = Recorder()
    unstripe: list[float] = []
    wt = {"words": 0}
    orig = (
        dev_mod.mws_gather,
        dev_mod.threshold_reduce,
        agg_mod.popcount,
        shard_mod.merge_mask_batch,
        PackedStore._write_through,
    )

    def merge_mask_batch(parts_list, sstore):
        t = time.perf_counter()
        out = orig[3](parts_list, sstore)
        unstripe.append(time.perf_counter() - t)
        return out

    def write_through(self, slot, start, stop):
        orig[4](self, slot, start, stop)
        if self._dev_buf is not None:
            wt["words"] += stop - start

    def reduce_groups(qs) -> int:
        """Reduce signatures of one lockstep flush: its host transfers."""
        _, groups = agg_mod.group_members([x.agg for x in qs], [sq.store.shards[0]] * len(qs))
        return len(groups)

    def serve_checked(qs, label=None, mask_sample=4096):
        st = sq.stats()
        if label is not None:
            for fn in kernels.values():
                fn.launches = 0
            mws_gather.variant_launches = dict.fromkeys(mws_gather.variant_launches, 0)
            rec.tag, rec.active = f"_{label}", True
        t = time.perf_counter()
        results = sq.serve(qs)
        seconds = time.perf_counter() - t
        rec.active = False
        out = {"seconds": seconds, "host_transfers": sq.stats()["host_transfers"] - st["host_transfers"]}
        if label is not None:
            out["launches"] = {k: fn.launches for k, fn in kernels.items()}
            out["mws_variants"] = dict(mws_gather.variant_launches)
        check_results(qs, results, oracle, mask_sample=mask_sample)
        return out

    def check_calls(label) -> dict:
        """Every recorded B2 and B3 call of a flush against its plain version."""
        n = {}
        for name, kern, plain in (("popcount", popcount, popcount_ref), ("threshold", threshold_reduce, threshold_ref)):
            calls = rec.calls.pop(f"{name}_{label}", [])
            for args, kwargs in calls:
                got, want = kern(*args, **kwargs), plain(*args, **kwargs)
                if got.shape != want.shape or not torch.equal(got, want):
                    raise AssertionError(f"{label}: a {name} call differs from its plain version")
            n[name] = len(calls)
        return n

    modes: dict[str, dict] = {}
    dev_mod.mws_gather = rec.wrap("mws", mws_gather)
    dev_mod.threshold_reduce = rec.wrap("threshold", threshold_reduce)
    agg_mod.popcount = rec.wrap("popcount", popcount)
    shard_mod.merge_mask_batch = merge_mask_batch
    PackedStore._write_through = write_through
    try:
        for mode in ("lockstep", "pipelined"):
            sq.pipeline = mode == "pipelined"
            for mix, qs in (("count_mask", queries), ("aggregates", mixed)):
                label = f"shard_{mode}" if mix == "count_mask" else None
                first = serve_checked(qs, label)
                want = reduce_groups(qs) if mode == "lockstep" else len(sq.store.active)
                if first["host_transfers"] != want:
                    raise AssertionError(f"{mode} {mix}: {first['host_transfers']} host transfers, not {want}")
                if label is not None and on_card:
                    for k, v in first["launches"].items():
                        if v < 1:
                            raise AssertionError(f"kernel {k} never launched on the {mode} fleet")
                del unstripe[:]
                lat = []
                for _ in range(SHARD_TIMED_FLUSHES):
                    lat.append(serve_checked(qs, mask_sample=0)["seconds"])
                r = {
                    "queries": len(qs),
                    "first_flush_s": first["seconds"],
                    "warm_flush_p50_s": statistics.median(lat),
                    "qps": len(qs) * len(lat) / sum(lat),
                    "host_transfers_per_flush": first["host_transfers"],
                    "mask_unstripe_s": statistics.median(unstripe) if unstripe else None,
                }
                if label is not None:
                    r["launches_first_flush"] = first["launches"]
                    r["mws_variants_first_flush"] = first["mws_variants"]
                    r["calls_checked"] = check_calls(label)
                if on_card and label is not None:
                    r["profile"] = profile_fleet_flush(sq, qs)
                modes[f"{mode}_{mix}"] = r
                log(
                    f"shard path [{mode}, {mix}]: {r['queries']} queries/flush, first flush "
                    f"{r['first_flush_s']:.4f} s, warm flush p50 {r['warm_flush_p50_s'] * 1e3:.3f} ms "
                    f"({r['qps']:.1f} q/s over {len(lat)} flushes), host transfers per flush "
                    f"{r['host_transfers_per_flush']}, MASK un-striping {r['mask_unstripe_s']} s per flush"
                    + (
                        f", launches per flush {r['launches_first_flush']} (mws by variant "
                        f"{r['mws_variants_first_flush']})"
                        if label is not None
                        else ""
                    )
                )
                if "profile" in r:
                    log(f"  one warm flush under torch.profiler [{mode}, {mix}]: {r['profile']}")

        # the live fleet: an append and a delete, the fleet tensor taking
        # the words in place
        uploads = [d.store.snapshot_uploads for d in sq.devices]
        rebuilds = sq.fleet_rebuilds
        sq.pipeline = False
        rng = np.random.default_rng(SEED + 13)
        mutations = {}
        resident, live = table, None
        for name in ("append", "delete"):
            wt0 = wt["words"]
            t = time.perf_counter()
            if name == "append":
                batch = make_batch(rng, reserve, oracle.points)
                sq.append(batch)
                sync()
                resident = {c: np.concatenate([v, batch[c]]) for c, v in resident.items()}
                oracle.add(batch)
            else:
                ids = rng.choice(sq.store.num_rows, reserve, replace=False)
                sq.delete(ids)
                sync()
                live = np.ones(sq.store.num_rows, bool)
                live[ids] = False
                oracle.add({c: v[ids] for c, v in resident.items()}, -1)
            seconds = time.perf_counter() - t
            wt1 = wt["words"]
            oracle.resident(resident, live)
            oracle.words = num_words(sq.store.num_rows)
            flush = serve_checked(queries)
            mutations[name] = {
                "seconds": seconds,
                "snapshot_bytes_written": (wt1 - wt0) * 4,
                # rebuilt materialized pages
                "flush_snapshot_bytes_written": (wt["words"] - wt1) * 4,
                "flush_s": flush["seconds"],
                "snapshot_uploads": [d.store.snapshot_uploads for d in sq.devices],
                "fleet_rebuilds": sq.fleet_rebuilds,
            }
            log(json.dumps({"shard_mutation": {"step": name, **mutations[name]}, **({"card": card} if card else {})}))
        if [d.store.snapshot_uploads for d in sq.devices] != uploads:
            raise AssertionError("an append or delete uploaded a shard's whole snapshot")
    finally:
        (
            dev_mod.mws_gather,
            dev_mod.threshold_reduce,
            agg_mod.popcount,
            shard_mod.merge_mask_batch,
            PackedStore._write_through,
        ) = orig
    fleet = sq._fleet
    out = {
        "rows": rows,
        "shards": SHARDS,
        "words": st0.words,
        "ingest_s": ingest_s,
        "modes": modes,
        "mutations": mutations,
        "fleet": {
            "shape": list(fleet.data.shape),
            "bytes": fleet.data.numel() * 4,
            "rebuilds": sq.fleet_rebuilds,
            "rebuilds_by_writes": sq.fleet_rebuilds - rebuilds,
            "bytes_copied": sq.fleet_bytes_copied,
        },
        "recorded": rec,
    }
    del sq, table, resident, live, oracle, fleet
    gc.collect()

    # fleet B: range striping on country, pipelined: stripe pruning and
    # routed depths
    t0 = time.perf_counter()
    table = make_table(routed_rows, SEED + 11)
    sq = q.build_sharded_flashql(
        table, SHARDS, policy="range", stripe_key="country", pipeline=True, warmup=queries[:3], device=device
    )
    oracle = Oracle(table, num_words(routed_rows))
    ingest_s = time.perf_counter() - t0
    first = serve_checked(queries)
    lat = [serve_checked(queries, mask_sample=0)["seconds"] for _ in range(SHARD_TIMED_FLUSHES)]
    st = sq.stats()
    if st["shards_pruned"] < 1:
        raise AssertionError("fleet B pruned no shard")
    out["routed"] = {
        "rows": routed_rows,
        "ingest_s": ingest_s,
        "first_flush_s": first["seconds"],
        "warm_flush_p50_s": statistics.median(lat),
        "qps": len(queries) * len(lat) / sum(lat),
        "shards_pruned": st["shards_pruned"],
        "host_transfers": st["host_transfers"],
        "fused_dispatches": st["fused_dispatches"],
        "flushes": st["flushes"],
        "stripe_bounds": sq.store.stripe_bounds,
    }
    log(json.dumps({"shard_routed": out["routed"], **({"card": card} if card else {})}))
    del sq, table, oracle
    gc.collect()
    return out


def device_profile(fn, intervals: list | None = None) -> tuple[float, list]:
    """Run ``fn`` once under ``torch.profiler``; its wall time (ms) and the
    self time of every device-side kernel, copy and memset as
    ``(ms, count, name)``, largest first.  ``intervals``, if given,
    receives each device event as ``(start_us, end_us, name)``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # host-side ops: their device time is their kernels'
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        dev.append((us / 1e3, e.count, e.key))
    dev.sort(reverse=True)
    if intervals is not None:
        intervals.extend(
            (e.time_range.start, e.time_range.end, e.name)
            for e in prof.events()
            if e.device_type == DeviceType.CUDA
        )
    return wall_ms, dev


def profile_flush(sched, queries) -> dict:
    """One warm flush under ``torch.profiler``: its wall time, the device's
    busy time and idle share, and the largest device consumers."""
    wall_ms, dev = device_profile(lambda: sched.serve(queries))
    busy_ms = sum(ms for ms, _, _ in dev)
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if dev else "not measured",
        "device_idle_share": 1 - busy_ms / wall_ms if dev else "not measured",
        "top": [[key[:70], n, ms] for ms, n, key in dev[:8]],
    }


def profile_fleet_flush(sq, queries) -> dict:
    """``profile_flush`` for a sharded fleet, plus how many of the flush's
    device-to-host payload copies ran while a kernel ran (the pipelined
    gather of shard k overlapping shard k+1's program)."""
    spans: list = []
    wall_ms, dev = device_profile(lambda: sq.serve(queries), spans)
    busy_ms = sum(ms for ms, _, _ in dev)
    kernels = [(a, b) for a, b, name in spans if not name.startswith("Memcpy") and not name.startswith("Memset")]
    copies = [(a, b) for a, b, name in spans if name.startswith("Memcpy DtoH")]
    overlapping = sum(any(a < kb and ka < b for ka, kb in kernels) for a, b in copies)
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if dev else "not measured",
        "device_idle_share": 1 - busy_ms / wall_ms if dev else "not measured",
        "dtoh_copies": len(copies) if spans else "not measured",
        "dtoh_copies_overlapping_a_kernel": overlapping if spans else "not measured",
        "top": [[key[:70], n, ms] for ms, n, key in dev[:8]],
    }


# -- phase 4: kernel times at the main path's shapes --------------------------


def mws_call(args, kwargs) -> dict:
    """One recorded ``mws_gather`` call: the kernel, its plain version and
    a launch of the streaming variant as thunks, the variant the wrapper
    chooses, and the bytes it names —
    ``bytes_min`` (each distinct row read once, each output written once;
    the bound) and ``bytes_gathered`` (every named row read once per
    output row, as the streaming variant reads them)."""
    import torch

    from repro_torch.kernels._build import vec_width
    from repro_torch.kernels.mws import mws_gather, mws_gather_ref
    from repro_torch.kernels.mws import ops as mws_ops

    src, idx = args[0], args[1]
    op = args[2] if len(args) > 2 else kwargs.get("op")
    kw = {k: v for k, v in kwargs.items() if k != "op"}
    B, K, N = idx.shape
    W = src.shape[1]
    ext, shr = kw.get("ext"), kw.get("shr")
    m_ext = 0 if ext is None else ext.shape[1]
    m_shr = 0 if shr is None else shr.shape[0]
    outer_or = kw.get("outer_or", True)
    n_out = B if outer_or else B * K
    distinct = int(torch.unique(idx[idx >= 0]).numel())
    vec = vec_width(W, src, ext, shr)

    def streaming():
        out = torch.empty((B, W) if outer_or else (B, K, W), dtype=torch.int32, device=src.device)
        inv = kw.get("invert", False)
        mws_ops._launch(src, idx, op, outer_or, inv, ext, shr, out, vec, mws_ops.VARIANTS["streaming"])
        return out

    return {
        "kern": lambda: mws_gather(src, idx, op, **kw),
        "plain": lambda: mws_gather_ref(src, idx, op, **kw),
        "streaming": streaming,
        "variant": mws_ops.choose_variant(src.shape[0], B, K, N, m_ext, m_shr, outer_or, vec),
        "bytes_min": (distinct + B * m_ext + m_shr + n_out) * 4 * W + idx.numel() * 4,
        "bytes_gathered": (B * K * N + n_out) * 4 * W,
        "ops": B * K * N * W,
        "shape": f"src {tuple(src.shape)}, idx {tuple(idx.shape)}",
    }


L2_SCRUB_BYTES = 256 << 20  # written before each replay: five times the H100's 50 MB L2


def replay_ms(fns: list, reps: int, hide_host: bool = True) -> tuple[float, list[float]]:
    """Run ``fns`` in order, as the flush issued them, ``reps`` times with
    CUDA events around each whole run; returns the mean device
    milliseconds of one run and each call's mean host microseconds.
    Before each run a 256 MiB write evicts the L2, so no run starts on
    rows the one before left there; within a run, calls share the L2 as
    in the flush.  With ``hide_host`` the card sleeps first, so the
    window holds the device's time only; without it a run costs
    whichever of host and card is slower."""
    import torch

    scrub = torch.empty(L2_SCRUB_BYTES // 4, dtype=torch.int32, device="cuda")
    for f in fns:  # warm-up
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in fns:
        f()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    windows = []
    host_us = [0.0] * len(fns)
    for rep in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        scrub.fill_(rep)
        if hide_host:
            hold_card(host_s)
        start.record()
        for i, f in enumerate(fns):
            t = time.perf_counter()
            f()
            host_us[i] += (time.perf_counter() - t) * 1e6 / reps
        end.record()
        windows.append((start, end))
    torch.cuda.synchronize()
    return statistics.fmean(s.elapsed_time(e) for s, e in windows), host_us


def b1_per_flush(calls: list, bw: float) -> dict:
    """Every ``mws_gather`` call of one first flush, each held bit-exact
    against its plain version at its own shape, then timed in the
    flush's order (``replay_ms``): the device time of the whole list
    against the sum of the distinct-row bounds; the same list with the
    host's enqueue time not hidden; each call's host time per
    variant; and, as a per-layer aside, the sum of each call repeated
    alone (where the L2 holds a small call's rows from one repeat to the
    next).  The time the gathered bytes would take and the calls per
    variant stand beside them."""
    import torch

    cs = [mws_call(args, kwargs) for args, kwargs in calls]
    for i, c in enumerate(cs):
        if not torch.equal(c["kern"](), c["plain"]()):
            raise AssertionError(f"mws call {i} ({c['shape']}): kernel != plain version")
    kerns = [c["kern"] for c in cs]
    flush_ms, host_us = replay_ms(kerns, FLUSH_REPS)
    host_ms, _ = replay_ms(kerns, FLUSH_REPS, hide_host=False)
    bound_ms = sum(c["bytes_min"] for c in cs) / bw * 1e3
    variants: dict[str, int] = {}
    host_by_variant: dict[str, list[float]] = {}
    for c, us in zip(cs, host_us):
        variants[c["variant"]] = variants.get(c["variant"], 0) + 1
        host_by_variant.setdefault(c["variant"], []).append(us)
    return {
        "calls_checked": len(cs),
        "flush_order_ms": flush_ms,
        "bound_ms_sum": bound_ms,
        "flush_order_over_bound": flush_ms / bound_ms,
        "flush_order_host_included_ms": host_ms,
        "host_us_per_launch": {v: statistics.median(us) for v, us in host_by_variant.items()},
        "repeat_alone_ms_sum": sum(time_ms(k, KERNEL_REPS) for k in kerns),
        "gathered_ms_sum": sum(c["bytes_gathered"] for c in cs) / bw * 1e3,
        "calls_by_variant": variants,
    }


def kernel_report(rec, res: dict, card: str) -> list[dict]:
    """mws at the largest shape of the COUNT/MASK flush with the optimizer
    on and (row ``mws_optimizer_off``) off, each with that flush's
    launches and beside the streaming variant at the same shape (the
    grid-order control is tools/b1_grid_control.py); threshold and
    popcount at the largest
    shapes of the COUNT/MASK flush with the optimizer on, and popcount at
    the largest (rows, W) of the flush with aggregates."""
    import torch

    from repro_torch.kernels.popcount import popcount, popcount_ref
    from repro_torch.kernels.threshold import threshold_reduce, threshold_ref

    bw = hbm_rate(card)
    mws_size = lambda src, idx, *a, **k: idx.numel() * src.shape[1]  # noqa: E731
    rows = []
    for name, key, setting in (
        ("mws", "mws_optimize", "optimize"),
        ("mws_optimizer_off", "mws_plain", "plain"),
    ):
        c = mws_call(*rec.largest(key, mws_size))
        got, want = c["streaming"](), c["plain"]()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{name}: the streaming launch != plain version")
        del got, want
        rows.append(
            kernel_row(
                name,
                c["kern"],
                c["plain"],
                res[setting]["launches_first_flush"]["mws"],
                c["bytes_min"],
                c["ops"],
                bw,
                c["shape"],
                variant=c["variant"],
                variants_first_flush=res[setting]["mws_variants_first_flush"],
                streaming_ms=time_ms(c["streaming"], KERNEL_REPS),
            )
        )
        log(
            f"kernel {name}: indexes {c['bytes_gathered']} bytes of rows and outputs "
            f"({c['bytes_gathered'] / bw * 1e3:.4f} ms at {bw / 1e12} TB/s); its bound "
            f"counts {c['bytes_min']} bytes and {c['ops']} operations; {c['variant']} variant"
        )
    for name, key in (
        ("threshold", "threshold_optimize"),
        ("popcount", "popcount_optimize"),
        ("popcount_aggregates", "popcount_optimize_aggregates"),
    ):
        args, kwargs = rec.calls[key][0]
        if name == "threshold":
            x, k = args[0], args[1]
            inv = kwargs.get("invert", False)
            kern = lambda: threshold_reduce(x, k, invert=inv)  # noqa: E731
            plain = lambda: threshold_ref(x, k, invert=inv)  # noqa: E731
            B, n, W = x.shape
            nbytes = (B * n + B) * 4 * W
            ops = B * W * (8 * n + 9 * (n - k + 1))
            shape = f"x {tuple(x.shape)}, k={k}"
        else:
            x = args[0]
            kern = lambda: popcount(x)  # noqa: E731
            plain = lambda: popcount_ref(x)  # noqa: E731
            R, W = x.shape
            nbytes = R * W * 4 + R * 4
            ops = 2 * R * W
            shape = f"words {tuple(x.shape)}"
        setting = "optimize_aggregates" if name == "popcount_aggregates" else "optimize"
        launches = res[setting]["launches_first_flush"][name.split("_")[0]]
        rows.append(kernel_row(name, kern, plain, launches, nbytes, ops, bw, shape))
        log(f"kernel {name}: moves {nbytes} bytes and {ops} operations")
    return rows


def fleet_kernel_row(rec, modes: dict, card: str) -> dict:
    """mws at the largest shape of the lockstep fleet's COUNT/MASK flush:
    one launch over every shard's rows of the fleet tensor, beside the
    streaming variant at the same shape."""
    c = mws_call(*rec.largest("mws_shard_lockstep", lambda src, idx, *a, **k: idx.numel()))
    first = modes["lockstep_count_mask"]
    return kernel_row(
        "mws_fleet",
        c["kern"],
        c["plain"],
        first["launches_first_flush"]["mws"],
        c["bytes_min"],
        c["ops"],
        hbm_rate(card),
        c["shape"],
        variant=c["variant"],
        variants_first_flush=first["mws_variants_first_flush"],
        streaming_ms=time_ms(c["streaming"], KERNEL_REPS),
    )


def kernel_row(name, kern, plain, launches, bytes_min, ops, bw, shape, **extra) -> dict:
    """Hold ``kern()`` equal to ``plain()``, time both, and build the
    ``kernels`` line's entry.  No single PyTorch call computes any of
    these functions (no bitwise reduction over an axis, no popcount in
    this build's API, no bit packing), so there is no library time."""
    import torch

    got, want = kern(), plain()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: kernel shape {got.shape} != plain {want.shape}")
    if got.dtype.is_floating_point:
        err = float((got - want).abs().max()) if got.numel() else 0.0
        bad = err or not torch.equal(got, want)  # NaN-free ±1 here
    else:
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        bad = err
    if bad:
        raise AssertionError(f"{name}: kernel != plain version at the path's shape")
    del got, want
    ms = time_ms(kern, KERNEL_REPS)
    plain_ms = time_ms(plain, max(3, KERNEL_REPS // 4))
    bound_bytes_ms = bytes_min / bw * 1e3
    bound_ops_ms = ops / _OPS_PER_S * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": SOURCES[name],
        "replaces": REPLACES[name],
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": None,
        "shape": shape,
        **extra,
    }


# -- phase 5: the one-pass BMI count at the paper's size ------------------------


def bmi_path(device, words: int, days=BMI_DAYS, card: str | None = None, log=log) -> dict:
    """The paper's BMI query, "how many users were active on every one of
    the last d days", for each d in ``days`` over ``words`` words (32
    users each) per day, through the public ``mws_count``.

    The year's day stack is made on ``device`` from the seed: random
    activity plus a "loyal users" mask of about 1/8 density active every
    day, so the AND keeps about an eighth of the users.  The d-day stack is
    the last d rows.  Launch counts are set to 0 just before the counts and
    read just after; each count is then held against the plain version,
    against mws + popcount, and against the loyal users it must contain.
    With ``card``, B4, its plain version and mws + popcount are timed at
    each d and the kernels line's row is built at the largest.
    """
    import torch

    from repro_torch.core.bitops import BitOp
    from repro_torch.kernels.mws import mws_gather, mws_reduce
    from repro_torch.kernels.mws_count import mws_count, mws_count_ref
    from repro_torch.kernels.popcount import popcount, popcount_ref

    on_card = torch.device(device).type == "cuda"
    resident = torch.cuda.memory_allocated() if on_card else 0
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 6)

    def rand():
        return torch.randint(-(2**31), 2**31, (words,), generator=g, dtype=torch.int32, device=device)

    t0 = time.perf_counter()
    loyal = rand() & rand() & rand()
    loyal_users = int(popcount_ref(loyal[None])[0])
    n_days = max(days)
    year = torch.empty((n_days, words), dtype=torch.int32, device=device)
    for d in range(n_days):
        torch.bitwise_or(rand(), loyal, out=year[d])
    del loyal
    stacks = {d: year[n_days - d :] for d in days}
    if on_card:
        torch.cuda.synchronize()
    log(
        f"BMI stacks: {32 * words} users, {n_days} days x {words} words "
        f"({year.numel() * 4} bytes), {loyal_users} loyal users, {resident} bytes "
        f"resident before, {time.perf_counter() - t0:.2f} s"
    )

    kernels = {"mws_count": mws_count, "mws": mws_gather, "popcount": popcount}
    for fn in kernels.values():
        fn.launches = 0
    counts = {d: int(mws_count(stacks[d], BitOp.AND)) for d in days}
    launches = {k: fn.launches for k, fn in kernels.items()}
    if on_card and launches != {"mws_count": len(days), "mws": 0, "popcount": 0}:
        raise AssertionError(f"the BMI count launched {launches}, not mws_count once per window")
    for d in days:
        plain = int(mws_count_ref(stacks[d], BitOp.AND))
        b1b2 = int(popcount(mws_reduce(stacks[d], BitOp.AND)))
        if not counts[d] == plain == b1b2:
            raise AssertionError(f"BMI count d={d}: mws_count {counts[d]}, plain {plain}, mws+popcount {b1b2}")
        if counts[d] < loyal_users:
            raise AssertionError(f"BMI count d={d}: {counts[d]} < {loyal_users} loyal users")
    ordered = [counts[d] for d in sorted(days)]
    if ordered != sorted(ordered, reverse=True):
        raise AssertionError(f"a longer window counts more users: {counts}")
    out = {"users": 32 * words, "counts": counts, "loyal_users": loyal_users, "launches": launches}
    log(f"BMI one-pass count: {counts} (loyal users {loyal_users}), launches {launches}")
    if card is not None:
        bw = hbm_rate(card)
        windows = {}
        for d in days:
            s = stacks[d]
            windows[d] = {
                "count": counts[d],
                "ms": time_ms(lambda: mws_count(s, BitOp.AND), KERNEL_REPS),
                "plain_ms": time_ms(lambda: mws_count_ref(s, BitOp.AND), 3),
                "b1_b2_ms": time_ms(lambda: popcount(mws_reduce(s, BitOp.AND)), KERNEL_REPS),
                "bound_ms": (d * words * 4 + 4) / bw * 1e3,
                "b1_b2_bound_ms": ((d + 2) * words * 4 + 4) / bw * 1e3,
            }
            log(f"  BMI d={d}: {windows[d]}")
        s = stacks[n_days]
        out["row"] = kernel_row(
            "mws_count",
            lambda: mws_count(s, BitOp.AND),
            lambda: mws_count_ref(s, BitOp.AND),
            launches["mws_count"],
            n_days * words * 4 + 4,
            n_days * words,  # one logic op per word read; the popcounts are W more
            bw,
            f"stack ({n_days}, {words}) AND -> ()",
            b1_b2_ms=windows[n_days]["b1_b2_ms"],
            windows=windows,
        )
    del year, stacks
    return out


# -- phase 6: the training path -------------------------------------------------

_MATMUL_KEYS = ("gemm", "xmma", "nvjet", "cutlass", "cublas", "matmul")
_SIGNCOMP_KEYS = ("pack_signs_kernel", "unpack_signs_kernel")


def profile_step(trainer, batches) -> dict:
    """One training step under ``torch.profiler``: wall and device busy
    time, idle share, and the matmuls' and the sign kernels' time and
    share of the step."""
    wall_ms, dev = device_profile(lambda: trainer.train(batches, 1, log_every=0))
    if not dev:
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured"}
    busy = sum(ms for ms, _, _ in dev)
    mm = sum(ms for ms, _, k in dev if any(t in k.lower() for t in _MATMUL_KEYS))
    sc = sum(ms for ms, _, k in dev if any(t in k for t in _SIGNCOMP_KEYS))
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy,
        "device_idle_share": 1 - busy / wall_ms,
        "matmul_ms": mm,
        "matmul_share_of_step": mm / wall_ms,
        "signcomp_ms": sc,
        "signcomp_share_of_step": sc / wall_ms,
        "top": [[key[:90], n, ms] for ms, n, key in dev[:12]],
    }


def leaf_checker(checked: dict):
    """A ``Trainer.leaf_hook`` that holds every leaf's packed words against
    the plain version and its round trip against the sign rule (on the
    rank's own shard of a sharded leaf), and records the leaf's length."""
    import torch

    from repro_torch.kernels.signcomp import LANES, compress_signs_ref

    rows_per_chunk = 4096  # compare in slices of 64 Mi elements
    chunk = rows_per_chunk * 32 * LANES

    def check_leaf(name, acc, words, signs):
        flat = acc.view(-1)
        for r0 in range(0, words.shape[0], rows_per_chunk):
            part = flat[r0 * 32 * LANES : r0 * 32 * LANES + chunk]
            if not torch.equal(words[r0 : r0 + rows_per_chunk], compress_signs_ref(part, LANES)):
                raise AssertionError(f"{name}: packed words != plain version at row {r0}")
            if not torch.equal(signs[r0 * 32 * LANES : r0 * 32 * LANES + chunk], sign_rule(part)):
                raise AssertionError(f"{name}: round trip != sign rule at row {r0}")
        checked[name] = flat.numel()

    return check_leaf


def train_path(device, cfg, log=log) -> dict:
    """Train ``cfg`` with signSGD through ``Trainer`` on batches of the
    bitmap-index filtered corpus: WARMUP_STEPS steps (the first checks
    every leaf's packed words and round trip against the plain versions),
    then TIMED_STEPS timed steps and one profiled step."""
    import torch

    from repro_torch.core.bitops import to_uint32
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.kernels.mws import mws_gather
    from repro_torch.kernels.popcount import popcount
    from repro_torch.kernels.signcomp import compress_signs, decompress_signs
    from repro_torch.models.state import flatten
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    kernels = {
        "mws": mws_gather,
        "popcount": popcount,
        "pack_signs": compress_signs,
        "unpack_signs": decompress_signs,
    }
    for fn in kernels.values():
        fn.launches = 0

    t0 = time.perf_counter()
    corpus = SyntheticCorpus(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, num_samples=TRAIN_SAMPLES, device=device
    )
    kept = corpus.index.count(list(TRAIN_FILTER))
    planes = np.unpackbits(to_uint32(corpus.index.planes).view(np.uint8), axis=1, bitorder="little")
    pick = [corpus.index.names.index(p) for p in TRAIN_FILTER]
    want = int((planes[pick[0]] & planes[pick[1]])[:TRAIN_SAMPLES].sum())
    if kept != want:
        raise AssertionError(f"BMI filter keeps {kept} samples, numpy {want}")
    tcfg = TrainerConfig(
        opt=OptimizerConfig(mode="signsgd", lr=TRAIN_LR), compress_grads="signsgd"
    )
    trainer = Trainer(cfg, tcfg, device=device)
    leaves = flatten(trainer.params)
    n_params = sum(p.numel() for p in leaves.values())
    batches = corpus.batches(TRAIN_BATCH, TRAIN_FILTER)
    setup_s = time.perf_counter() - t0
    log(
        f"train setup: {cfg.name}, {cfg.n_layers} layers, d {cfg.d_model}, ff {cfg.d_ff}, "
        f"V {cfg.vocab}, {n_params} params in {len(leaves)} leaves, {cfg.param_dtype}, "
        f"remat {cfg.remat}; BMI filter keeps {kept}/{TRAIN_SAMPLES} samples (numpy "
        f"{want}); {setup_s:.2f} s"
    )

    checked = {}
    trainer.leaf_hook = leaf_checker(checked)
    losses = trainer.train(batches, 1, log_every=0)
    trainer.leaf_hook = None
    if sorted(checked) != sorted(leaves):
        raise AssertionError(f"checked {len(checked)} of {len(leaves)} leaves")
    losses += trainer.train(batches, WARMUP_STEPS - 1, log_every=0)
    step_s = []
    for _ in range(TIMED_STEPS):
        if on_card:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses += trainer.train(batches, 1, log_every=0)
        step_s.append(time.perf_counter() - t1)
    steps = WARMUP_STEPS + TIMED_STEPS
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated() if on_card else None

    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    lo, hi = math.log(cfg.vocab) - 0.8, math.log(cfg.vocab) + 2.2
    if not lo <= losses[0] <= hi:
        raise AssertionError(f"first loss {losses[0]} outside [{lo:.2f}, {hi:.2f}]")
    if on_card:  # the plain versions, on the CPU, count nothing
        if not launches["pack_signs"] == launches["unpack_signs"] == len(leaves) * steps:
            raise AssertionError(f"sign kernels launched {launches}, not once per leaf per step")
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel of the training path never launched: {launches}")
    p50 = statistics.median(step_s)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {
        "arch": cfg.name,
        "layers": cfg.n_layers,
        "params": n_params,
        "leaves": len(leaves),
        "largest_leaf": max(checked.values()),
        "losses": losses,
        "step_p50_s": p50,
        "tokens_per_s": tokens * TIMED_STEPS / sum(step_s),
        "step_s": step_s,
        "launches": launches,
        "max_memory_allocated": peak,
    }
    log(
        f"train: {steps} steps, losses {losses[0]:.4f} -> {losses[-1]:.4f}, step p50 "
        f"{p50 * 1e3:.2f} ms, {out['tokens_per_s']:.1f} tokens/s over {TIMED_STEPS} steps, "
        f"launches {launches}, max_memory_allocated {peak}"
    )
    if on_card:
        out["profile"] = profile_step(trainer, batches)
        log(f"  one step under torch.profiler: {out['profile']}")
    del trainer, batches, corpus
    return out


# -- phase 6b: the sharded trainer on a one-rank mesh -----------------------------

DIST_STEPS = 3  # losses held against train_path's first steps
DIST_TIMED_STEPS = 4
DRYRUN_CELLS = [(a, "train_4k", mp) for a in ("starcoder2-3b", "granite-8b") for mp in (False, True)]


def trainer_state_bytes(cfg, mesh_shape=(1, 1)) -> dict:
    """``launch/dryrun.py``'s per-rank count of what ``Trainer`` allocates
    at init for ``cfg`` with signSGD on a ("data", "model") mesh of
    ``mesh_shape``: parameters, optimizer state (the moments; the step is
    a host int in the port, 4 bytes in the count) and error feedback."""
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig

    mesh = AbstractMesh(mesh_shape, ("data", "model"))
    shape = ShapeConfig("smoke_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    names, args, resolved = dryrun.build_cell(cfg, shape, mesh, compress_grads="signsgd")
    groups = dryrun.per_rank(args, resolved, mesh)
    return {n: sum(r[3] for r in rows) for n, rows in zip(names, groups) if n != "batch"}


def dist_train_path(device, cfg, train: dict, card: str | None = None, log=log) -> dict:
    """``train_path`` again through ``Trainer(mesh=...)`` on a one-rank
    ("data", "model") mesh: NCCL on the card (gloo on the CPU), brought up
    over a file store in a temporary directory, so no port is taken.  The
    same seed and filtered batches: the first DIST_STEPS losses against
    ``train_path``'s, every leaf's packed words of the first step against
    the plain version, the memory Trainer init allocates against the
    dry-run's count (1%), B5/B6 once per leaf per step; then timed steps,
    one profiled step, and the dry-run's per-rank bytes at 16x16 and
    2x16x16."""
    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.kernels.signcomp import compress_signs, decompress_signs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.models.state import flatten
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev_type = torch.device(device).type
    on_card = dev_type == "cuda"
    kernels = {"pack_signs": compress_signs, "unpack_signs": decompress_signs}
    store = tempfile.mkdtemp()
    init_process_group(dev_type, init_method=f"file://{store}/pg")
    try:
        mesh = make_host_mesh(1, 1, device_type=dev_type)
        tcfg = TrainerConfig(
            opt=OptimizerConfig(mode="signsgd", lr=TRAIN_LR), compress_grads="signsgd"
        )
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        trainer = Trainer(cfg, tcfg, device=device, mesh=mesh)
        init_s = time.perf_counter() - t0
        leaves = flatten(trainer.params)
        if not all(is_dtensor(p) for p in leaves.values()):
            raise AssertionError("a parameter of the sharded trainer is not a DTensor")
        want = trainer_state_bytes(cfg)
        allocated = torch.cuda.memory_allocated() - before if on_card else None
        if on_card and abs(allocated - sum(want.values())) > 0.01 * sum(want.values()):
            raise AssertionError(f"Trainer init allocated {allocated} bytes, the dry-run counts {want}")
        log(
            f"dist train setup: {cfg.name} on a {tuple(mesh.mesh.shape)} {dist.get_backend()} mesh, "
            f"{len(leaves)} DTensor leaves, init {init_s:.2f} s, allocated {allocated} bytes, "
            f"dry-run count {sum(want.values())} {want}"
        )
        corpus = SyntheticCorpus(
            vocab=cfg.vocab, seq_len=TRAIN_SEQ, num_samples=TRAIN_SAMPLES, device=device
        )
        batches = corpus.batches(TRAIN_BATCH, TRAIN_FILTER)

        for fn in kernels.values():
            fn.launches = 0
        checked = {}
        trainer.leaf_hook = leaf_checker(checked)
        losses = trainer.train(batches, 1, log_every=0)
        trainer.leaf_hook = None
        if sorted(checked) != sorted(leaves):
            raise AssertionError(f"checked {len(checked)} of {len(leaves)} leaves")
        losses += trainer.train(batches, DIST_STEPS - 1, log_every=0)
        step_s = []
        for _ in range(DIST_TIMED_STEPS):
            if on_card:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses += trainer.train(batches, 1, log_every=0)
            step_s.append(time.perf_counter() - t1)
        steps = DIST_STEPS + DIST_TIMED_STEPS
        launches = {k: fn.launches for k, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated() if on_card else None

        ref = train["losses"][:DIST_STEPS]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses[:DIST_STEPS], ref)]
        if losses[:DIST_STEPS] != ref:
            log(f"dist train: first losses {losses[:DIST_STEPS]} vs train_path {ref}, rel {rel}")
            if max(rel) > 1e-6:
                raise AssertionError(f"sharded losses {losses[:DIST_STEPS]} != train_path's {ref}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite loss: {losses}")
        if on_card and not launches["pack_signs"] == launches["unpack_signs"] == len(leaves) * steps:
            raise AssertionError(f"sign kernels launched {launches}, not once per leaf per step")
        p50 = statistics.median(step_s)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        out = {
            "arch": cfg.name,
            "mesh": list(mesh.mesh.shape),
            "backend": dist.get_backend(),
            "losses": losses,
            "train_path_losses": ref,
            "losses_bit_equal": losses[:DIST_STEPS] == ref,
            "max_rel_loss_diff": max(rel),
            "init_allocated": allocated,
            "dryrun_bytes": want,
            "step_p50_s": p50,
            "tokens_per_s": tokens * DIST_TIMED_STEPS / sum(step_s),
            "step_s": step_s,
            "train_path_step_p50_s": train.get("step_p50_s"),
            "train_path_tokens_per_s": train.get("tokens_per_s"),
            "launches": launches,
            "max_memory_allocated": peak,
        }
        log(
            f"dist train: {steps} steps, losses {losses[0]:.4f} -> {losses[-1]:.4f} (first "
            f"{DIST_STEPS} bit-equal to train_path: {out['losses_bit_equal']}), step p50 "
            f"{p50 * 1e3:.2f} ms vs {train.get('step_p50_s', float('nan')) * 1e3:.2f} ms, "
            f"{out['tokens_per_s']:.1f} tokens/s, launches {launches}, max_memory_allocated {peak}"
        )
        if on_card:
            out["profile"] = profile_step(trainer, batches)
            out["train_path_idle_share"] = train.get("profile", {}).get("device_idle_share")
            log(f"  one sharded step under torch.profiler: {out['profile']}")
        del trainer, batches, corpus
    finally:
        dist.destroy_process_group()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    memory = torch.cuda.get_device_properties(0).total_memory if on_card else None
    # bytes only: roofline_path counts a 16x16 cell in its own process
    cells = [dryrun.run_cell(a, s, mp, device_bytes=memory, roofline=False) for a, s, mp in DRYRUN_CELLS]
    log(json.dumps({"dryrun": [
        {k: c[k] for k in ("arch", "shape", "mesh", "argument_bytes", "bytes_by_group", "device_bytes", "fits")}
        for c in cells
    ], "temp_bytes": None, "why": dryrun.NO_TEMP, "card": card}))
    return out


# -- phase 6c: the roofline count against a measured step -------------------------

ROOFLINE_WARMUP = 2
ROOFLINE_TIMED = 5
ROOFLINE_CELL = ("starcoder2-3b", "train_4k")  # one 16x16 cell, in its own process
ROOFLINE_CELL_TIMEOUT_S = 600


def roofline_path(device, cfg, card: str | None = None, cell=ROOFLINE_CELL, log=log) -> dict:
    """``launch/hlo_analysis.py``'s count of ``cfg``'s AdamW
    ``make_train_step`` at TRAIN_BATCH x TRAIN_SEQ, unsharded, held
    against the same step on ``device``: counted on meta tensors (after
    one uncounted call), then ROOFLINE_WARMUP + ROOFLINE_TIMED steps run
    on the device (host clock around each, synchronized; p50) and one
    more counted there, whose FLOPs, bytes and op count must equal the
    meta count (the ops whose counts differ are named).  The bound is the
    meta count's larger term (989 TFLOP/s bf16, 3.35 TB/s); MFU is
    ``model_flops`` over p50 x 989 TFLOP/s.  Then ``cell`` runs in its own
    process (``python -m repro_torch.launch.roofline``, a 16x16 "fake"
    mesh), which must come out ``ok``.  No B1-B7 kernel launches."""
    import torch

    from repro_torch.kernels import wrappers as kernel_wrappers
    from repro_torch.launch import hlo_analysis
    from repro_torch.launch.roofline import count_params, plain_cell
    from repro_torch.models.config import ShapeConfig

    shape = ShapeConfig("smoke_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    on_card = torch.device(device).type == "cuda"
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0

    t0 = time.perf_counter()
    step, args = plain_cell(cfg, shape, "meta", seed=SEED)
    step(*args)  # the RoPE table's copy, once per device
    meta = hlo_analysis.count_step(step, args)
    meta_s = time.perf_counter() - t0
    del step, args

    step, args = plain_cell(cfg, shape, device, seed=SEED)
    for _ in range(ROOFLINE_WARMUP):
        step(*args)
    step_s = []
    for _ in range(ROOFLINE_TIMED):
        if on_card:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, _, metrics = step(*args)
        if on_card:
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
    loss = float(metrics["loss"])
    real = hlo_analysis.count_step(step, args)
    del step, args
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    if (real.flops, real.bytes, real.ops) != (meta.flops, meta.bytes, meta.ops):
        differ = {
            op: (meta.by_op.get(op, 0), real.by_op.get(op, 0))
            for op in set(meta.by_op) | set(real.by_op)
            if meta.by_op.get(op, 0) != real.by_op.get(op, 0)
        }
        raise AssertionError(
            f"the {device} step counts flops {real.flops}, bytes {real.bytes}, ops {real.ops}; "
            f"meta {meta.flops}, {meta.bytes}, {meta.ops}; ops (meta, {device}) that differ: {differ}"
        )
    launched = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    if launched:
        raise AssertionError(f"the AdamW step launched Flash-Cosmos kernels: {launched}")

    terms = meta.terms(1)
    total, active = count_params(cfg)
    mf = hlo_analysis.model_flops(cfg, shape, total, active)
    p50 = statistics.median(step_s)
    out = {
        "arch": cfg.name,
        "batch": [TRAIN_BATCH, TRAIN_SEQ],
        "device": str(device),
        "meta_count_s": meta_s,
        "flops": meta.flops,
        "bytes": meta.bytes,
        "ops": meta.ops,
        "counts_equal": True,
        "step_s": step_s,
        "step_p50_s": p50,
        "loss": loss,
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "dominant": terms.dominant,
        "bound_s": terms.bound_s,
        "p50_over_bound": p50 / terms.bound_s,
        "model_flops": mf,
        "mfu": mf / (p50 * hlo_analysis.PEAK_FLOPS),
        "card": card,
    }
    log(
        f"roofline: {cfg.name} AdamW step {TRAIN_BATCH} x {TRAIN_SEQ}, counted on meta and {device} alike "
        f"(flops {meta.flops}, bytes {meta.bytes}, ops {meta.ops}); p50 {p50 * 1e3:.2f} ms, compute "
        f"{terms.compute_s * 1e3:.2f} ms, memory {terms.memory_s * 1e3:.2f} ms ({terms.dominant}), "
        f"p50 / bound {out['p50_over_bound']:.3f}, MFU {out['mfu']:.4f}; {card}"
    )

    arch, shape = cell
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    with tempfile.TemporaryDirectory() as cell_dir:  # the cell's file, not kept
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.roofline", "--arch", arch, "--shape", shape,
             "--out", cell_dir],
            capture_output=True, text=True, timeout=ROOFLINE_CELL_TIMEOUT_S, env=env,
        )
    lines = [line for line in run.stdout.splitlines() if line.startswith("{")]
    if run.returncode != 0 or len(lines) != 1 or json.loads(lines[0])["status"] != "ok":
        raise AssertionError(f"roofline cell {cell}: rc {run.returncode}\n{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    out["cell"] = json.loads(lines[0])
    out["cell_wall_s"] = time.perf_counter() - t0
    log(f"roofline cell ({out['cell_wall_s']:.1f} s): {lines[0]}")
    return out


SHARDED_COUNT_PROCS = 3  # counting processes of launch/split.py, started with the gradient check
SHARDED_COUNT_TIMEOUT_S = 300
SHARDED_COUNT_MUST_RUN = (("recurrentgemma-2b", "train_4k"), ("recurrentgemma-2b", "prefill_32k"))  # C24


def sharded_count_path(card: str | None = None, log=log) -> dict:
    """``launch/split.py`` on this machine's torch: each family of
    ``split.FAMILIES`` as a reduced train step on a 2x2 "fake" mesh, rank
    0's matmul FLOPs x 4 against the unsharded step's per model line
    (forward and backward) and for the whole step; then every reduced
    (arch x shape) cell that ``tests/test_torch_roofline_cells.py`` runs.
    A fake mesh is one per process and ``dist_train_path``'s NCCL group
    is up in this one, so the jobs run in SHARDED_COUNT_PROCS processes
    of ``python -m repro_torch.launch.split``, all started together, on
    meta tensors with no CUDA device visible.  Every family must count
    excess 0 with no unsplit line, every cell ``ok`` (or skipped by the
    reference's rule), SHARDED_COUNT_MUST_RUN among the ``ok``.  A fourth
    process runs each family's loss and gradients on a real 4-rank gloo
    2x2 mesh (``split.grad_check``): every leaf within the reference's
    tolerance of the unsharded step's, the loss within 1e-4.  Each
    process must report 0 launches of every B1-B7 kernel."""
    import torch

    from repro_torch.launch import split
    from repro_torch.models.config import SHAPES

    jobs = [("--families", a) for a in split.FAMILIES] + [("--cells", a) for a in split.CELL_ARCHS]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"), CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    cmds = []
    for i in range(SHARDED_COUNT_PROCS):
        mine = jobs[i::SHARDED_COUNT_PROCS]
        cmd = [sys.executable, "-m", "repro_torch.launch.split"]
        for flag in ("--families", "--cells"):
            cmd += [flag, *(a for f, a in mine if f == flag)]
        cmds.append(cmd)
    # the gradients on a real 4-rank gloo mesh, in a process of their own
    cmds.append([sys.executable, "-m", "repro_torch.launch.split", "--families", "--grads", *split.FAMILIES])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env) for c in cmds]
    runs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, SHARDED_COUNT_TIMEOUT_S - (time.perf_counter() - t0)))
            runs.append((p.args, p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    families, cells, grads, launched, reports = {}, {}, {}, {}, 0
    for args, rc, out, err in runs:
        if rc != 0:
            raise AssertionError(f"{' '.join(args[1:])}: rc {rc}\n{out[-3000:]}\n{err[-4000:]}")
        for line in out.splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                if "family" in rec:
                    families[rec["family"]["arch"]] = rec["family"]
                elif "grads" in rec:
                    grads[rec["grads"]["arch"]] = {k: v for k, v in rec["grads"].items() if k != "arch"}
                elif "launches" in rec:  # each process's own kernel launches
                    reports += 1
                    launched.update({k: n for k, n in rec["launches"].items() if n})
                else:
                    cells[(rec["cell"]["arch"], rec["cell"]["shape"])] = rec["cell"]["status"]
    bad = {a: f for a, f in families.items() if f["unsplit"] or any(f["excess"].values())}
    if set(families) != set(split.FAMILIES) or bad:
        raise AssertionError(f"families counted {sorted(families)}; not split: {bad}")
    ok = sorted(f"{a} {s}" for (a, s), st in cells.items() if st == "ok")
    skipped = sorted(f"{a} {s}" for (a, s), st in cells.items() if st == "skip")
    if len(ok) + len(skipped) != len(cells) or len(cells) != len(SHAPES) * len(split.CELL_ARCHS):
        raise AssertionError(f"cells: {cells}")
    off = {a: g for a, g in grads.items() if not g["worst_over_tol"] <= 1 or abs(g["loss"][0] - g["loss"][1]) > 1e-4}
    if set(grads) != set(split.FAMILIES) or off:
        raise AssertionError(f"gradients checked {sorted(grads)}; off: {off}")
    missing = [c for c in SHARDED_COUNT_MUST_RUN if cells.get(c) != "ok"]
    if missing:
        raise AssertionError(f"cells not ok: {missing}")
    if reports != len(runs) or launched:
        raise AssertionError(f"the sharded counts launched Flash-Cosmos kernels: {launched} ({reports} reports)")
    out = {
        "torch": torch.__version__,
        "mesh": "2x2",
        "families": {a: {k: f[k] for k in ("lines", "excess", "unsplit")} for a, f in families.items()},
        "cells": {"ok": ok, "skipped": skipped},
        "grads": grads,
        "procs": len(cmds),
        "wall_s": time.perf_counter() - t0,
        "card": card,
    }
    log(
        f"sharded count (torch {torch.__version__}): {len(families)} families split on 2x2, forward and "
        f"backward, excess 0; {len(ok)} reduced cells ok, {len(skipped)} skipped; gradients on 4 gloo ranks "
        f"within tolerance (worst {max(g['worst_over_tol'] for g in grads.values()):.4g} of it) ({out['wall_s']:.1f} s)"
    )
    return out


# -- phase 7: the sign kernels at the training path's largest leaf ---------------


def signcomp_report(n: int, train: dict, card: str) -> list[dict]:
    """pack_signs and unpack_signs timed at the largest gradient leaf the
    training path compressed (n elements), on fresh data from the seed;
    ``launches`` are the training path's."""
    import torch

    from repro_torch.kernels.signcomp import (
        LANES,
        compress_signs,
        compress_signs_ref,
        decompress_signs,
        decompress_signs_ref,
        sign_layout,
    )

    bw = hbm_rate(card)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 3)
    x = torch.randn(n, generator=g, device="cuda")
    words = compress_signs(x)
    layout = sign_layout(n)
    out_bytes = 4 * layout.rows * layout.words
    per_step = train["launches"]["pack_signs"] // (WARMUP_STEPS + TIMED_STEPS)
    rows = [
        kernel_row(
            "pack_signs",
            lambda: compress_signs(x),
            lambda: compress_signs_ref(x, LANES),
            train["launches"]["pack_signs"],
            4 * n + out_bytes,
            3 * n,  # a compare, a shift and an OR per element
            bw,
            f"x ({n},) f32 -> words ({layout.rows}, {layout.words})",
            launches_per_step=per_step,
        ),
        kernel_row(
            "unpack_signs",
            lambda: decompress_signs(words, n),
            lambda: decompress_signs_ref(words, n),
            train["launches"]["unpack_signs"],
            out_bytes + 4 * n,
            3 * n,  # a shift, an AND and a select per element
            bw,
            f"words ({layout.rows}, {layout.words}) -> ({n},) f32",
            launches_per_step=per_step,
        ),
    ]
    del x, words
    return rows


# -- phase 8: majority votes at the largest leaf's layout --------------------------


def majority_phase(n: int, card: str) -> dict:
    """Vote K in VOTERS packed sign planes of the largest leaf's layout, as
    K data-parallel replicas would (each plane packs one replica's
    gradient: a shared part plus its own noise), with the counter set to 0
    just before; check every vote against the plain version; time the
    largest K and, beside it, the smallest.  No program path votes on one
    card (ROADMAP A8d)."""
    import torch

    from repro_torch.kernels.signcomp import compress_signs, majority_ref, majority_vote, sign_layout

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 4)
    K = max(VOTERS)
    layout = sign_layout(n)
    shared = torch.randn(n, generator=g, device="cuda")
    planes = torch.empty((K, layout.rows, layout.words), dtype=torch.int32, device="cuda")
    for k in range(K):
        planes[k] = compress_signs(shared + torch.randn(n, generator=g, device="cuda"))
    del shared
    majority_vote.launches = 0
    votes = {k: majority_vote(planes[:k]) for k in VOTERS}
    launches = majority_vote.launches
    for k, v in votes.items():
        if not torch.equal(v, majority_ref(planes[:k])):
            raise AssertionError(f"majority K={k}: kernel != plain version")
    del votes
    RW = layout.rows * layout.words
    small = min(VOTERS)
    log(f"kernel majority: K={small} moves {4 * (small + 1) * RW} bytes "
        f"({4 * (small + 1) * RW / hbm_rate(card) * 1e3:.4f} ms at the HBM rate)")
    counter_planes = next(p for p, most in ((3, 7), (4, 15), (8, 255), (16, 65535)) if K <= most)
    row = kernel_row(
        "majority",
        lambda: majority_vote(planes),
        lambda: majority_ref(planes),
        launches,
        4 * K * RW + 4 * RW,
        (2 * K + 2) * counter_planes * RW,  # a ripple carry per input word, a borrow chain per output
        hbm_rate(card),
        f"stacks ({K}, {layout.rows}, {layout.words}) -> ({layout.rows}, {layout.words})",
        path=f"votes of K={list(VOTERS)} replica planes; no program path on one card",
        # the smaller vote, an even K (ties vote 1), timed beside it
        smaller_k=small,
        smaller_k_ms=time_ms(lambda: majority_vote(planes[:small]), KERNEL_REPS),
    )
    del planes
    return row


# -- phase 9: LM serving ----------------------------------------------------------

# (arch, batch, prompt tokens, new tokens, encoder frames, config overrides, why)
SERVE_RUNS = (
    ("granite-8b", 8, 512, 64, 0, {}, "dense; serve.py's default arch, its default naive attention"),
    ("granite-8b", 1, 8192, 16, 0, {"attention_impl": "auto"},
     "blockwise prefill, and blockwise decode at a large offset"),
    ("internvl2-26b", 2, 128, 32, 0, {}, "VLM: 256 patch embeddings + 128 tokens"),
    ("deepseek-v2-lite-16b", 8, 512, 64, 0, {}, "MoE + MLA at the published capacity 1.25"),
    ("xlstm-350m", 8, 500, 64, 0, {},
     "3 chunks of 128 plus a 116-token ragged tail step by step; O(1) recurrent decode"),
    ("recurrentgemma-2b", 8, 512, 64, 0, {},
     "Griffin's 2:1 recurrent/local pattern, 2 remainder layers, ring cache below the window"),
    ("recurrentgemma-2b", 1, 8192, 32, 0, {"attention_impl": "auto"},
     "two RG-LRU chunks, the ring wrapped 4 times, blockwise windowed prefill"),
    ("whisper-medium", 8, 128, 64, 1500, {},
     "30 s of audio (1500 frames after the conv stub), a 128-token decoder prompt"),
)
SERVE_CHECK_STEPS = 4  # decode steps held against the full forward
# The cached path and the full forward round bf16 (8 significant bits) at
# different points: other matmul shapes and attention over the cache's
# empty slots.  That moves dense logits by a few hundredths of their
# spread; a wrong position, cache slot or mask decorrelates them (RMS
# ratio near 1-1.4).
SERVE_BF16_TOL = 0.1  # per batch row: RMS(cached - forward) / std(forward)
# In bf16 an MoE's top-k router re-routes the compared token in several
# layers (tools/serve_route_flips.py counts them), and the xLSTM's layers
# amplify the two paths' different bf16 roundings with depth
# (tools/serve_recurrent_drift.py), so their cached paths are held against
# the forward in f32 at full width and depth, to the reference's own f32
# decode-vs-forward tolerance (tests/test_arch_smoke.py:57); their bf16
# ratios are reported beside.
SERVE_F32_RATIO_TOL = 3e-3
SERVE_F32_TOL = 1e-4  # card vs CPU, f32 reduced configs (d), elementwise
def _serve_inputs(cfg, batch: int, prompt: int, seed: int, device, frames: int = 0):
    """Prompts, the audio family's ``frames`` encoder frames and the VLM's
    patch embeddings from ``seed``, in ``launch/serve.py``'s order (which
    ties the frames to the prompt's length; here each run sets it)."""
    import torch

    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt))).to(device)
    extra = {}
    if cfg.family == "audio":
        if frames <= 0:
            raise ValueError(f"{cfg.name} needs encoder frames")
        enc = rng.normal(size=(batch, frames, cfg.d_model))
        extra["frames"] = torch.from_numpy(enc).to(device, cfg.cdtype)
    if cfg.family == "vlm":
        patches = rng.normal(size=(batch, cfg.num_patch_tokens, cfg.d_model))
        extra["patch_embeds"] = torch.from_numpy(patches).to(device, cfg.cdtype)
    return prompts, extra


def serve_check_config(cfg):
    """The config whose cached path ``serve_path`` holds against its full
    forward: ``cfg`` itself, or in f32 for a family whose bf16 paths
    disagree by design: an MoE (its router re-routes near ties;
    ``tools/serve_route_flips.py``), at a no-drop capacity (E / top_k,
    so a forward over more tokens keeps every assignment the cached
    steps kept), and the xLSTM (its 24 layers amplify the two paths'
    different bf16 roundings; ``tools/serve_recurrent_drift.py``)."""
    if cfg.moe is not None:
        no_drop = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)
        cfg = cfg.with_(moe=no_drop)
    elif cfg.family != "ssm":
        return cfg
    return cfg.with_(param_dtype="float32", compute_dtype="float32")


def check_cached_path(cfg, params, prompts, extra, device) -> list[float]:
    """Serve SERVE_CHECK_STEPS + 1 tokens; for the prefill and each decode
    step, the worst batch row's RMS(step logits - forward logits) /
    std(forward logits), the forward running over the prompt plus the
    tokens generated so far."""
    import torch

    from repro_torch.launch.serve import serve
    from repro_torch.models.registry import get_model

    kept = {}
    ids = serve(cfg, params, prompts, SERVE_CHECK_STEPS + 1, extra, device,
                on_step=lambda i, lg: kept.__setitem__(i, lg[:, -1].clone()))
    ratios = []
    with torch.inference_mode():
        for i in range(SERVE_CHECK_STEPS + 1):
            seq = torch.cat([prompts, ids[:, :i]], dim=1)
            want = get_model(cfg).forward(cfg, params, seq, **extra)[:, -1].float()
            rms = (kept[i].float() - want).pow(2).mean(dim=-1).sqrt()
            ratios.append(float((rms / want.std(dim=-1)).max()))
            del want
    return ratios


def _free(device) -> None:
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def decode_work(cfg, params, batch: int, frames: int, context: int) -> dict:
    """The least work of one decode step at ``context`` tokens: the bytes
    it must move, each once (every weight the step reads; a recurrent
    state read and written whole; a cache's filled slots, at most a
    ring's W, and Whisper's ``enc_out`` read; the f32 logits written),
    and its operations (2 per weight read per batch row, and Whisper's
    cross-attention K/V projections of ``enc_out``, which the reference
    recomputes every step: 2·B·frames·d·2d per layer)."""
    from repro_torch.models.registry import get_model
    from repro_torch.models.state import flatten

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    leaves = flatten(params)
    if cfg.family == "audio":  # no encoder weight, one row of the position table
        skip = ("enc_layers/", "enc_norm/", "dec_pos")
        leaves = {k: v for k, v in leaves.items() if not k.startswith(skip)}
        leaves["dec_pos"] = params["dec_pos"][0]
    weights = nbytes(leaves.values())
    kw = {"enc_len": frames} if cfg.family == "audio" else {}
    cache = flatten(get_model(cfg).init_kv_cache(cfg, batch, context, device="meta", **kw))
    if cfg.family == "ssm":
        state = 2 * nbytes(cache.values())
    elif cfg.family == "hybrid":  # the ring holds min(context, window) filled slots
        ring = [v for k, v in cache.items() if k.startswith("triples/4/")]
        state = nbytes(ring) + 2 * (nbytes(cache.values()) - nbytes(ring))
    else:  # every slot up to ``context`` filled, and enc_out
        state = nbytes(cache.values())
    ops = 2 * batch * sum(v.numel() for v in leaves.values())
    if cfg.family == "audio":
        ops += 2 * batch * frames * cfg.d_model * 2 * cfg.d_model * cfg.n_layers
    return {"weight_bytes": weights, "state_bytes": state, "logit_bytes": 4 * batch * cfg.vocab,
            "bytes": weights + state + 4 * batch * cfg.vocab, "ops": ops}


def slstm_prefill_share(cfg, params, prompts, device) -> float:
    """The share of an xLSTM prefill's host-clock time spent in its sLSTM
    blocks (the card synchronised around each block)."""
    import torch

    from repro_torch.models import xlstm

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    real, spent = xlstm.slstm_block_fwd, [0.0]

    def timed(*args, **kw):
        sync()
        t = time.perf_counter()
        out = real(*args, **kw)
        sync()
        spent[0] += time.perf_counter() - t
        return out

    xlstm.slstm_block_fwd = timed
    try:
        sync()
        t0 = time.perf_counter()
        xlstm.prefill(cfg, params, prompts)
        sync()
        total = time.perf_counter() - t0
    finally:
        xlstm.slstm_block_fwd = real
    return spent[0] / total


def serve_path(device, cfg, batch: int, prompt: int, tokens: int, frames: int = 0,
               seed: int = SEED, card: str | None = None, log=log) -> dict:
    """Serve ``cfg`` at random weights from ``seed`` through
    ``launch/serve.py::serve``: first the check of the cached path against
    the full forward (``serve_check_config``; an MoE's or an xLSTM's in
    f32 on its own parameters, freed before the served ones are built),
    then the timed run at ``cfg`` itself (every logit finite), then one
    profiled decode step and the unembedding's f32 copy.  ``frames``: the
    audio family's encoder frames (they take no cache slot).  For the
    xLSTM also the sLSTM's share of a prefill."""
    import torch

    from repro_torch.kernels import wrappers as kernel_wrappers
    from repro_torch.launch.serve import serve
    from repro_torch.models.registry import get_model
    from repro_torch.models.state import flatten
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    on_card = torch.device(device).type == "cuda"
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    model = get_model(cfg)
    check_cfg = serve_check_config(cfg)
    same = check_cfg.param_dtype == cfg.param_dtype
    if not same:
        params = model.init_params(check_cfg, seed, device)
        ratios = check_cached_path(
            check_cfg, params, *_serve_inputs(check_cfg, batch, prompt, seed, device, frames), device
        )
        del params
        _free(device)

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed, device)
    if on_card:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    peak_init = torch.cuda.max_memory_allocated() if on_card else None
    n_params = sum(p.numel() for p in flatten(params).values())
    prompts, extra = _serve_inputs(cfg, batch, prompt, seed, device, frames)
    n_ctx = prompt + (extra["patch_embeds"].shape[1] if "patch_embeds" in extra else 0)
    if same:
        ratios = check_cached_path(check_cfg, params, prompts, extra, device)
        reported = None
    else:  # the served dtype's ratios, beside the gated f32 ones
        reported = check_cached_path(serve_check_config(cfg).with_(
            param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype), params, prompts, extra, device)
    tol = SERVE_BF16_TOL if check_cfg.cdtype == torch.bfloat16 else SERVE_F32_RATIO_TOL
    if not max(ratios) <= tol:
        raise AssertionError(f"{cfg.name}: cached logits vs forward {ratios} > {tol}")

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    marks = []
    finite = torch.ones((), dtype=torch.bool, device=device)

    def on_step(i, logits):
        finite.logical_and_(torch.isfinite(logits).all())
        if on_card:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())

    t1 = time.perf_counter()
    ids = serve(cfg, params, prompts, tokens, extra, device, on_step).cpu()
    peak_serve = torch.cuda.max_memory_allocated() if on_card else None
    if not bool(finite):
        raise AssertionError(f"{cfg.name}: a served logit is not finite")
    if ids.shape != (batch, tokens) or not (0 <= int(ids.min()) and int(ids.max()) < cfg.vocab):
        raise AssertionError(f"{cfg.name}: served ids {tuple(ids.shape)} out of range")
    steps_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    p50 = statistics.median(steps_ms)
    launched = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    if launched:
        raise AssertionError(f"the serving path launched B1-B7 kernels: {launched}")

    # the bound of a decode step at the timed steps' middle offset (the
    # MoE's dense einsum reads every expert)
    work = decode_work(cfg, params, batch, frames, n_ctx + tokens // 2)
    out = {
        "arch": cfg.name,
        "layers": cfg.n_layers,
        "params": n_params,
        "batch": batch,
        "prompt": prompt,
        "context": n_ctx,
        "frames": frames,
        "tokens_generated": batch * tokens,
        "attention_impl": cfg.attention_impl,
        "capacity_factor": cfg.moe.capacity_factor if cfg.moe else None,
        "init_s": init_s,
        "prefill_ms": (marks[0] - t1) * 1e3,
        "decode_p50_ms": p50,
        "decode_steps_ms": steps_ms,
        "decode_tokens_per_s": batch * (tokens - 1) / (marks[-1] - marks[0]),
        "peak_init_bytes": peak_init,
        "peak_serve_bytes": peak_serve,
        "decode_bound_bytes": work["bytes"],
        "decode_bound_parts": work,
        "sample": ids[0, :8].tolist(),
        "check": {
            "decode_vs_forward": ratios,
            "worst": max(ratios),
            "tol": tol,
            "dtype": check_cfg.compute_dtype,
            "metric": "per batch row RMS(cached - forward) / std(forward), worst row",
            "capacity_factor": check_cfg.moe.capacity_factor if cfg.moe else None,
            "why": "bf16 rounds at other points on the two paths; a wrong slot, position or "
                   "mask gives ~1; an MoE is held in f32, its bf16 router re-routes near ties; "
                   "the xLSTM in f32, its layers amplify bf16 rounding differences with depth",
            **({"served_dtype_ratios_not_gated": reported} if reported else {}),
        },
    }
    if cfg.family == "ssm":
        out["slstm_prefill_share"] = slstm_prefill_share(cfg, params, prompts, device)
    if on_card:
        bw = hbm_rate(torch.cuda.get_device_name(0))
        out["decode_bytes_bound_ms"] = work["bytes"] / bw * 1e3
        out["decode_ops_bound_ms"] = work["ops"] / 989e12 * 1e3  # bf16 dense peak
        out["decode_bound_ms"] = max(out["decode_bytes_bound_ms"], out["decode_ops_bound_ms"])
        out["decode_bound_by"] = (
            "bytes" if out["decode_bytes_bound_ms"] >= out["decode_ops_bound_ms"] else "operations"
        )
        out["decode_ms_over_bound"] = p50 / out["decode_bound_ms"]
        # one decode step under the profiler, from a fresh prefill, warm
        prefill = make_prefill_step(cfg, max_len=n_ctx + 3)
        decode = make_decode_step(cfg)
        with torch.inference_mode():
            logits, cache = prefill(params, {"inputs": {"tokens": prompts, **extra}})
            nxt = torch.argmax(logits[:, -1:], dim=-1)
            decode(params, cache, nxt, n_ctx)
            wall_ms, dev = device_profile(lambda: decode(params, cache, nxt, n_ctx + 1))
        del cache, logits
        busy = sum(ms for ms, _, _ in dev)
        out["profile"] = {
            "wall_ms": wall_ms,
            "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms if dev else "not measured",
            "kernel_launches": sum(n for _, n, _ in dev),
            "top": [[key[:90], n, ms] for ms, n, key in dev[:8]],
        }
        out["device_idle_share"] = out["profile"]["device_idle_share"]
        emb = params["embed"]["embedding"]
        out["unembed_f32_copy_ms"] = time_ms(lambda: emb.float(), 10)
        out["unembed_f32_copy_bytes"] = emb.numel() * (emb.element_size() + 4)
        if card:
            out["card"] = card
    log(json.dumps({"serve_path": out}))
    del params, ids
    _free(device)
    return out


def serve_card_vs_cpu(archs=("granite-8b", "internvl2-26b", "deepseek-v2-lite-16b", "xlstm-350m",
                             "recurrentgemma-2b", "whisper-medium")) -> dict:
    """(d): each family's reduced config in f32, the same parameters and
    prompts served on the card and on the CPU: every step's logits within
    SERVE_F32_TOL and the greedy ids equal.  f32 matmuls run in full f32
    on the card (TF32 off, torch's default), which is asserted."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.registry import get_model
    from repro_torch.models.state import params_from_reference, params_to_reference

    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("f32 matmuls on the card would run in TF32")
    out = {}
    for arch in archs:
        cfg = get_config(arch).reduced()
        host = params_to_reference(get_model(cfg).init_params(cfg, SEED, "cpu"))
        runs = {}
        for device in ("cpu", "cuda"):
            prompts, extra = _serve_inputs(cfg, 2, 16, SEED, device, frames=24)
            logs = []
            ids = serve(cfg, params_from_reference(host, device=device), prompts, 8, extra, device,
                        on_step=lambda i, lg, logs=logs: logs.append(lg.cpu()))
            runs[device] = (ids.cpu(), torch.stack(logs))
        err = float((runs["cuda"][1] - runs["cpu"][1]).abs().max())
        if not torch.allclose(runs["cuda"][1], runs["cpu"][1], rtol=SERVE_F32_TOL, atol=SERVE_F32_TOL):
            raise AssertionError(f"{arch} reduced: card logits differ from the CPU's by {err}")
        if not torch.equal(runs["cuda"][0], runs["cpu"][0]):
            raise AssertionError(f"{arch} reduced: card ids {runs['cuda'][0]} != CPU {runs['cpu'][0]}")
        out[arch] = {"max_abs_err": err, "ids_equal": True}
    return out


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    card_line = _card()
    log(f"card: {card_line}")
    kind = torch.cuda.get_device_name(0)
    log(
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, numpy {np.__version__}, "
        f"python {sys.version.split()[0]}"
    )

    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build+load: {time.perf_counter() - t0:.2f} s (nvcc: {_build.build_seconds})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    t0 = time.perf_counter()
    cases = check_kernels("cuda") + check_signcomp("cuda")
    log(f"kernels vs plain versions: {cases} cases bit-exact ({time.perf_counter() - t0:.2f} s)")

    log(
        json.dumps(
            {
                "reduced": {
                    "rows": [PAPER_ROWS, ROWS],
                    "routed_fleet_rows": [ROWS, ROUTED_ROWS],
                    "why": "the smoke's time limit",
                }
            }
        )
    )
    res = main_path("cuda", ROWS)
    rec = res.pop("recorded")
    report = kernel_report(rec, res, kind)
    for name in ("optimize", "plain"):
        per_flush = b1_per_flush(rec.calls[f"mws_{name}"], hbm_rate(kind))
        per_flush["launches_by_variant"] = res[name]["mws_variants_first_flush"]
        log(json.dumps({"b1_per_flush": per_flush, "optimizer": name == "optimize", "card": card_line}))
    del rec
    for r in report:
        log(
            f"kernel {r['name']}: {r['ms']:.4f} ms at {r['shape']}, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['launches']} launches per flush"
        )
    summary = {k: v for k, v in res.items() if isinstance(v, dict)}
    log(json.dumps({"main_path": summary, "rows": ROWS, "words": res["words"], "card": card_line}))
    del res
    gc.collect()

    t0 = time.perf_counter()
    shard = shard_path("cuda", ROWS, ROUTED_ROWS, card=card_line)
    rec = shard.pop("recorded")
    fleet_row = fleet_kernel_row(rec, shard["modes"], kind)
    report.append(fleet_row)
    for mode in ("lockstep", "pipelined"):
        per_flush = b1_per_flush(rec.calls[f"mws_shard_{mode}"], hbm_rate(kind))
        per_flush["launches_by_variant"] = shard["modes"][f"{mode}_count_mask"]["mws_variants_first_flush"]
        log(json.dumps({"b1_per_flush": per_flush, "fleet": mode, "card": card_line}))
    del rec
    log(
        f"kernel {fleet_row['name']}: {fleet_row['ms']:.4f} ms at {fleet_row['shape']}, plain "
        f"{fleet_row['plain_ms']:.4f} ms, bound {fleet_row['bound_ms']:.4f} ms ({fleet_row['bound_by']}), "
        f"{fleet_row['launches']} launches per flush, {fleet_row['variant']} variant"
    )
    log(json.dumps({"shard_path": shard, "card": card_line}))
    log(f"shard path: {time.perf_counter() - t0:.1f} s")
    del shard
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mut = mutation_path("cuda", ROWS, card=card_line)
    log(f"mutation path: {time.perf_counter() - t0:.1f} s, launches {mut['launches']}")
    del mut
    # the 365-day stack (36.5 GB) needs the card to itself: nothing of the
    # FlashQL phases stays resident, and training starts after it is freed
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    bmi = bmi_path("cuda", PAPER_ROWS // 32, card=kind)
    report.append(bmi.pop("row"))
    log(json.dumps({"bmi_path": bmi, "card": card_line}))
    log(f"BMI path: {time.perf_counter() - t0:.1f} s")
    del bmi
    gc.collect()
    torch.cuda.empty_cache()

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    train = train_path("cuda", get_config(TRAIN_ARCH))
    torch.cuda.empty_cache()
    log(json.dumps({"train_path": train, "card": card_line}))
    log(f"training path: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dist_train = dist_train_path("cuda", get_config(TRAIN_ARCH), train, card=card_line)
    log(json.dumps({"dist_train_path": dist_train, "card": card_line}))
    log(f"sharded training path: {time.perf_counter() - t0:.1f} s")
    del dist_train
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(json.dumps({"roofline_path": roofline_path("cuda", get_config(TRAIN_ARCH), card=card_line)}))
    log(f"roofline path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log(json.dumps({"sharded_count": sharded_count_path(card=card_line)}))
    log(f"sharded count path: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    sign_rows = signcomp_report(train["largest_leaf"], train, kind)
    torch.cuda.empty_cache()
    sign_rows.append(majority_phase(train["largest_leaf"], kind))
    for r in sign_rows:
        log(
            f"kernel {r['name']}: {r['ms']:.4f} ms at {r['shape']}, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['launches']} launches"
        )
    report += sign_rows
    del train, sign_rows
    gc.collect()
    torch.cuda.empty_cache()

    # serving runs last: each model is built, served and freed before the
    # next (internvl2-26b's init peaks near 58 GB)
    t0 = time.perf_counter()
    log(json.dumps({"serve_card_vs_cpu": serve_card_vs_cpu(), "tol": SERVE_F32_TOL, "card": card_line}))
    for arch, batch, prompt, tokens, frames, overrides, why in SERVE_RUNS:
        log(f"serve {arch}: batch {batch}, prompt {prompt}, {tokens} new tokens, {frames} frames, "
            f"{overrides} ({why})")
        serve_path("cuda", get_config(arch).with_(**overrides), batch, prompt, tokens, frames,
                   card=card_line)
    log(f"serving path: {time.perf_counter() - t0:.1f} s")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card_line)
    print(json.dumps({"kernels": report}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": kind,
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
