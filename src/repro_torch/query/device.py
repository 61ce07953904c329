"""FlashDevice: the batched multi-plane execution engine.

A :class:`repro_torch.core.engine.FlashArray` executes one plan at a time
with a Python loop over commands.  ``FlashDevice`` extends it for query
serving:

* the page store is packed ``(slots, planes * words_per_plane)`` (see
  :class:`repro_torch.core.store.PackedStore`) — a logical bit vector is
  striped across ``num_planes`` planes, and because planes are word-axis
  shards, ONE kernel launch senses a command on every plane at once;
* a :class:`CommandPlan` compiles to an :class:`ExecPlan`: per MWS command
  a static ``(blocks, wordlines)`` slot-index array (ragged wordline sets
  padded with the store's all-ones identity slot) plus the static ISCM
  flags;
* plans with identical *signatures* (same command structure and shapes,
  different slot indices) execute as one batch: the batch axis is written
  out, so each MWS step of a whole signature group is ONE launch of the
  gather-reduce kernel over ``(B, blocks, wordlines)`` slot indices —
  the snapshot rows are read in place, never copied into a cube;
* **plan-aware batching**: plans of one *family* (same command sequence
  and ISCM flags, narrower gather shapes) pad into the family's widest
  signature — extra wordlines gather the all-ones identity slot, extra
  blocks the all-zeros slot.

Plans that spill lower too: the spilled latch values stay device-resident
(``"spill"`` steps) and later MWS steps read them through negative gather
indices (:func:`encode_idx`), so deep-range chains batch like any other
plan.  The eager :meth:`FlashArray.execute` path remains for plans that
sense non-ESP pages (their reads inject modelled bit errors, which the
batch path never does).

:func:`make_flush_runner` runs a WHOLE flush — every signature group plus
every aggregate reduce — and returns a single flat 32-bit payload (see
:func:`repro_torch.query.compile.compile_flush`).  Where the flush's
plans' AND chains fold over repeated commands, :func:`hoist_flush` has
each command of those chains sensed once; the modelled chip still senses
every command of every plan, so the counters and the wear do not change.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.core.bitops import BitOp
from repro_torch.core.commands import (
    CommandPlan,
    ESPCommand,
    MWSCommand,
    SpillCommand,
    ThresholdCommand,
    TransferCommand,
    XORCommand,
)
from repro_torch.core.engine import FlashArray
from repro_torch.core.store import IDENTITY_SLOT, ZERO_SLOT, PackedStore
from repro_torch.kernels.mws import mws_gather
from repro_torch.kernels.threshold import threshold_reduce


@dataclass(frozen=True)
class _Step:
    """Static part of one executable command (its signature entry)."""

    kind: str  # "mws" | "xor" | "xfer" | "spill"
    # "mws": threshold k for a ThresholdCommand sensing, 0 for the plain
    # wired-OR MWS.  Part of the signature AND the family (family erasure
    # rewrites only ``shape``), so a threshold plan never pads into a
    # plain group — the combine semantics differ.
    k: int = 0
    inverse: bool = False
    init_s: bool = True
    init_c: bool = True
    move: bool = False
    source: str = "C"
    invert: bool = False
    shape: tuple[int, int] = (0, 0)  # (blocks, padded wordlines) for "mws"
    # "mws": (block_pos, wordline_pos, spill ordinal) substitutions — the
    # gathered cube rows replaced by device-resident spilled values; the
    # positions are static, so spilling plans stay pure array programs
    subs: tuple[tuple[int, int, int], ...] = ()
    # "mws": (block_pos, wordline_pos, shared ordinal) substitutions into
    # the flush-level shared-value stack (cross-query CSE): the row is a
    # latch result another plan in the same flush already sensed
    shared: tuple[tuple[int, int, int], ...] = ()
    ordinal: int = 0  # "spill": index into the plan's scratch values


@dataclass(frozen=True)
class ExecPlan:
    """A CommandPlan lowered to gather indices + static step descriptors.

    Spilling plans lower too: each :class:`SpillCommand` becomes a
    ``"spill"`` step that parks the latch value in device-resident scratch
    (a plan-local value list inside the device program — never a store
    write), and later MWS steps that sense the scratch page substitute it
    into the gathered cube at static positions.  Deep-range queries
    therefore batch and join the fused flush reduce like any
    spill-free plan.
    """

    steps: tuple[_Step, ...]
    idxs: tuple[np.ndarray, ...]  # one (blocks, wordlines) array per MWS
    spills: int = 0  # scratch values the plan carries device-side
    # scratch blocks the plan's SpillCommands target: a spill is
    # physically an ESP program, so batched executions charge the same
    # P/E wear the eager path does (see age_spill_blocks)
    spill_blocks: tuple[int, ...] = ()

    @property
    def signature(self) -> tuple[_Step, ...]:
        """Batch key: two plans with equal signatures batch together."""
        return self.steps

    @property
    def family(self) -> tuple[_Step, ...]:
        """Signature with MWS gather shapes erased (plan-aware batching).

        Two plans of one family run the same command sequence with the same
        ISCM flags and differ only in how many (blocks, wordlines) each MWS
        gathers; the narrower plan pads to the wider shape with identity
        slots (see :func:`pad_idx`) and then shares its batch group.
        Scratch substitution positions are NOT erased — they are part of
        the command sequence, and padding never moves them.
        """
        return tuple(
            replace(st, shape=(0, 0)) if st.kind == "mws" else st
            for st in self.steps
        )


def age_spill_blocks(pec: dict, execs) -> None:
    """Charge P/E wear for the scratch programs of batch-executed plans.

    A SpillCommand is physically an ESP program to a scratch wordline; the
    batched paths run it as device-resident latch scratch, but the wear on
    the scratch block is real — this keeps ``pec`` consistent with the
    eager :meth:`FlashArray.execute`, which bumps per SpillCommand.
    """
    for e in execs:
        if e is not None:
            for b in e.spill_blocks:
                pec[b] = pec.get(b, 0) + 1


def pad_idx(idx: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """Pad an MWS gather-index array to ``shape`` without changing results.

    Extra *wordlines* of real blocks gather the all-ones identity slot
    (AND-neutral within a block); extra *blocks* gather the all-zeros slot
    in their first wordline, so they AND to zero and are OR-neutral across
    blocks — and stay so under inverse read, which complements only after
    the cross-block OR.
    """
    b, w = idx.shape
    B, W = shape
    if (b, w) == (B, W):
        return idx
    out = np.full((B, W), IDENTITY_SLOT, dtype=np.int32)
    out[:b, :w] = idx
    if B > b:
        out[b:, 0] = ZERO_SLOT
    return out


def group_execs(
    execs: list["ExecPlan | None"], pad: bool = True
) -> list[tuple[tuple[_Step, ...], list[int], list[np.ndarray]]]:
    """Group batchable plans for batched execution.

    Returns ``(signature, member_indices, stacked_idxs)`` triples, where
    ``stacked_idxs`` holds one ``(B, blocks, wordlines)`` array per MWS
    step.  With ``pad`` set, plans are grouped by :attr:`ExecPlan.family`
    and padded to the family's widest shapes — fewer, larger batch groups;
    otherwise grouping is by exact signature.
    """
    groups: dict[tuple, list[int]] = {}
    for i, e in enumerate(execs):
        if e is not None:
            groups.setdefault(e.family if pad else e.signature, []).append(i)
    out = []
    for key, members in groups.items():
        first = execs[members[0]]
        n_mws = len(first.idxs)
        shapes = [
            (
                max(execs[i].idxs[s].shape[0] for i in members),
                max(execs[i].idxs[s].shape[1] for i in members),
            )
            for s in range(n_mws)
        ]
        it = iter(shapes)
        signature = tuple(
            replace(st, shape=next(it)) if st.kind == "mws" else st
            for st in first.steps
        )
        stacked = [
            np.stack([pad_idx(execs[i].idxs[s], shapes[s]) for i in members])
            for s in range(n_mws)
        ]
        out.append((signature, members, stacked))
    return out


def encode_idx(
    signature: tuple[_Step, ...], stacked: list[np.ndarray]
) -> list[np.ndarray]:
    """Gather indices of a signature group with its substitutions encoded.

    ``stacked`` holds one ``(B, blocks, wordlines)`` slot array per MWS
    step (placeholders at substituted positions).  A spilled value of
    scratch ordinal ``o`` becomes index ``-1 - o``; a shared CSE value
    ``k`` becomes ``-1 - m - k``, where ``m`` is the number of scratch
    values the step passes (``len(scratch)`` when it has spill
    substitutions, else 0) — the row naming the kernel decodes (see
    ``csrc/mws.cu``).
    """
    out = []
    it = iter(stacked)
    spills = 0
    for st in signature:
        if st.kind == "spill":
            spills += 1
        if st.kind != "mws":
            continue
        idx = next(it)
        if st.subs or st.shared:
            idx = idx.copy()
            m = spills if st.subs else 0
            for bi, wi, o in st.subs:
                idx[:, bi, wi] = -1 - o
            for bi, wi, k in st.shared:
                idx[:, bi, wi] = -1 - m - k
        out.append(np.ascontiguousarray(idx, dtype=np.int32))
    return out


def reorder_rows(pieces: list[torch.Tensor], order: list[int]) -> torch.Tensor:
    """Concatenate per-group output blocks and restore input order with a
    single inverse-permutation gather (never per-row slicing)."""
    allout = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
    inv = np.empty(len(order), dtype=np.int64)
    inv[np.asarray(order)] = np.arange(len(order), dtype=np.int64)
    return allout[torch.as_tensor(inv, device=allout.device)]


def plan_step_fn(signature: tuple[_Step, ...]):
    """Batched executor for one signature: ``run(data, shared, *idxs)``.

    ``data`` is the ``(slots, words)`` snapshot and each ``idxs`` entry the
    :func:`encode_idx`-encoded ``(B, blocks, wordlines)`` gather indices of
    one MWS step; returns the ``(B, words)`` results.  ``"spill"`` steps
    park the latch value in a plan-local scratch list, which MWS steps
    with substitutions pass to the kernel as its per-plan extra rows;
    ``shared`` is the flush-level CSE value stack (``(K, words)`` or None),
    passed as the kernel's shared rows.
    """

    def run(data: torch.Tensor, shared, *idxs: torch.Tensor) -> torch.Tensor:
        s = c = out = None
        scratch: list[torch.Tensor] = []
        it = iter(idxs)
        for st in signature:
            if st.kind == "mws":
                idx = next(it)
                ext = torch.stack(scratch, dim=1) if st.subs else None
                shr = shared if st.shared else None
                if st.k:
                    per_block = mws_gather(
                        data, idx, BitOp.AND, outer_or=False, ext=ext, shr=shr
                    )
                    raw = threshold_reduce(per_block, st.k, invert=st.inverse)
                else:
                    raw = mws_gather(
                        data, idx, BitOp.AND, invert=st.inverse, ext=ext, shr=shr
                    )
                s = raw if (st.init_s or s is None) else s & raw
                if st.init_c:
                    c = None
                if st.move:
                    c = s if c is None else c | s
            elif st.kind == "spill":
                assert st.ordinal == len(scratch)
                scratch.append(s if st.source == "S" else c)
            elif st.kind == "xor":
                c = s ^ c
            else:
                val = s if st.source == "S" else c
                out = ~val if st.invert else val
        assert out is not None, "plan missing TransferCommand"
        return out

    return run


def make_plan_runner(signature: tuple[_Step, ...]):
    """Executor for one plan signature: ``run(data, *idxs)`` over one
    ``(slots, words)`` source shared by every batch element.

    A sharded fleet runs one signature group across every shard with the
    same runner: ``data`` is then the fleet tensor viewed as one
    ``(shards * cap, words)`` source and each batch element's slot indices
    are shifted into its own shard's rows (:func:`offset_slots`) — no
    snapshot is copied or stacked."""
    run_one = plan_step_fn(signature)
    return lambda data, *idxs: run_one(data, None, *idxs)


def offset_slots(idx: np.ndarray, base: np.ndarray) -> np.ndarray:
    """Shift an :func:`encode_idx` array ``(B, blocks, wordlines)`` into a
    fleet source: every slot index of batch element ``b`` gains
    ``base[b]`` (its shard's first row in the fleet); the negative
    entries, which name substituted spill/shared rows, stay as they are."""
    shift = np.asarray(base, dtype=np.int64).reshape(-1, 1, 1)
    out = np.where(idx >= 0, idx + shift, idx)
    if out.size and out.max() > np.iinfo(np.int32).max:
        raise ValueError("fleet source has more rows than int32 indices reach")
    return np.ascontiguousarray(out, dtype=np.int32)


def _hoistable(st: _Step) -> bool:
    """A plain MWS step whose command is one gather row of store slots."""
    return st.kind == "mws" and not (st.k or st.subs or st.shared)


def _pure_and_chain(signature: tuple[_Step, ...]) -> bool:
    """Whether a plan is ``S = AND of its commands``, then a transfer of S:
    one latch initialisation, plain non-inverted senses, nothing else."""
    *mws, last = signature
    return (
        bool(mws)
        and last.kind == "xfer"
        and last.source == "S"
        and mws[0].init_s
        and all(
            _hoistable(st) and not (st.inverse or st.move) for st in mws
        )
        and not any(st.init_s for st in mws[1:])
    )


def _pad_wordlines(idx: np.ndarray, n: int) -> np.ndarray:
    """Pad the last axis to ``n`` by repeating each block's first entry:
    an AND within a block, and an OR over blocks, ignore repeats."""
    extra = n - idx.shape[-1]
    if not extra:
        return idx
    return np.concatenate(
        [idx, np.repeat(idx[..., :1], extra, axis=-1)], axis=-1
    )


@dataclass(frozen=True)
class FlushHoist:
    """The commands a fused flush senses once, for the AND chains that fold.

    ``sense`` holds one ``(H, blocks, wordlines)`` slot array per launch
    (commands of equal block count, wordlines padded by repetition): each
    command of the groups that fold, once.  Their outputs are the hoisted
    stack, which follows the flush's CSE values in the shared rows.
    ``folds`` holds ``(invert, (P, 1, n))`` per fold launch: each plan of a
    folding group is one row, a gather over its hoisted rows.  ``folded``
    marks the batch groups that fold; the others run as
    :func:`group_execs` built them.  ``order`` is the plan order of the
    concatenated outputs (the folds', then the other groups' members in
    group order), and ``saved`` the command sensings the folds save.
    """

    sense: tuple[np.ndarray, ...]
    folds: tuple[tuple[bool, np.ndarray], ...]
    folded: tuple[bool, ...]
    order: list[int]
    saved: int

    @property
    def key(self) -> tuple:
        """The structure a flush runner needs (shapes and flags only)."""
        return (
            tuple(x.shape for x in self.sense),
            tuple((inv, x.shape) for inv, x in self.folds),
            self.folded,
        )


def hoist_flush(
    execs: list[ExecPlan], groups: list[tuple], n_shared: int
) -> FlushHoist | None:
    """Plan the fused flush's folds and the commands they sense once.

    A command is a plain MWS step's gather row (``_hoistable``); two are
    the same when their slot arrays are equal.  A command read ``occ``
    times over ``rows`` slots repeats when sensing it once would save
    bytes (``rows`` reads, one write, then one row a read):
    ``(occ - 1) * rows > occ + 1``.  A batch group of pure AND chains
    (:func:`_pure_and_chain`) in which every plan names a repeated command
    folds: every command of its plans is sensed once, and each plan
    becomes one row of a fold launch, which drops the chain's per-step
    launches and ``s & raw`` passes.  Groups that do not fold run as built
    by :func:`group_execs` and sense their commands themselves, repeated
    or not; a flush in which no group folds returns None.  ``execs`` are
    the groups' (unpadded) plans and ``n_shared`` the flush's CSE value
    count.
    """
    where: dict[tuple, list[tuple[int, int, int]]] = {}
    for g, (signature, members, _stacked) in enumerate(groups):
        mws = [st for st in signature if st.kind == "mws"]
        for s, st in enumerate(mws):
            if _hoistable(st):
                for j, i in enumerate(members):
                    idx = execs[i].idxs[s]
                    where.setdefault((idx.shape, idx.tobytes()), []).append(
                        (g, j, s)
                    )
    repeats = {
        c
        for c, at in where.items()
        if (len(at) - 1) * int(np.prod(c[0])) > len(at) + 1
    }
    if not repeats:
        return None

    def command(i: int, s: int) -> tuple:
        idx = execs[i].idxs[s]
        return (idx.shape, idx.tobytes())

    folded = tuple(
        _pure_and_chain(signature)
        and all(
            any(command(i, s) in repeats for s in range(len(execs[i].idxs)))
            for i in members
        )
        for signature, members, _stacked in groups
    )
    if not any(folded):
        return None
    hoisted = {
        command(i, s)
        for (_sig, members, _stacked), f in zip(groups, folded)
        if f
        for i in members
        for s in range(len(execs[i].idxs))
    }
    # the stack: commands of one block count share a launch
    by_blocks: dict[int, list[tuple]] = {}
    for c in sorted(hoisted, key=lambda c: where[c][0]):
        by_blocks.setdefault(c[0][0], []).append(c)
    row: dict[tuple, int] = {}
    sense = []
    for cmds in by_blocks.values():
        n = max(c[0][1] for c in cmds)
        rows = []
        for c in cmds:
            row[c] = n_shared + len(row)
            rows.append(
                _pad_wordlines(np.frombuffer(c[1], np.int32).reshape(c[0]), n)
            )
        sense.append(np.stack(rows))

    uses = 0
    folds: dict[bool, list[tuple[int, list[int]]]] = {}  # (plan, rows)
    for (signature, members, _stacked), f in zip(groups, folded):
        if f:
            inv = signature[-1].invert
            for i in members:
                rows = [row[command(i, s)] for s in range(len(execs[i].idxs))]
                folds.setdefault(inv, []).append((i, rows))
                uses += len(rows)
    fold_arrays = []
    order: list[int] = []
    for inv, plans in folds.items():
        n = max(len(rows) for _i, rows in plans)
        padded = [_pad_wordlines(np.asarray(rows, np.int32), n) for _i, rows in plans]
        fold_arrays.append((inv, np.stack(padded)[:, None, :]))
        order.extend(i for i, _rows in plans)
    order.extend(
        i
        for (_sig, members, _stacked), f in zip(groups, folded)
        if not f
        for i in members
    )
    return FlushHoist(
        sense=tuple(sense),
        folds=tuple(fold_arrays),
        folded=folded,
        order=order,
        saved=uses - len(hoisted),
    )


def make_flush_runner(key: tuple):
    """Build the function executing a whole flush signature.

    ``key`` is the flush signature: ``(sense, reduce, w, cse, hoist)``
    where ``sense`` is a tuple of ``(plan signature, member count)`` per
    batch group, ``reduce`` a tuple of ``(aggregator kind, reduce_sig,
    member count, extra-plane count)`` per reduce group, ``w`` the store's
    logical word count, ``cse`` a tuple of shared-plan signatures — the
    cross-query common subexpressions this flush senses ONCE — and
    ``hoist`` the :attr:`FlushHoist.key` of the commands it senses once
    (``()`` for none).  The returned ``run(data, group_idxs, inv_perm,
    mask, sels, extras, cse_idxs, hoist_idxs, fold_idxs)`` runs everything
    a flush does on the device — the shared sensings, the hoisted
    commands and the fold launches, the per-group gather-reduce + latch
    algebra (``group_idxs`` for the groups that do not fold), the
    member-order gather (``inv_perm`` maps members onto deduplicated
    unique-plan rows), validity masking, and every aggregate's reduce —
    and returns ONE flat int32 payload (see
    :func:`repro_torch.query.aggregate.unpack_group`): one host transfer
    per flush, however many groups and aggregate kinds it mixes.
    """
    from repro_torch.query.aggregate import kind_reduce, payload_words

    sense, reduce_sigs, w, cse, hoist = key
    hoist_shapes, fold_keys, folded = hoist or ((), (), (False,) * len(sense))
    group_fns = [
        plan_step_fn(psig) for (psig, _n), f in zip(sense, folded) if not f
    ]
    cse_fns = [plan_step_fn(psig) for psig in cse]
    n_hoisted = sum(shape[0] for shape in hoist_shapes)

    def run(
        data, group_idxs, inv_perm, mask, sels, extras, cse_idxs, hoist_idxs, fold_idxs
    ):
        shared = None
        if cse or hoist:
            # the shared rows: the CSE values (one plan each, B = 1), then
            # the hoisted commands, each launch writing its rows in place;
            # members read them through the kernel's shared-row source
            shared = torch.empty(
                (len(cse) + n_hoisted, data.shape[1]),
                dtype=data.dtype,
                device=data.device,
            )
            if cse:
                torch.cat(
                    [fn(data, None, *idxs) for fn, idxs in zip(cse_fns, cse_idxs)],
                    out=shared[: len(cse)],
                )
            r = len(cse)
            for idx in hoist_idxs:
                mws_gather(data, idx, BitOp.AND, out=shared[r : r + len(idx)])
                r += len(idx)
        pieces = [
            mws_gather(shared, idx, BitOp.AND, invert=inv)[:, :w]
            for (inv, _shape), idx in zip(fold_keys, fold_idxs)
        ] + [
            fn(data, shared, *idxs)[:, :w]
            for fn, idxs in zip(group_fns, group_idxs)
        ]
        allout = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
        masked = allout[inv_perm] & mask  # member order, padding zeroed
        parts = []
        for (kind, sig, _n, _p), sel, ex in zip(reduce_sigs, sels, extras):
            sub = masked if sel is None else masked[sel]
            parts.extend(payload_words(kind_reduce(kind, sub, ex, sig)))
        return torch.cat(parts)

    return run


@dataclass
class FlashDevice(FlashArray):
    """Multi-plane Flash-Cosmos device with batched plan execution."""

    num_planes: int = 4
    # plan-aware batching: pad narrower plans into a family's widest
    # signature so one batch group covers every shape variant of a family
    pad_signatures: bool = True
    last_signature_groups: int = 0  # groups dispatched by the last batch
    last_eager_plans: int = 0  # noisy-page eager fallbacks in the last batch
    _runners: dict = field(default_factory=dict, repr=False)
    # prepared-batch cache: grouping + device-resident idx uploads per
    # recurring batch composition (see execute_batch_stacked's batch_key)
    _batch_cache: dict = field(default_factory=dict, repr=False)
    # attached by the owning scheduler (repro_torch.query.telemetry.Telemetry):
    # counts runner builds and prepared-batch cache traffic
    telemetry: object = field(default=None, repr=False)

    def __post_init__(self):
        super().__post_init__()
        if self.store.planes != self.num_planes:
            if len(self.store):
                raise ValueError(
                    "cannot re-stripe a non-empty store; construct the "
                    "device with store=PackedStore(planes=num_planes)"
                )
            self.store = PackedStore(planes=self.num_planes)

    def reset_after_rebuild(self) -> None:
        """Drop prepared-batch state after :meth:`erase_rebuild`.

        Batch-cache keys embed plan-cache keys whose epochs can never be
        minted again, so the entries are unreachable — clearing just frees
        them (and their device index tensors) eagerly.  Runners stay: they
        are keyed on structural signatures and serve the rebuilt store.
        """
        self._batch_cache.clear()
        self.last_signature_groups = 0
        self.last_eager_plans = 0

    # -- plan lowering -----------------------------------------------------
    def build_exec(
        self,
        plan: CommandPlan,
        shared: dict[str, int] | None = None,
        layout=None,
    ) -> ExecPlan | None:
        """Lower a plan (spilling or not) to a batchable ExecPlan.

        Spill commands lower to ``"spill"`` steps whose values stay
        device-resident; MWS commands that re-sense a spilled scratch page
        record a static substitution instead of a store slot, so the whole
        plan — deep-range chains included — is a pure function of the
        packed snapshot and joins the fused and batched execution paths.

        ``shared`` maps virtual CSE page names to ordinals in the flush's
        shared-value stack: sensing one records a ``shared`` substitution
        instead of a store slot (the value is another plan's latch result,
        resident only inside the fused program).  ``layout`` overrides the
        device layout for name resolution — CSE member plans compile
        against a fork that additionally places the virtual pages.
        """
        lay = self.layout if layout is None else layout
        steps: list[_Step] = []
        idxs: list[np.ndarray] = []
        scratch_ord: dict[str, int] = {}
        spill_blocks: list[int] = []
        for cmd in plan.commands:
            if isinstance(cmd, MWSCommand):
                n_max = max(len(t.wordlines) for t in cmd.targets)
                idx = np.full(
                    (len(cmd.targets), n_max), IDENTITY_SLOT, dtype=np.int32
                )
                subs: list[tuple[int, int, int]] = []
                shared_subs: list[tuple[int, int, int]] = []
                for bi, t in enumerate(cmd.targets):
                    for wi, wl in enumerate(t.wordlines):
                        name = lay.page_at(t.block, wl)
                        if name in scratch_ord:
                            subs.append((bi, wi, scratch_ord[name]))
                            continue  # placeholder gathers the identity row
                        if shared and name in shared:
                            shared_subs.append((bi, wi, shared[name]))
                            continue
                        idx[bi, wi] = self.store.slot(name)
                steps.append(
                    _Step(
                        "mws",
                        k=cmd.k if isinstance(cmd, ThresholdCommand) else 0,
                        inverse=cmd.iscm.inverse_read,
                        init_s=cmd.iscm.init_s_latch,
                        init_c=cmd.iscm.init_c_latch,
                        move=cmd.iscm.move_s_to_c,
                        shape=(len(cmd.targets), n_max),
                        subs=tuple(subs),
                        shared=tuple(shared_subs),
                    )
                )
                idxs.append(idx)
            elif isinstance(cmd, SpillCommand):
                steps.append(
                    _Step(
                        "spill",
                        source=cmd.source,
                        ordinal=len(scratch_ord),
                    )
                )
                scratch_ord[cmd.page_name] = len(scratch_ord)
                spill_blocks.append(cmd.block)
            elif isinstance(cmd, XORCommand):
                steps.append(_Step("xor"))
            elif isinstance(cmd, TransferCommand):
                steps.append(
                    _Step("xfer", source=cmd.source, invert=cmd.invert)
                )
            elif isinstance(cmd, ESPCommand):
                raise AssertionError("data writes flow through fc_write")
        return ExecPlan(
            tuple(steps),
            tuple(idxs),
            spills=len(scratch_ord),
            spill_blocks=tuple(spill_blocks),
        )

    # -- batched execution -------------------------------------------------
    def _runner(self, signature: tuple[_Step, ...]):
        fn = self._runners.get(signature)
        if fn is None:
            fn = make_plan_runner(signature)
            self._runners[signature] = fn
            if self.telemetry is not None:
                self.telemetry.count("runner_builds")
        return fn

    def _prepare_batch(
        self, execs: list[ExecPlan | None], batch_key=None
    ) -> tuple[list[tuple], tuple[int, ...]]:
        """Group + pad execs and upload their encoded gather indices.

        Returns ``(groups, eager_ix)``: the batch groups plus the indices
        of plans demoted to the eager path — spilling plans that sense a
        non-ESP page keep their error-injecting execution (the batch path
        never injects read errors); a spill-free plan over a non-ESP page
        raises.  With ``batch_key`` (any hashable derived from the
        plan-cache keys, whose epochs make staleness impossible) the
        prepared groups are memoized, host->device index upload included.
        """
        if batch_key is not None:
            prepared = self._batch_cache.get(batch_key)
            if prepared is not None:
                if self.telemetry is not None:
                    self.telemetry.count("batch_cache_hits")
                return prepared
            if self.telemetry is not None:
                self.telemetry.count("batch_cache_misses")
        noisy_slots = {
            self.store.slot(n) for n in self._non_esp if n in self.store
        }
        eager_ix: list[int] = []
        use = list(execs)
        if noisy_slots:
            for i, e in enumerate(execs):
                if e is not None and any(
                    bool(np.isin(idx, list(noisy_slots)).any())
                    for idx in e.idxs
                ):
                    if e.spills:
                        use[i] = None  # eager fallback injects the errors
                        eager_ix.append(i)
                    else:
                        raise ValueError(
                            "batched execution senses a non-ESP page; "
                            "reprogram it with esp=True or execute eagerly"
                        )
        prepared = (
            [
                (
                    signature,
                    members,
                    tuple(
                        torch.as_tensor(x, device=self.device)
                        for x in encode_idx(signature, stacked)
                    ),
                )
                for signature, members, stacked in group_execs(
                    use, pad=self.pad_signatures
                )
            ],
            tuple(eager_ix),
        )
        if batch_key is not None:
            if len(self._batch_cache) >= 64:  # bound recurring compositions
                self._batch_cache.clear()
            self._batch_cache[batch_key] = prepared
        return prepared

    def execute_batch_stacked(
        self,
        plans: list[CommandPlan],
        seed: int = 0,
        execs: list[ExecPlan | None] | None = None,
        batch_key=None,
    ) -> torch.Tensor:
        """Execute independent plans; returns ``(B, num_words)`` results in
        input order as ONE stacked tensor.

        The whole batch costs O(signature groups) kernel launches per MWS
        step — group outputs are concatenated and re-ordered with a single
        gather.  Every page a batched plan senses must be ESP-programmed;
        spilling plans over noisy pages demote to the eager
        error-injecting path.  Pass ``execs`` (from :meth:`build_exec`) to
        skip re-lowering, and ``batch_key`` to memoize the grouping.
        """
        if execs is None:
            execs = [self.build_exec(p) for p in plans]
        groups, eager_ix = self._prepare_batch(execs, batch_key)
        self.last_signature_groups = len(groups)
        self.last_eager_plans = len(eager_ix) + sum(
            1 for e in execs if e is None
        )

        w = self.store.num_words
        pieces: list[torch.Tensor] = []  # (B_g, w) per group / eager plan
        order: list[int] = []
        if groups:
            data = self.store.snapshot(self.device)
            for signature, members, idxs in groups:
                out = self._runner(signature)(data, *idxs)  # (B_g, Wp)
                pieces.append(out[:, :w])
                order.extend(members)
        for i, e in enumerate(execs):
            if e is None or i in eager_ix:  # noisy-page eager fallback
                # execute() charges its own spill wear
                pieces.append(self.execute(plans[i], seed=seed + i)[None])
                order.append(i)
            elif e.spill_blocks:
                age_spill_blocks(self.pec, (e,))
        if not pieces:
            return torch.zeros((0, w or 0), dtype=torch.int32, device=self.device)
        return reorder_rows(pieces, order)

    def execute_batch(
        self,
        plans: list[CommandPlan],
        seed: int = 0,
        execs: list[ExecPlan | None] | None = None,
    ) -> list[torch.Tensor]:
        """List-of-tensors variant of :meth:`execute_batch_stacked`."""
        stacked = self.execute_batch_stacked(plans, seed=seed, execs=execs)
        return [stacked[i] for i in range(len(plans))]
