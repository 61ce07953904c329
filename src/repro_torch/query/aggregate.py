"""Pluggable aggregation pipeline: every aggregate is an :class:`Aggregator`.

An :class:`Aggregator` declares

* **extra sensed planes** (:meth:`Aggregator.extra_pages`) — the BSI slices
  and/or equality bitmaps of its target column, fetched through
  :func:`repro_torch.query.bitmap.fetch_pages`;
* **a batched device-side reduce** (:meth:`Aggregator.batch_reduce`) — one
  (weighted-)popcount over the stacked result bitmaps of a flush:
  ``SUM = Σ_b 2^b · popcount(mask ∧ slice_b)``, ``MIN``/``MAX`` walk the
  slices MSB→LSB narrowing a candidate mask, ``AVG = SUM / COUNT``, and
  ``TOP-K`` / ``GROUP BY`` count per-group masks from the equality bitmaps;
* **a shard-merge rule** (:meth:`Aggregator.merge`) — sum partials, take
  the min/max, merge count vectors, or un-stripe bitmaps.

``COUNT`` and ``MASK`` are trivial instances of the same interface.  The
intersections (``mask ∧ page``) and the MIN/MAX walk are plain torch ops;
every popcount goes through :func:`repro_torch.kernels.popcount.popcount`,
so on the card one popcount kernel launch covers a whole reduce group.
:func:`reduce_flush` is the per-group driver of the legacy flush path: it
groups a flush's members by *reduce signature* (aggregator kind + static
shapes) and costs one reduce and one host transfer per group.

Exact-integer guarantee: the device only ever produces popcounts (int32);
the 2^b weighting happens host-side in Python integers, so SUM and the AVG
numerator are exact at any bit width.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Iterable, Mapping

import numpy as np
import torch

from repro_torch.core.bitops import BitVector
from repro_torch.kernels.popcount import popcount
from repro_torch.query.ast import (
    AggSpec,
    Avg,
    Count,
    GroupBy,
    Mask,
    Max,
    Min,
    Query,
    Sum,
    TopK,
    columns_of,
    normalize_agg,
    pred_columns,
)
from repro_torch.query.bitmap import BitmapStore, bsi_pages, eq_pages, fetch_pages

# -- batched reduces ---------------------------------------------------------


def sliced_counts(masks: torch.Tensor, extras: torch.Tensor) -> torch.Tensor:
    """``(B, P)`` popcounts of ``mask ∧ page`` for every member × page:
    one intersection and ONE batched popcount over ``(B·P, W)`` rows."""
    b, p, w = extras.shape
    inter = masks[:, None, :] & extras
    return popcount(inter.reshape(b * p, w)).reshape(b, p)


def sliced_counts_with_total(masks: torch.Tensor, extras: torch.Tensor) -> torch.Tensor:
    """``(B, P+1)``: per-slice popcounts plus the plain mask popcount in
    the last column (AVG's numerator slices and denominator, one launch)."""
    aug = torch.cat([extras, masks[:, None, :]], dim=1)
    return sliced_counts(masks, aug)


def bsi_extreme(
    masks: torch.Tensor, extras: torch.Tensor, *, maximize: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bit-sliced MIN/MAX walk over ``(B, bits, W)`` BSI slices.

    MSB→LSB, a candidate mask narrows to the rows still extremal: for MAX,
    if any candidate has bit b set, the extremum does too and candidates
    without it drop out; MIN walks the complemented slice.  Returns the
    per-bit decisions ``(B, bits)`` (LSB first) and a per-member non-empty
    flag — the host assembles the exact integer, so any bit width works.
    """
    bits = extras.shape[1]
    cand = masks
    decisions = []
    for b in range(bits - 1, -1, -1):
        sl = extras[:, b, :]
        # cand has no padding bits (masks are validity-masked), so the
        # complement's padding ones never enter the candidate set
        t = cand & (sl if maximize else ~sl)
        nz = (t != 0).any(dim=-1)
        cand = torch.where(nz[:, None], t, cand)
        decisions.append(nz if maximize else ~nz)
    dec = torch.stack(decisions[::-1], dim=1)
    return dec, (masks != 0).any(dim=-1)


def pervalue_counts(masks: torch.Tensor, extras: torch.Tensor, *, groups: int, bits: int):
    """Per-group popcounts for TOP-K / GROUP BY.

    ``extras`` stacks ``groups`` equality bitmaps then ``bits`` BSI slices
    of the inner-aggregate column (``bits == 0`` for plain counts).  Group
    counts and per-(group, slice) counts run as ONE batched popcount over
    ``(B·G + B·G·bits, W)`` rows.
    """
    b, _, w = extras.shape
    gm = masks[:, None, :] & extras[:, :groups, :]  # (B, G, W)
    if not bits:
        return popcount(gm.reshape(b * groups, w)).reshape(b, groups)
    sl = extras[:, groups:, :]
    inter = gm[:, :, None, :] & sl[:, None, :, :]  # (B, G, bits, W)
    rows = torch.cat([gm.reshape(b * groups, w), inter.reshape(b * groups * bits, w)])
    counts = popcount(rows)
    return (
        counts[: b * groups].reshape(b, groups),
        counts[b * groups :].reshape(b, groups, bits),
    )


def _weighted(counts: Iterable) -> int:
    """Exact Σ 2^b · count_b in Python integers (LSB first)."""
    return sum(int(c) << b for b, c in enumerate(counts))


def payload_words(out) -> list[torch.Tensor]:
    """The flat int32 pieces of one reduce's output leaves (a tensor or a
    tuple of them): counts and MASK words as they are, MIN/MAX's bool
    leaves as 32-bit 0/1 — the layout :func:`unpack_group` reads back."""
    leaves = out if isinstance(out, tuple) else (out,)
    return [leaf.reshape(-1).to(torch.int32) for leaf in leaves]


# -- the interface -----------------------------------------------------------


@dataclass(frozen=True)
class Aggregator:
    """One aggregate's execution semantics (see module docstring).

    Stateless and cached per spec (:func:`get_aggregator`); everything a
    flush needs is parameterized on the :class:`BitmapStore` whose pages
    the member's predicate was evaluated against.
    """

    spec: AggSpec
    kind = "abstract"
    # does the SSD projection model host-side postprocessing (popcounts /
    # arithmetic) for this aggregate, or does the bitmap stream out raw?
    host_postprocess = True

    # -- admission-time validation
    def validate(self, columns: Mapping[str, object]) -> None:
        """Raise before a bad query can enter a flush (queue poisoning)."""

    # -- extra sensed planes
    def extra_pages(self, store: BitmapStore) -> tuple[str, ...]:
        return ()

    def reduce_sig(self, store: BitmapStore) -> tuple:
        """Static part of the batched reduce: members of one flush with
        equal ``(kind,) + reduce_sig`` reduce together in one launch."""
        return ()

    # -- batched device-side reduce
    def batch_reduce(self, masks, extras, sig: tuple):
        """Reduce ``(B, W)`` int32 result bitmaps (+ ``(B, P, W)`` extra
        planes) to per-member device values.  Depends only on ``(masks,
        extras, sig)`` — never on ``self.spec`` — so the fused flush
        program can run a reduce from ``(kind, sig)`` alone
        (:func:`kind_reduce`); the tensors' device picks kernel or plain
        version."""
        raise NotImplementedError

    def payload_leaves(
        self, sig: tuple, b: int, w: int
    ) -> tuple[tuple[tuple[int, ...], object], ...]:
        """``(shape, dtype)`` of every :meth:`batch_reduce` output leaf for
        a ``b``-member group over ``w``-word bitmaps — the static layout of
        this group's slice of a fused flush's single 32-bit payload."""
        raise NotImplementedError

    def member_partial(self, host, j: int):
        """Slice member ``j``'s partial out of the host-transferred reduce
        output (the per-shard unit :meth:`merge` combines)."""
        raise NotImplementedError

    def empty_partial(self, store: BitmapStore):
        """The partial of a shard whose stripe provably cannot match."""
        raise NotImplementedError

    # -- gather
    def finalize(self, partial, store: BitmapStore):
        """Partial -> final value on a single (unsharded) store."""
        raise NotImplementedError

    def merge(self, parts: dict[int, object], sstore) -> object:
        """Shard partials -> final value (``sstore``: a sharded store)."""
        raise NotImplementedError

    # -- helpers
    def _column(self) -> str:
        return self.spec.column

    def _require(self, columns: Mapping[str, object], name: str) -> None:
        if name not in columns:
            raise KeyError(f"unknown aggregate column {name!r} for {self.kind.upper()}")

    def _first_store(self, parts: dict[int, object], sstore) -> BitmapStore:
        return sstore.shards[next(iter(parts))]


class CountAggregator(Aggregator):
    kind = "count"

    def batch_reduce(self, masks, extras, sig):
        return popcount(masks)

    def payload_leaves(self, sig, b, w):
        return (((b,), np.int64),)

    def member_partial(self, host, j):
        return int(host[j])

    def empty_partial(self, store):
        return 0

    def finalize(self, partial, store):
        return partial

    def merge(self, parts, sstore):
        return sum(parts.values())


class MaskAggregator(Aggregator):
    kind = "mask"
    host_postprocess = False  # the bitmap streams out as-is

    def batch_reduce(self, masks, extras, sig):
        return masks

    def payload_leaves(self, sig, b, w):
        return (((b, w), np.uint32),)

    def member_partial(self, host, j):
        return host[j]  # (W,) uint32 words

    def empty_partial(self, store):
        return np.zeros((store.words,), np.uint32)

    def finalize(self, partial, store):
        # keep the host words as-is: no re-upload on the serving path
        return BitVector(partial, store.num_rows)

    def merge(self, parts, sstore):
        return merge_mask_batch([parts], sstore)[0]


def merge_mask_batch(parts_list, sstore) -> list:
    """Un-stripe a whole flush's MASK tickets in one fused numpy pass.

    ``parts_list`` holds each MASK ticket's shard partials (dicts of shard
    -> host words).  Every shard's words stack across tickets first, so
    the flush costs ONE unpackbits + scatter per shard and ONE packbits
    total.  Returns one :class:`BitVector` per ticket, in order.
    """
    t_count = len(parts_list)
    bits = np.zeros((t_count, sstore.num_rows), dtype=np.uint8)
    shards = sorted({s for parts in parts_list for s in parts})
    for s in shards:
        n_s = sstore.shards[s].num_rows
        rows = [t for t in range(t_count) if s in parts_list[t]]
        words = np.ascontiguousarray(
            np.stack([np.asarray(parts_list[t][s]) for t in rows])
        )
        unpacked = np.unpackbits(
            words.view(np.uint8), axis=1, bitorder="little"
        )[:, :n_s]
        bits[
            np.asarray(rows, np.intp)[:, None],
            sstore.row_maps[s][None, :],
        ] = unpacked
    pad = (sstore.num_rows + 31) // 32 * 32
    span = np.zeros((t_count, pad), dtype=np.uint8)
    span[:, : sstore.num_rows] = bits
    packed = np.packbits(span, axis=1, bitorder="little").view(np.uint32)
    return [BitVector(packed[t], sstore.num_rows) for t in range(t_count)]


class SumAggregator(Aggregator):
    kind = "sum"

    def validate(self, columns):
        self._require(columns, self._column())

    def extra_pages(self, store):
        return bsi_pages(store, self._column())

    def reduce_sig(self, store):
        return (store.columns[self._column()].bits,)

    def batch_reduce(self, masks, extras, sig):
        return sliced_counts(masks, extras)

    def payload_leaves(self, sig, b, w):
        return (((b, sig[0]), np.int64),)

    def member_partial(self, host, j):
        return host[j]  # (bits,) per-slice popcounts

    def empty_partial(self, store):
        return np.zeros((store.columns[self._column()].bits,), np.int64)

    def finalize(self, partial, store):
        return _weighted(partial)

    def merge(self, parts, sstore):
        return sum(_weighted(p) for p in parts.values())


class AvgAggregator(SumAggregator):
    kind = "avg"

    def batch_reduce(self, masks, extras, sig):
        return sliced_counts_with_total(masks, extras)

    def payload_leaves(self, sig, b, w):
        return (((b, sig[0] + 1), np.int64),)

    def member_partial(self, host, j):
        return host[j]  # (bits + 1,): slice popcounts + row count

    def empty_partial(self, store):
        return np.zeros((store.columns[self._column()].bits + 1,), np.int64)

    def finalize(self, partial, store):
        count = int(partial[-1])
        if not count:
            return None
        return _weighted(partial[:-1]) / count

    def merge(self, parts, sstore):
        total = np.sum(
            np.stack([np.asarray(p) for p in parts.values()]), axis=0, dtype=np.int64
        )
        return self.finalize(total, self._first_store(parts, sstore))


class ExtremeAggregator(Aggregator):
    """Shared MIN/MAX implementation (the walk differs by one flag)."""

    maximize = False

    def validate(self, columns):
        self._require(columns, self._column())

    def extra_pages(self, store):
        return bsi_pages(store, self._column())

    def reduce_sig(self, store):
        return (store.columns[self._column()].bits, self.maximize)

    def batch_reduce(self, masks, extras, sig):
        # maximize comes from sig (not self.spec) so the fused flush
        # program can run this reduce from the group key alone
        return bsi_extreme(masks, extras, maximize=sig[1])

    def payload_leaves(self, sig, b, w):
        return (((b, sig[0]), np.bool_), ((b,), np.bool_))

    def member_partial(self, host, j):
        dec, nonempty = host
        return (np.asarray(dec[j]), bool(nonempty[j]))

    def empty_partial(self, store):
        bits = store.columns[self._column()].bits
        return (np.zeros((bits,), bool), False)

    def finalize(self, partial, store):
        dec, nonempty = partial
        if not nonempty:
            return None
        return _weighted(dec)

    def merge(self, parts, sstore):
        store = self._first_store(parts, sstore)
        vals = [v for v in (self.finalize(p, store) for p in parts.values()) if v is not None]
        if not vals:
            return None
        return max(vals) if self.maximize else min(vals)


class MinAggregator(ExtremeAggregator):
    kind = "min"
    maximize = False


class MaxAggregator(ExtremeAggregator):
    kind = "max"
    maximize = True


class PerValueAggregator(Aggregator):
    """Shared TOP-K / GROUP BY machinery: per-group masks from the target
    column's equality bitmaps, reduced to per-group (count[, slice-count])
    vectors that merge across shards by elementwise sum — the global
    schema aligns value order on every shard."""

    def _key_column(self) -> str:
        raise NotImplementedError

    def _inner_bits_column(self) -> str | None:
        return None  # BSI slices of the inner SUM/AVG column, if any

    def extra_pages(self, store):
        pages = eq_pages(store, self._key_column())
        inner = self._inner_bits_column()
        if inner is not None:
            pages += bsi_pages(store, inner)
        return pages

    def reduce_sig(self, store):
        groups = len(store.columns[self._key_column()].values)
        inner = self._inner_bits_column()
        bits = store.columns[inner].bits if inner is not None else 0
        return (groups, bits)

    def batch_reduce(self, masks, extras, sig):
        groups, bits = sig
        return pervalue_counts(masks, extras, groups=groups, bits=bits)

    def payload_leaves(self, sig, b, w):
        groups, bits = sig
        if not bits:
            return (((b, groups), np.int64),)
        return (((b, groups), np.int64), ((b, groups, bits), np.int64))

    def member_partial(self, host, j):
        if isinstance(host, tuple):
            return (host[0][j], host[1][j])
        return host[j]

    def empty_partial(self, store):
        groups = len(store.columns[self._key_column()].values)
        inner = self._inner_bits_column()
        if inner is None:
            return np.zeros((groups,), np.int64)
        bits = store.columns[inner].bits
        return (np.zeros((groups,), np.int64), np.zeros((groups, bits), np.int64))

    def merge(self, parts, sstore):
        vals = list(parts.values())
        if isinstance(vals[0], tuple):
            total = tuple(
                np.sum(np.stack([np.asarray(v[i]) for v in vals]), axis=0, dtype=np.int64)
                for i in range(2)
            )
        else:
            total = np.sum(np.stack([np.asarray(v) for v in vals]), axis=0, dtype=np.int64)
        return self.finalize(total, self._first_store(parts, sstore))


class TopKAggregator(PerValueAggregator):
    kind = "topk"

    def validate(self, columns):
        self._require(columns, self.spec.column)
        if self.spec.k < 1:
            raise ValueError(f"TopK needs k >= 1, got {self.spec.k}")

    def _key_column(self):
        return self.spec.column

    def finalize(self, partial, store):
        values = store.columns[self.spec.column].values
        ranked = sorted(
            ((v, int(c)) for v, c in zip(values, partial)),
            key=lambda vc: (-vc[1], vc[0]),
        )
        return tuple((v, c) for v, c in ranked if c > 0)[: self.spec.k]


class GroupByAggregator(PerValueAggregator):
    kind = "groupby"

    def validate(self, columns):
        self._require(columns, self.spec.key)
        inner = self.spec.value
        if not isinstance(inner, (Count, Sum, Avg)):
            raise TypeError(f"GroupBy value must be Count/Sum/Avg, got {inner!r}")
        if isinstance(inner, (Sum, Avg)):
            self._require(columns, inner.column)

    def _key_column(self):
        return self.spec.key

    def _inner_bits_column(self):
        inner = self.spec.value
        return inner.column if isinstance(inner, (Sum, Avg)) else None

    def finalize(self, partial, store):
        values = store.columns[self.spec.key].values
        inner = self.spec.value
        if isinstance(inner, Count):
            return {v: int(c) for v, c in zip(values, partial) if int(c) > 0}
        counts, slices = partial
        out = {}
        for g, v in enumerate(values):
            c = int(counts[g])
            if not c:
                continue
            num = _weighted(slices[g])
            out[v] = num / c if isinstance(inner, Avg) else num
        return out


_AGGREGATORS: dict[type, type[Aggregator]] = {
    Count: CountAggregator,
    Mask: MaskAggregator,
    Sum: SumAggregator,
    Avg: AvgAggregator,
    Min: MinAggregator,
    Max: MaxAggregator,
    TopK: TopKAggregator,
    GroupBy: GroupByAggregator,
}

# spec-less instances for kind-keyed dispatch (see Aggregator.batch_reduce)
_BY_KIND: dict[str, Aggregator] = {
    cls.kind: cls(spec=None) for cls in _AGGREGATORS.values()
}


def kind_reduce(kind: str, masks, extras, sig: tuple):
    """Run one reduce group's device computation from its static group key
    — the body :func:`repro_torch.query.device.make_flush_runner` runs per
    reduce group of a fused flush program."""
    return _BY_KIND[kind].batch_reduce(masks, extras, sig)


def payload_spec(
    kind: str, sig: tuple, b: int, w: int
) -> tuple[tuple[tuple[int, ...], object], ...]:
    """Static ``(shape, dtype)`` leaves of one group's payload slice."""
    return _BY_KIND[kind].payload_leaves(sig, b, w)


def payload_size(leaves) -> int:
    """Flat 32-bit words one group contributes to the fused payload."""
    return sum(int(np.prod(shape)) for shape, _ in leaves)


def unpack_group(flat: np.ndarray, leaves):
    """Re-assemble one reduce group's host structure from its payload slice.

    ``flat`` is the host ``uint32`` view of the payload's 32-bit words:
    counts come back as exact ``int64`` (device popcounts are int32, so the
    round-trip is lossless) and MASK words stay ``uint32``.  Returns a
    single array or a tuple, as :meth:`Aggregator.member_partial` expects.
    """
    out = []
    off = 0
    for shape, dtype in leaves:
        n = int(np.prod(shape))
        out.append(flat[off : off + n].reshape(shape).astype(dtype))
        off += n
    return out[0] if len(out) == 1 else tuple(out)


@functools.lru_cache(maxsize=1024)
def get_aggregator(agg) -> Aggregator:
    """Aggregator for a spec (or legacy ``Agg`` enum member); cached."""
    spec = normalize_agg(agg)
    cls = _AGGREGATORS.get(type(spec))
    if cls is None:
        raise TypeError(f"no aggregator registered for {spec!r}")
    return cls(spec)


def validate_query(query: Query, columns: Mapping[str, object]) -> Aggregator:
    """Admission-time validation: every predicate column and the
    aggregate's target columns must exist, so a bad query raises at
    ``submit()`` — never mid-flush.  Returns the query's aggregator.

    The predicate's column set is kept on its tree after the first walk,
    so checking a repeat query is a subset test against ``columns`` as
    they are now."""
    if not columns.keys() >= pred_columns(query.where):
        for col in columns_of(query.where):  # the first unknown, in tree order
            if col not in columns:
                raise KeyError(f"unknown column {col!r}")
    agg = get_aggregator(query.agg)
    agg.validate(columns)
    return agg


# -- the shared flush driver -------------------------------------------------


def _cached_pages(
    agg: Aggregator, store: BitmapStore, store_key, cache: dict, cap: int
) -> tuple[str, ...]:
    """Memoized :meth:`Aggregator.extra_pages`."""
    pkey = ("pages", agg.spec, store_key)
    pages = cache.get(pkey)
    if pages is None:
        _evict_one(cache, cap)
        pages = agg.extra_pages(store)
        cache[pkey] = pages
    return pages


def _evict_one(cache: dict, cap: int) -> None:
    """Bound the shared extras cache by evicting the oldest entry."""
    if len(cache) >= cap:
        cache.pop(next(iter(cache)))


def group_members(
    specs: list, stores: list[BitmapStore]
) -> tuple[list[Aggregator], dict[tuple, list[int]]]:
    """Group a flush's members by reduce signature ``(kind,) + reduce_sig``
    — the shared first step of :func:`reduce_flush` and
    :func:`repro_torch.query.compile.compile_flush`."""
    aggs = [get_aggregator(sp) for sp in specs]
    groups: dict[tuple, list[int]] = {}
    for i, a in enumerate(aggs):
        groups.setdefault((a.kind,) + a.reduce_sig(stores[i]), []).append(i)
    return aggs, groups


def group_extras(
    aggs: list[Aggregator],
    members: list[int],
    stores: list[BitmapStore],
    store_keys: list,
    extras_cache: dict,
    cache_cap: int,
    device,
):
    """Stacked ``(B_g, P, W)`` extra sensed planes of one reduce group on
    ``device``.

    Returns ``(extras, counts)`` where ``extras`` is the device stack (or
    None when the group's aggregate senses no extra planes) and ``counts``
    maps member index -> planes sensed (the caller's projected-traffic
    accounting).  The group stack is memoized per member composition.
    """
    member_pages = [
        _cached_pages(aggs[i], stores[i], store_keys[i], extras_cache, cache_cap)
        for i in members
    ]
    counts: dict[int, int] = {}
    if not member_pages[0]:
        return None, counts
    cks = []
    for i, pages in zip(members, member_pages):
        counts[i] = len(pages)
        cks.append((store_keys[i], pages))
    gk = ("stack",) + tuple(cks)
    extras = extras_cache.get(gk)
    if extras is None:
        stacks = []
        for i, ck in zip(members, cks):
            stack = extras_cache.get(ck)
            if stack is None:
                _evict_one(extras_cache, cache_cap)
                stack = fetch_pages(stores[i], ck[1], device)
                extras_cache[ck] = stack
            stacks.append(stack)
        extras = torch.stack(stacks)  # (B_g, P, W)
        _evict_one(extras_cache, cache_cap)
        extras_cache[gk] = extras
    return extras, counts


def reduce_flush(
    masked: torch.Tensor,
    specs: list,
    stores: list[BitmapStore],
    store_keys: list,
    *,
    extras_cache: dict,
    cache_cap: int = 128,
) -> tuple[list, list[int], int]:
    """Batched aggregation of one flush (per-group transfer path).

    Returns ``(partials, extra_counts, n_groups)``: the per-member
    partials, how many extra planes each member sensed, and the number of
    reduce groups — i.e. device->host transfers — the flush cost.  The
    fused flush program replaces this driver on the hot path with ONE
    transfer for the whole flush; this path remains for devices holding
    non-ESP pages and as the lockstep oracle.
    """
    n = len(specs)
    aggs, groups = group_members(specs, stores)
    partials: list = [None] * n
    extra_counts: list[int] = [0] * n
    for group_key, members in groups.items():
        a0 = aggs[members[0]]
        sig = group_key[1:]
        sub = (
            masked
            if len(members) == n
            else masked[torch.as_tensor(members, device=masked.device)]
        )
        extras, counts = group_extras(
            aggs, members, stores, store_keys, extras_cache, cache_cap,
            masked.device,
        )
        for i, c in counts.items():
            extra_counts[i] = c
        flat = torch.cat(payload_words(a0.batch_reduce(sub, extras, sig)))
        host = unpack_group(
            flat.cpu().numpy().view(np.uint32),
            a0.payload_leaves(sig, len(members), masked.shape[1]),
        )
        for j, i in enumerate(members):
            partials[i] = aggs[i].member_partial(host, j)
    return partials, extra_counts, len(groups)
