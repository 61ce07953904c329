"""Pluggable aggregation pipeline: every aggregate is an :class:`Aggregator`.

An :class:`Aggregator` declares

* **extra sensed planes** (:meth:`Aggregator.extra_pages`) — the BSI slices
  and/or equality bitmaps of its target column, fetched through
  :func:`repro_torch.query.bitmap.fetch_pages`;
* **a batched device-side reduce** (:meth:`Aggregator.batch_reduce`) — one
  popcount kernel launch over the stacked result bitmaps of a flush;
* **a shard-merge rule** (:meth:`Aggregator.merge`).

This slice of the port serves ``COUNT`` and ``MASK``.  SUM/AVG/MIN/MAX/
TOP-K/GROUP BY are a later slice (ROADMAP A5): asking for one raises
``NotImplementedError`` at ``submit()``, before a flush can be poisoned.
:func:`reduce_flush` is the per-group driver of the legacy flush path: it
groups a flush's members by *reduce signature* (aggregator kind + static
shapes) and costs one kernel launch and one host transfer per group.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Mapping

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
)
from repro_torch.query.bitmap import BitmapStore, fetch_pages

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


_AGGREGATORS: dict[type, type[Aggregator]] = {
    Count: CountAggregator,
    Mask: MaskAggregator,
}
# specs whose aggregators are a later slice of the port
_NOT_PORTED = (Sum, Avg, Min, Max, TopK, GroupBy)

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
        if isinstance(spec, _NOT_PORTED):
            raise NotImplementedError(
                f"{type(spec).__name__} is not ported to repro_torch yet "
                "(ROADMAP A5: the remaining aggregates); COUNT and MASK are"
            )
        raise TypeError(f"no aggregator registered for {spec!r}")
    return cls(spec)


def validate_query(query: Query, columns: Mapping[str, object]) -> Aggregator:
    """Admission-time validation: every predicate column and the
    aggregate's target columns must exist, so a bad query raises at
    ``submit()`` — never mid-flush.  Returns the query's aggregator."""
    for col in columns_of(query.where):
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
    device=None,
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
        flat = a0.batch_reduce(sub, extras, sig).reshape(-1).cpu().numpy()
        host = unpack_group(
            flat.view(np.uint32),
            a0.payload_leaves(sig, len(members), masked.shape[1]),
        )
        for j, i in enumerate(members):
            partials[i] = aggs[i].member_partial(host, j)
    return partials, extra_counts, len(groups)
