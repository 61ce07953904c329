"""Packed page store: the contiguous array behind the Flash-Cosmos engine.

:class:`PackedStore` packs every programmed page into one contiguous
``(slots, planes * words_per_plane)`` buffer — the layout analogue of a
multi-plane NAND die where a logical bit vector is striped across planes
and every plane holds the same (block, wordline) grid.  An MWS command
then becomes a *gather* of slot rows plus one kernel launch over the whole
word axis (= all planes at once).

Slot 0 is reserved for an all-ones row: the AND identity used to pad the
ragged per-block wordline sets of an inter-block MWS to a rectangle.  Slot
1 is the dual all-zeros row: a block whose first wordline gathers slot 1
ANDs to zero and is therefore OR-neutral across blocks — plan-aware
batching uses it to pad a plan with fewer target blocks into a wider
signature's shape.

Writes go to a host-side ``numpy`` buffer (amortized doubling).  The
device snapshot (an ``int32`` tensor on the caller's ``torch.device``) is
uploaded whole once, lazily, and from then on kept in place: every write
copies just the words it changed into the cached tensor (one
host-to-device copy), and a new slot grows the device tensor on the
device, by capacity doubling like the host buffer.  A delta append of B
rows therefore moves O(B) words to the device, never the store.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.bitops import to_words

IDENTITY_SLOT = 0  # all-ones row (AND identity / pad row), always present
ZERO_SLOT = 1  # all-zeros row (OR identity: pads whole blocks), always present

_ONES = np.uint32(0xFFFFFFFF)
_SCRATCH_PREFIX = "__scratch"


def _canonical(device) -> torch.device:
    """``device`` with its index: ``"cuda"`` names the current card, and
    a tensor on it reports ``cuda:0`` (or whichever), so snapshots are
    compared by canonical devices, never by spelling."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def page_region(name: str) -> str | None:
    """Epoch region of a page name, or ``None`` for planner scratch pages.

    Equality bitmaps are ``column=value`` and BSI slices ``column#bit``, so
    the prefix before the first ``=`` / ``#`` groups every page of one
    column into one region; constant pages (``__all`` / ``__none``) are
    their own single-page regions.  Plan caches invalidate per region.
    """
    if name.startswith(_SCRATCH_PREFIX):
        return None
    return name.split("=", 1)[0].split("#", 1)[0]


@dataclass
class PackedStore:
    """Name-addressed packed page store striped over ``planes`` planes.

    All pages share one word count ``W`` (fixed by the first write); each
    page occupies one *slot* of ``planes * words_per_plane`` words, where
    ``words_per_plane = ceil(W / planes)`` (tail padding is sliced off on
    read).
    """

    planes: int = 1
    _slots: dict[str, int] = field(default_factory=dict)
    _buf: np.ndarray | None = None  # (capacity, planes * wpp) uint32
    _n: int = 0
    _words: int | None = None  # logical words per page (pre-padding)
    # device copy of the host buffer, same capacity; the snapshot is its
    # first ``_n`` rows
    _dev_buf: torch.Tensor | None = None
    _snapshot: torch.Tensor | None = None
    _snapshot_device: torch.device | None = None
    # Content version: bumped whenever page *content* changes, except
    # planner scratch pages.  Snapshot-level caches key on this.
    epoch: int = 0
    # Region-granular mutation epochs (see :func:`page_region`): bumped on
    # a full (re)program of a page in the region.  Plan caches key on the
    # regions their leaves touch.
    region_epochs: dict[str, int] = field(default_factory=dict)
    # how many times the whole packed buffer was uploaded to the device:
    # steady-state serving holds this flat (spilled values stay in latch
    # scratch, never the store), and so do writes, which update the cached
    # snapshot in place
    snapshot_uploads: int = 0

    # -- geometry ----------------------------------------------------------
    @property
    def num_words(self) -> int | None:
        """Logical words per page (None until the first write)."""
        return self._words

    @property
    def padded_words(self) -> int:
        assert self._words is not None
        return -(-self._words // self.planes) * self.planes

    @property
    def words_per_plane(self) -> int:
        return self.padded_words // self.planes

    @property
    def num_slots(self) -> int:
        return self._n

    @property
    def capacity(self) -> int:
        """Slots the host buffer holds before its next doubling."""
        return 0 if self._buf is None else self._buf.shape[0]

    def __len__(self) -> int:
        return len(self._slots)

    def __contains__(self, name: str) -> bool:
        return name in self._slots

    # -- writes ------------------------------------------------------------
    def _ensure_buf(self, words: int) -> None:
        if self._buf is not None:
            return
        self._words = words
        wp = self.padded_words
        self._buf = np.empty((16, wp), dtype=np.uint32)
        self._buf[IDENTITY_SLOT] = _ONES  # AND identity row
        self._buf[ZERO_SLOT] = 0  # OR identity row (block padding)
        self._n = 2

    def __setitem__(self, name: str, words) -> None:
        if isinstance(words, torch.Tensor):
            words = words.detach().cpu().numpy().view(np.uint32)
        w = np.asarray(words, dtype=np.uint32).reshape(-1)
        self._ensure_buf(w.shape[0])
        if w.shape[0] != self._words:
            raise ValueError(
                f"page {name!r} has {w.shape[0]} words, store fixed at "
                f"{self._words}"
            )
        slot = self._slots.get(name)
        if slot is None:
            if self._n == self._buf.shape[0]:
                grown = np.empty(
                    (2 * self._buf.shape[0], self._buf.shape[1]),
                    dtype=np.uint32,
                )
                grown[: self._n] = self._buf[: self._n]
                self._buf = grown
            slot = self._n
            self._n += 1
            self._slots[name] = slot
        self._buf[slot, : self._words] = w
        self._buf[slot, self._words :] = 0
        self._write_through(slot, 0, self._buf.shape[1])
        region = page_region(name)
        if region is not None:
            self.epoch += 1
            self.region_epochs[region] = self.region_epochs.get(region, 0) + 1

    def append_words(self, name: str, words, start: int) -> None:
        """Delta-page programming: overwrite only ``words`` at ``start``.

        The incremental-ingest write path.  The caller guarantees the
        written range covers only the page's tail beyond previously-valid
        rows (an *append*), so compiled plans — which gather by slot —
        remain valid: the page's region epoch is left alone and only the
        content ``epoch`` is bumped (snapshot-level caches must refresh).
        """
        w = np.asarray(words, dtype=np.uint32).reshape(-1)
        slot = self._slots[name]
        assert self._words is not None
        if start < 0 or start + w.shape[0] > self._words:
            raise ValueError(
                f"delta [{start}, {start + w.shape[0]}) out of range for "
                f"page {name!r} with {self._words} words"
            )
        self._buf[slot, start : start + w.shape[0]] = w
        self._write_through(slot, start, start + w.shape[0])
        if page_region(name) is not None:
            self.epoch += 1

    def _write_through(self, slot: int, start: int, stop: int) -> None:
        """Copy host words ``[start, stop)`` of ``slot`` into the cached
        device snapshot, if there is one: one synchronous host-to-device
        copy of just those words.  A slot past the device tensor's
        capacity first grows it on the device to the host capacity."""
        dev = self._dev_buf
        if dev is None:
            return
        if slot >= dev.shape[0]:
            grown = torch.empty(
                (self._buf.shape[0], dev.shape[1]), dtype=dev.dtype, device=dev.device
            )
            grown[:slot].copy_(dev[:slot])
            self._dev_buf = dev = grown
            self._snapshot = None
        host = torch.from_numpy(self._buf[slot, start:stop].view(np.int32))
        dev[slot, start:stop].copy_(host)

    # -- reads -------------------------------------------------------------
    def slot(self, name: str) -> int:
        return self._slots[name]

    def __getitem__(self, name: str) -> torch.Tensor:
        slot = self._slots[name]
        return to_words(self._buf[slot, : self._words])

    def snapshot(self, device=None) -> torch.Tensor:
        """Device-side ``(slots, planes * words_per_plane)`` int32 tensor.

        Uploaded whole on the first call (and on a request for another
        device), then kept up to date in place by every write; a
        multi-plane gather + reduce over it covers every plane in one
        kernel launch because planes are word-axis shards of each slot row.
        The tensor is always a copy, never a view of the host buffer (on
        the CPU too), so a host reallocation cannot leave it stale.
        """
        device = _canonical("cpu" if device is None else device)
        if self._dev_buf is None or self._snapshot_device != device:
            assert self._buf is not None, "empty store has no snapshot"
            dev = torch.empty(self._buf.shape, dtype=torch.int32, device=device)
            dev[: self._n].copy_(to_words(self._buf[: self._n]))
            self._dev_buf, self._snapshot_device = dev, device
            self._snapshot = None
            self.snapshot_uploads += 1
        if self._snapshot is None or self._snapshot.shape[0] != self._n:
            self._snapshot = self._dev_buf[: self._n]
        return self._snapshot

    def bind(self, view: torch.Tensor) -> int:
        """Make ``view`` — ``(rows, planes * words_per_plane)`` int32 with
        rows at least the host capacity, typically one shard's slab of a
        fleet tensor — this store's device buffer, holding its snapshot.

        The current snapshot moves in by a device-to-device copy when the
        store already has one on ``view``'s device; otherwise the host
        buffer is uploaded whole, which counts in ``snapshot_uploads``.
        Later writes land in ``view`` in place, until a new slot outgrows
        it (then :meth:`_write_through` moves the store to a tensor of its
        own).  Returns the bytes copied into ``view``.
        """
        assert self._buf is not None, "empty store has no snapshot"
        if view.shape[0] < self._buf.shape[0] or view.shape[1] != self._buf.shape[1]:
            raise ValueError(
                f"view {tuple(view.shape)} cannot hold a store of "
                f"{tuple(self._buf.shape)}"
            )
        n = self._n
        if self._dev_buf is not None and self._snapshot_device == view.device:
            view[:n].copy_(self._dev_buf[:n])
        else:
            view[:n].copy_(to_words(self._buf[:n]))
            self.snapshot_uploads += 1
        self._dev_buf, self._snapshot_device = view, view.device
        self._snapshot = None
        return n * view.shape[1] * view.element_size()

    def bound_to(self, view: torch.Tensor) -> bool:
        """Whether ``view`` (the very tensor given to :meth:`bind`) is
        still this store's device buffer."""
        return self._dev_buf is view

    def plane_view(self, device=None) -> torch.Tensor:
        """The snapshot as ``(planes, slots, words_per_plane)``."""
        snap = self.snapshot(device)
        return snap.reshape(self._n, self.planes, self.words_per_plane).transpose(0, 1)
