"""Carry a deployment's state across: export to plain data, load into the port.

:func:`export_state` reads a bitmap store and its flash device into numpy
arrays plus plain Python (JSON-able) metadata.  It only reads attributes,
so it takes the reference package's objects as well as the port's — a
reference deployment is exported on its side, and
:func:`load_reference_state` rebuilds an equivalent port
``BitmapStore`` + ``FlashDevice`` from the export without importing the
reference.  The state carried is:

* the packed buffer and slot map of the ``PackedStore`` (``_buf[:_n]``,
  ``_slots``, ``_words``, ``planes``, ``epoch``, ``region_epochs``);
* the ``Layout`` placements, block fills and allocation state;
* the page ``program_configs``, the non-ESP set, ``pec``,
  ``esp_programs`` and ``block_erases``;
* the ``BitmapStore``'s logical pages (the tombstone page included),
  column metadata, epochs and ``deleted_rows``.

:func:`export_fleet_state` and :func:`load_reference_fleet` do the same
for a sharded fleet: every shard through the functions above, plus the
fleet's striping (``row_maps``, ``schema``, ``shard_values``,
``stripe_bounds``, ``reserve_rows``, ``num_rows``).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.placement import Layout, PagePlacement
from repro_torch.core.reliability import CellMode, ProgramConfig
from repro_torch.core.store import PackedStore
from repro_torch.query.bitmap import BitmapStore, ColumnIndex
from repro_torch.query.device import FlashDevice
from repro_torch.query.shard import ShardedBitmapStore

_PAGE = "logical:"


def export_state(store, device) -> tuple[dict[str, np.ndarray], dict]:
    """``(arrays, meta)`` of a bitmap store and the device it is
    programmed into (see the module docstring)."""
    ps, lay = device.store, device.layout
    placements, fill, next_block, scratch, by_loc, regions = lay.snapshot()
    # a fleet's never-ingested shard has a device with no pages yet
    buf = np.zeros((0, 0), np.uint32) if ps._buf is None else ps._buf[: ps._n]
    arrays = {"buf": np.array(buf, dtype=np.uint32)}
    for name, page in store.logical.items():
        arrays[_PAGE + name] = np.array(page, dtype=np.uint32)
    meta = {
        "packed": {
            "planes": ps.planes,
            "slots": dict(ps._slots),
            "words": ps._words,
            "epoch": ps.epoch,
            "region_epochs": dict(ps.region_epochs),
        },
        "layout": {
            "wls_per_block": lay.wls_per_block,
            "levels": lay.levels,
            "placements": {
                n: [p.block, p.wordline, bool(p.inverted), p.level]
                for n, p in placements.items()
            },
            "block_fill": [[b, f] for b, f in fill.items()],
            "next_block": next_block,
            "scratch_count": scratch,
            "by_location": [[b, w, n] for (b, w), n in by_loc.items()],
            "regions": dict(regions),
        },
        "device": {
            "num_planes": device.num_planes,
            "program_configs": {
                n: [c.mode.value, bool(c.randomized), float(c.tesp_ratio), c.levels]
                for n, c in device.program_configs.items()
            },
            "non_esp": sorted(device._non_esp),
            "pec": [[b, c] for b, c in device.pec.items()],
            "esp_programs": device.esp_programs,
            "block_erases": device.block_erases,
        },
        "bitmap": {
            "num_rows": store.num_rows,
            "columns": {
                n: [list(ci.values), ci.bits] for n, ci in store.columns.items()
            },
            "epoch": store.epoch,
            "column_epochs": dict(store.column_epochs),
            "capacity_rows": store.capacity_rows,
            "min_words": store.min_words,
            "deleted_rows": store.deleted_rows,
        },
    }
    return arrays, meta


def load_reference_state(
    arrays: dict[str, np.ndarray], meta: dict, device="cuda"
) -> tuple[BitmapStore, FlashDevice]:
    """Rebuild a port ``BitmapStore`` + ``FlashDevice`` (on ``device``)
    from :func:`export_state` output; serving them answers exactly as the
    exported deployment does."""
    lm = meta["layout"]
    layout = Layout(wls_per_block=lm["wls_per_block"], levels=lm["levels"])
    layout.restore(
        (
            {
                n: PagePlacement(b, w, inv, lvl)
                for n, (b, w, inv, lvl) in lm["placements"].items()
            },
            {b: f for b, f in lm["block_fill"]},
            lm["next_block"],
            lm["scratch_count"],
            {(b, w): n for b, w, n in lm["by_location"]},
            dict(lm["regions"]),
        )
    )

    pm = meta["packed"]
    packed = PackedStore(planes=pm["planes"])
    buf = np.array(arrays["buf"], dtype=np.uint32)
    if buf.shape[0]:
        packed._buf = buf
        packed._n = buf.shape[0]
    packed._words = pm["words"]
    packed._slots = dict(pm["slots"])
    packed.epoch = pm["epoch"]
    packed.region_epochs = dict(pm["region_epochs"])

    dm = meta["device"]
    dev = FlashDevice(
        layout=layout, store=packed, num_planes=dm["num_planes"], device=device
    )
    dev.program_configs = {
        n: ProgramConfig(CellMode(mode), randomized=r, tesp_ratio=t, levels=lv)
        for n, (mode, r, t, lv) in dm["program_configs"].items()
    }
    dev._non_esp = set(dm["non_esp"])
    dev.pec = {b: c for b, c in dm["pec"]}
    dev.esp_programs = dm["esp_programs"]
    dev.block_erases = dm["block_erases"]

    bm = meta["bitmap"]
    store = BitmapStore(
        num_rows=bm["num_rows"],
        columns={
            n: ColumnIndex(n, tuple(vals), bits)
            for n, (vals, bits) in bm["columns"].items()
        },
        logical={
            k[len(_PAGE):]: np.array(v, dtype=np.uint32)
            for k, v in arrays.items()
            if k.startswith(_PAGE)
        },
        epoch=bm["epoch"],
        column_epochs=dict(bm["column_epochs"]),
        capacity_rows=bm["capacity_rows"],
        min_words=bm["min_words"],
        deleted_rows=bm["deleted_rows"],
    )
    return store, dev


def export_fleet_state(sstore, devices) -> tuple[dict[str, np.ndarray], dict]:
    """``(arrays, meta)`` of a sharded bitmap store and its devices:
    shard ``s``'s :func:`export_state` under the prefix ``shard{s}/``,
    its row map as ``row_map{s}``, and the fleet's striping metadata."""
    arrays: dict[str, np.ndarray] = {}
    shards = []
    for s, (st, dev) in enumerate(zip(sstore.shards, devices)):
        a, m = export_state(st, dev)
        arrays.update({f"shard{s}/{k}": v for k, v in a.items()})
        shards.append(m)
    for s, rmap in enumerate(sstore.row_maps):
        arrays[f"row_map{s}"] = np.array(rmap, dtype=np.int64)
    meta = {
        "num_shards": sstore.num_shards,
        "policy": sstore.policy,
        "stripe_key": sstore.stripe_key,
        "reserve_rows": sstore.reserve_rows,
        "num_rows": sstore.num_rows,
        "schema": {c: list(v) for c, v in sstore.schema.items()},
        "shard_values": [
            {c: list(v) for c, v in sv.items()} for sv in sstore.shard_values
        ],
        "stripe_bounds": [
            None if b is None else list(b) for b in sstore.stripe_bounds
        ],
        "row_maps": len(sstore.row_maps),
        "shards": shards,
    }
    return arrays, meta


def load_reference_fleet(
    arrays: dict[str, np.ndarray], meta: dict, device="cuda"
) -> tuple[ShardedBitmapStore, list[FlashDevice]]:
    """Rebuild a port ``ShardedBitmapStore`` and its devices (on
    ``device``) from :func:`export_fleet_state` output; a
    ``ShardedFlashQL`` over them answers as the exported fleet does."""
    stores, devices = [], []
    for s, m in enumerate(meta["shards"]):
        prefix = f"shard{s}/"
        st, dev = load_reference_state(
            {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)},
            m,
            device=device,
        )
        stores.append(st)
        devices.append(dev)
    sstore = ShardedBitmapStore(
        num_shards=meta["num_shards"],
        policy=meta["policy"],
        stripe_key=meta["stripe_key"],
        reserve_rows=meta["reserve_rows"],
        shards=stores,
        row_maps=[
            np.array(arrays[f"row_map{s}"], dtype=np.int64)
            for s in range(meta["row_maps"])
        ],
        num_rows=meta["num_rows"],
        schema={c: tuple(v) for c, v in meta["schema"].items()},
        shard_values=[
            {c: tuple(v) for c, v in sv.items()} for sv in meta["shard_values"]
        ],
        stripe_bounds=[
            None if b is None else tuple(b) for b in meta["stripe_bounds"]
        ],
    )
    return sstore, devices
