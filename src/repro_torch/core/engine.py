"""Flash-Cosmos execution engine.

Executes a :class:`CommandPlan` with bit-exact latch semantics (paper
Figs. 3/4/6 and §6.2):

* MWS sensing: per target block, the NAND string conducts only if **all**
  selected cells conduct ⇒ AND of the block's selected wordlines; blocks
  share bitlines ⇒ OR across blocks; inverse read complements.
* S-latch: ``S = raw`` when initialized, else ``S & raw`` (ParaBit-AND).
* move-S-to-C: ``C = S`` when C initialized, else ``C | S`` (ParaBit-OR).
* XOR command: ``C = S ^ C``.
* Spill: ESP-program a latch into a scratch page.
* Transfer: DMA out, optional controller-side inversion.

The engine stores *logical* page data; physical cell data is complemented
for pages placed ``inverted`` (De Morgan storage).  Reads of non-ESP pages
can inject modelled bit errors (``repro_torch.core.reliability``); ESP
pages are error-free — the paper's headline reliability result.

Page data lives in a :class:`repro_torch.core.store.PackedStore`; sensing
is a gather of the command's wordline rows plus one launch of the MWS
gather-reduce kernel (AND within blocks, OR across blocks, inverse read)
on a CUDA tensor, or its plain PyTorch version on a CPU tensor.  The
tensor's device decides; ``FlashArray.device`` says where the snapshot
lives.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.bitops import BitOp, reduce_words, to_words
from repro_torch.core.commands import (
    CommandPlan,
    ESPCommand,
    MWSCommand,
    SpillCommand,
    ThresholdCommand,
    TransferCommand,
    XORCommand,
)
from repro_torch.core.expr import Expr, Node, Page, Threshold
from repro_torch.core.placement import Layout
from repro_torch.core.planner import Planner
from repro_torch.core.reliability import (
    CellMode,
    ProgramConfig,
    inject_bit_errors,
    rber,
)
from repro_torch.core.store import IDENTITY_SLOT, PackedStore
from repro_torch.kernels.mws import mws_gather
from repro_torch.kernels.threshold import bitslice_threshold, threshold_reduce


def resolve_device(device) -> torch.device:
    """The engine's device: CUDA unless the caller names another.

    A CUDA device with no GPU present raises here — there is no silent
    CPU fallback; pass ``device="cpu"`` to run the plain versions.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _stable_seed(name: str) -> int:
    """Deterministic per-page seed component (CRC32, unlike ``hash``)."""
    return zlib.crc32(name.encode("utf-8")) & 0xFFFF


def _cube_idx(k: int, n: int, device) -> torch.Tensor:
    return torch.arange(k * n, dtype=torch.int32, device=device).reshape(1, k, n)


def fused_block_reduce(cube: torch.Tensor, inverse: bool) -> torch.Tensor:
    """MWS semantics on a gathered ``(blocks, wordlines, words)`` cube.

    AND over each block's wordlines, OR across blocks, complement under
    inverse read — one launch of the gather-reduce kernel over the cube's
    rows (on a CPU tensor, its plain version).  Rows padded with the
    all-ones identity are AND-neutral.
    """
    k, n, w = cube.shape
    flat = cube.reshape(k * n, w).contiguous()
    return mws_gather(
        flat, _cube_idx(k, n, cube.device), BitOp.AND, invert=inverse
    )[0]


def threshold_block_reduce(
    cube: torch.Tensor, k: int, inverse: bool
) -> torch.Tensor:
    """k-of-N threshold sensing on a gathered ``(blocks, wls, words)`` cube.

    Stage one is a plain MWS per block (AND of its selected wordlines);
    the cross-block combine then sets bit j iff at least ``k`` blocks
    conduct at j.  Blocks padded with the all-zeros row never conduct.
    ``inverse`` complements AFTER the comparison.
    """
    kb, n, w = cube.shape
    flat = cube.reshape(kb * n, w).contiguous()
    per_block = mws_gather(
        flat, _cube_idx(kb, n, cube.device), BitOp.AND, outer_or=False
    )  # (1, kb, w)
    return threshold_reduce(per_block, k, invert=inverse)[0]


@dataclass
class FlashArray:
    """A (single-plane) Flash-Cosmos array: layout + packed page store.

    ``device`` is where the store's snapshot lives and the kernels run:
    ``"cuda"`` by default (raises without a GPU), ``"cpu"`` for the plain
    PyTorch versions.
    """

    layout: Layout = field(default_factory=Layout)
    store: PackedStore = field(default_factory=PackedStore)
    program_configs: dict[str, ProgramConfig] = field(default_factory=dict)
    pec: dict[int, int] = field(default_factory=dict)  # block -> P/E cycles
    device: torch.device | str = "cuda"
    # names of non-ESP pages, maintained incrementally so hot paths never
    # scan program_configs
    _non_esp: set = field(default_factory=set, repr=False)
    # host-initiated ESP page programs (fc_write(esp=True) + fc_append):
    # appending B rows programs O(B) pages, not O(num_rows)
    esp_programs: int = 0
    # whole-block erases issued by erase_rebuild (NAND programs only 1->0,
    # so reclaiming tombstoned rows erases every block the stripe occupies
    # and reprograms the live data)
    block_erases: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # -- host API (fc_write / fc_read, §6.3) -------------------------------
    def fc_write(
        self,
        name: str,
        words,
        *,
        inverted: bool | None = None,
        block: int | None = None,
        wordline: int | None = None,
        esp: bool = True,
        charge: bool = True,
    ) -> None:
        """Program a page (logical words: host uint32 or an int32 tensor).
        ESP mode (default) guarantees error-free reads.

        Under multi-level packing (``layout.levels > 1``) the ESP margin
        stretches to ``tESP = (1 + levels) x tPROG``.  ``charge=False``
        records the page content without bumping the wear/ESP counters
        (the co-resident levels of one physical page program together).
        """
        if name in self.layout:
            p = self.layout[name]
            inverted = p.inverted if inverted is None else inverted
        else:
            inverted = bool(inverted)
            if block is None:
                (p,) = self.layout.place_colocated([name], inverted)
            else:
                p = self.layout.place(name, block, wordline or 0, inverted)
        levels = self.layout.levels
        cfg = ProgramConfig(
            CellMode.SLC,
            randomized=False,
            tesp_ratio=1.0 + float(levels) if esp else 1.0,
            levels=levels,
        )
        self.program_configs[name] = cfg
        if esp:
            self._non_esp.discard(name)
        else:
            self._non_esp.add(name)
        if isinstance(words, torch.Tensor):
            words = words.detach().cpu().numpy().view(np.uint32)
        words = np.asarray(words, dtype=np.uint32)
        self.store[name] = ~words if inverted else words
        if charge:
            self.pec[p.block] = self.pec.get(p.block, 0) + 1
            if esp:
                self.esp_programs += 1

    def fc_append(
        self, name: str, words, *, start: int, charge: bool = True
    ) -> None:
        """Delta-page ESP program: extend an already-placed page's tail.

        Only ``words`` (logical host ``uint32``, at word offset ``start``)
        are programmed — one page program however many earlier words the
        page holds.  The page keeps its placement, inversion, and program
        config; the store treats the write as a tail extension (compiled
        plans stay valid, see ``PackedStore.append_words``).
        ``charge=False`` as in :meth:`fc_write`.
        """
        p = self.layout[name]
        w = np.asarray(words, dtype=np.uint32)
        self.store.append_words(name, ~w if p.inverted else w, start)
        if charge:
            self.pec[p.block] = self.pec.get(p.block, 0) + 1
            self.esp_programs += 1

    def fc_read(self, e: Expr) -> torch.Tensor:
        """Plan + execute a bulk bitwise expression; returns logical words."""
        plan = Planner(self.layout).compile(e)
        return self.execute(plan)

    def erase_rebuild(self) -> int:
        """Erase every programmed block and reset for a full reprogram.

        The device half of compaction: every block the layout occupies
        takes one P/E cycle (``pec``) and counts toward ``block_erases``;
        the page store and layout come back empty, with the store's
        content and region epochs seeded ABOVE their old values, so no
        plan-cache or snapshot-cache key minted against the old data can
        match the rebuilt one.  The new store inherits the old one's
        ``snapshot_uploads``: its first snapshot is the rebuild's one
        whole upload.  Returns the blocks erased.
        """
        blocks = {p.block for p in self.layout.placements.values()}
        for b in blocks:
            self.pec[b] = self.pec.get(b, 0) + 1
        self.block_erases += len(blocks)
        old = self.store
        self.store = PackedStore(planes=old.planes)
        self.store.epoch = old.epoch + 1
        self.store.region_epochs = {r: e + 1 for r, e in old.region_epochs.items()}
        self.store.snapshot_uploads = old.snapshot_uploads
        self.layout = Layout(
            wls_per_block=self.layout.wls_per_block, levels=self.layout.levels
        )
        self.program_configs.clear()
        self._non_esp.clear()
        return len(blocks)

    # -- sensing ------------------------------------------------------------
    def _gather_cube(
        self,
        cmd: MWSCommand,
        seed: int,
        scratch: dict[str, torch.Tensor] | None = None,
    ) -> torch.Tensor:
        """Gather the command's wordline rows into a padded (k, n, W) cube.

        Non-ESP pages get modelled bit errors injected on their gathered
        rows; ESP pages come straight from the packed snapshot.
        ``scratch`` holds the device-resident values of pages spilled
        earlier in the executing plan; their rows are substituted after
        the gather and never take injected errors (a spill IS an ESP
        program).
        """
        snap = self.store.snapshot(self.device)
        n_max = max(len(t.wordlines) for t in cmd.targets)
        idx = []
        noisy: list[tuple[int, int, str]] = []
        subs: list[tuple[int, int, str]] = []
        for bi, t in enumerate(cmd.targets):
            row = []
            for wl in t.wordlines:
                name = self.layout.page_at(t.block, wl)
                if scratch is not None and name in scratch:
                    subs.append((bi, len(row), name))
                    row.append(IDENTITY_SLOT)  # placeholder, overwritten
                    continue
                row.append(self.store.slot(name))
                if name in self._non_esp:
                    noisy.append((bi, len(row) - 1, name))
            row.extend([IDENTITY_SLOT] * (n_max - len(row)))
            idx.append(row)
        cube = snap[torch.as_tensor(idx, device=snap.device)]
        for bi, wi, name in subs:
            cube[bi, wi] = scratch[name]
        for bi, wi, name in noisy:
            p = self.layout[name]
            r = rber(self.program_configs[name], pec=self.pec.get(p.block, 0))
            cube[bi, wi] = inject_bit_errors(
                cube[bi, wi], r, seed=seed ^ _stable_seed(name)
            )
        return cube

    def _sense(
        self,
        cmd: MWSCommand,
        seed: int,
        scratch: dict[str, torch.Tensor] | None = None,
    ) -> torch.Tensor:
        cube = self._gather_cube(cmd, seed, scratch)
        if isinstance(cmd, ThresholdCommand):
            return threshold_block_reduce(cube, cmd.k, cmd.iscm.inverse_read)
        return fused_block_reduce(cube, cmd.iscm.inverse_read)

    # -- plan execution -------------------------------------------------------
    def execute(self, plan: CommandPlan, seed: int = 0) -> torch.Tensor:
        # Spilled sub-results stay device-resident for the plan's lifetime:
        # the SpillCommand's ESP program targets latch scratch, not the
        # packed store, so executions never invalidate the store snapshot.
        scratch: dict[str, torch.Tensor] = {}
        s = c = None
        out = None
        w = self.store.num_words
        for i, cmd in enumerate(plan.commands):
            if isinstance(cmd, MWSCommand):
                raw = self._sense(cmd, seed + i, scratch)
                s = raw if cmd.iscm.init_s_latch or s is None else s & raw
                if cmd.iscm.init_c_latch:
                    c = None  # M4 pulse wipes the cache latch (Fig. 6a)
                if cmd.iscm.move_s_to_c:
                    c = s if c is None else c | s
            elif isinstance(cmd, XORCommand):
                c = s ^ c
            elif isinstance(cmd, SpillCommand):
                # spilled data is physical, like every stored page; the
                # planner recorded any complement in the scratch placement
                scratch[cmd.page_name] = s if cmd.source == "S" else c
                self.pec[cmd.block] = self.pec.get(cmd.block, 0) + 1
            elif isinstance(cmd, TransferCommand):
                value = s if cmd.source == "S" else c
                out = ~value if cmd.invert else value
            elif isinstance(cmd, ESPCommand):
                pass  # data writes flow through fc_write in this model
        assert out is not None, "plan missing TransferCommand"
        return out[:w]


def eval_expr(e: Expr, logical: dict) -> torch.Tensor:
    """Direct (oracle) evaluation of an expression on logical page data
    (int32 tensors, or host uint32 arrays converted on use)."""
    if isinstance(e, Page):
        v = logical[e.name]
        return v if isinstance(v, torch.Tensor) else to_words(v)
    vals = torch.stack([eval_expr(c, logical) for c in e.children])
    if isinstance(e, Threshold):
        return bitslice_threshold(vals, e.k, vals.shape[0])[0]
    assert isinstance(e, Node)
    return reduce_words(vals, e.op)
