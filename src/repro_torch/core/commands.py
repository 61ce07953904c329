"""Flash-Cosmos NAND command set (paper §6.2, Fig. 15).

Three new commands: ``MWS`` (multi-wordline sensing with ISCM flags and
per-block page bitmaps), ``ESP`` (enhanced SLC-mode program), ``XOR``
(inter-latch XOR).  The encodings below follow Fig. 15: an MWS command
carries an ISCM flag slot, then up to :data:`MAX_INTER_BLOCKS` (block
address, page-bitmap) slots chained with CONT and closed with CONF.
"""

from __future__ import annotations

from dataclasses import dataclass, field

MAX_INTER_BLOCKS = 4  # power-budget limit measured in §5.2 (Fig. 14)
WLS_PER_BLOCK = 48  # NAND-string length of the characterized chips
# Threshold sensing (MCFlash-style dynamic sensing) compares the summed
# bitline current of the activated blocks against a programmable reference
# instead of a fixed conduct/no-conduct cut, so its power envelope is the
# slower staircase sense, not the parallel-OR one — the characterized
# dynamic-sensing chips resolve up to 8 block currents in one shot.
THRESHOLD_MAX_BLOCKS = 8


@dataclass(frozen=True)
class ISCM:
    """The four ISCM feature flags of an MWS command (Fig. 15a)."""

    inverse_read: bool = False  # I: sense in inverse-read mode
    init_s_latch: bool = True  # S: initialize sensing latch before evaluate
    init_c_latch: bool = True  # C: initialize cache latch
    move_s_to_c: bool = False  # M: pulse M3 (S-latch -> C-latch transfer)

    def __post_init__(self):
        # §6.2: an inverse read requires S-latch initialization, which
        # prevents accumulation into the S-latch by an inverse-read command.
        if self.inverse_read and not self.init_s_latch:
            raise ValueError(
                "inverse read requires S-latch initialization (paper §6.2)"
            )


@dataclass(frozen=True)
class BlockPBM:
    """One address slot: block index + page bitmap of wordlines to sense."""

    block: int
    pbm: int  # bit i set => apply V_REF to wordline i (V_PASS otherwise)

    def __post_init__(self):
        if self.pbm <= 0 or self.pbm >= (1 << WLS_PER_BLOCK):
            raise ValueError(f"PBM out of range for {WLS_PER_BLOCK}-WL block")

    @property
    def wordlines(self) -> tuple[int, ...]:
        return tuple(i for i in range(WLS_PER_BLOCK) if (self.pbm >> i) & 1)


@dataclass(frozen=True)
class MWSCommand:
    iscm: ISCM
    targets: tuple[BlockPBM, ...]

    def __post_init__(self):
        if not 1 <= len(self.targets) <= MAX_INTER_BLOCKS:
            raise ValueError(
                f"MWS activates 1..{MAX_INTER_BLOCKS} blocks, got "
                f"{len(self.targets)} (power budget, §5.2)"
            )
        blocks = [t.block for t in self.targets]
        if len(set(blocks)) != len(blocks):
            raise ValueError("duplicate block address slots")

    @property
    def num_blocks(self) -> int:
        return len(self.targets)

    @property
    def num_wordlines(self) -> int:
        return sum(len(t.wordlines) for t in self.targets)


@dataclass(frozen=True)
class ThresholdCommand(MWSCommand):
    """k-of-N threshold sensing (MCFlash dynamic sensing thresholds).

    Bit ``j`` of the raw result is 1 iff at least ``k`` of the activated
    blocks conduct at position ``j`` — each block conducts iff ALL of its
    selected wordlines conduct, exactly as in a plain MWS, but the
    cross-block combine is a programmable current threshold instead of
    the fixed wired-OR (``k == 1`` degenerates to the MWS OR).
    ``iscm.inverse_read`` complements the result AFTER the comparison.
    """

    k: int = 1

    def __post_init__(self):
        if not 1 <= len(self.targets) <= THRESHOLD_MAX_BLOCKS:
            raise ValueError(
                f"threshold sensing activates 1..{THRESHOLD_MAX_BLOCKS} "
                f"blocks, got {len(self.targets)} (dynamic-sensing power "
                "envelope)"
            )
        blocks = [t.block for t in self.targets]
        if len(set(blocks)) != len(blocks):
            raise ValueError("duplicate block address slots")
        if not 1 <= self.k <= len(self.targets):
            raise ValueError(
                f"threshold k={self.k} outside 1..{len(self.targets)} blocks"
            )


@dataclass(frozen=True)
class XORCommand:
    """C-latch := S-latch XOR C-latch (existing on-chip XOR logic, §6.1)."""


@dataclass(frozen=True)
class ESPCommand:
    """Program one wordline with enhanced SLC-mode programming (§4.2)."""

    block: int
    wordline: int
    page_name: str
    tesp_ratio: float = 2.0  # tESP/tPROG; >= 1.9 guarantees zero errors


@dataclass(frozen=True)
class TransferCommand:
    """DMA the result latch to the controller; optionally invert in flight.

    The controller-side inversion is how the engine realizes a final NOT when
    the inverse-read slot is already used (free: the bus inverter costs no
    flash-array operation)."""

    source: str = "C"  # "S" or "C"
    invert: bool = False


@dataclass(frozen=True)
class SpillCommand:
    """Program the current result latch into a scratch page (ESP mode) so a
    later command chain can re-sense it — used when an expression needs more
    inverse-read groups than one S-latch chain allows."""

    block: int
    wordline: int
    page_name: str
    source: str = "S"


Command = (
    MWSCommand
    | ThresholdCommand
    | XORCommand
    | ESPCommand
    | TransferCommand
    | SpillCommand
)


@dataclass
class CommandPlan:
    commands: list[Command] = field(default_factory=list)
    result_source: str = "S"  # latch holding the final result
    result_invert: bool = False  # controller-side inversion on transfer

    @property
    def num_sensing_ops(self) -> int:
        return sum(1 for c in self.commands if isinstance(c, MWSCommand))

    @property
    def num_spills(self) -> int:
        return sum(1 for c in self.commands if isinstance(c, SpillCommand))
