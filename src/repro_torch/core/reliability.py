"""RBER / ESP reliability model (paper §2.2, §5, Figs. 8 & 11).

There is no threshold voltage on a GPU, so ESP becomes (i) this calibrated
analytical RBER model, consumed by :mod:`repro_torch.flashsim` to reproduce
the paper's reliability figures, and (ii) the *verified storage mode* of the
engine (no error injection) — the software analogue of "zero bit errors in
computation results".

Calibration anchors (all stated in the paper text; interior points of Fig. 8
are interpolated, which we document rather than pretend to measure):

* disabling randomization multiplies RBER by **1.91×** (SLC) / **4.92×** (MLC);
* MLC-mode RBER is up to **4×** SLC-mode RBER;
* the MLC plots span **8.6e-4 … 1.6e-2** across (PEC, retention, rand);
* SLC+randomization is "~12 orders of magnitude above" the 1e-15…1e-16 UBER
  target at the worst tested condition (10K PEC, 1-year retention);
* ESP (Fig. 11): at tESP ≥ **1.9×tPROG**, zero errors across 4.83e11 bits
  (statistical RBER < **2.07e-12** → modelled as 0); the *median* block gains
  one order of magnitude at tESP = 1.6×tPROG.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum

import torch

UBER_TARGET = 1e-15  # JEDEC-ish requirement quoted in the paper
ESP_ZERO_THRESHOLD = 2.07e-12  # below this the paper observed zero errors
ESP_ZERO_TESP = 1.9  # tESP/tPROG ratio where all tested blocks hit zero

# Reference worst-case condition used throughout the paper's §5 methodology.
REF_PEC = 10_000
REF_RETENTION_DAYS = 365

# Anchors (see module docstring).
_RAND_OFF_SLC = 1.91
_RAND_OFF_MLC = 4.92
_MLC_OVER_SLC = 4.0
_MLC_NORAND_MAX = 1.6e-2  # @ (10K PEC, 1 yr, no randomization)
_MLC_RAND_MIN = 8.6e-4  # @ (1K PEC, 1 day, randomized)

# Derived reference points.
_MLC_RAND_REF = _MLC_NORAND_MAX / _RAND_OFF_MLC  # 3.25e-3
_SLC_RAND_REF = _MLC_RAND_REF / _MLC_OVER_SLC  # 8.1e-4 (~12 orders over UBER)

# Stress exponents: chosen so MLC+rand at the mildest tested condition
# (1K PEC, 1 day) lands on the paper's 8.6e-4 minimum.
#   total dynamic range needed: 3.25e-3 / 8.6e-4 = 3.78×
_PEC_EXP = 0.447  # (1K -> 10K) contributes 10**0.447 = 2.80×
_RET_EXP = math.log(3.78 / 2.80) / math.log(365.0)  # 1 d -> 365 d: 1.35×

# ESP log-drop curve  drop(Δ) = α·Δ + β·Δ^γ  (orders of magnitude),
# fitted to: median block −1 order at Δ=0.6; ≥10.3 orders at Δ=0.9 so that
# even the worst tested block (quality ≈ 22×) lands below the zero threshold
# — Fig. 11 reports zero errors in ALL tested pages at tESP ≥ 1.9×tPROG.
_ESP_ALPHA = 0.725
_ESP_BETA = 20.2
_ESP_GAMMA = 7.0


class CellMode(Enum):
    SLC = "slc"
    MLC = "mlc"
    TLC = "tlc"  # storage-only in this work (paper characterizes TLC chips
    # but computes on SLC-mode pages)


@dataclass(frozen=True)
class ProgramConfig:
    """How a page was programmed (paper: mode + randomization + tESP).

    ``levels`` is the multi-level packing count (1 = one bitmap page per
    physical page, the SLC-parity baseline; 2/3 = MLC/TLC-style packing
    of 2/3 bitmap pages at distinct voltage levels).  Packing L pages
    divides the per-level voltage margin by L, so the raw error rate
    scales as L^2 (RBER ~ margin^-2 in the charge-noise regime — the
    L=2 factor reproduces the paper's 4x MLC-over-SLC anchor), and the
    ESP margin gain of a given tESP stretch shrinks by the same 1/L.
    """

    mode: CellMode = CellMode.SLC
    randomized: bool = True
    tesp_ratio: float = 1.0  # tESP / tPROG; 1.0 == regular programming
    levels: int = 1  # bitmap pages packed per physical page (1..3)

    def __post_init__(self):
        if not 1 <= self.levels <= 3:
            raise ValueError(f"levels must be 1..3, got {self.levels}")

    @property
    def is_esp(self) -> bool:
        # zero-error needs the FULL 0.9x margin stretch at the per-level
        # scale: Delta >= (ESP_ZERO_TESP - 1) * levels
        zero_at = 1.0 + (ESP_ZERO_TESP - 1.0) * self.levels
        return self.tesp_ratio >= zero_at and not self.randomized


def _mode_base(mode: CellMode) -> float:
    if mode is CellMode.SLC:
        return _SLC_RAND_REF
    if mode is CellMode.MLC:
        return _MLC_RAND_REF
    # TLC ~ 2× MLC (paper: more bits/cell => smaller margins; §2.2)
    return 2.0 * _MLC_RAND_REF


def _rand_off_factor(mode: CellMode) -> float:
    return _RAND_OFF_SLC if mode is CellMode.SLC else _RAND_OFF_MLC


def esp_log_drop(tesp_ratio: float, levels: int = 1) -> float:
    """Orders of magnitude of RBER reduction vs regular programming.

    Packing ``levels`` pages per cell shrinks the margin an extra tESP
    stretch buys by 1/levels, so the same ratio drops fewer orders — the
    zero-error point moves out to ``1 + 0.9 * levels``.
    """
    delta = max(0.0, tesp_ratio - 1.0) / levels
    drop = _ESP_ALPHA * delta + _ESP_BETA * delta**_ESP_GAMMA
    # the stretched program's finer verify steps also re-tighten the packed
    # levels' distributions: by the full 0.9x per-level stretch the L^2
    # density penalty is fully recovered, restoring SLC-parity zero-error
    # reads at tESP = 1 + 0.9*L (linear in the margin progress; exactly 0
    # at levels=1, so the paper's single-level anchors are untouched)
    drop += (
        2.0
        * math.log10(levels)
        * min(delta / (ESP_ZERO_TESP - 1.0), 1.0)
    )
    return drop


def rber(
    config: ProgramConfig,
    *,
    pec: int = REF_PEC,
    retention_days: float = REF_RETENTION_DAYS,
    block_quality: float = 1.0,
) -> float:
    """Raw bit-error rate for a page programmed with ``config``.

    ``block_quality`` is a per-block multiplier (1.0 = median; the paper's
    Fig. 11 worst/best blocks are ~5×/0.2×).  Returns 0.0 once the modelled
    RBER falls below the paper's zero-observation threshold.
    """
    r = _mode_base(config.mode) * block_quality
    if not config.randomized:
        r *= _rand_off_factor(config.mode)
    # L-level packing divides the per-level margin by L; RBER ~ margin^-2
    # (at L=2 this IS the paper's 4x MLC-over-SLC anchor)
    r *= float(config.levels) ** 2
    r *= (max(pec, 1) / REF_PEC) ** _PEC_EXP
    r *= (max(retention_days, 1e-3) / REF_RETENTION_DAYS) ** _RET_EXP
    r *= 10.0 ** (-esp_log_drop(config.tesp_ratio, config.levels))
    if r < ESP_ZERO_THRESHOLD:
        return 0.0
    return float(r)


# ---------------------------------------------------------------------------
# Data randomization (the SSD scrambler the paper says MWS cannot use)
# ---------------------------------------------------------------------------
#
# Both functions draw from a ``torch.Generator`` seeded with ``seed``.  The
# bits differ from any other framework's generator for the same seed, so a
# noisy read is held to its flip RATE (``rber``), never to exact bits.


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(int(seed))
    return g


def randomize_words(words: torch.Tensor, seed: int) -> torch.Tensor:
    """XOR-scramble packed words with a seeded PRNG sequence (SSD scrambler).

    Involutive: applying twice with the same seed de-randomizes.  Used by
    tests/benchmarks to demonstrate the paper's incompatibility claim:
    MWS over *scrambled* operands, de-randomized afterwards, is garbage.
    """
    mask = torch.randint(
        -(2**31), 2**31, words.shape, generator=_generator(seed),
        dtype=torch.int32,
    )
    return words ^ mask.to(words.device)


def inject_bit_errors(
    words: torch.Tensor, rber_value: float, seed: int
) -> torch.Tensor:
    """Flip each stored bit independently with probability ``rber_value``.

    Models the read-out of a non-ESP page.  Exact per-bit Bernoulli on the
    unpacked view — intended for test/benchmark scale vectors.
    """
    if rber_value <= 0.0:
        return words
    from repro_torch.core.bitops import pack_bits

    nbits = words.numel() * 32
    flips = torch.rand(nbits, generator=_generator(seed)) < rber_value
    flip_words = pack_bits(flips.to(torch.uint8)).reshape(words.shape)
    return words ^ flip_words.to(words.device)


def block_quality_quantile(q: float) -> float:
    """Per-block quality multiplier at quantile q (0=best, 0.5=median, 1=worst).

    Lognormal spread matching Fig. 11's ~±0.7-order worst/best band.
    """
    sigma = 1.0  # ln-space; worst(≈q=0.98) ≈ 7.7×, best(≈0.02) ≈ 0.13×
    from statistics import NormalDist

    z = NormalDist().inv_cdf(min(max(q, 1e-6), 1 - 1e-6))
    return math.exp(sigma * z)
