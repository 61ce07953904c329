"""MWS latency and power models calibrated to the paper's measurements.

Anchor points (all stated in §5.2):

* intra-block (Fig. 12): single-WL read without randomization needs no extra
  latency; ≤ 8 WLs < +1%; all 48 WLs +3.3%.
* inter-block (Fig. 13): WL-precharge hidden by BL-precharge up to ~8 blocks;
  4 blocks +3.3%; 32 blocks +36.3% (≪ 32× for serial reads).
* power (Fig. 14): 1→2 blocks +34%; 4 blocks ≈ +80% (< erase power);
  4-block MWS saves ~53% energy vs 4 serial reads.

Between anchors we interpolate piecewise-linearly — the paper publishes only
these points, and every consumer in this repo (benchmarks, platform model)
asserts against the anchors, not the interpolation.
"""

from __future__ import annotations

import numpy as np

# (n_wls, tMWS/tR - 1) anchors for intra-block MWS (Fig. 12)
_INTRA_ANCHORS = [(1, 0.0), (8, 0.008), (48, 0.033)]
# (n_blocks, tMWS/tR - 1) anchors for inter-block MWS (Fig. 13)
_INTER_ANCHORS = [(1, 0.0), (4, 0.033), (8, 0.049), (32, 0.363)]
# (n_blocks, P/P_read) anchors for inter-block MWS power (Fig. 14)
_POWER_ANCHORS = [(1, 1.0), (2, 1.34), (4, 1.80), (32, 8.24)]

ERASE_POWER_RATIO = 1.9  # erase power ceiling: 4-block MWS stays below it


def _interp(anchors, x: float) -> float:
    xs = np.array([a[0] for a in anchors], dtype=float)
    ys = np.array([a[1] for a in anchors], dtype=float)
    if x >= xs[-1]:  # extrapolate with the final slope
        slope = (ys[-1] - ys[-2]) / (xs[-1] - xs[-2])
        return float(ys[-1] + slope * (x - xs[-1]))
    return float(np.interp(x, xs, ys))


def intra_block_tmws_ratio(n_wls: int) -> float:
    """tMWS / tR for an intra-block MWS over ``n_wls`` wordlines."""
    return 1.0 + _interp(_INTRA_ANCHORS, n_wls)


def inter_block_tmws_ratio(n_blocks: int) -> float:
    """tMWS / tR for an inter-block MWS over ``n_blocks`` blocks."""
    return 1.0 + _interp(_INTER_ANCHORS, n_blocks)


def mws_power_ratio(n_blocks: int, n_wls_intra: int = 1) -> float:
    """MWS power / regular-read power.

    Inter-block activation dominates (more WLs precharged); intra-block MWS
    is slightly *cheaper* than a read (extra target WLs get V_REF instead of
    the much higher V_PASS, §4.1).
    """
    p = _interp(_POWER_ANCHORS, n_blocks)
    p -= 0.002 * max(0, n_wls_intra - 1)  # small intra-block discount
    return max(p, 0.5)


def mws_latency_us(
    t_r_us: float, n_blocks: int, max_wls_per_block: int
) -> float:
    """Latency of one MWS command (the slower of the two effects governs)."""
    ratio = max(
        inter_block_tmws_ratio(n_blocks),
        intra_block_tmws_ratio(max_wls_per_block),
    )
    return t_r_us * ratio


def mws_energy_j(
    t_r_us: float, p_read_w: float, n_blocks: int, max_wls_per_block: int
) -> float:
    """Energy of one MWS command on one plane."""
    t = mws_latency_us(t_r_us, n_blocks, max_wls_per_block) * 1e-6
    return t * p_read_w * mws_power_ratio(n_blocks, max_wls_per_block)


# ---------------------------------------------------------------------------
# Threshold sensing (MCFlash dynamic sensing thresholds)
# ---------------------------------------------------------------------------
#
# A k-of-N sense replaces the wired-OR cross-block combine with a
# programmable current comparison: the sense amplifier must settle a
# reference ladder and resolve the summed block current, so one threshold
# sense costs several plain-read times of setup plus a small per-block
# current-resolution term.  Still FAR cheaper than the C(N, k) And/Or
# chain it replaces once N grows — the cost model prices both and keeps
# the cheaper form.
THRESH_SETUP_RATIO = 6.0  # reference-ladder settle, in units of tR
THRESH_PER_BLOCK_RATIO = 0.15  # per-block current resolution, units of tR


def threshold_latency_us(
    t_r_us: float, n_blocks: int, max_wls_per_block: int
) -> float:
    """Latency of one k-of-N threshold sensing command."""
    return mws_latency_us(t_r_us, n_blocks, max_wls_per_block) + t_r_us * (
        THRESH_SETUP_RATIO - 1.0 + THRESH_PER_BLOCK_RATIO * n_blocks
    )


# ---------------------------------------------------------------------------
# Multi-level (MLC/TLC) packing factors
# ---------------------------------------------------------------------------


def level_read_factor(levels: int) -> float:
    """Sense-time scale for an L-level page, per logical page sensed.

    Resolving L bits per cell needs a (2^L - 1)-step reference staircase
    that yields L logical pages: (2^L - 1) / L reads' worth of staircase
    per page — 1.0 (SLC), 1.5 (MLC), ~2.33 (TLC).
    """
    return (2.0**levels - 1.0) / levels


def level_program_factor(levels: int) -> float:
    """Program-time scale for an L-level page, per physical program.

    ISPP needs finer verify steps as the per-level margin shrinks; the
    paper's Table 1 tPROG SLC:MLC:TLC = 200:500:700 is roughly linear in
    the level count — modelled as (1 + L) / 2: 1.0, 1.5, 2.0.
    """
    return (1.0 + levels) / 2.0
