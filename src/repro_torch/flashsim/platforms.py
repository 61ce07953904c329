"""End-to-end performance/energy model of the four platforms (paper §7).

OSP  — outside-storage processing: stream every operand to the host CPU;
       external PCIe link is the bottleneck, host busy the whole time.
ISP  — in-storage processing: per-channel accelerator; SSD-internal channel
       bandwidth is the bottleneck.
PB   — ParaBit IFP: one sensing per operand per page position; sensing is
       the bottleneck for many-operand ops.
FC   — Flash-Cosmos: one MWS per planner command (≈ one per 48 operands);
       result transfer dominates when operands are few but large.

Modeling follows the paper's two-stage throughput formulation: SSD-side
(sense + internal DMA) and host-side stages pipeline, so the end-to-end time
is the max of the stage times plus un-overlappable result handling.  Energy
integrates active/idle host power over time plus per-operation flash/DMA/link
energies — with host idle power included, which is what makes the paper's
energy ratios (e.g. 1839× for BMI m=36) reproducible.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from repro_torch.flashsim.geometry import DEFAULT_SSD, SSDConfig
from repro_torch.flashsim.timing import (
    mws_energy_j,
    mws_latency_us,
    threshold_latency_us,
)
from repro_torch.flashsim.workloads import BulkBitwiseWorkload, MWSCommandShape


def _shape_latency_us(ssd: SSDConfig, s: MWSCommandShape) -> float:
    """One command's sensing latency: threshold shapes pay the staircase
    reference sweep on top of the MWS wordline-select setup."""
    if getattr(s, "threshold_k", 0):
        return threshold_latency_us(ssd.t_r_us, s.n_blocks, s.max_wls_per_block)
    return mws_latency_us(ssd.t_r_us, s.n_blocks, s.max_wls_per_block)


class Platform(enum.Enum):
    OSP = "osp"
    ISP = "isp"
    PB = "parabit"
    FC = "flash-cosmos"


@dataclass(frozen=True)
class PlatformResult:
    platform: Platform
    time_s: float
    energy_j: float
    breakdown: dict = field(default_factory=dict)

    @property
    def bits_per_joule(self) -> float:
        return self.breakdown.get("useful_bits", 0.0) / self.energy_j


def _sense_time_s(ssd: SSDConfig, senses_per_plane: int) -> float:
    return senses_per_plane * ssd.t_r_us * 1e-6


def _common(ssd: SSDConfig, wl: BulkBitwiseWorkload):
    positions = ssd.pages_per_plane(wl.operand_bits)
    operand_bytes = wl.num_operands * wl.operand_bits / 8 * wl.num_queries
    result_bytes = wl.result_bits / 8 * wl.num_queries
    total_sense_pages = positions * ssd.num_planes  # per operand vector
    useful_bits = wl.num_operands * wl.operand_bits * wl.num_queries
    return positions, operand_bytes, result_bytes, total_sense_pages, useful_bits


def run_workload(
    wl: BulkBitwiseWorkload,
    platform: Platform,
    ssd: SSDConfig = DEFAULT_SSD,
) -> PlatformResult:
    positions, operand_bytes, result_bytes, sense_pages, useful_bits = _common(
        ssd, wl
    )
    Q = wl.num_queries

    if platform is Platform.OSP:
        t_sense = _sense_time_s(ssd, wl.num_operands * positions * Q)
        t_int = operand_bytes / ssd.internal_bw
        t_ext = operand_bytes / ssd.ext_bw
        # host compute fully hidden behind operand streaming (§8.1)
        t = max(t_sense, t_int, t_ext)
        e = (
            ssd.p_host_active_w * t
            + wl.num_operands * Q * sense_pages * ssd.e_sense_page
            + operand_bytes * 8 * (ssd.e_dma_per_bit + ssd.e_ext_per_bit)
            + ssd.p_ssd_idle_w * t
        )
        return PlatformResult(
            platform,
            t,
            e,
            {
                "t_sense": t_sense,
                "t_internal": t_int,
                "t_external": t_ext,
                "bottleneck": "external-io",
                "useful_bits": useful_bits,
            },
        )

    if platform is Platform.ISP:
        t_sense = _sense_time_s(ssd, wl.num_operands * positions * Q)
        t_int = operand_bytes / ssd.internal_bw
        t_result = result_bytes / ssd.ext_bw
        # the accelerator streams results out while operands stream in
        t = max(t_sense, t_int, t_result)
        t_host = result_bytes / ssd.host_compute_bw
        e = (
            ssd.p_host_active_w * t_host
            + ssd.p_host_idle_w * max(0.0, t - t_host)
            + wl.num_operands * Q * sense_pages * ssd.e_sense_page
            + operand_bytes * 8 * ssd.e_dma_per_bit
            + (operand_bytes / 64) * ssd.e_accel_per_64b
            + result_bytes * 8 * ssd.e_ext_per_bit
            + ssd.p_ssd_idle_w * t
        )
        return PlatformResult(
            platform,
            t,
            e,
            {
                "t_sense": t_sense,
                "t_internal": t_int,
                "t_result": t_result,
                "bottleneck": "internal-io" if t_int >= t_sense else "sense",
                "useful_bits": useful_bits,
            },
        )

    if platform is Platform.PB:
        # one sensing per operand per position; result moves overlap sensing
        t_sense = _sense_time_s(ssd, wl.num_operands * positions * Q)
        t_res_int = result_bytes / ssd.internal_bw
        t_res_ext = result_bytes / ssd.ext_bw
        t = max(t_sense, t_res_int, t_res_ext)
        t_host = (
            result_bytes / ssd.host_compute_bw if wl.host_postprocess else 0.0
        )
        e = (
            ssd.p_host_active_w * t_host
            + ssd.p_host_idle_w * max(0.0, t - t_host)
            + wl.num_operands * Q * sense_pages * ssd.e_sense_page
            + result_bytes * 8 * (ssd.e_dma_per_bit + ssd.e_ext_per_bit)
            + ssd.p_ssd_idle_w * t
        )
        return PlatformResult(
            platform,
            t,
            e,
            {
                "t_sense": t_sense,
                "t_result_ext": t_res_ext,
                "bottleneck": "sense" if t_sense >= t_res_ext else "external-io",
                "useful_bits": useful_bits,
            },
        )

    assert platform is Platform.FC
    cmd_pairs = wl.fc_command_pairs
    t_cmd_us = sum(
        _shape_latency_us(ssd, s) * cnt for s, cnt in cmd_pairs
    )
    t_sense = t_cmd_us * 1e-6 * positions * Q
    t_res_int = result_bytes / ssd.internal_bw
    t_res_ext = result_bytes / ssd.ext_bw
    t = max(t_sense, t_res_int, t_res_ext)
    t_host = result_bytes / ssd.host_compute_bw if wl.host_postprocess else 0.0
    e_mws = (
        sum(
            # threshold sensings hold the read circuitry active for their
            # longer staircase sweep: energy scales with the same latency
            mws_energy_j(
                ssd.t_r_us, ssd.p_read_w, s.n_blocks, s.max_wls_per_block
            )
            * (
                _shape_latency_us(ssd, s)
                / mws_latency_us(ssd.t_r_us, s.n_blocks, s.max_wls_per_block)
            )
            * cnt
            for s, cnt in cmd_pairs
        )
        * positions
        * ssd.num_planes
        * Q
    )
    e = (
        ssd.p_host_active_w * t_host
        + ssd.p_host_idle_w * max(0.0, t - t_host)
        + e_mws
        + result_bytes * 8 * (ssd.e_dma_per_bit + ssd.e_ext_per_bit)
        + ssd.p_ssd_idle_w * t
    )
    return PlatformResult(
        platform,
        t,
        e,
        {
            "t_sense": t_sense,
            "t_result_ext": t_res_ext,
            "mws_commands": sum(cnt for _, cnt in cmd_pairs),
            "bottleneck": "sense" if t_sense >= t_res_ext else "external-io",
            "useful_bits": useful_bits,
        },
    )


def fig7_timeline(ssd: SSDConfig) -> dict:
    """Per-channel segment durations for the Fig. 7 walk-through (3 × 1 MiB
    OR): returns the per-die tR/tDMA/tEXT figures and each platform's
    channel-level bottleneck time for one batch of 32 KiB per die."""
    batch_bytes = ssd.planes_per_die * ssd.page_bytes  # 32 KiB per die
    t_dma = batch_bytes / ssd.channel_bw
    t_ext = batch_bytes / ssd.ext_bw
    dies = ssd.dies_per_channel
    return {
        "tR_us": ssd.t_r_us,
        "tDMA_us": t_dma * 1e6,
        "tEXT_us": t_ext * 1e6,
        # one sensing round across the channel's dies:
        "osp_round_us": max(ssd.t_r_us, dies * t_dma * 1e6)
        + dies * t_ext * 1e6 * ssd.channels,  # ext shared by 8 channels
        "isp_round_us": max(ssd.t_r_us, dies * t_dma * 1e6),
        "ifp_round_us": ssd.t_r_us,
    }
