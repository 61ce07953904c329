"""SSD / NAND geometry and timing constants (paper Table 1)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SSDConfig:
    # -- organization (Table 1: 48-WL-layer 3D TLC NAND SSD, 2 TB) ---------
    channels: int = 8
    dies_per_channel: int = 8
    planes_per_die: int = 2
    blocks_per_plane: int = 2048
    wls_per_block: int = 48  # sub-block = compute granularity (paper §2.1)
    subblocks_per_block: int = 4  # 196 = 4 × 48 WLs per (full) block
    page_bytes: int = 16 * 1024

    # -- latencies (Table 1) -------------------------------------------------
    t_r_us: float = 22.5  # SLC-mode page read
    t_mws_us: float = 25.0  # MWS with the ≤4-block inter-block limit
    t_prog_slc_us: float = 200.0
    t_prog_mlc_us: float = 500.0
    t_prog_tlc_us: float = 700.0
    t_esp_us: float = 400.0
    t_bers_ms: float = 4.0  # block erase (3–5 ms, §2.1)

    # -- bandwidths (Table 1) -----------------------------------------------
    channel_bw: float = 1.2e9  # B/s per channel
    ext_bw: float = 8.0e9  # B/s host link (4-lane PCIe Gen4)

    # -- limits ----------------------------------------------------------------
    max_inter_blocks: int = 4  # power budget (§5.2 / Fig. 14)

    # -- power/energy constants (documented estimates; §Energy in DESIGN) --
    p_read_w: float = 0.0825  # per-plane active sense power (≈25 mA @ 3.3 V)
    p_prog_w: float = 0.165  # per-plane program power (~2x read: ISPP pulses)
    e_dma_per_bit: float = 8e-12  # ONFI channel I/O
    e_ext_per_bit: float = 15e-12  # PCIe + SSD controller
    e_accel_per_64b: float = 93e-12  # ISP accelerator (Table 1)
    p_host_active_w: float = 100.0  # i7-11700K package+DRAM under load
    p_host_idle_w: float = 15.0
    p_ssd_idle_w: float = 2.0
    host_compute_bw: float = 20e9  # host bulk-bitwise/bit-count B/s (DRAM-bw)

    # -- derived ----------------------------------------------------------
    @property
    def num_planes(self) -> int:
        return self.channels * self.dies_per_channel * self.planes_per_die

    @property
    def internal_bw(self) -> float:
        return self.channels * self.channel_bw  # 9.6 GB/s (Table 1)

    @property
    def page_bits(self) -> int:
        return self.page_bytes * 8

    @property
    def e_sense_page(self) -> float:
        """Energy of one SLC page sense (J)."""
        return self.p_read_w * self.t_r_us * 1e-6

    def pages_per_plane(self, vector_bits: int) -> int:
        """Page positions per plane for a bit vector striped over all planes."""
        total_pages = -(-vector_bits // self.page_bits)
        return -(-total_pages // self.num_planes)


DEFAULT_SSD = SSDConfig()


# The Fig. 7 walk-through example uses a smaller SSD (4 dies/channel = 64
# planes) with tR = 60 µs; kept separate so the timeline benchmark can
# reproduce the figure's numbers exactly (tDMA = 27 µs, tEXT = 4 µs).
FIG7_SSD = SSDConfig(dies_per_channel=4, t_r_us=60.0)
