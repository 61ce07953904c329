from repro_torch.flashsim.geometry import SSDConfig, DEFAULT_SSD
from repro_torch.flashsim.timing import (
    inter_block_tmws_ratio,
    intra_block_tmws_ratio,
    mws_power_ratio,
)
from repro_torch.flashsim.platforms import (
    Platform,
    PlatformResult,
    run_workload,
)
from repro_torch.flashsim.workloads import (
    BulkBitwiseWorkload,
    bmi_workload,
    ims_workload,
    kcs_workload,
)

__all__ = [
    "SSDConfig",
    "DEFAULT_SSD",
    "inter_block_tmws_ratio",
    "intra_block_tmws_ratio",
    "mws_power_ratio",
    "Platform",
    "PlatformResult",
    "run_workload",
    "BulkBitwiseWorkload",
    "bmi_workload",
    "ims_workload",
    "kcs_workload",
]
