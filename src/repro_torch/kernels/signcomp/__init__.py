from repro_torch.kernels.signcomp.ops import (
    LANES,
    SignLayout,
    compress_signs,
    decompress_signs,
    majority_vote,
    sign_layout,
)
from repro_torch.kernels.signcomp.ref import (
    compress_signs_ref,
    decompress_signs_ref,
    majority_ref,
    pack_signs_ref,
    unpack_signs_ref,
)

__all__ = [
    "LANES",
    "SignLayout",
    "compress_signs",
    "decompress_signs",
    "majority_vote",
    "sign_layout",
    "compress_signs_ref",
    "decompress_signs_ref",
    "majority_ref",
    "pack_signs_ref",
    "unpack_signs_ref",
]
