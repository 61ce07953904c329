#!/usr/bin/env python3
"""The grid-order control for B1, the MWS gather-reduce, on one NVIDIA GPU.

Run from the repository root:

    python3 tools/b1_grid_control.py

At FlashQL's largest B1 launches (src (64, 4194304) with idx (45, 2, 2),
and src (52, 4194304) with idx (22, 2, 2): 16 MiB pages, many plans over
12 distinct rows) it times three launches of the same gather-reduce:

* ``staged``: ``mws_gather`` as the serving path calls it (the staged
  variant of ``src/repro_torch/csrc/mws.cu``);
* ``streaming``: the same wrapper's streaming variant;
* ``row_fastest``: ``tools/b1_grid_control.cu``, the streaming kernel with
  the output row fastest in the grid, so the L2 serves a column block's
  repeated rows while its plans run together.

Each is held bit-exact against ``mws_gather_ref`` and timed with
``chip_smoke.py``'s ``time_ms``.  The indices are drawn from a seed with
the flush's repeat structure: block k of plan b ANDs one of 8 "country"
rows with one of 4 "device" rows.  Prints the card's name and power
limit, then one JSON line.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "tools" / "b1_grid_control.cu"
BUILD = ROOT / "tools" / "build"
W = 4_194_304  # words of one 16 MiB page
SHAPES = ((64, 45), (52, 22))  # (slots, plans) of the two largest launches
SEED = 0


def build() -> ctypes.CDLL:
    from repro_torch.kernels._build import _nvcc

    BUILD.mkdir(exist_ok=True)
    lib = BUILD / "libb1control.so"
    subprocess.run(
        [
            _nvcc(),
            "-gencode",
            "arch=compute_90a,code=sm_90a",
            "-O3",
            "-shared",
            "-Xcompiler",
            "-fPIC",
            str(SOURCE),
            "-o",
            str(lib),
        ],
        check=True,
    )
    dll = ctypes.CDLL(str(lib))
    fn = dll.b1_row_fastest_launch
    fn.argtypes = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)
    fn.restype = ctypes.c_int
    return dll


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("b1_grid_control: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import _card, hbm_rate, time_ms
    from repro_torch.core.bitops import BitOp
    from repro_torch.kernels.mws import mws_gather, mws_gather_ref
    from repro_torch.kernels.mws import ops as mws_ops

    card = _card()
    kind = torch.cuda.get_device_name(0)
    fn = build().b1_row_fastest_launch
    rng = np.random.default_rng(SEED)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    rows = []
    for S, B in SHAPES:
        src = torch.randint(-(2**31), 2**31, (S, W), generator=g, dtype=torch.int32, device="cuda")
        named = rng.choice(S, 12, replace=False)
        idx_np = np.stack(
            [rng.choice(named[:8], (B, 2)), rng.choice(named[8:], (B, 2))], axis=-1
        ).astype(np.int32)
        idx = torch.as_tensor(idx_np, device="cuda")

        def staged():
            return mws_gather(src, idx, BitOp.AND)

        def streaming():
            out = torch.empty((B, W), dtype=torch.int32, device="cuda")
            mws_ops._launch(src, idx, BitOp.AND, True, False, None, None, out, 4, 0)
            return out

        def row_fastest():
            out = torch.empty((B, W), dtype=torch.int32, device="cuda")
            err = fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(), B, 2, 2, W, 0,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"b1_row_fastest_launch failed with cudaError_t {err}")
            return out

        want = mws_gather_ref(src, idx, BitOp.AND)
        before = mws_gather.variant_launches["staged"]
        for name, f in (("staged", staged), ("streaming", streaming), ("row_fastest", row_fastest)):
            if not torch.equal(f(), want):
                raise AssertionError(f"{name} != plain version at ({B}, 2, 2)")
        if mws_gather.variant_launches["staged"] != before + 1:
            raise AssertionError("the wrapper did not launch the staged variant")
        del want
        distinct = int(torch.unique(idx).numel())
        rows.append(
            {
                "src": [S, W],
                "idx": [B, 2, 2],
                "distinct_rows": distinct,
                "staged_ms": time_ms(staged, 20),
                "streaming_ms": time_ms(streaming, 20),
                "row_fastest_ms": time_ms(row_fastest, 20),
                "bound_ms": ((distinct + B) * 4 * W + idx.numel() * 4) / hbm_rate(kind) * 1e3,
            }
        )
        del src, idx
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"b1_grid_control": rows, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
