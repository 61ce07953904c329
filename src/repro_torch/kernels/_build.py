"""Build, load and call the port's CUDA kernels (plain C interface + ctypes).

The sources live in ``repro_torch/csrc/*.cu``.  At first use each source is
compiled for ``sm_90a`` by its own ``nvcc`` process (all started
together), the objects are linked into one shared library, and the
library is loaded with ``ctypes``.  The build goes into
``repro_torch/csrc/build/`` under a name derived from the sources' hash,
so an edited source rebuilds and an unchanged one loads the cached
library.  Nothing here runs at import time: the CPU tests import every
module on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("mws.cu", "popcount.cu", "threshold.cu", "signcomp.cu", "mws_count.cu")
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # (src, ext, shr, idx, out, S, B, K, N, W, m_ext, m_shr, op, outer_or,
    #  invert, vec, variant, stream)
    "mws_gather_launch": (_P,) * 5 + (_I, _I, _I, _I, _L) + (_I,) * 7 + (_P,),
    # (x, out, R, W, vec, stream)
    "popcount_launch": (_P, _P, _I, _L, _I, _P),
    # (x, out, N, W, op, invert, vec, stream)
    "mws_count_launch": (_P, _P, _L, _L, _I, _I, _I, _P),
    # (x, out, B, n, W, k, invert, vec, stream)
    "threshold_launch": (_P, _P, _I, _I, _L, _I, _I, _I, _P),
    # (x or words, out, n, R, W, vec, stream)
    "pack_signs_launch": (_P, _P, _L, _L, _L, _I, _P),
    "unpack_signs_launch": (_P, _P, _L, _L, _L, _I, _P),
    # (stacks, out, K, words, vec, stream)
    "majority_launch": (_P, _P, _I, _L, _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's build
build_log: str = ""  # nvcc's output (-Xptxas -v), for the smoke log


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or CUDA_HOME): the CUDA kernels build only "
        "on a machine with the CUDA toolkit"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (one ``nvcc`` per source, in parallel) and link
    them into one shared library; returns its path.  A library built from
    identical sources is reused."""
    global build_seconds, build_log
    lib = BUILD_DIR / f"libreprokernels-{_digest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name.replace(".cu", ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / name), "-o", obj]
            procs.append(
                (name, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ))
            )
        logs = []
        failed = []
        for name, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {name}\n{out}")
            if p.returncode:
                failed.append(name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        part = os.path.join(tmp, lib.name)
        link = subprocess.run(
            [nvcc, "-shared", "-o", part, *(obj for _, obj, _ in procs)],
            capture_output=True,
            text=True,
        )
        if link.returncode:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}{link.stderr}")
        os.replace(part, lib)  # atomic: concurrent builders never see half a file
    build_seconds = time.perf_counter() - t0
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA
    one (the kernel launches); any other device (a meta tensor) raises,
    so no launch gets a pointer without memory behind it."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"the kernels take cpu or cuda tensors, got {t.device}")


def check_words(t: torch.Tensor, name: str, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous int32 CUDA tensor of ``ndim`` dims."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 words, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def vec_width(w: int, *tensors: torch.Tensor | None) -> int:
    """4 when every row of ``w`` words starts 16-byte aligned, else 1."""
    if w % 4:
        return 1
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            return 1
    return 4


def launch(fn_name: str, *args) -> None:
    """Call a C launcher on the current stream; raise on a CUDA error."""
    fn = getattr(library(), fn_name)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{fn_name} failed with cudaError_t {err}")
