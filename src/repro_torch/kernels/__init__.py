"""Hand-written CUDA kernels of the port, one package per kernel.

Each package holds ``ops.py`` (the wrapper: checks, dispatch, launch
count) and ``ref.py`` (the plain PyTorch version of the same function).
The CUDA sources are in ``repro_torch/csrc/``; ``_build.py`` compiles
and loads them at first use.  A wrapper launches its kernel for a CUDA
tensor and runs the plain version only for a CPU tensor.
"""


def wrappers() -> dict:
    """Every kernel's wrapper (B1-B7) by name; each counts its launches
    in its ``launches`` attribute."""
    from repro_torch.kernels.mws import mws_gather
    from repro_torch.kernels.mws_count import mws_count
    from repro_torch.kernels.popcount import popcount
    from repro_torch.kernels.signcomp import compress_signs, decompress_signs, majority_vote
    from repro_torch.kernels.threshold import threshold_reduce

    fns = (mws_gather, popcount, threshold_reduce, mws_count, compress_signs, decompress_signs, majority_vote)
    return {fn.__name__: fn for fn in fns}
