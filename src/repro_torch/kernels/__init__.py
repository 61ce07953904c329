"""Hand-written CUDA kernels of the port, one package per kernel.

Each package holds ``ops.py`` (the wrapper: checks, dispatch, launch
count) and ``ref.py`` (the plain PyTorch version of the same function).
The CUDA sources are in ``repro_torch/csrc/``; ``_build.py`` compiles
and loads them at first use.  A wrapper launches its kernel for a CUDA
tensor and runs the plain version only for a CPU tensor.
"""
