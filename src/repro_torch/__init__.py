"""PyTorch + CUDA port of the Flash-Cosmos reproduction (``repro``).

A module-by-module mirror of ``repro`` (``repro/query/device.py`` ->
``repro_torch/query/device.py``) that imports ``torch`` and numpy, never
JAX and never ``repro``.  Packed words are ``torch.int32`` bit patterns.
The engine runs on the card unless told otherwise: ``FlashDevice()``
means ``device="cuda"`` and raises without a GPU; ``device="cpu"`` runs
the plain PyTorch version of every kernel.  The hand-written CUDA kernels
(``csrc/``) are built at first use.
"""
