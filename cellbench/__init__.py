"""The benchmark of the PyTorch and CUDA port of FlashQL: see README.md."""
