"""The ``cuda`` fixture: tests that need the card skip without one.  The
check runs inside the fixture, never at import."""

import pytest


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
