"""The benchmark's own tests: ``python -m pytest portbench/tests -q -p
no:cacheprovider`` from the repository's root (the repo's ``pytest tests/``
does not collect them). Tests marked ``cuda`` need a card and skip without
one, decided inside the test."""

import pytest


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
