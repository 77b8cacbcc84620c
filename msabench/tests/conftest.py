"""The benchmark's tests: the manifest, the files found by name, the
generator, the work counts, the reference against the port and the
faults the check must catch, on the CPU at small sizes; the controls on
the card (marker `cuda`, skipped without one)."""
import pytest
import torch


@pytest.fixture
def card():
    """Skips a test without a CUDA device (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    return "cuda"
