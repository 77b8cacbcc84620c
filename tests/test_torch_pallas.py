"""The port's posterior stage against the JAX package's Pallas kernels
in interpret mode, mix mode (all three models) at B = 8.

Its own file because Pallas interpret mode takes over a minute on the
CPU; the small-batch case and the tolerances are in
tests/test_torch_wavefront.py.
"""
import pytest

pytest.importorskip("torch")

from test_torch_wavefront import check_against_pallas  # noqa: E402


def test_plain_engine_matches_pallas_interpret_mix():
    check_against_pallas(8, ("hmm5", "partition", "local"))
