"""The port's STP train step (one shared affine projection, the
reference's) against the JAX package's in float64, in the three
deterministic sampling modes: every gradient < 1e-6 relative Frobenius
(PARITY.md). Helpers in test_torch_train_step_dna.py."""

import numpy as np
import pytest

from test_torch_train_step import MODES
from test_torch_train_step_dna import check_gradients_f64, head_setup

STP = dict(model_type="STP", num_masks=4)


@pytest.fixture(scope="module")
def setup():
    return head_setup(**STP)


@pytest.mark.parametrize("mode", list(MODES))
def test_stp_gradients_match_jax_float64(setup, mode):
    got = check_gradients_f64(*setup, mode, **STP)
    assert got["head/identity_params/w"].shape == (100, 6)
    assert np.abs(got["head/identity_params/w"]).sum() > 0
