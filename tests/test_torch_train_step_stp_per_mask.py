"""The port's STP train step with an affine projection per mask (the
port's one batched (B, M-1, 2, 3) warp against the JAX package's loop
over the masks) in float64 at num_masks 3, in the three deterministic
sampling modes: every gradient < 1e-6 relative Frobenius (PARITY.md),
each projection's among them. Helpers in test_torch_train_step_dna.py."""

import numpy as np
import pytest

from test_torch_train_step import MODES
from test_torch_train_step_dna import check_gradients_f64, head_setup

PER_MASK = dict(model_type="STP", num_masks=3, stp_shared_params=False)


@pytest.fixture(scope="module")
def setup():
    return head_setup(**PER_MASK)


@pytest.mark.parametrize("mode", list(MODES))
def test_stp_per_mask_gradients_match_jax_float64(setup, mode):
    got = check_gradients_f64(*setup, mode, **PER_MASK)
    for i in range(2):
        g = got[f"head/identity_params/{i}/w"]
        assert g.shape == (100, 6) and np.abs(g).sum() > 0
