"""The port's DNA train step against the JAX package's, on shared weights
at a small size, in float64: every parameter gradient within the
PARITY.md gate (< 1e-6 relative Frobenius) in the three deterministic
sampling modes of test_torch_train_step.py (in the reference-literal
mode, DNA takes the border-zeroed windows). The helpers here serve the
STP files too."""

import dataclasses

import jax
import numpy as np
import pytest

from pivp_tpu import config as jconfig
from pivp_tpu.models import predictor as jpred
from pivp_tpu_torch import config as tconfig
from test_torch_train_step import (MODES, SMALL, _jax_loss_grads,
                                   _port_loss_grads, _rel_frobenius)

DNA = dict(model_type="DNA", num_masks=1)


def head_setup(**head):
    jcfg = jconfig.ModelConfig(**dict(SMALL, **head))
    params = jax.device_get(jax.jit(jpred.init_params, static_argnums=1)(
        jax.random.PRNGKey(3), jcfg))
    rng = np.random.RandomState(0)
    t, b = SMALL["sequence_length"], 2
    data = (rng.rand(t, b, 16, 16, 3).astype(np.float32),
            (rng.randn(t, b, 5) * 0.5).astype(np.float32),
            (rng.randn(t, b, 5) * 0.5).astype(np.float32))
    return params, data


def head_cfgs_f64(mode, **head):
    """Both packages' float64 configs of a sampling mode. The
    reference-literal switches keep a per-mask STP head per mask."""
    k, literal, iter_num = MODES[mode]
    kw = dict(SMALL, scheduled_sampling_k=k, compute_dtype="float64",
              lstm_gate_compute="compute", **head)
    jcfg = jconfig.ModelConfig(use_pallas=False, **kw)
    tcfg = tconfig.ModelConfig(**kw)
    if literal:
        shared = dict(stp_shared_params=tcfg.stp_shared_params)
        jcfg = dataclasses.replace(jconfig.as_reference_literal(jcfg),
                                   **shared)
        tcfg = dataclasses.replace(tconfig.as_reference_literal(tcfg),
                                   **shared)
    return jcfg, tcfg, iter_num


def check_gradients_f64(params, data, mode, **head):
    jcfg, tcfg, iter_num = head_cfgs_f64(mode, **head)
    want_loss, want = _jax_loss_grads(jcfg, params, data, iter_num,
                                      np.float64)
    loss, got, _ = _port_loss_grads(tcfg, params, data, iter_num,
                                    np.float64)
    assert set(got) == set(want)
    assert abs(loss - want_loss) <= 1e-9 * abs(want_loss)
    errs = _rel_frobenius(got, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] < 1e-6, (worst, errs[worst])
    return got


@pytest.fixture(scope="module")
def setup():
    return head_setup(**DNA)


@pytest.mark.parametrize("mode", list(MODES))
def test_dna_gradients_match_jax_float64(setup, mode):
    got = check_gradients_f64(*setup, mode, **DNA)
    assert got["head/enc7/w"].shape == (1, 1, 8, 25)
