"""The port's float32 train step against the JAX package's, with JAX on
its local-apply Pallas kernel in interpret mode (forward and custom
VJP), in the three deterministic sampling modes of
test_torch_train_step.py: the loss of the scheduled-sampling rollout to
rtol 1e-5, and one full step (gradients + Chainer Adam update) per
tensor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pivp_tpu.parallel import train_step as jts
from pivp_tpu.utils.checkpoint import flatten_pytree
from pivp_tpu_torch.parallel import train_step as tts
from pivp_tpu_torch.utils import weights
from test_torch_train_step import (MODES, _cfgs, _port_loss_grads,
                                   _port_params, setup)  # noqa: F401


@pytest.mark.parametrize("mode", list(MODES))
def test_loss_matches_jax_pallas_float32(setup, mode):  # noqa: F811
    params, data = setup
    jcfg, tcfg, iter_num = _cfgs(mode, np.float32)
    assert jcfg.use_pallas and jcfg.pallas_interpret
    want, _ = jax.jit(jts._loss_fn, static_argnums=(1, 5))(
        params, jcfg, tuple(jnp.asarray(a) for a in data),
        jnp.asarray(float(iter_num)), jax.random.PRNGKey(0), False)
    loss, _, metrics = _port_loss_grads(tcfg, params, data, iter_num,
                                        np.float32)
    assert metrics["loss"].dtype == torch.float32
    np.testing.assert_allclose(loss, float(want), rtol=1e-5)


def test_full_train_step_update_matches_jax(setup):  # noqa: F811
    """One f32 step (gradients + Chainer Adam update) of each package,
    per tensor: update-direction cosine > 0.98 and every |update| within
    lr (the metric of test_full_train_step_update_parity: at t=1 an
    element near the f32 gradient noise floor may flip sign)."""
    params, data = setup
    jcfg, tcfg, iter_num = _cfgs("no_ground_truth_detached", np.float32)
    opt = jts.make_optimizer(1e-3)
    jstate = jts.TrainState(params, opt.init(params), jnp.int32(0))
    jnew, _ = jts.make_train_step(jcfg, opt)(
        jstate, tuple(jnp.asarray(a) for a in data),
        jnp.float32(iter_num), jax.random.PRNGKey(0))
    want = flatten_pytree(jax.device_get(jnew.params))

    state = tts.create_train_state(_port_params(params, np.float32),
                                   tts.make_optimizer(1e-3))
    state, _ = tts.make_train_step(tcfg)(
        state, tuple(torch.as_tensor(a) for a in data), iter_num,
        torch.Generator().manual_seed(0))
    got = weights.to_jax_params(state.params)
    old = flatten_pytree(params)
    assert state.step == 1
    for k in want:
        upd = (got[k] - old[k]).ravel().astype(np.float64)
        upd_j = (want[k] - old[k]).ravel().astype(np.float64)
        cos = np.dot(upd, upd_j) / (np.linalg.norm(upd)
                                    * np.linalg.norm(upd_j) + 1e-30)
        assert cos > 0.98, (k, cos)
        assert np.all(np.abs(upd) <= 1e-3 * 1.01), k
