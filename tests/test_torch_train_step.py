"""The port's train step against the JAX package's, on shared weights (JAX
init_params -> weight bridge), at a small size.

torch cannot reproduce `jax.random`, so parity runs in the three modes
where the scheduled-sampling mix is deterministic: feed-self (k = -1),
every row ground truth (k = 900 at iteration 0, n_gt = B) and no row
ground truth with the reference-literal detached mix (iteration 20000,
n_gt = 0). Here, in float64, the semantics are held to the gradient gate
of PARITY.md (every parameter gradient < 1e-6 relative Frobenius); JAX
runs its plain ops, since its Pallas kernels accumulate in float32 by
design. test_torch_train_step_f32.py holds the float32 path against the
JAX Pallas kernel in interpret mode. The port runs on the CPU, where its
kernel Functions compute their plain forward and backward versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pivp_tpu import config as jconfig
from pivp_tpu.models import predictor as jpred
from pivp_tpu.parallel import train_step as jts
from pivp_tpu.utils.checkpoint import flatten_pytree
from pivp_tpu_torch import config as tconfig
from pivp_tpu_torch.parallel import train_step as tts
from pivp_tpu_torch.utils import weights

SMALL = dict(image_height=16, image_width=16, num_masks=4,
             sequence_length=4, enc_channels=(8, 8, 8, 8, 16, 8, 8),
             lstm_channels=(8, 8, 8, 8, 16, 8, 8))
T, B = 4, 2
# k, reference-literal, iteration
MODES = {"feedself": (-1.0, False, 0),
         "all_ground_truth": (900.0, False, 0),
         "no_ground_truth_detached": (900.0, True, 20000)}


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfig.ModelConfig(use_pallas=True, pallas_interpret=True,
                               use_pallas_gates=False, **SMALL)
    params = jax.device_get(jax.jit(jpred.init_params, static_argnums=1)(
        jax.random.PRNGKey(3), jcfg))
    rng = np.random.RandomState(0)
    data = (rng.rand(T, B, 16, 16, 3).astype(np.float32),
            (rng.randn(T, B, 5) * 0.5).astype(np.float32),
            (rng.randn(T, B, 5) * 0.5).astype(np.float32))
    return params, data


def _cfgs(mode, dtype):
    k, literal, iter_num = MODES[mode]
    x64 = dtype == np.float64
    extra = dict(scheduled_sampling_k=k)
    if x64:
        extra.update(compute_dtype="float64", lstm_gate_compute="compute")
    jcfg = jconfig.ModelConfig(use_pallas=not x64, pallas_interpret=True,
                               use_pallas_gates=False, **extra, **SMALL)
    tcfg = tconfig.ModelConfig(**extra, **SMALL)
    if literal:
        jcfg = jconfig.as_reference_literal(jcfg)
        tcfg = tconfig.as_reference_literal(tcfg)
    return jcfg, tcfg, iter_num


def _jax_loss_grads(jcfg, params, data, iter_num, dtype):
    def run():
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
        batch = tuple(jnp.asarray(a, dtype) for a in data)
        grad_fn = jax.jit(jax.value_and_grad(jts._loss_fn, has_aux=True),
                          static_argnums=(1, 5))
        (loss, _), grads = grad_fn(p, jcfg, batch,
                                   jnp.asarray(float(iter_num)),
                                   jax.random.PRNGKey(0), False)
        return float(loss), flatten_pytree(jax.device_get(grads))

    if dtype == np.float64:
        with jax.enable_x64(True):
            return run()
    return run()


def _port_params(params, dtype):
    return weights.from_jax_params(
        {k: np.asarray(v, dtype) for k, v in flatten_pytree(params).items()})


def _port_loss_grads(tcfg, params, data, iter_num, dtype, **kw):
    tparams = _port_params(params, dtype)
    leaves = weights.flatten(tparams)
    for p in leaves.values():
        p.requires_grad_(True)
    batch = tuple(torch.as_tensor(np.asarray(a, dtype)) for a in data)
    grads, metrics = tts.grads_and_metrics(
        tparams, tcfg, batch, iter_num, torch.Generator().manual_seed(0),
        **kw)
    flat = weights.to_jax_params(weights.unflatten(dict(zip(leaves,
                                                            grads))))
    return float(metrics["loss"]), flat, metrics


def _rel_frobenius(got, want):
    return {k: float(np.linalg.norm(got[k] - want[k])
                     / (np.linalg.norm(want[k]) + 1e-30)) for k in want}


@pytest.mark.parametrize("mode", list(MODES))
def test_gradients_match_jax_float64(setup, mode):
    params, data = setup
    jcfg, tcfg, iter_num = _cfgs(mode, np.float64)
    want_loss, want = _jax_loss_grads(jcfg, params, data, iter_num,
                                      np.float64)
    loss, got, _ = _port_loss_grads(tcfg, params, data, iter_num,
                                    np.float64)
    assert set(got) == set(want)
    assert abs(loss - want_loss) <= 1e-9 * abs(want_loss)
    errs = _rel_frobenius(got, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] < 1e-6, (worst, errs[worst])


def test_chainer_adam_matches_jax():
    r = np.random.RandomState(0)
    p0 = {"a": r.randn(3, 4), "b": r.randn(5)}
    grads = [{k: r.randn(*v.shape) for k, v in p0.items()}
             for _ in range(3)]
    with jax.enable_x64(True):
        opt = jts.chainer_adam(1e-3)
        jp = jax.tree_util.tree_map(jnp.asarray, p0)
        jstate = opt.init(jp)
        for g in grads:
            upd, jstate = opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                     jstate)
            jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)
        want = jax.device_get(jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    topt = tts.ChainerAdam(list(tp.values()), 1e-3)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        topt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), want[k], rtol=1e-12,
                                   atol=0)
    assert all(st["count"] == 3 for st in topt.state.values())


@pytest.mark.parametrize("mode", ["all_ground_truth",
                                  "no_ground_truth_detached"])
def test_grad_accum_equals_one_batch(setup, mode):
    params, data = setup
    _, tcfg, iter_num = _cfgs(mode, np.float64)
    loss1, g1, m1 = _port_loss_grads(tcfg, params, data, iter_num,
                                     np.float64)
    loss2, g2, m2 = _port_loss_grads(tcfg, params, data, iter_num,
                                     np.float64, grad_accum=2)
    assert abs(loss1 - loss2) <= 1e-12 * abs(loss1)
    errs = _rel_frobenius(g2, g1)
    assert max(errs.values()) < 1e-10, max(errs.items(), key=lambda e: e[1])
    np.testing.assert_allclose(m2["recon_costs"].numpy(),
                               m1["recon_costs"].numpy(), rtol=1e-12)


def test_remat_equals_no_remat(setup):
    params, data = setup
    _, tcfg, iter_num = _cfgs("all_ground_truth", np.float64)
    _, g1, _ = _port_loss_grads(tcfg, params, data, iter_num, np.float64)
    _, g2, _ = _port_loss_grads(tcfg, params, data, iter_num, np.float64,
                                remat=True)
    errs = _rel_frobenius(g2, g1)
    assert max(errs.values()) < 1e-12


def test_optimizer_state_tree_round_trips(setup):
    params, data = setup
    _, tcfg, iter_num = _cfgs("feedself", np.float32)
    state = tts.create_train_state(_port_params(params, np.float32),
                                   tts.make_optimizer(1e-3))
    tree0 = tts.opt_state_tree(state)
    assert int(tree0["count"]) == 0
    state, _ = tts.make_train_step(tcfg)(
        state, tuple(torch.as_tensor(a) for a in data), iter_num,
        torch.Generator().manual_seed(0))
    tree = tts.opt_state_tree(state)
    assert int(tree["count"]) == 1
    fresh = tts.create_train_state(_port_params(params, np.float32),
                                   tts.make_optimizer(1e-3))
    tts.load_opt_state_tree(fresh, tree)
    again = tts.opt_state_tree(fresh)
    for k, v in weights.flatten(tree).items():
        assert torch.equal(weights.flatten(again)[k], v), k
    assert float(tree["mu"]["enc0"]["w"].abs().sum()) > 0
