"""The port's K-step dispatch (`make_train_multi`) and the training
loop's dispatch pipeline, on the CPU at a small size: K staged steps
equal K one-step calls bit for bit (float32 and float64, each head,
scheduled sampling on), the `k_real` tail, the port against the JAX
package's `make_train_multi` in float64 (feed-self sampling, where the
two packages' random streams do not matter). On the card the same staged
steps are replays of a CUDA graph (tests/test_torch_gpu.py and
chip_smoke.py phase 11); the loop's use of them is in
test_torch_resume.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pivp_tpu import config as jconfig
from pivp_tpu.parallel import train_step as jts
from pivp_tpu.utils.checkpoint import flatten_pytree
from pivp_tpu_torch import config as tconfig
from pivp_tpu_torch.data import assembler, dataset, synthetic
from pivp_tpu_torch.models import predictor
from pivp_tpu_torch.ops import sampling
from pivp_tpu_torch.parallel import train_step as ts
from pivp_tpu_torch.utils import weights

NARROW = dict(enc_channels=(8, 8, 8, 8, 16, 8, 8),
              lstm_channels=(8, 8, 8, 8, 16, 8, 8))
SMALL = dict(image_height=16, image_width=16, num_masks=4,
             sequence_length=4, **NARROW)
HEADS = {"CDNA": {}, "DNA": dict(model_type="DNA", num_masks=1),
         "STP": dict(model_type="STP")}
K, T, B = 3, 4, 2
SEED = 7
# n_gt = 1 of 2 rows here, so the steps depend on the sampling stream.
ITER0 = 6100


def _batches(k=K, seed=0):
    """k time-major batches, stacked (k, T, B, ...), images uint8."""
    imgs, acts, stas = synthetic.generate_sequences(k * B, T, 16, 16,
                                                    seed=seed)
    per = [dataset.to_time_major(imgs[i * B:(i + 1) * B],
                                 acts[i * B:(i + 1) * B],
                                 stas[i * B:(i + 1) * B]) for i in range(k)]
    stacked = tuple(np.stack(col) for col in zip(*per))
    return (assembler.quantize_images(stacked[0]),) + stacked[1:]


def _state(cfg, dtype=torch.float32):
    params = predictor.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
    params = predictor.map_params(lambda p: p.to(dtype), params)
    return ts.create_train_state(params, ts.make_optimizer(1e-3))


def _singles(cfg, batches, k, dtype):
    state = _state(cfg, dtype)
    step = ts.make_train_step(cfg)
    metrics = []
    for i in range(k):
        batch = tuple(torch.from_numpy(np.ascontiguousarray(a[i]))
                      for a in batches)
        batch = (batch[0],) + tuple(a.to(dtype) for a in batch[1:])
        state, m = step(state, batch, ITER0 + i,
                        sampling.generator(SEED, ITER0 + i))
        metrics.append((m["loss"], m["psnr_all"]))
    return state, metrics


def _multi(cfg, batches, dtype, k_real=None):
    state = _state(cfg, dtype)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    batches = (batches[0],) + tuple(a.astype(np_dtype) for a in batches[1:])
    state, m = ts.make_train_multi(cfg)(state, batches, ITER0, SEED,
                                        k_real)
    return state, m


def _assert_states_equal(a, b):
    assert a.step == b.step
    for x, y in zip(a.leaves(), b.leaves()):
        assert torch.equal(x, y)
    ta, tb = ts.opt_state_tree(a), ts.opt_state_tree(b)
    assert int(ta["count"]) == int(tb["count"]) == a.step
    for key, x in weights.flatten(ta).items():
        assert torch.equal(x, weights.flatten(tb)[key]), key


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("head", list(HEADS))
def test_multi_equals_single_steps_bit_for_bit(head, dtype):
    extra = ({"compute_dtype": "float64", "lstm_gate_compute": "compute"}
             if dtype == torch.float64 else {})
    cfg = tconfig.ModelConfig(**dict(SMALL, **HEADS[head], **extra))
    batches = _batches()
    want, want_m = _singles(cfg, batches, K, dtype)
    got, got_m = _multi(cfg, batches, dtype)
    _assert_states_equal(got, want)
    assert got_m["loss"].shape == (K,)
    for i, (loss, psnr) in enumerate(want_m):
        assert torch.equal(got_m["loss"][i], loss)
        assert torch.equal(got_m["psnr_all"][i], psnr)


def test_k_real_runs_only_the_real_steps():
    cfg = tconfig.ModelConfig(**SMALL)
    batches = _batches()
    want, want_m = _singles(cfg, batches, 2, torch.float32)
    got, got_m = _multi(cfg, batches, torch.float32, k_real=2)
    _assert_states_equal(got, want)
    assert torch.equal(got_m["loss"][:2], torch.stack([m[0] for m
                                                       in want_m]))
    assert torch.isnan(got_m["loss"][2]) and torch.isnan(got_m["psnr_all"][2])
    with pytest.raises(ValueError, match="k_real"):
        ts.make_train_multi(cfg)(_state(cfg), batches, ITER0, SEED, 4)


def test_staged_call_holds_the_one_step_sampling_inputs():
    cfg = tconfig.ModelConfig(**SMALL)
    batches = _batches()
    staged = ts.stage_call(cfg, batches, ITER0, SEED)
    views = staged.views()
    for i in range(K):
        u, n = ts.step_sampling(cfg, T, B, ITER0 + i,
                                sampling.generator(SEED, ITER0 + i))
        assert torch.equal(views["uniforms"][i], u)
        assert int(views["n_gt"][i]) == n == 1
        assert torch.equal(views["images"][i], torch.from_numpy(batches[0][i]))
    # A call staged for one iteration is not run at another.
    with pytest.raises(ValueError, match="staged"):
        ts.make_train_multi(cfg)(_state(cfg), staged, ITER0 + 1, SEED)
    feedself = tconfig.ModelConfig(**dict(SMALL, scheduled_sampling_k=-1))
    assert set(ts.stage_call(feedself, batches, 0, SEED).views()) == {
        "images", "actions", "states"}


def test_multi_matches_jax_make_train_multi_f64():
    """Three steps of each package's K-step dispatch from shared weights,
    feed-self sampling, float64: losses and parameters to 1e-9."""
    kw = dict(SMALL, scheduled_sampling_k=-1.0, compute_dtype="float64",
              lstm_gate_compute="compute")
    jcfg = jconfig.ModelConfig(use_pallas=False, **kw)
    tcfg = tconfig.ModelConfig(**kw)
    params = weights.unflatten(weights.to_jax_params(
        predictor.init_params(torch.Generator().manual_seed(3), tcfg,
                              device="cpu")))
    flat = {k: np.asarray(v, np.float64)
            for k, v in flatten_pytree(params).items()}
    imgs, acts, stas = (a.astype(np.float64) for a in _batches())
    imgs = imgs / 255.0
    with jax.enable_x64(True):
        jparams = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), params)
        opt = jts.make_optimizer(1e-3)
        jstate = jts.TrainState(jparams, opt.init(jparams), jnp.int32(0))
        jstate, jm = jts.make_train_multi(jcfg, opt)(
            jstate, (jnp.asarray(imgs), jnp.asarray(acts),
                     jnp.asarray(stas)),
            jnp.float32(0.0), jax.random.PRNGKey(0))
        want = flatten_pytree(jax.device_get(jstate.params))
        want_loss = np.asarray(jm["loss"])
    state = ts.create_train_state(weights.from_jax_params(flat),
                                  ts.make_optimizer(1e-3))
    state, m = ts.make_train_multi(tcfg)(state, (imgs, acts, stas), 0,
                                         SEED)
    np.testing.assert_allclose(m["loss"].numpy(), want_loss, rtol=1e-9)
    got = weights.to_jax_params(state.params)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                   atol=1e-12, err_msg=key)
