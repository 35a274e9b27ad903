"""The port's DNA and STP heads against the JAX package's on the same
weights and inputs (float32): candidates and enc7, the per-mask STP
projections in their order, and the head table."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pivp_tpu import config as jconfig
from pivp_tpu.models import heads as jheads
from pivp_tpu.utils.checkpoint import flatten_pytree
from pivp_tpu_torch import config as tconfig
from pivp_tpu_torch.models import heads as theads
from pivp_tpu_torch.ops import transforms as tt
from pivp_tpu_torch.utils import weights

SIZE = dict(image_height=16, image_width=16, sequence_length=4)
HIDDEN5 = (2, 2, 2, 128)          # (B, H/8, W/8, lstm_channels[4])


def _inputs(seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(2, 16, 16, 64).astype(np.float32),      # enc6
            r.randn(*HIDDEN5).astype(np.float32),           # hidden5
            r.rand(2, 16, 16, 3).astype(np.float32))         # prev frame


def _heads(model_type, **kw):
    jcfg = jconfig.ModelConfig(model_type=model_type, use_pallas=True,
                               pallas_interpret=True, **SIZE, **kw)
    tcfg = tconfig.ModelConfig(model_type=model_type, **SIZE, **kw)
    init, _ = jheads.HEADS[model_type]
    jp = jax.device_get(init(jax.random.PRNGKey(1), jcfg,
                             int(np.prod(HIDDEN5[1:]))))
    # The bridge keys a head's parameters as the trunk's ("head/...").
    tp = weights.from_jax_params(flatten_pytree({"head": jp}))["head"]
    return jcfg, tcfg, jp, tp


def _run(jcfg, tcfg, jp, tp, inputs):
    _, jfn = jheads.HEADS[jcfg.model_type]
    _, tfn = theads.HEADS[tcfg.model_type]
    want = jax.jit(lambda p, *a: jfn(p, jcfg, *a))(
        jp, *[jnp.asarray(a) for a in inputs])
    got = tfn(tp, tcfg, *[torch.as_tensor(a) for a in inputs])
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_head_table():
    assert set(theads.HEADS) == set(jheads.HEADS) == {"CDNA", "DNA", "STP"}


@pytest.mark.parametrize("use_kernel", [True, False])
def test_dna_head_matches_jax(use_kernel):
    jcfg, tcfg, jp, tp = _heads("DNA", num_masks=1)
    tcfg = tconfig.ModelConfig(model_type="DNA", num_masks=1,
                               use_kernel=use_kernel, **SIZE)
    (want, want7), (got, got7) = _run(jcfg, tcfg, jp, tp, _inputs())
    assert got.shape == (2, 1, 16, 16, 3) and got7.shape == (2, 16, 16, 25)
    np.testing.assert_allclose(got7, want7, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shared", [True, False],
                         ids=["shared", "per_mask"])
def test_stp_head_matches_jax(shared):
    jcfg, tcfg, jp, tp = _heads("STP", num_masks=4,
                                stp_shared_params=shared)
    (want, want7), (got, got7) = _run(jcfg, tcfg, jp, tp, _inputs(1))
    assert got.shape == (2, 4, 16, 16, 3)
    np.testing.assert_allclose(got7, want7, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    warps_equal = [np.array_equal(got[:, 1], got[:, i]) for i in (2, 3)]
    assert warps_equal == ([True, True] if shared else [False, False])


def test_stp_per_mask_projection_i_feeds_warp_i_plus_1():
    """The batched warp keeps the JAX list's order: candidate i+1 is the
    frame warped by projection i alone, and swapping two projections
    swaps their candidates."""
    _, tcfg, _, tp = _heads("STP", num_masks=4, stp_shared_params=False)
    enc6, h5, prev = (torch.as_tensor(a) for a in _inputs(2))
    cands, _ = theads.stp_head(tp, tcfg, enc6, h5, prev)
    feat = torch.relu(h5.reshape(2, -1) @ tp["stp_input"]["w"].T
                      + tp["stp_input"]["b"])
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
    for i in range(3):
        p = tp["identity_params"][str(i)]
        theta = feat @ p["w"].T + p["b"] + ident
        one = tt.stp_apply(prev, theta.reshape(2, 2, 3))
        np.testing.assert_allclose(cands[:, i + 1].numpy(), one.numpy(),
                                   rtol=1e-5, atol=1e-5)
    ip = tp["identity_params"]
    swapped = dict(tp, identity_params=dict(ip, **{"0": ip["1"],
                                                   "1": ip["0"]}))
    cands2, _ = theads.stp_head(swapped, tcfg, enc6, h5, prev)
    assert torch.equal(cands2[:, 1], cands[:, 2])
    assert torch.equal(cands2[:, 2], cands[:, 1])
    assert torch.equal(cands2[:, 3], cands[:, 3])
