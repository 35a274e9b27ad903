"""The PyTorch port's ConvLSTM cell against the JAX package's, on the
same numpy inputs and weights, with the gate update through the kernel
wrapper (its plain version on the CPU) and through the plain gate math
at both gate precisions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pivp_tpu.ops import convlstm as jc
from pivp_tpu_torch.ops import convlstm as tc
from pivp_tpu_torch.utils import weights


def _data(in_ch=6, out_ch=8, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(2, 8, 8, in_ch).astype(np.float32)
    c = r.randn(2, 8, 8, out_ch).astype(np.float32)
    h = r.randn(2, 8, 8, out_ch).astype(np.float32)
    p = {"w": (r.randn(5, 5, in_ch + out_ch, 4 * out_ch) * 0.1
               ).astype(np.float32),
         "b": r.randn(4 * out_ch).astype(np.float32)}
    return x, c, h, p


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("forget_bias", [1.0, 0.0])
def test_conv_lstm_matches_jax(use_kernel, forget_bias):
    x, c, h, p = _data()
    (jst, jh) = jc.conv_lstm({k: jnp.asarray(v) for k, v in p.items()},
                             jc.LSTMState(jnp.asarray(c), jnp.asarray(h)),
                             jnp.asarray(x), forget_bias)
    tp = weights.from_jax_params({f"lstm1/{k}": v for k, v in p.items()})
    (tst, th) = tc.conv_lstm(tp["lstm1"],
                             tc.LSTMState(torch.as_tensor(c),
                                          torch.as_tensor(h)),
                             torch.as_tensor(x), forget_bias,
                             use_kernel=use_kernel)
    for got, want in ((tst.c, jst.c), (tst.h, jst.h), (th, jh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_bf16_gate_precision_matches_jax():
    x, c, h, p = _data(seed=1)
    bf = jnp.bfloat16
    (jst, _) = jc.conv_lstm({k: jnp.asarray(v) for k, v in p.items()},
                            jc.LSTMState(jnp.asarray(c, bf),
                                         jnp.asarray(h, bf)),
                            jnp.asarray(x, bf), 1.0, gate_dtype=bf)
    tp = weights.from_jax_params({f"lstm1/{k}": v for k, v in p.items()})
    tb = torch.bfloat16
    (tst, _) = tc.conv_lstm(tp["lstm1"],
                            tc.LSTMState(torch.as_tensor(c).to(tb),
                                         torch.as_tensor(h).to(tb)),
                            torch.as_tensor(x).to(tb), 1.0, gate_dtype=tb)
    assert tst.c.dtype == tb
    # bf16 conv and gate math round at different places in the two
    # frameworks: a few bf16 ulps of values of order 1.
    np.testing.assert_allclose(tst.c.float().numpy(),
                               np.asarray(jst.c.astype(jnp.float32)),
                               rtol=5e-2, atol=5e-2)


def test_zero_state():
    st = tc.zero_state(2, 4, 4, 8)
    assert st.c.shape == (2, 4, 4, 8) and not st.h.any()
