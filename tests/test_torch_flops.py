"""The port's analytic FLOP counts (utils/flops.py) are the JAX
package's integers for every head, at the reference sizes and a small
one, with remat on and off; `mfu` divides by the H100's float32 peak."""

import pytest

from pivp_tpu import config as jconfig
from pivp_tpu.utils import flops as jflops
from pivp_tpu_torch import config as tconfig
from pivp_tpu_torch.utils import flops

HEADS = {"CDNA": {}, "DNA": dict(model_type="DNA", num_masks=1),
         "STP": dict(model_type="STP"),
         "STP per-mask": dict(model_type="STP", stp_shared_params=False)}
SIZES = {"reference": {},
         "small": dict(image_height=16, image_width=24, num_masks=4,
                       sequence_length=4, use_state=False,
                       enc_channels=(8, 8, 8, 8, 16, 8, 8),
                       lstm_channels=(8, 8, 8, 8, 16, 8, 8))}


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("head", list(HEADS))
def test_counts_equal_jax(head, size):
    kw = dict(SIZES[size], **HEADS[head])
    if head == "DNA":
        kw["num_masks"] = 1
    jcfg, tcfg = jconfig.ModelConfig(**kw), tconfig.ModelConfig(**kw)
    want = jflops.forward_step_flops(jcfg)
    got = flops.forward_step_flops(tcfg)
    assert isinstance(got, int) and got == want > 0
    assert sum(flops.forward_step_terms(tcfg).values()) == got
    for remat in (False, True):
        for batch in (1, 32):
            assert (flops.train_step_flops(tcfg, batch, remat)
                    == jflops.train_step_flops(jcfg, batch, remat))
    assert flops.train_step_flops(tcfg, 32, True) * 3 == \
        flops.train_step_flops(tcfg, 32) * 4


def test_default_num_masks_and_the_h100_peak():
    assert flops.DEFAULT_NUM_MASKS == jflops.DEFAULT_NUM_MASKS
    assert flops.H100_F32_PEAK_TFLOPS == 67.0
    assert flops.mfu(67.0) == 1.0
    assert flops.mfu(33.5) == pytest.approx(0.5)
    assert not hasattr(flops, "V5E_BF16_PEAK_TFLOPS")
