"""Analytic FLOP count for the predictor train step.

The port's own copy of `pivp_tpu/utils/flops.py`, with the same integer
counts: multiply-adds count as 2 FLOPs, a backward pass is the standard
2x forward (grad wrt inputs + grad wrt filters), so one optimizer step is
3x the forward (4x with per-step remat). `mfu` divides by the H100's
float32 peak outside the tensor cores, which is what the port's float32
convolutions with TF32 off can use.

The integers keep two conventions of the JAX count that are not the
layers' multiply-adds (`forward_step_terms`): the stride-2 deconvs are
counted over their output grid, and CDNA's local apply for one mask. At
the reference CDNA size the count is 1.117x the multiply-adds that the
weights' shapes give, so a share of the peak from it is that much high.
"""

from __future__ import annotations

from typing import Dict

from pivp_tpu_torch.config import ModelConfig

# NVIDIA H100 SXM (nvidia-smi: "NVIDIA H100 80GB HBM3", power limit
# 700.00 W): the data sheet's float32 rate outside the tensor cores,
# 67 TFLOP/s. The port runs float32 with TF32 off
# (utils/device.resolve_device), so this is its peak; chip_smoke.py
# bounds its kernels with the same constant.
H100_F32_PEAK_TFLOPS = 67.0

# Reference default mask counts per head (train_model.py:786 num_masks=10;
# DNA asserts num_masks==1 at :389-390).
DEFAULT_NUM_MASKS = {"CDNA": 10, "DNA": 1, "STP": 10}


def mfu(achieved_tflops: float) -> float:
    """Fraction of the H100's float32 peak that `achieved_tflops` is."""
    return achieved_tflops / H100_F32_PEAK_TFLOPS


def _conv(out_hw: int, ksize: int, c_in: int, c_out: int) -> int:
    return out_hw * ksize * ksize * c_in * c_out * 2


def forward_step_terms(cfg: ModelConfig) -> Dict[str, int]:
    """`forward_step_flops` layer by layer, keyed by the predictor's
    parameter names (enc0, lstm1, ..., masks, head/enc7, state_pred),
    with the local kernel apply as `local_apply` and STP's bilinear
    warps as `stp_sampler`. Two of the JAX counts' conventions differ
    from the multiply-adds a layer does: a stride-2 deconv (enc4-enc6)
    is counted over its output grid, 4x its transposed conv's work over
    its input grid, and CDNA's local apply is counted for one mask, not
    `num_masks`."""
    h, w = cfg.image_height, cfg.image_width
    r0, r1, r2, r3 = h * w, (h // 2) * (w // 2), (h // 4) * (w // 4), \
        (h // 8) * (w // 8)
    ec = cfg.enc_channels
    lc = cfg.lstm_channels
    c = cfg.color_channels
    sa = (cfg.action_dim + cfg.state_dim) if cfg.use_state else 0
    k2 = cfg.dna_kern_size ** 2

    f = {
        "enc0": _conv(r1, 5, c, ec[0]),
        "lstm1": _conv(r1, 5, ec[0] + lc[0], 4 * lc[0]),
        "lstm2": _conv(r1, 5, lc[0] + lc[1], 4 * lc[1]),
        "enc1": _conv(r2, 3, lc[1], ec[1]),
        "lstm3": _conv(r2, 5, ec[1] + lc[2], 4 * lc[2]),
        "lstm4": _conv(r2, 5, lc[2] + lc[3], 4 * lc[3]),
        "enc2": _conv(r3, 3, lc[3], ec[2]),
        "enc3": _conv(r3, 1, ec[2] + sa, ec[3]),
        "lstm5": _conv(r3, 5, ec[3] + lc[4], 4 * lc[4]),
        "enc4": _conv(r2, 3, lc[4], ec[4]),             # deconv
        "lstm6": _conv(r2, 5, ec[4] + lc[5], 4 * lc[5]),
        "enc5": _conv(r1, 3, lc[5] + ec[1], ec[5]),     # deconv
        "lstm7": _conv(r1, 5, ec[5] + lc[6], 4 * lc[6]),
        "enc6": _conv(r0, 3, lc[6] + ec[0], ec[6]),     # deconv
        "masks": _conv(r0, 1, ec[6], cfg.num_masks + 1),
    }
    hidden5_dim = r3 * lc[4]
    if cfg.is_cdna:
        f["head/enc7"] = _conv(r0, 1, ec[6], c)
        f["head/cdna_kerns"] = hidden5_dim * k2 * cfg.num_masks * 2
        f["local_apply"] = r0 * k2 * c * 2
    elif cfg.is_dna:
        f["head/enc7"] = _conv(r0, 1, ec[6], k2)
        f["local_apply"] = r0 * k2 * c * 2
    else:                                             # STP
        f["head/enc7"] = _conv(r0, 1, ec[6], c)
        f["head/stp_input"] = hidden5_dim * 100 * 2
        f["head/identity_params"] = 100 * 6 * 2
        n_warps = 1 if cfg.stp_shared_params else cfg.num_masks - 1
        f["stp_sampler"] = n_warps * r0 * c * 8       # 4-tap bilinear
    f["state_pred"] = sa * cfg.state_dim * 2
    return f


def forward_step_flops(cfg: ModelConfig) -> int:
    """Conv/matmul FLOPs for ONE timestep of the trunk + head, per sample.
    Mirrors the stage structure of predictor.forward_step (channel plan
    from reference train_model.py:500-529)."""
    return sum(forward_step_terms(cfg).values())


def train_step_flops(cfg: ModelConfig, batch: int,
                     remat: bool = False) -> int:
    """FLOPs for one optimizer step: (T-1) timesteps x batch x 3x forward
    (4x with per-step remat, which recomputes the forward in backward)."""
    mult = 4 if remat else 3
    return forward_step_flops(cfg) * (cfg.sequence_length - 1) * batch \
        * mult
