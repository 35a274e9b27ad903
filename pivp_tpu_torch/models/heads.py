"""The transformation heads: CDNA, DNA and STP.

Counterpart of `pivp_tpu/models/heads.py`. Each head takes the trunk's
enc6 and hidden5 and the previous frame and returns a stack of candidate
frames (B, n_cand, H, W, C) and its enc7 activation; the compositor
pairs the first num_masks candidates with masks 1..num_masks.

  * CDNA: 1 + num_masks candidates, the synthesized frame (a 1x1 deconv
    of enc6) and one transform of the previous frame per normalized
    K*K kernel (a dense layer on hidden5).
  * DNA: 1 candidate (num_masks must be 1), per-pixel K*K kernels from
    the 1x1 deconv of enc6, applied by the local-apply kernel when
    `use_kernel` is on and `dna_border_zero` off.
  * STP: num_masks candidates, the synthesized frame and num_masks - 1
    affine warps from a dense layer on relu(dense(hidden5)).

STP's per-mask projections (`stp_shared_params=False`) are held as a
dict keyed "0", "1", ... (projection i feeds warp i + 1), which
flattens to the same `head/identity_params/<i>/w|b` keys as the JAX
package's list; they run as one stacked dense layer and one batched
warp.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from pivp_tpu_torch.config import ModelConfig
from pivp_tpu_torch.ops import layers, transforms
from pivp_tpu_torch.ops.kernels import local_apply

Params = Dict[str, torch.Tensor]


def cdna_head_init(generator: torch.Generator, cfg: ModelConfig,
                   hidden5_dim: int) -> Params:
    ksq = cfg.dna_kern_size ** 2
    return {
        # Deconv 1x1 stride 1 == pointwise conv.
        "enc7": layers.deconv2d_init(generator, cfg.enc_channels[6],
                                     cfg.color_channels, 1),
        # Linear(hidden5_flat -> K*K*num_masks).
        "cdna_kerns": layers.dense_init(generator, hidden5_dim,
                                        ksq * cfg.num_masks),
    }


def cdna_head_parts(params: Params, cfg: ModelConfig, enc6: torch.Tensor,
                    hidden5: torch.Tensor, enc7_raw=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Synthesized frame + normalized kernels. Returns (synth (B,H,W,C),
    kerns (B,M,K*K), enc7). `enc7_raw`, when given, is the pre-activation
    enc7 of the trunk's merged masks+enc7 conv."""
    b = enc6.shape[0]
    if enc7_raw is None:
        enc7_raw = layers.deconv2d(params["enc7"], enc6, stride=1,
                                   padding=0)
    enc7 = torch.relu(enc7_raw)
    synth = torch.sigmoid(enc7)
    raw = layers.dense(params["cdna_kerns"], hidden5.reshape(b, -1))
    raw = raw.reshape(b, cfg.num_masks, cfg.dna_kern_size ** 2)
    kerns = transforms.normalize_cdna_kernels(raw, cfg.relu_shift)
    return synth, kerns, enc7


def cdna_head(params: Params, cfg: ModelConfig, enc6: torch.Tensor,
              hidden5: torch.Tensor, prev_image: torch.Tensor,
              enc7_raw=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidates (B, 1+M, H, W, C): the synthesized frame and one CDNA
    transform of the previous frame per kernel."""
    synth, kerns, enc7 = cdna_head_parts(params, cfg, enc6, hidden5,
                                         enc7_raw)
    moved = transforms.cdna_apply(prev_image, kerns)
    candidates = torch.cat([synth[:, None], moved], dim=1)
    return candidates, enc7


def dna_head_init(generator: torch.Generator, cfg: ModelConfig,
                  hidden5_dim: int) -> Params:
    del hidden5_dim
    # 1x1 deconv -> K*K channels of per-pixel kernel logits.
    return {"enc7": layers.deconv2d_init(generator, cfg.enc_channels[6],
                                         cfg.dna_kern_size ** 2, 1)}


def dna_head(params: Params, cfg: ModelConfig, enc6: torch.Tensor,
             hidden5: torch.Tensor, prev_image: torch.Tensor,
             enc7_raw=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One candidate (B, 1, H, W, C): the previous frame moved by the
    per-pixel kernels."""
    del hidden5
    if enc7_raw is None:
        enc7_raw = layers.deconv2d(params["enc7"], enc6, stride=1,
                                   padding=0)
    enc7 = torch.relu(enc7_raw)
    local = local_apply.local_kernel_apply if cfg.use_kernel else None
    out = transforms.dna_apply(prev_image, enc7, cfg.relu_shift,
                               local_apply=local,
                               border_zero=cfg.dna_border_zero)
    return out[:, None], enc7


def stp_head_init(generator: torch.Generator, cfg: ModelConfig,
                  hidden5_dim: int) -> Params:
    params = {
        "enc7": layers.deconv2d_init(generator, cfg.enc_channels[6],
                                     cfg.color_channels, 1),
        # Linear(hidden5_flat -> 100).
        "stp_input": layers.dense_init(generator, hidden5_dim, 100),
    }
    if cfg.stp_shared_params:
        # The reference's one Linear(6) shared by every mask.
        params["identity_params"] = layers.dense_init(generator, 100, 6)
    else:
        params["identity_params"] = {
            str(i): layers.dense_init(generator, 100, 6)
            for i in range(cfg.num_masks - 1)}
    return params


def stp_head(params: Params, cfg: ModelConfig, enc6: torch.Tensor,
             hidden5: torch.Tensor, prev_image: torch.Tensor,
             enc7_raw=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidates (B, M, H, W, C): the synthesized frame and M-1 affine
    warps of the previous frame."""
    b, m = prev_image.shape[0], cfg.num_masks
    # No ReLU before the sigmoid here, unlike CDNA.
    enc7 = (layers.deconv2d(params["enc7"], enc6, stride=1, padding=0)
            if enc7_raw is None else enc7_raw)
    synth = torch.sigmoid(enc7)
    feat = torch.relu(layers.dense(params["stp_input"],
                                   hidden5.reshape(b, -1)))
    # [1, 0, 0, 0, 1, 0], made on the device: a host tensor copied to
    # the GPU inside the step would be a copy a CUDA graph cannot capture.
    identity = torch.eye(2, 3, dtype=feat.dtype,
                         device=feat.device).reshape(6)
    ip = params["identity_params"]
    if cfg.stp_shared_params:
        # One shared projection makes every warp the same: warp once and
        # broadcast.
        theta = layers.dense(ip, feat) + identity
        warp = transforms.stp_apply(prev_image, theta.reshape(b, 2, 3))
        warps = warp[:, None].expand((b, m - 1) + tuple(warp.shape[1:]))
    else:
        # The M-1 projections as one dense layer of (M-1)*6 outputs,
        # and the M-1 warps as one batched (B, M-1, 2, 3) stack.
        w = torch.cat([ip[str(i)]["w"] for i in range(m - 1)])
        bias = torch.cat([ip[str(i)]["b"] for i in range(m - 1)])
        theta = F.linear(feat, w.to(feat.dtype)) + bias.to(feat.dtype)
        theta = theta.reshape(b, m - 1, 6) + identity
        warps = transforms.stp_apply(prev_image,
                                     theta.reshape(b, m - 1, 2, 3))
    return torch.cat([synth[:, None], warps], dim=1), enc7


HEADS = {
    "CDNA": (cdna_head_init, cdna_head),
    "DNA": (dna_head_init, dna_head),
    "STP": (stp_head_init, stp_head),
}
