"""The CDNA transformation head.

Counterpart of the CDNA part of `pivp_tpu/models/heads.py`: a 1x1
deconv of enc6 gives the synthesized frame, a dense layer on hidden5
the M normalized K*K kernels. The DNA and STP heads come in a later
slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from pivp_tpu_torch.config import ModelConfig
from pivp_tpu_torch.ops import layers, transforms

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
