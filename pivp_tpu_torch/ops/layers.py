"""Layer primitives on NHWC tensors: conv, transposed conv with explicit
output size, flattened-feature LayerNorm and dense layers.

Counterpart of `pivp_tpu/ops/layers.py`. Activations keep the JAX
package's NHWC layout at every public function. Inside, an NHWC tensor's
`.permute(0, 3, 1, 2)` is an NCHW view with channels_last strides, which
cuDNN takes as it is; the result is permuted back to NHWC.

Weights are held in PyTorch's layouts (utils/weights.py maps them from
and to the JAX ones): conv `(out, in, kh, kw)`, transposed conv
`(in, out, kh, kw)`, dense `(out, in)`; LayerNorm scale and bias keep
the `(H, W, C)` shape of the NHWC feature volume.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def glorot_uniform(generator: torch.Generator, shape, fan_in: int,
                   fan_out: int) -> torch.Tensor:
    """Glorot/Xavier uniform in float32, drawn on the CPU so the same
    generator seed gives the same weights whatever the device."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return u * (2.0 * limit) - limit


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d_init(generator: torch.Generator, in_ch: int, out_ch: int,
                ksize: int) -> Params:
    """Weight (out, in, kh, kw), zero bias."""
    receptive = ksize * ksize
    w = glorot_uniform(generator, (out_ch, in_ch, ksize, ksize),
                       fan_in=in_ch * receptive, fan_out=out_ch * receptive)
    return {"w": w, "b": torch.zeros(out_ch)}


def conv2d(params: Params, x: torch.Tensor, stride: int = 1,
           padding: Optional[int] = None) -> torch.Tensor:
    """2D cross-correlation of an NHWC tensor; `padding=None` pads
    `k // 2` (the Chainer convention of the reference trunk)."""
    w = params["w"].to(x.dtype)
    if padding is None:
        padding = w.shape[-1] // 2
    out = F.conv2d(_nchw(x), w, None, stride=stride, padding=padding)
    return _nhwc(out) + params["b"].to(x.dtype)


def deconv2d_init(generator: torch.Generator, in_ch: int, out_ch: int,
                  ksize: int) -> Params:
    """Weight (in, out, kh, kw), zero bias. The Glorot fans are those of
    the JAX package's (kh, kw, in, out) weight."""
    receptive = ksize * ksize
    w = glorot_uniform(generator, (in_ch, out_ch, ksize, ksize),
                       fan_in=in_ch * receptive, fan_out=out_ch * receptive)
    return {"w": w, "b": torch.zeros(out_ch)}


def deconv2d(params: Params, x: torch.Tensor, stride: int = 1,
             padding: int = 0,
             outsize: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Transposed conv with Chainer `L.Deconvolution2D(..., stride, pad,
    outsize)` semantics. The outsize adjustment over the base size
    `(h - 1) * stride + k - 2 * pad` becomes `output_padding`."""
    w = params["w"].to(x.dtype)
    k = w.shape[-1]
    _, h, w_in, _ = x.shape
    base_h = (h - 1) * stride + k - 2 * padding
    base_w = (w_in - 1) * stride + k - 2 * padding
    if outsize is None:
        outsize = (base_h, base_w)
    adj_h, adj_w = outsize[0] - base_h, outsize[1] - base_w
    if not (0 <= adj_h < stride and 0 <= adj_w < stride):
        raise ValueError(
            f"outsize {outsize} unreachable from input {(h, w_in)} with "
            f"k={k} stride={stride} pad={padding}")
    out = F.conv_transpose2d(_nchw(x), w, None, stride=stride,
                             padding=padding, output_padding=(adj_h, adj_w))
    return _nhwc(out) + params["b"].to(x.dtype)


def layer_norm_flat_init(shape: Tuple[int, ...]) -> Params:
    """Per-element gamma/beta over the whole (H, W, C) volume."""
    return {"scale": torch.ones(shape), "bias": torch.zeros(shape)}


def layer_norm_flat(params: Params, x: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """Normalize each sample over all of (H, W, C) jointly, then apply
    the elementwise affine. Statistics in float32 (float64 for a float64
    input), with the E[x^2] - E[x]^2 variance of the JAX package."""
    orig_dtype = x.dtype
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = tuple(range(1, x.ndim))
    mean = xf.mean(dim=dims, keepdim=True)
    mean_sq = xf.square().mean(dim=dims, keepdim=True)
    var = torch.clamp(mean_sq - mean.square(), min=0.0)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    out = normed * params["scale"] + params["bias"]
    return out.to(orig_dtype)


def dense_init(generator: torch.Generator, in_dim: int,
               out_dim: int) -> Params:
    """Weight (out, in), zero bias."""
    w = glorot_uniform(generator, (out_dim, in_dim), fan_in=in_dim,
                       fan_out=out_dim)
    return {"w": w, "b": torch.zeros(out_dim)}


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    out = F.linear(x, params["w"].to(x.dtype))
    return out + params["b"].to(x.dtype)
