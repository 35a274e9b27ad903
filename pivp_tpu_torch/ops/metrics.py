"""Loss and image-quality metrics on NHWC tensors.

Counterpart of `pivp_tpu/ops/metrics.py`: MSE, the reference's batch
PSNR, per-image MSE and PSNR, windowed SSIM (11x11 Gaussian, sigma 1.5,
`tf.image.ssim` semantics with VALID filtering) and the global
single-window SSIM.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _accf(x: torch.Tensor) -> torch.Tensor:
    """Cast to float32, or keep float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def mean_squared_error(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(_accf(x) - _accf(y)))


def _psnr(mse: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log(1.0 / mse) / np.log(10.0)


def peak_signal_to_noise_ratio(true: torch.Tensor,
                               pred: torch.Tensor) -> torch.Tensor:
    """PSNR over the whole batch, 10*log10(1/MSE) (the reference's
    formulation: one PSNR for the batch)."""
    return _psnr(mean_squared_error(true, pred))


def per_image_mse(true: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Per-sample MSE (B,)."""
    dims = tuple(range(1, true.ndim))
    return torch.mean(torch.square(_accf(true) - _accf(pred)), dim=dims)


def psnr_per_image(true: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR averaged over the batch."""
    return torch.mean(_psnr(per_image_mse(true, pred)))


@functools.lru_cache(maxsize=8)
def _gauss_1d(size: int, sigma: float):
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return tuple((g / g.sum()).tolist())


def ssim_per_image(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0,
                   filter_size: int = 11, filter_sigma: float = 1.5,
                   k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Windowed SSIM per sample (B,) of NHWC inputs: a depthwise Gaussian
    filter with VALID padding gives the local means, variances use the
    E[x^2]-mu^2 form, and the map is averaged over space and channels.
    Images smaller than the filter use the global formula."""
    if x.ndim != 4:
        raise ValueError(f"ssim_per_image expects (B,H,W,C), got "
                         f"{tuple(x.shape)}")
    h, w, c = x.shape[1], x.shape[2], x.shape[3]
    if h < filter_size or w < filter_size:
        return ssim_global_per_image(x, y, max_val)
    dt = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dt).permute(0, 3, 1, 2)
    yf = y.to(dt).permute(0, 3, 1, 2)
    g = torch.tensor(_gauss_1d(filter_size, filter_sigma), dtype=dt,
                     device=x.device)
    kern = torch.outer(g, g)[None, None].repeat(c, 1, 1, 1)

    def filt(t):
        return F.conv2d(t, kern, groups=c)

    mu_x = filt(xf)
    mu_y = filt(yf)
    var_x = filt(xf * xf) - mu_x * mu_x
    var_y = filt(yf * yf) - mu_y * mu_y
    cov = filt(xf * yf) - mu_x * mu_y
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    ssim_map = ((2.0 * mu_x * mu_y + c1) * (2.0 * cov + c2) /
                ((mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2)))
    return torch.mean(ssim_map, dim=(1, 2, 3))


def structural_similarity(x: torch.Tensor, y: torch.Tensor,
                          max_val: float = 1.0) -> torch.Tensor:
    """Windowed SSIM averaged over the batch."""
    return torch.mean(ssim_per_image(x, y, max_val))


def ssim_global_per_image(x: torch.Tensor, y: torch.Tensor,
                          max_val: float = 1.0) -> torch.Tensor:
    """Global (single-window) SSIM per sample (B,)."""
    dims = tuple(range(1, x.ndim))
    xf = _accf(x)
    yf = _accf(y)
    mu_x = xf.mean(dim=dims, keepdim=True)
    mu_y = yf.mean(dim=dims, keepdim=True)
    var_x = torch.square(xf - mu_x).mean(dim=dims)
    var_y = torch.square(yf - mu_y).mean(dim=dims)
    cov = ((xf - mu_x) * (yf - mu_y)).mean(dim=dims)
    mu_x = mu_x.reshape(-1)
    mu_y = mu_y.reshape(-1)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    return ((2 * mu_x * mu_y + c1) * (2 * cov + c2) /
            ((mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2)))


def ssim_global(x: torch.Tensor, y: torch.Tensor,
                max_val: float = 1.0) -> torch.Tensor:
    """Global (single-window) SSIM averaged over the batch."""
    return torch.mean(ssim_global_per_image(x, y, max_val))
