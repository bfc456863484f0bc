"""Training losses: L1 + SSIM mix, PSNR (counterpart of
``gaussian_splatting_tpu/losses.py``).

SSIM uses the reference's torchmetrics defaults (gaussian window 11,
sigma 1.5, k1 = 0.01, k2 = 0.03, data range 1) as a separable filter of
shifted, weighted adds with reflect padding, in float32.  No convolution
runs, so no TF32 setting reaches it: SSIM's variances E[x^2] - mu^2 cancel
and need full float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_SIZE, _SIGMA = 11, 1.5


@functools.lru_cache
def _gaussian_taps(size: int = _SIZE, sigma: float = _SIGMA) -> tuple:
    """The 1-D filter's float32 weights, as Python floats (exact)."""
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    return tuple(float(w) for w in (g / g.sum()).astype(np.float32))


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    """Indices of numpy's "reflect" padding by r on each side of n."""
    idx = torch.arange(-r, n + r, device=device).abs()
    return torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)


def _filter1d(img: torch.Tensor, dim: int) -> torch.Tensor:
    """1-D gaussian filter along ``dim``: the sum of the 11 shifted slices
    of the reflect-padded image times their weights, in tap order."""
    taps = _gaussian_taps()
    r = (len(taps) - 1) // 2
    n = img.shape[dim]
    p = img.index_select(dim, _reflect_index(n, r, img.device))
    out = None
    for t, w in enumerate(taps):
        sl = p.narrow(dim, t, n) * w
        out = sl if out is None else out + sl
    return out


def _filter2d(img: torch.Tensor) -> torch.Tensor:
    """Separable gaussian filter of an (H, W, C) image: rows, then columns."""
    return _filter1d(_filter1d(img, 0), 1)


def ssim(img: torch.Tensor, gt: torch.Tensor, data_range: float = 1.0,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM between two (H, W, C) images (Wang et al. 2004)."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _filter2d(img)
    mu_y = _filter2d(gt)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_x = _filter2d(img * img) - mu_xx
    sigma_y = _filter2d(gt * gt) - mu_yy
    sigma_xy = _filter2d(img * gt) - mu_xy
    num = (2 * mu_xy + c1) * (2 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2)
    return torch.mean(num / den)


def _psnr(img, gt):
    mse = torch.mean((img - gt) ** 2)
    return -10.0 * torch.log10(mse)


def _abs(x):
    """|x| whose derivative is +1 at x = 0, as ``jnp.abs``'s; the derivative
    of ``torch.abs`` there is 0.  Where the render equals the target (an
    uncovered pixel, a colour channel that is 0 in both) the two would
    differ by 1/N in the L1 gradient."""
    return torch.where(x >= 0, x, -x)


def train_loss(image: torch.Tensor, gt: torch.Tensor, ssim_frac: float):
    """(1-f)*L1 + f*(1-SSIM) on the raw (unclipped) rendered image.
    Returns (loss, psnr)."""
    l1 = torch.mean(_abs(image - gt))
    s = ssim(image, gt)
    loss = (1.0 - ssim_frac) * l1 + ssim_frac * (1.0 - s)
    return loss, _psnr(image, gt)


def eval_psnr_ssim(image: torch.Tensor, gt: torch.Tensor):
    """Test-split metrics on the image clipped to [0, 1]: (psnr, ssim)."""
    img = torch.clamp(image, 0.0, 1.0)
    return _psnr(img, gt), ssim(img, gt)
