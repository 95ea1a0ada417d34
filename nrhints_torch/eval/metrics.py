"""Image metrics (port of ``nrhints_tpu/eval/metrics.py``): PSNR, SSIM and
LPIPS in f32 PyTorch on the host's copies of the images.  The host, not
the card: SSIM's variances are differences of nearly equal window sums,
and the card's convolution moved a 128 x 128 view's SSIM by 2e-4, where
the host's f32 stays within 1e-5 of the JAX package's.

SSIM uses torchmetrics' defaults, as the JAX package does: an 11 x 11
Gaussian window of sigma 1.5, k1 = 0.01, k2 = 0.03, valid windows only,
per channel, then the mean.  LPIPS (the AlexNet variant) needs pretrained
weights, which are never downloaded: ``lpips()`` reads them from the .npz
that ``NRHINTS_LPIPS_WEIGHTS`` names (conv{i}_w [out, in, kh, kw],
conv{i}_b, lin{i}_w [1, C, 1, 1]) and returns NaN without one.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

_LPIPS_ENV = "NRHINTS_LPIPS_WEIGHTS"


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def psnr(rgb, rgb_gt, data_range: float = 1.0) -> float:
    mse = torch.mean((_f32(rgb) - _f32(rgb_gt)) ** 2)
    return float(10.0 * torch.log10(data_range**2 / (mse + 1e-12)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(rgb, rgb_gt, data_range: float = 1.0) -> float:
    """[H, W, C] images -> mean SSIM."""
    img1, img2 = _f32(rgb), _f32(rgb_gt)
    c = img1.shape[-1]
    kernel = _gaussian_kernel()[None, None].repeat(c, 1, 1, 1)

    def filt(x):
        return F.conv2d(x.permute(2, 0, 1)[None], kernel, groups=c)[0]

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = filt(img1 * img1) - mu1_sq
    sigma2_sq = filt(img2 * img2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu12
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return float(torch.mean(ssim_map))


@functools.lru_cache(maxsize=1)
def _load_lpips_weights():
    path = os.environ.get(_LPIPS_ENV)
    if not path or not os.path.exists(path):
        return None
    with np.load(path) as data:
        return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in data.items()}


def lpips_available() -> bool:
    return _load_lpips_weights() is not None


# AlexNet's five convolutions as LPIPS taps them: (stride, padding, a 3 x 3
# stride-2 max pool before the convolution).
_ALEXNET = ((4, 2, False), (1, 2, True), (1, 1, True), (1, 1, False), (1, 1, False))


def _alexnet_features(w: dict, x: torch.Tensor) -> list[torch.Tensor]:
    feats = []
    for i, (stride, pad, pool) in enumerate(_ALEXNET):
        if pool:
            x = F.max_pool2d(x, 3, 2)
        x = torch.relu(F.conv2d(x, w[f"conv{i}_w"], w[f"conv{i}_b"], stride=stride, padding=pad))
        feats.append(x)
    return feats


def lpips(rgb, rgb_gt) -> float:
    """LPIPS (AlexNet) distance of two [H, W, 3] images in [0, 1]; NaN
    without weights."""
    w = _load_lpips_weights()
    if w is None:
        return float("nan")
    shift = torch.tensor([-0.030, -0.088, -0.188])[None, :, None, None]
    scale = torch.tensor([0.458, 0.448, 0.450])[None, :, None, None]

    def prep(img):
        return (_f32(img).permute(2, 0, 1)[None] * 2.0 - 1.0 - shift) / scale

    total = torch.zeros(())
    with torch.no_grad():
        for i, (a, b) in enumerate(zip(_alexnet_features(w, prep(rgb)), _alexnet_features(w, prep(rgb_gt)))):
            a = a / torch.sqrt(torch.sum(a**2, dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(torch.sum(b**2, dim=1, keepdim=True) + 1e-10)
            total = total + torch.mean(torch.sum((a - b) ** 2 * w[f"lin{i}_w"], dim=1, keepdim=True))
    return float(total)
