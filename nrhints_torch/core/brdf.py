"""Cook-Torrance specular terms for the highlight hint (port of
``nrhints_tpu/core/brdf.py``)."""
from __future__ import annotations

import math
from typing import Sequence

import torch

from nrhints_torch.utils import device_constant


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize the last axis, dividing by max(||v||, eps)."""
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=eps)


def cook_torrance_specular(
    normals: torch.Tensor,  # [..., 3] unit shading normals
    lit_dirs: torch.Tensor,  # [..., 3] unit, surface -> light
    view_dirs: torch.Tensor,  # [..., 3] unit, surface -> eye
    roughnesses: Sequence[float],
) -> torch.Tensor:
    """GGX lobe per roughness -> [..., len(roughnesses)]."""
    half_vecs = normalize(lit_dirs + view_dirs)
    ndl = torch.clamp(torch.sum(normals * lit_dirs, dim=-1), 0.0, 1.0)[..., None]
    ndv = torch.clamp(torch.sum(normals * view_dirs, dim=-1), 0.0, 1.0)[..., None]
    ndh = torch.clamp(torch.sum(normals * half_vecs, dim=-1), 0.0, 1.0)
    hdv = torch.clamp(torch.sum(half_vecs * view_dirs, dim=-1), 0.0, 1.0)[..., None]
    ndh2 = (ndh**2)[..., None]

    r = device_constant(roughnesses, normals.dtype, normals.device)
    k = (r + 1.0) ** 2 / 8.0
    g = (ndv / (ndv * (1.0 - k) + k)) * (ndl / (ndl * (1.0 - k) + k))
    a2 = r * r
    ndf = a2 / (math.pi * (ndh2 * (a2 - 1.0) + 1.0) ** 2)
    f = 0.04 + 0.96 * (1.0 - hdv) ** 5
    return ndf * g * f / (4.0 * ndv + 1e-3)
