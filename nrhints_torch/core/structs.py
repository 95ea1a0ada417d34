"""Batched tensor dataclasses passed between the camera, render and eval
layers (port of ``nrhints_tpu/core/structs.py``)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


def _map(obj, fn):
    """Apply ``fn`` to every tensor field (None stays None)."""
    return dataclasses.replace(
        obj,
        **{
            f.name: None if getattr(obj, f.name) is None else fn(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        },
    )


@dataclass
class PixelBundle:
    """A batch of pixels; every field shares the leading batch shape.
    ``img_indices`` is None for procedural (video) views."""

    h_indices: torch.Tensor  # [*bs] pixel row
    w_indices: torch.Tensor  # [*bs] pixel column
    poses: torch.Tensor  # [*bs, 4, 4] camera-to-world
    pls: torch.Tensor  # [*bs, 3] point-light position
    img_indices: Optional[torch.Tensor] = None  # [*bs] int
    rgb_gt: Optional[torch.Tensor] = None  # [*bs, 3]

    def __getitem__(self, idx) -> "PixelBundle":
        return _map(self, lambda x: x[idx])

    def to(self, device) -> "PixelBundle":
        return _map(self, lambda x: torch.as_tensor(x).to(device))


@dataclass
class RayBundle:
    origins: torch.Tensor  # [*bs, 3]
    directions: torch.Tensor  # [*bs, 3] unit-norm
    pl_positions: torch.Tensor  # [*bs, 3]
    nears: torch.Tensor  # [*bs, 1]
    fars: torch.Tensor  # [*bs, 1]


@dataclass
class RenderOutput:
    """Per-ray render results.  ``relax_inside_sphere`` carries the r<1.0
    mask, as the JAX package and the original code do."""

    rgb: torch.Tensor  # [B, 3]
    depth: torch.Tensor  # [B, 1]
    weights: torch.Tensor  # [B, n_samples]
    s_val: torch.Tensor  # [B, 1]
    inside_sphere: torch.Tensor  # [B, n_samples]
    relax_inside_sphere: torch.Tensor  # [B, n_samples]
    analytic_normals: torch.Tensor  # [B, n_samples, 3]
    normalized_analytic_normals: torch.Tensor  # [B, n_samples, 3]
    visibilities: Optional[torch.Tensor] = None  # [B, 1] shadow map
    specular_cue: Optional[torch.Tensor] = None  # [B, n_samples, n_rough]
