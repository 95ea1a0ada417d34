"""Relighting-aware background NeRF over NeRF++ inverted-sphere coordinates
(port of ``nrhints_tpu/fields/bg_nerf.py``): an 8 x 256 ReLU MLP with a
skip at layer 4 on PE(pts4, L=10), whose view branch takes concat(view
direction, light position) encoded jointly at L=4, so the background
follows the moving light.  Points are the 4-D inverted-sphere coordinates
(x/r, y/r, z/r, 1/r) the renderer makes.  The renderer runs it in plain
f32 matmuls, as the JAX package runs it outside any kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from nrhints_torch.core.encodings import nerf_encoding, nerf_encoding_dim
from nrhints_torch.fields.mlp import apply_linear_any, linear_params, torch_default_linear_init


@dataclass(frozen=True)
class BgNeRFConfig:
    d_hidden: int = 256
    n_layers: int = 8
    multi_res: int = 10
    multi_res_view: int = 4
    skips: Tuple[int, ...] = (4,)
    d_in: int = 4
    d_in_view: int = 6


def bg_nerf_init(generator: torch.Generator, cfg: BgNeRFConfig = BgNeRFConfig(), device="cuda") -> dict:
    """torch.nn.Linear's default init for every layer, in the JAX order
    (the point layers, then views_lin0, feature, alpha, rgb), drawn on the
    host from ``generator`` and placed on the card unless ``device="cpu"``.
    A skip layer's input is W + d_pts wide: the skip is concatenated after
    the previous layer's ReLU."""
    d_pts = nerf_encoding_dim(cfg.d_in, cfg.multi_res)
    d_view = nerf_encoding_dim(cfg.d_in_view, cfg.multi_res_view)
    W = cfg.d_hidden
    params = {}
    in_dim = d_pts
    for i in range(cfg.n_layers):
        params[f"pts_lin{i}"] = linear_params(*torch_default_linear_init(generator, in_dim, W, device))
        in_dim = W + d_pts if i in cfg.skips else W
    params["views_lin0"] = linear_params(*torch_default_linear_init(generator, d_view + W, W // 2, device))
    params["feature"] = linear_params(*torch_default_linear_init(generator, W, W, device))
    params["alpha"] = linear_params(*torch_default_linear_init(generator, W, 1, device))
    params["rgb"] = linear_params(*torch_default_linear_init(generator, W // 2, 3, device))
    return params


def bg_nerf_forward(params: dict, cfg: BgNeRFConfig, pts4: torch.Tensor, view_dirs: torch.Tensor,
                    pl_positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(density [N, 1], raw rgb [N, 3]) at inverted-sphere points ``pts4``
    [N, 4] seen along ``view_dirs`` [N, 3] under lights ``pl_positions``."""
    pts_enc = nerf_encoding(pts4, cfg.multi_res, include_input=True)
    view_enc = nerf_encoding(torch.cat([view_dirs, pl_positions], dim=-1), cfg.multi_res_view, include_input=True)
    h = pts_enc
    for i in range(cfg.n_layers):
        h = torch.relu(apply_linear_any(params[f"pts_lin{i}"], h))
        if i in cfg.skips:
            h = torch.cat([pts_enc, h], dim=-1)
    alpha = apply_linear_any(params["alpha"], h)
    feature = apply_linear_any(params["feature"], h)
    h = torch.relu(apply_linear_any(params["views_lin0"], torch.cat([feature, view_enc], dim=-1)))
    return alpha, apply_linear_any(params["rgb"], h)
