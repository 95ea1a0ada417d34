"""Reflectance (colour) MLP conditioned on geometry features, view
direction, point light and the two hints (port of
``nrhints_tpu/fields/reflectance.py``).

Input = [pts, PE(view, 4), normal, PE(pl, 4), feat, PE(vis, 4),
PE(spec, 4)] -> n_layers x d_hidden ReLU MLP -> sigmoid RGB.  On the eval
path the trunk runs in float32 as plain matmuls, as the JAX package's
``eval_reflectance_impl="xla"`` default does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from nrhints_torch.core.encodings import nerf_encoding, nerf_encoding_dim
from nrhints_torch.fields.mlp import (
    apply_linear_any,
    maybe_weight_norm_params,
    torch_default_linear_init,
)


@dataclass(frozen=True)
class ReflectanceNetConfig:
    d_hidden: int = 256
    n_layers: int = 4
    weight_norm: bool = True
    multi_res: int = 4
    squeeze_out: bool = True
    compute_dtype: str = "float32"


def reflectance_input_dim(
    cfg: ReflectanceNetConfig,
    d_feature: int,
    shadow_hint: bool,
    specular_hint: bool,
    specular_hint_len: int,
) -> int:
    d = 3 + 3 + 3 + 3 + d_feature
    d += (nerf_encoding_dim(3, cfg.multi_res) - 3) * 2
    if shadow_hint:
        d += nerf_encoding_dim(1, cfg.multi_res)
    if specular_hint:
        d += nerf_encoding_dim(specular_hint_len, cfg.multi_res)
    return d


def reflectance_init(
    generator: torch.Generator,
    cfg: ReflectanceNetConfig = ReflectanceNetConfig(),
    d_feature: int = 256,
    d_out: int = 3,
    shadow_hint: bool = True,
    specular_hint: bool = True,
    specular_hint_len: int = 4,
    device="cuda",
) -> dict:
    """Weight-norm trunk parameters, on the card unless ``device="cpu"``
    (without CUDA the default raises)."""
    d0 = reflectance_input_dim(cfg, d_feature, shadow_hint, specular_hint, specular_hint_len)
    dims = [d0] + [cfg.d_hidden] * cfg.n_layers + [d_out]
    params = {}
    for i in range(len(dims) - 1):
        w, b = torch_default_linear_init(generator, dims[i], dims[i + 1], device)
        params[f"lin{i}"] = maybe_weight_norm_params(w, b, cfg.weight_norm)
    return params


def reflectance_forward(
    params: dict,
    cfg: ReflectanceNetConfig,
    points: torch.Tensor,  # [N, 3]
    normals: torch.Tensor,  # [N, 3]
    view_dirs: torch.Tensor,  # [N, 3]
    feature_vectors: torch.Tensor,  # [N, F]
    point_lights: torch.Tensor,  # [N, 3]
    visibilities: torch.Tensor | None = None,  # [N, 1]
    specular_cue: torch.Tensor | None = None,  # [N, R]
) -> torch.Tensor:
    """-> [N, 3] RGB in [0, 1], in the original concat order."""
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            "ReflectanceNetConfig.compute_dtype='bfloat16' steers the unfused "
            "training path, which is a later slice"
        )
    parts = [
        points,
        nerf_encoding(view_dirs, cfg.multi_res),
        normals,
        nerf_encoding(point_lights, cfg.multi_res),
        feature_vectors,
    ]
    if visibilities is not None:
        parts.append(nerf_encoding(visibilities, cfg.multi_res))
    if specular_cue is not None:
        parts.append(nerf_encoding(specular_cue, cfg.multi_res))
    h = torch.cat(parts, dim=-1)
    n_lin = cfg.n_layers + 1
    for i in range(n_lin):
        h = apply_linear_any(params[f"lin{i}"], h)
        if i < n_lin - 1:
            h = torch.relu(h)
    if cfg.squeeze_out:
        h = torch.sigmoid(h)
    return h
