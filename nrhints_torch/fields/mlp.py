"""Linear-layer primitives as parameter dicts (port of
``nrhints_tpu/fields/mlp.py``).

Plain layers are ``{w, b}``; weight-normalized layers are ``{v, g, b}``.
``w``/``v`` are stored ``[in, out]`` like the JAX package, so a layer is
``x @ w + b`` and converted JAX weights need no transpose.  Weight norm is
torch's ``weight_norm(dim=0)`` over an ``[out, in]`` weight, i.e. the norm
is taken over axis 0 of the stored ``[in, out]`` ``v``.
"""
from __future__ import annotations

import math

import torch

from nrhints_torch.utils import resolve_device


def torch_default_linear_init(
    generator: torch.Generator, in_dim: int, out_dim: int, device="cuda"
) -> tuple[torch.Tensor, torch.Tensor]:
    """torch.nn.Linear's default init: U(-1/sqrt(in), 1/sqrt(in)) for the
    weight ``[in, out]`` and the bias, drawn on the host from ``generator``
    and placed on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    bound = 1.0 / math.sqrt(in_dim)
    w = torch.rand((in_dim, out_dim), generator=generator) * (2 * bound) - bound
    b = torch.rand((out_dim,), generator=generator) * (2 * bound) - bound
    return w.to(device), b.to(device)


def linear_params(w: torch.Tensor, b: torch.Tensor) -> dict:
    return {"w": w, "b": b}


def weight_norm_params(w: torch.Tensor, b: torch.Tensor) -> dict:
    """Weight-norm parameters whose initial effective weight is ``w``."""
    return {"v": w, "g": torch.linalg.norm(w, dim=0), "b": b}


def maybe_weight_norm_params(w: torch.Tensor, b: torch.Tensor, weight_norm: bool) -> dict:
    return weight_norm_params(w, b) if weight_norm else linear_params(w, b)


def effective_weight(params: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(w [in, out], b [out]) of a layer in either parameterization."""
    if "v" in params:
        v = params["v"]
        return v * (params["g"][None, :] / torch.linalg.norm(v, dim=0, keepdim=True)), params["b"]
    return params["w"], params["b"]


def apply_linear_any(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` in float32 for either parameterization."""
    w, b = effective_weight(params)
    return x @ w + b
