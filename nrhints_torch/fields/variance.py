"""NeuS single-variance network: one learnable scalar, inv_s =
exp(10 * variance) (port of ``nrhints_tpu/fields/variance.py``)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from nrhints_torch.utils import resolve_device


@dataclass(frozen=True)
class VarianceConfig:
    init_val: float = 0.3


def variance_init(cfg: VarianceConfig = VarianceConfig(), device="cuda") -> dict:
    """On the card unless ``device="cpu"``; without CUDA the default raises."""
    return {"variance": torch.tensor(cfg.init_val, dtype=torch.float32, device=resolve_device(device))}


def inv_s_from_params(params: dict) -> torch.Tensor:
    """Scalar inv_s, clipped to [1e-6, 1e6]."""
    return torch.clamp(torch.exp(params["variance"] * 10.0), 1e-6, 1e6)
