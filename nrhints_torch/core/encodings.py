"""Frequency (NeRF) positional encoding (port of the ``nerf_encoding`` part
of ``nrhints_tpu/core/encodings.py``; the hash, SH and RFF encodings are
later work)."""
from __future__ import annotations

import math

import torch

from nrhints_torch.utils import device_constant


def nerf_encoding_dim(in_dim: int, num_frequencies: int, include_input: bool = True) -> int:
    out = in_dim * num_frequencies * 2
    if include_input:
        out += in_dim
    return out


def nerf_encoding(
    x: torch.Tensor, num_frequencies: int, include_input: bool = True
) -> torch.Tensor:
    """``[x, sin(x*2^f) dim-major, cos(...) same order]``, with the cosines
    computed as ``sin(z + pi/2)`` as the JAX package does."""
    freqs = device_constant([2.0**f for f in range(num_frequencies)], x.dtype, x.device)
    scaled = (x[..., None] * freqs).reshape(*x.shape[:-1], x.shape[-1] * num_frequencies)
    enc = torch.sin(torch.cat([scaled, scaled + math.pi / 2.0], dim=-1))
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
