"""Positional encodings (port of ``nrhints_tpu/core/encodings.py``): the
frequency (NeRF) encoding, the Instant-NGP multiresolution hash grid, real
spherical harmonics and random Fourier features.  The renderer reaches the
frequency encoding and, under ``SDFNetConfig(encoding="hash")``, the hash
grid; SH and RFF are the JAX module's other encodings."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from nrhints_torch.utils import device_constant, resolve_device


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


class HashEncodingConfig(NamedTuple):
    """Multiresolution hash grid: ``num_levels`` grids of resolutions from
    ``min_res`` to ``max_res`` (geometric), each hashed into a table of
    2^``log2_hashmap_size`` rows of ``features_per_level`` features."""

    num_levels: int = 16
    min_res: int = 16
    max_res: int = 1024
    init_scale: float = 0.001
    log2_hashmap_size: int = 19
    features_per_level: int = 2

    @property
    def out_dim(self) -> int:
        return self.num_levels * self.features_per_level


# Instant-NGP's spatial-hash primes, one per axis.
_HASH_PRIMES = (1, 2654435761, 805459861)
_CORNERS = [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def hash_encoding_init(generator: torch.Generator, cfg: HashEncodingConfig, device="cuda") -> dict:
    """{"table": [L, 2^log2_hashmap_size, F]} ~ U(-init_scale, init_scale),
    drawn on the host from ``generator`` and placed on the card unless
    ``device="cpu"``."""
    shape = (cfg.num_levels, 2**cfg.log2_hashmap_size, cfg.features_per_level)
    table = torch.rand(shape, generator=generator) * (2.0 * cfg.init_scale) - cfg.init_scale
    return {"table": table.to(resolve_device(device))}


def _level_scalings(cfg: HashEncodingConfig) -> list[float]:
    """floor(min_res * growth^l) per level, in float32 as the JAX package
    computes them (at the defaults the last level is 1024, not the float64
    1023)."""
    L = cfg.num_levels
    growth = math.exp((math.log(cfg.max_res) - math.log(cfg.min_res)) / (L - 1)) if L > 1 else 1.0
    powers = torch.tensor(growth, dtype=torch.float32) ** torch.arange(L, dtype=torch.float32)
    return torch.floor(cfg.min_res * powers).tolist()


def _mul_low32(c: torch.Tensor, prime: int) -> torch.Tensor:
    """(c * prime) mod 2^32 for int64 c in [0, 2^32): uint32 multiplication
    with wraparound, as two 16-bit halves of the prime so no int64 product
    overflows."""
    lo, hi = prime & 0xFFFF, prime >> 16
    return (c * lo + (((c * hi) & 0xFFFF) << 16)) & 0xFFFFFFFF


def hash_encoding_apply(params: dict, x: torch.Tensor, cfg: HashEncodingConfig) -> torch.Tensor:
    """The hash encoding of points ``x`` in [0, 1]^3 -> [N, L * F]: each
    level's 8 cell corners hashed (xor of the uint32 products with the
    primes, mod the table size), their rows gathered from the flat
    [L * T, F] table by ``index_select`` and blended trilinearly."""
    table = params["table"]
    L, F, T = cfg.num_levels, cfg.features_per_level, 2**cfg.log2_hashmap_size
    dev = x.device
    scalings = device_constant(_level_scalings(cfg), x.dtype, dev)
    xs = x[..., None, :] * scalings[:, None]  # [N, L, 3]
    xf = torch.floor(xs)
    w = xs - xf
    offsets = device_constant(sum(_CORNERS, []), torch.int64, dev).reshape(8, 3)
    # int32 corners read as uint32, as JAX's astype does.
    corners = (xf.to(torch.int32).to(torch.int64)[..., None, :] + offsets) & 0xFFFFFFFF  # [N, L, 8, 3]
    h = _mul_low32(corners[..., 0], _HASH_PRIMES[0])
    for d in (1, 2):
        h = h ^ _mul_low32(corners[..., d], _HASH_PRIMES[d])
    h = h % T
    level_base = device_constant([l * T for l in range(L)], torch.int64, dev)
    flat_idx = (h + level_base[:, None]).reshape(-1)
    vals = table.reshape(L * T, F).index_select(0, flat_idx).reshape(*h.shape, F)  # [N, L, 8, F]
    cw = torch.where(offsets == 1, w[..., None, :], 1.0 - w[..., None, :])  # [N, L, 8, 3]
    cw = cw[..., 0:1] * cw[..., 1:2] * cw[..., 2:3]
    out = torch.sum(vals * cw, dim=-2)  # [N, L, F]
    return out.reshape(*x.shape[:-1], cfg.out_dim)


def spherical_harmonics_encoding(directions: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """Real spherical harmonics of unit ``directions`` up to ``levels``
    (1-4), in nerfstudio's all-positive coefficient convention."""
    if not 1 <= levels <= 4:
        raise ValueError("levels must be in [1, 4]")
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    comps = [torch.full_like(x, 0.28209479177387814)]
    if levels > 1:
        comps += [0.4886025119029199 * y, 0.4886025119029199 * z, 0.4886025119029199 * x]
    if levels > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        comps += [
            1.0925484305920792 * xy,
            1.0925484305920792 * yz,
            0.9461746957575601 * zz - 0.31539156525251999,
            1.0925484305920792 * xz,
            0.5462742152960396 * (xx - yy),
        ]
    if levels > 3:
        comps += [
            0.5900435899266435 * y * (3.0 * xx - yy),
            2.890611442640554 * xy * z,
            0.4570457994644658 * y * (5.0 * zz - 1.0),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.4570457994644658 * x * (5.0 * zz - 1.0),
            1.445305721320277 * z * (xx - yy),
            0.5900435899266435 * x * (xx - 3.0 * yy),
        ]
    return torch.stack(comps, dim=-1)


def rff_encoding_init(generator: torch.Generator, in_dim: int, num_frequencies: int, scale: float,
                      device="cuda") -> dict:
    """Random Fourier features: a fixed Gaussian [in_dim, num_frequencies]
    frequency matrix times ``scale``, on the card unless ``device="cpu"``."""
    b = torch.randn((in_dim, num_frequencies), generator=generator) * scale
    return {"b_matrix": b.to(resolve_device(device))}


def rff_encoding_apply(params: dict, x: torch.Tensor, include_input: bool = False) -> torch.Tensor:
    """[sin(2 pi x B), cos(2 pi x B)] and, with ``include_input``, 2 pi x
    appended after them."""
    x2pi = 2.0 * math.pi * x
    scaled = x2pi @ params["b_matrix"]
    enc = torch.sin(torch.cat([scaled, scaled + math.pi / 2.0], dim=-1))
    if include_input:
        enc = torch.cat([enc, x2pi], dim=-1)
    return enc
