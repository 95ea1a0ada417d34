"""Neural SDF field: frequency-encoded softplus(100) MLP with the SAL sphere
init, weight norm and a skip connection (port of
``nrhints_tpu/fields/sdf.py``).

The eval path evaluates this field through the fused core
(``kernels/core_mlp.py``) and the march sweeps (``kernels/march.py``);
``sdf_forward`` here is the plain reference of the same network.  The hash
encoding and the autograd normal/eikonal helpers come with later slices.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from nrhints_torch.core.encodings import nerf_encoding, nerf_encoding_dim
from nrhints_torch.fields.mlp import (
    apply_linear_any,
    maybe_weight_norm_params,
    torch_default_linear_init,
)
from nrhints_torch.utils import resolve_device


@dataclass(frozen=True)
class SDFNetConfig:
    """Same fields and defaults as the JAX ``SDFNetConfig``."""

    d_in: int = 3
    d_out_feat: int = 256
    d_hidden: int = 256
    n_layers: int = 8
    skip_in: Tuple[int, ...] = (4,)
    multi_res: int = 6
    init_bias: float = 0.5
    scale: float = 3.0
    geometric_init: bool = True
    weight_norm: bool = True
    inside_outside: bool = False
    encoding: str = "frequency"
    compute_dtype: str = "float32"
    hash_levels: int = 16
    hash_min_res: int = 16
    hash_max_res: int = 1024
    hash_log2_size: int = 19
    hash_features_per_level: int = 2

    @property
    def d_encoded(self) -> int:
        return nerf_encoding_dim(self.d_in, self.multi_res, include_input=True)


def check_ported(cfg: SDFNetConfig) -> None:
    """Raise on the config values whose code paths this slice lacks."""
    if cfg.encoding != "frequency":
        raise NotImplementedError(
            f"SDF encoding {cfg.encoding!r}: the port has only the frequency "
            "encoding; the hash encoding is a later slice (off-path features)"
        )
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            "SDFNetConfig.compute_dtype only steers the JAX package's unfused "
            "training path, which is a later slice"
        )


def _layer_dims(cfg: SDFNetConfig):
    """Per-hidden-layer (in_dim, out_dim); a layer feeding a skip layer
    shrinks so concat([h, enc]) refills the hidden width."""
    d0 = cfg.d_encoded
    dims = [d0] + [cfg.d_hidden] * cfg.n_layers + [cfg.d_out_feat + 1]
    io = []
    for i in range(cfg.n_layers):
        out_dim = dims[i + 1] - d0 if (i + 1) in cfg.skip_in else dims[i + 1]
        io.append((dims[i], out_dim))
    return io, dims


def sdf_init(generator: torch.Generator, cfg: SDFNetConfig = SDFNetConfig(), device="cuda") -> dict:
    """SAL init to a sphere of radius ``init_bias``: hidden weights
    ~ N(0, sqrt(2)/sqrt(out)) with the encoding channels zeroed at the input
    and skip layers; heads near-constant sqrt(pi)/sqrt(d_last) with bias
    -init_bias*scale.  Drawn on the host from ``generator``, placed on the
    card unless ``device="cpu"`` (without CUDA the default raises)."""
    check_ported(cfg)
    device = resolve_device(device)
    io, dims = _layer_dims(cfg)
    d0 = cfg.d_encoded
    bias = cfg.init_bias * cfg.scale
    params = {}
    for i, (in_dim, out_dim) in enumerate(io):
        if cfg.geometric_init:
            w = torch.randn((in_dim, out_dim), generator=generator) * (math.sqrt(2.0) / math.sqrt(out_dim))
            b = torch.zeros((out_dim,))
            if cfg.multi_res > 0 and i == 0:
                w[cfg.d_in :, :] = 0.0
            elif cfg.multi_res > 0 and i in cfg.skip_in:
                w[-(d0 - cfg.d_in) :, :] = 0.0
        else:
            w, b = torch_default_linear_init(generator, in_dim, out_dim, "cpu")
        params[f"lin{i}"] = maybe_weight_norm_params(w.to(device), b.to(device), cfg.weight_norm)
    for name, out_dim in (("sdf", 1), ("feat", dims[-1] - 1)):
        if cfg.geometric_init:
            sign = -1.0 if cfg.inside_outside else 1.0
            mean = math.sqrt(math.pi) / math.sqrt(dims[-1])
            w = sign * mean + 1e-4 * torch.randn((dims[-2], out_dim), generator=generator)
            b = torch.full((out_dim,), -sign * bias)
        else:
            w, b = torch_default_linear_init(generator, dims[-2], out_dim, "cpu")
        params[f"out_{name}"] = maybe_weight_norm_params(w.to(device), b.to(device), cfg.weight_norm)
    return params


def sdf_forward(params: dict, cfg: SDFNetConfig, x: torch.Tensor) -> torch.Tensor:
    """[N, 3] -> [N, 1 + d_out_feat] in float32: column 0 is the SDF."""
    check_ported(cfg)
    inputs = nerf_encoding(x * cfg.scale, cfg.multi_res, include_input=True)
    h = inputs
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for i in range(cfg.n_layers):
        if i in cfg.skip_in:
            h = torch.cat([h, inputs], dim=-1) * inv_sqrt2
        h = F.softplus(100.0 * apply_linear_any(params[f"lin{i}"], h)) / 100.0
    sdf = apply_linear_any(params["out_sdf"], h) / cfg.scale
    feat = apply_linear_any(params["out_feat"], h)
    return torch.cat([sdf, feat], dim=-1)


def sdf_only(params: dict, cfg: SDFNetConfig, x: torch.Tensor) -> torch.Tensor:
    """[N, 3] -> [N] signed distance."""
    return sdf_forward(params, cfg, x)[..., 0]
