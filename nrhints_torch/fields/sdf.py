"""Neural SDF field: frequency- or hash-encoded softplus(100) MLP with the
SAL sphere init, weight norm and a skip connection (port of
``nrhints_tpu/fields/sdf.py``).

The fused path evaluates this field through the fused core
(``kernels/core_mlp.py``) and the march sweeps (``kernels/march.py``);
``sdf_forward`` here is the plain network, which the unfused path runs:
``sdf_value_feat_grad`` (value, feature and the input gradient by
``torch.autograd.grad``, differentiable again for the eikonal loss) and
``sdf_value_and_dirderiv`` (value and one forward-mode tangent, for the
shadow march).  ``compute_dtype="bfloat16"`` carries the activations in
bf16 with f32 accumulation, as the JAX package does on its unfused path.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F

from nrhints_torch.core.encodings import (
    HashEncodingConfig,
    hash_encoding_apply,
    hash_encoding_init,
    nerf_encoding,
    nerf_encoding_dim,
)
from nrhints_torch.fields.mlp import (
    apply_linear_any,
    maybe_weight_norm_params,
    torch_default_linear_init,
)
from nrhints_torch.utils import resolve_device, tree_leaves


@dataclass(frozen=True)
class SDFNetConfig:
    """Same fields and defaults as the JAX ``SDFNetConfig``.  ``encoding``:
    "frequency" or "hash" (the fused kernels take the frequency encoding
    only, so the hash encoding runs the unfused path); ``compute_dtype``
    ("float32" or "bfloat16") steers the plain network only."""

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
    def hash_config(self) -> HashEncodingConfig:
        return HashEncodingConfig(
            num_levels=self.hash_levels,
            min_res=self.hash_min_res,
            max_res=self.hash_max_res,
            log2_hashmap_size=self.hash_log2_size,
            features_per_level=self.hash_features_per_level,
        )

    @property
    def d_encoded(self) -> int:
        if self.encoding == "hash":
            return self.d_in + self.hash_config.out_dim
        return nerf_encoding_dim(self.d_in, self.multi_res, include_input=True)


def compute_dtype_of(name: str) -> torch.dtype | None:
    """None for "float32" (plain f32 dots), else the torch dtype."""
    if name == "float32":
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {name!r}")


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
    -init_bias*scale; under the hash encoding its table first.  Drawn on
    the host from ``generator``, placed on the card unless ``device="cpu"``
    (without CUDA the default raises)."""
    device = resolve_device(device)
    io, dims = _layer_dims(cfg)
    d0 = cfg.d_encoded
    bias = cfg.init_bias * cfg.scale
    params = {}
    if cfg.encoding == "hash":
        params["hash"] = hash_encoding_init(generator, cfg.hash_config, device)
    elif cfg.encoding != "frequency":
        raise ValueError(f"SDF encoding must be 'frequency' or 'hash', got {cfg.encoding!r}")
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
    """[N, 3] -> [N, 1 + d_out_feat] in float32: column 0 is the SDF.  Under
    ``compute_dtype="bfloat16"`` the encoding and every activation are kept
    in bf16 between the layers (each dot accumulates in f32, the softplus
    runs on the f32 sum)."""
    if cfg.encoding == "hash":
        # The scene lies in the unit sphere; the grid covers the unit cube.
        x01 = torch.clamp((x + 1.0) * 0.5, 0.0, 1.0)
        inputs = torch.cat([x * cfg.scale, hash_encoding_apply(params["hash"], x01, cfg.hash_config)], dim=-1)
    else:
        inputs = nerf_encoding(x * cfg.scale, cfg.multi_res, include_input=True)
    cdt = compute_dtype_of(cfg.compute_dtype)
    if cdt is not None:
        inputs = inputs.to(cdt)
    h = inputs
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for i in range(cfg.n_layers):
        if i in cfg.skip_in:
            h = torch.cat([h, inputs], dim=-1) * inv_sqrt2
        h = F.softplus(100.0 * apply_linear_any(params[f"lin{i}"], h, cdt)) / 100.0
        if cdt is not None:
            h = h.to(cdt)
    sdf = apply_linear_any(params["out_sdf"], h, cdt) / cfg.scale
    feat = apply_linear_any(params["out_feat"], h, cdt)
    return torch.cat([sdf, feat], dim=-1)


def sdf_only(params: dict, cfg: SDFNetConfig, x: torch.Tensor) -> torch.Tensor:
    """[N, 3] -> [N] signed distance."""
    return sdf_forward(params, cfg, x)[..., 0]


def sdf_value_feat_grad(params: dict, cfg: SDFNetConfig, x: torch.Tensor):
    """(sdf [N], feat [N, F], grad_x sdf [N, 3]) of the plain network: the
    input gradient by ``torch.autograd.grad`` of the sdf column.  Where
    autograd will want gradients of the outputs (grad mode on and ``x`` or
    a parameter requiring one), the gradient keeps its graph
    (``create_graph=True``), so the eikonal loss differentiates through it;
    otherwise (the evaluator's ``no_grad``) grad is enabled locally for the
    normal alone and every output comes back detached."""
    want = torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in tree_leaves(params)))
    with torch.enable_grad():
        xg = x if want and x.requires_grad else x.detach().requires_grad_(True)
        out = sdf_forward(params, cfg, xg)
        (grad,) = torch.autograd.grad(out[:, 0].sum(), xg, create_graph=want)
    if not want:
        out = out.detach()
    return out[:, 0], out[:, 1:], grad


def sdf_value_and_dirderiv(params: dict, cfg: SDFNetConfig, x: torch.Tensor, dirs: torch.Tensor):
    """(sdf [N], dirs . grad_x sdf [N]) by one forward-mode tangent along
    ``dirs`` (``torch.autograd.forward_ad``); the tangent's ops are ordinary
    autograd ops, so a backward runs through it (``shadow_hint_gradient``)."""
    with fwAD.dual_level():
        out = sdf_only(params, cfg, fwAD.make_dual(x, dirs))
        sdf, dcos = fwAD.unpack_dual(out)
    return sdf, dcos
