"""Ray-sampling primitives of the render and train paths (port of parts of
``nrhints_tpu/core/sampling.py``): stratified samples with their optional
jitter, the in-bin jitter of shadow rays, and the exclusive transmittance.
The non-fused samplers (``sample_pdf``, ``neus_up_sample``,
``merge_z_vals``) belong to the unfused path, a later slice.

Jitter takes its uniforms in [0, 1) either explicitly (``u=``, so a test
can hand both packages the same numbers) or drawn from a
``torch.Generator`` on the tensors' device."""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable


def linspace01(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``n`` evenly spaced values in [0, 1] as ``i * (1/(n-1))`` — the
    formulation that reproduces ``jnp.linspace(0, 1, n)`` bit for bit."""
    return torch.arange(n, dtype=dtype, device=device) * (1.0 / (n - 1))


def _uniforms(shape, like: torch.Tensor, u: torch.Tensor | None, generator: torch.Generator | None):
    if u is not None:
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"uniforms of shape {tuple(shape)} expected, got {tuple(u.shape)}")
        return u.to(dtype=like.dtype, device=like.device)
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


def stratified_z_vals(
    nears: torch.Tensor,
    fars: torch.Tensor,
    n_samples: int,
    *,
    jitter: bool = False,
    u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Uniform z in [near, far] -> [B, n]; with ``jitter``, every ray moves
    by one shared offset of (u - 0.5) sample widths, u [B, 1]."""
    t = linspace01(n_samples, nears.dtype, nears.device)
    z_vals = nears + (fars - nears) * t[None, :]
    if jitter:
        t_rand = _uniforms((z_vals.shape[0], 1), z_vals, u, generator) - 0.5
        z_vals = z_vals + t_rand * 2.0 / n_samples
    return z_vals


def perturb_z_vals_within_bins(
    z_vals: torch.Tensor, *, u: torch.Tensor | None = None, generator: torch.Generator | None = None
) -> torch.Tensor:
    """Independent jitter of every sample inside its interval between the
    neighbouring mid-points; u has the shape of ``z_vals``."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    return lower + (upper - lower) * _uniforms(z_vals.shape, z_vals, u, generator)


class _PositiveCumprod(torch.autograd.Function):
    """``torch.cumprod`` over the last axis of factors that are never 0, with
    the backward PyTorch takes for such factors, reversed_cumsum(out * g) /
    x, bit for bit.  PyTorch's own backward first asks the host whether any
    factor is 0, a sync that a CUDA graph cannot capture."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return (out * g).flip(-1).cumsum(-1).flip(-1).div(x)


def transmittance(alpha: torch.Tensor) -> torch.Tensor:
    """T_i = prod_{j<i} (1 - a_j + 1e-7), exclusive (the 1e-7 matches the
    original cumprod); alpha lies in [0, 1], so no factor is 0."""
    shifted = torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha[..., :-1] + 1e-7], dim=-1)
    return _PositiveCumprod.apply(shifted)
