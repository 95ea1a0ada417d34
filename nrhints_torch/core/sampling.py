"""Ray-sampling primitives of the render and train paths (port of
``nrhints_tpu/core/sampling.py``): stratified samples with their optional
jitter, the in-bin jitter of shadow rays, the exclusive transmittance, and
the unfused march's samplers: the inverse-CDF ``sample_pdf``, one round of
NeuS up-sampling (``neus_up_sample``) and the rank-by-count sorted merge
(``merge_z_vals``).  Every one of them is differentiable in its float
inputs (``shadow_hint_gradient`` differentiates the whole shadow march),
and their backward passes are deterministic: ``sample_pdf``'s gathers sum
their repeated indices by comparison, not by atomic adds.

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


class _GatherLast(torch.autograd.Function):
    """``torch.gather`` over the last axis whose backward sums the
    cotangents of repeated indices by a one-hot comparison and a sum over
    the gathered axis, a fixed order, where ``scatter_add`` adds them by
    atomics in any order on the card."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.n = src.shape[-1]
        return torch.gather(src, -1, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        slots = torch.arange(ctx.n, device=idx.device)
        onehot = idx[..., :, None] == slots
        return torch.sum(torch.where(onehot, g[..., :, None], 0.0), dim=-2), None


def _gather_last(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return _GatherLast.apply(src, idx) if src.requires_grad else torch.gather(src, -1, idx)


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    *,
    det: bool = True,
    u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Inverse-CDF draw of ``n_samples`` positions from the piecewise-constant
    pdf of ``weights`` [B, n_bins - 1] over the edges ``bins`` [B, n_bins].
    ``det`` takes the evenly spaced u of NeuS's up-sampling; otherwise u
    [B, n_samples] is given or drawn from ``generator``."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    shape = (*cdf.shape[:-1], n_samples)
    if det:
        u = linspace01(n_samples, cdf.dtype, cdf.device).expand(shape)
    else:
        u = _uniforms(shape, cdf, u, generator)
    # Right searchsorted as a count of the cdf entries <= u, as JAX counts.
    inds = torch.sum(u[..., :, None] >= cdf[..., None, :], dim=-1)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_below, cdf_above = _gather_last(cdf, below), _gather_last(cdf, above)
    bins_below, bins_above = _gather_last(bins, below), _gather_last(bins, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def neus_up_sample(rays_o: torch.Tensor, rays_d: torch.Tensor, z_vals: torch.Tensor, sdf: torch.Tensor,
                   n_importance: int, inv_s: float) -> torch.Tensor:
    """One round of NeuS up-sampling at a fixed ``inv_s``: section alphas
    from the sdf at the samples by the sigmoid-CDF ratio, with the
    min(cos, previous cos) guard, clipped to [-1e3, 0] and zeroed where
    neither end lies in the unit sphere; then ``n_importance`` det draws
    from their weights -> [B, n_importance]."""
    batch, n = z_vals.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., :, None]
    radius = torch.linalg.norm(pts, dim=-1)
    inside_sphere = (radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0)
    sdf = sdf.reshape(batch, n)
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
    prev_cos = torch.cat([torch.zeros_like(cos_val[:, :1]), cos_val[:, :-1]], dim=-1)
    cos_val = torch.minimum(prev_cos, cos_val)
    cos_val = torch.clamp(cos_val, -1e3, 0.0) * inside_sphere
    dist = next_z - prev_z
    prev_cdf = torch.sigmoid((mid_sdf - cos_val * dist * 0.5) * inv_s)
    next_cdf = torch.sigmoid((mid_sdf + cos_val * dist * 0.5) * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    weights = alpha * transmittance(alpha)
    return sample_pdf(z_vals, weights, n_importance, det=True)


def merge_z_vals(z_vals: torch.Tensor, new_z_vals: torch.Tensor, sdf: torch.Tensor | None = None,
                 new_sdf: torch.Tensor | None = None):
    """Sorted merge of two sorted buffers [B, n] and [B, m] -> ([B, n + m],
    the sdf values merged alike or None).  Each value's slot is its rank by
    count, old before new on ties (a stable sort of the concatenation), and
    the values are written there by scatter: exact, and differentiable in
    the values."""
    n, m = z_vals.shape[-1], new_z_vals.shape[-1]
    r_old = torch.arange(n, device=z_vals.device) + torch.sum(new_z_vals[:, None, :] < z_vals[:, :, None], dim=-1)
    r_new = torch.arange(m, device=z_vals.device) + torch.sum(z_vals[:, None, :] <= new_z_vals[:, :, None], dim=-1)

    def merged(a, b):
        out = torch.zeros((a.shape[0], n + m), dtype=a.dtype, device=a.device)
        return out.scatter(-1, r_old, a).scatter(-1, r_new, b)

    return merged(z_vals, new_z_vals), None if sdf is None else merged(sdf, new_sdf)
