"""NeuS-with-hints volume renderer (port of
``nrhints_tpu/render/renderer.py``).

``render_rays`` follows the JAX package's fused path: 64 stratified
samples (jittered in training) refined by a 4 x 16 importance march (under
the shipping ``RendererConfig`` plain sweeps and kernel B; the round-4
knobs ``importance_split``, ``march_sweep_impl``, ``march_rounds_impl``,
``march_merge`` route it through kernels K, L or M as in JAX), the SDF core
with normals (kernel A
without a gradient; with one, the ``core_backward`` schedule: kernels D and
E for "stash", A and H for "recompute", D and E's plain version for
"stash_xla"), sigmoid-CDF alpha with cos annealing, transmittance
compositing, alpha-blended depth, the shadow hint as the transmittance of a
64 + 4 x 16 march from the light (kernels B and C, or under
``shadow_split=False`` the monolith N; its samples jittered in training),
the Cook-Torrance highlight hint at 4 roughnesses, and the
reflectance trunk: ``reflectance_impl`` in training and
``eval_reflectance_impl`` in eval pick f32 plain matmuls ("xla") or the
fused trunk (kernel I without a gradient; F and G, or I and J under
"recompute", with one).  On CUDA tensors every
kernel runs on the card; on CPU tensors each kernel wrapper runs its plain
version.  Config values that reach a branch the port does not have yet
raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch

from nrhints_torch.core.brdf import cook_torrance_specular, normalize
from nrhints_torch.core.sampling import linspace01, perturb_z_vals_within_bins, stratified_z_vals, transmittance
from nrhints_torch.core.structs import RayBundle, RenderOutput
from nrhints_torch.fields.bg_nerf import BgNeRFConfig
from nrhints_torch.fields.reflectance import ReflectanceNetConfig, reflectance_forward, reflectance_init
from nrhints_torch.fields.sdf import SDFNetConfig, sdf_init, sdf_only
from nrhints_torch.fields.variance import VarianceConfig, inv_s_from_params, variance_init
from nrhints_torch.kernels.core_mlp import fused_reflectance_forward, fused_sdf_value_feat_grad
from nrhints_torch.kernels.march import fused_importance_z, fused_shadow_tau
from nrhints_torch.utils import resolve_device


@dataclass(frozen=True)
class RendererConfig:
    """Same field names and defaults as the JAX ``RendererConfig``.

    ``fused_kernels``: "auto" and "on" both mean the kernels (on CPU
    tensors, their plain versions); "off" (the unfused path) raises in this
    slice.  The block-size knobs of the TPU kernels are kept so configs
    carry across; the march knobs (``shadow_split``, ``importance_split``,
    the three ``*_impl`` of the march, ``march_merge``) route as in JAX,
    and a value outside their JAX sets raises ``ValueError``; of the other
    implementation knobs, values the port has no path for raise
    (``core_backward`` takes "stash", "recompute" and "stash_xla" in
    training; for both trunk knobs "xla" is the f32 plain trunk and any
    other value the fused one, as in JAX)."""

    use_outside_nerf: bool = False
    n_samples: int = 64
    n_importance_samples: int = 64
    n_outside_samples: int = 32
    normal_type: str = "normalized_analytic"
    up_sample_steps: int = 4
    depth_type: str = "alpha_blending"
    shadow_hint: bool = True
    force_shadow_map: bool = False
    specular_hint: bool = True
    force_specular_cue: bool = False
    shadow_ray_offset: float = 1e-2
    specular_roughness: Tuple[float, ...] = (0.02, 0.05, 0.13, 0.34)
    shadow_hint_gradient: bool = False
    specular_hint_gradient: bool = False
    n_shadow_importance_clip: int = -1
    n_shadow_samples: int = 64
    n_shadow_importance_samples: int = 64
    override_near_far_to_sphere: bool = True
    fused_kernels: str = "auto"
    fused_interpret: bool = False
    march_dtype: str = "bfloat16"
    importance_block_rays: int = 128
    shadow_block_rays: int = 16
    shadow_split: bool = True
    shadow_refine_block_rays: int = 128
    importance_split: bool = False
    march_sweep_impl: str = "xla"
    shadow_final_impl: str = "pallas"
    march_rounds_impl: str = "xla"
    march_merge: str = "bitonic"
    reflectance_impl: str = "pallas"
    eval_reflectance_impl: str = "xla"
    core_backward: str = "stash"
    core_block_pts_bwd: int = 128


@dataclass(frozen=True)
class ModelConfig:
    sdf_network: SDFNetConfig = field(default_factory=SDFNetConfig)
    outside_nerf: BgNeRFConfig = field(default_factory=BgNeRFConfig)
    deviation_network: VarianceConfig = field(default_factory=VarianceConfig)
    reflectance_network: ReflectanceNetConfig = field(default_factory=ReflectanceNetConfig)
    renderer: RendererConfig = field(default_factory=RendererConfig)

    igr_weight: float = 0.1
    lr: float = 5e-4
    lr_alpha: float = 0.05
    warm_up_end: int = 5_000
    end_iter: int = 1_000_000
    anneal_end: int = 50_000
    geometry_warmup_end: int = 0

    batch_size: int = 512
    shadow_mini_chunk_size: int = 2048
    training_chunk_size: int = 512
    inference_chunk_size: int = 512

    @property
    def has_shadow_hint(self) -> bool:
        return self.renderer.shadow_hint or self.renderer.force_shadow_map

    @property
    def has_specular_hint(self) -> bool:
        return self.renderer.specular_hint or self.renderer.force_specular_cue


def init_model_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> dict:
    """All field parameters (SAL-initialized SDF, variance, reflectance), on
    the card unless ``device="cpu"``; without CUDA the default raises."""
    if cfg.renderer.use_outside_nerf:
        raise NotImplementedError("use_outside_nerf: the background NeRF is a later slice")
    device = resolve_device(device)
    return {
        "sdf": sdf_init(generator, cfg.sdf_network, device),
        "variance": variance_init(cfg.deviation_network, device),
        "color": reflectance_init(
            generator,
            cfg.reflectance_network,
            d_feature=cfg.sdf_network.d_out_feat,
            d_out=3,
            shadow_hint=cfg.renderer.shadow_hint,
            specular_hint=cfg.renderer.specular_hint,
            specular_hint_len=len(cfg.renderer.specular_roughness),
            device=device,
        ),
    }


def _neus_alpha(sdf, grads, dirs, dists, inv_s, cos_anneal_ratio):
    """Alpha from section SDF by the sigmoid-CDF ratio with cos annealing."""
    return _neus_alpha_from_cos(sdf, torch.sum(dirs * grads, dim=-1), dists, inv_s, cos_anneal_ratio)


def _neus_alpha_from_cos(sdf, true_cos, dists, inv_s, cos_anneal_ratio):
    iter_cos = -(
        torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
        + torch.relu(-true_cos) * cos_anneal_ratio
    )
    prev_cdf = torch.sigmoid((sdf - iter_cos * dists * 0.5) * inv_s)
    next_cdf = torch.sigmoid((sdf + iter_cos * dists * 0.5) * inv_s)
    return torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)


def check_ported(cfg: ModelConfig, *, is_training: bool = False, geometry_warmup: bool = False) -> None:
    """Raise ``NotImplementedError`` for any setting that would reach a
    branch the port does not have yet."""
    r = cfg.renderer
    later = {
        "use_outside_nerf": r.use_outside_nerf,
        f"depth_type={r.depth_type!r}": r.depth_type != "alpha_blending",
        "n_shadow_importance_clip != -1 (partial shadow hint)": r.n_shadow_importance_clip != -1,
        "shadow_hint_gradient": r.shadow_hint_gradient,
        "fused_kernels='off' (the unfused march and core)": r.fused_kernels == "off",
        "importance march geometry other than 64 + 4 x 16": r.n_importance_samples > 0
        and (r.n_samples, r.n_importance_samples, r.up_sample_steps) != (64, 64, 4),
        "shadow march geometry other than 64 + 4 x 16": (cfg.has_shadow_hint)
        and (r.n_shadow_samples, r.n_shadow_importance_samples, r.up_sample_steps) != (64, 64, 4),
        f"core_backward={r.core_backward!r} in training": is_training
        and r.core_backward not in ("stash", "recompute", "stash_xla"),
    }
    missing = [name for name, hit in later.items() if hit]
    if missing:
        raise NotImplementedError(
            "nrhints_torch has not ported: " + ", ".join(missing)
            + " (the other kernels and off-path features are later slices)"
        )
    if r.fused_kernels not in ("auto", "on"):
        raise ValueError(f"fused_kernels must be 'auto', 'on' or 'off', got {r.fused_kernels!r}")
    for knob in ("march_sweep_impl", "march_rounds_impl", "shadow_final_impl"):
        if getattr(r, knob) not in ("pallas", "xla"):
            raise ValueError(f"{knob} must be 'pallas' or 'xla', got {getattr(r, knob)!r}")
    if r.march_merge not in ("bitonic", "rank"):
        raise ValueError(f"march_merge must be 'bitonic' or 'rank', got {r.march_merge!r}")


def _importance_sample_z(params, cfg: ModelConfig, rays_o, rays_d, z_vals):
    """64 stratified -> 128 refined z per ray; no gradient, as the JAX march
    cuts it with ``stop_gradient`` at every input.  The march is split
    where JAX splits it (renderer.py:372-376)."""
    r = cfg.renderer
    with torch.no_grad():
        return fused_importance_z(
            params["sdf"], cfg.sdf_network, rays_o, rays_d, z_vals, mlp_dtype=r.march_dtype, merge=r.march_merge,
            split=r.importance_split or r.march_sweep_impl == "xla" or r.march_rounds_impl == "xla",
            sweep_impl=r.march_sweep_impl, rounds_impl=r.march_rounds_impl,
        )


@torch.no_grad()
def _shadow_transmittance(params, cfg: ModelConfig, pls, target_points, cos_anneal_ratio, jitter: dict | None):
    """Final transmittance of a march from the light to just before the
    target point -> [N, 1], with no gradient; sample_dist = |light - target|
    / n per ray.  ``jitter`` (training) moves every shadow sample inside its
    bin: {"u": [N, n] uniforms or None, "generator": ...}."""
    rcfg = cfg.renderer
    n = rcfg.n_shadow_samples
    d = target_points - pls
    light_norm = torch.linalg.norm(d, dim=-1, keepdim=True)
    sample_dist = light_norm / n
    ray_d = d / light_norm
    z_vals = linspace01(n, d.dtype, d.device)[None, :] * light_norm * (1.0 - rcfg.shadow_ray_offset)
    if jitter is not None:
        z_vals = perturb_z_vals_within_bins(z_vals, u=jitter["u"], generator=jitter["generator"])
    # The monolith (shadow_split=False) has no sweep / final / rounds halves:
    # the impl knobs apply to the split march only (JAX renderer.py:512-532).
    s = rcfg.shadow_split
    if not isinstance(cos_anneal_ratio, torch.Tensor):  # a fill, not a host copy: graph-safe
        cos_anneal_ratio = torch.full((), cos_anneal_ratio, dtype=torch.float32, device=d.device)
    return fused_shadow_tau(
        params["sdf"], cfg.sdf_network, pls.contiguous(), ray_d, z_vals, sample_dist,
        inv_s_from_params(params["variance"]), cos_anneal_ratio,
        mlp_dtype=rcfg.march_dtype, split=s, merge=rcfg.march_merge,
        sweep_impl=rcfg.march_sweep_impl if s else "pallas",
        final_impl=rcfg.shadow_final_impl if s else "pallas",
        rounds_impl=rcfg.march_rounds_impl if s else "pallas",
    )


def train_uniforms(cfg: ModelConfig, n_rays: int, generator: torch.Generator | None, device, *,
                   geometry_warmup: bool = False) -> dict:
    """The uniforms of a training render's jitter, drawn from ``generator``
    on ``device`` in the order ``render_rays`` uses them: {"strat": [B, 1]}
    and, where the shadow hint is marched (not in geometry warm-up),
    {"shadow": [B, n_shadow_samples]}.  A CUDA graph of train steps draws
    them outside the graph with this function, so a replay sees the draws
    the eager step makes."""
    out = {"strat": torch.rand((n_rays, 1), generator=generator, device=device)}
    if cfg.has_shadow_hint and not geometry_warmup:
        out["shadow"] = torch.rand((n_rays, cfg.renderer.n_shadow_samples), generator=generator, device=device)
    return out


def render_rays(
    params: dict,
    cfg: ModelConfig,
    rays: RayBundle,
    generator: torch.Generator | None = None,
    *,
    is_training: bool = False,
    geometry_warmup: bool = False,
    cos_anneal_ratio: float | torch.Tensor = 1.0,
    background_rgb: torch.Tensor | None = None,
    uniforms: dict | None = None,
) -> RenderOutput:
    """Render a flat batch of rays -> RenderOutput.

    ``is_training`` jitters the stratified samples (one offset per ray) and
    the shadow samples (one per sample); the uniforms come from
    ``uniforms`` ({"strat": [B, 1], "shadow": [B, n_shadow_samples]}) when
    given, else from ``generator`` (``train_uniforms``).  The outputs carry gradients wherever
    the JAX package's do: the marches, the depth and the hints are cut.
    ``geometry_warmup`` zeroes both hints.  There is no mesh argument, as
    JAX's has: under data parallelism a rank renders its own rays."""
    check_ported(cfg, is_training=is_training, geometry_warmup=geometry_warmup)
    if is_training and generator is None and uniforms is None:
        raise ValueError("render_rays(is_training=True) needs a generator or uniforms for its jitter")
    rcfg = cfg.renderer
    rays_o, rays_d, rays_pl = rays.origins, rays.directions, rays.pl_positions
    batch = rays_o.shape[0]
    if is_training and uniforms is None:
        uniforms = train_uniforms(cfg, batch, generator, rays_o.device, geometry_warmup=geometry_warmup)
    uniforms = uniforms or {}
    sample_dist = 2.0 / rcfg.n_samples

    z_vals = stratified_z_vals(
        rays.nears, rays.fars, rcfg.n_samples, jitter=is_training, u=uniforms.get("strat"), generator=generator
    )
    if rcfg.n_importance_samples > 0:
        z_vals = _importance_sample_z(params, cfg, rays_o.detach(), rays_d.detach(), z_vals.detach())
    n_total = z_vals.shape[-1]

    dists = torch.cat([z_vals[..., 1:] - z_vals[..., :-1], torch.full_like(z_vals[:, :1], sample_dist)], dim=-1)
    mid_z = z_vals + dists * 0.5
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., :, None]  # [B, S, 3]
    pts_flat = pts.reshape(-1, 3)
    dirs_flat = rays_d[:, None, :].expand(pts.shape).reshape(-1, 3)
    pls_flat = rays_pl[:, None, :].expand(pts.shape).reshape(-1, 3)

    sdf, feat, grads = fused_sdf_value_feat_grad(
        params["sdf"], cfg.sdf_network, pts_flat, backward=rcfg.core_backward
    )
    inv_s = inv_s_from_params(params["variance"])
    alpha = _neus_alpha(sdf, grads, dirs_flat, dists.reshape(-1), inv_s, cos_anneal_ratio).reshape(batch, n_total)
    inside_sphere = (torch.linalg.norm(pts_flat.detach(), dim=-1).reshape(batch, n_total) < 1.0).to(alpha.dtype)

    weights = alpha * transmittance(alpha)
    weights_sum = torch.sum(weights, dim=-1, keepdim=True)
    depths = torch.sum(mid_z * weights, dim=-1, keepdim=True).detach()
    hit_points = rays_o + rays_d * depths

    visibilities = shadow_map = None
    if cfg.has_shadow_hint and geometry_warmup:
        visibilities = torch.zeros((batch * n_total, 1), dtype=alpha.dtype, device=alpha.device)
        shadow_map = visibilities[:batch]
    elif cfg.has_shadow_hint:
        jitter = {"u": uniforms.get("shadow"), "generator": generator} if is_training else None
        shadow_map = _shadow_transmittance(params, cfg, rays_pl, hit_points, cos_anneal_ratio, jitter)
        visibilities = shadow_map[:, None, :].expand(batch, n_total, 1).reshape(-1, 1)

    normalized_normal = normalize(grads)
    specular_cue = None
    if cfg.has_specular_hint and geometry_warmup:
        specular_cue = torch.zeros(
            (batch * n_total, len(rcfg.specular_roughness)), dtype=alpha.dtype, device=alpha.device
        )
    elif cfg.has_specular_hint:
        with torch.set_grad_enabled(torch.is_grad_enabled() and rcfg.specular_hint_gradient):
            hit_normal = normalize(torch.sum(normalized_normal.reshape(batch, n_total, 3) * weights[..., None], dim=1))
            spec = cook_torrance_specular(
                hit_normal, normalize(rays_pl - hit_points), normalize(-rays_d), rcfg.specular_roughness
            )
        specular_cue = spec[:, None, :].expand(batch, n_total, spec.shape[-1]).reshape(batch * n_total, -1)

    input_normal = grads if rcfg.normal_type == "analytic" else normalized_normal
    color_args = (
        params["color"], cfg.reflectance_network, pts_flat, input_normal, dirs_flat, feat, pls_flat,
        visibilities if rcfg.shadow_hint else None,
        specular_cue if rcfg.specular_hint else None,
    )
    # As JAX renderer.py: "xla" is the f32 plain trunk (with autograd when
    # training), anything else the fused trunk under core_backward.
    trunk_impl = rcfg.reflectance_impl if is_training else rcfg.eval_reflectance_impl
    if trunk_impl == "xla":
        sampled_color = reflectance_forward(*color_args)
    else:
        sampled_color = fused_reflectance_forward(*color_args, backward=rcfg.core_backward)
    sampled_color = sampled_color.reshape(batch, n_total, 3)
    color = torch.sum(sampled_color * weights[..., None], dim=1)
    if background_rgb is not None:
        color = color + background_rgb * (1.0 - weights_sum)

    return RenderOutput(
        rgb=color,
        depth=depths,
        weights=weights,
        s_val=(1.0 / inv_s).expand(batch)[:, None],
        inside_sphere=inside_sphere,
        relax_inside_sphere=inside_sphere,
        analytic_normals=grads.reshape(batch, n_total, 3),
        normalized_analytic_normals=normalized_normal.reshape(batch, n_total, 3),
        visibilities=shadow_map,
        specular_cue=None if specular_cue is None else specular_cue.reshape(batch, n_total, -1),
    )


@torch.no_grad()
def extract_sdf_grid(params: dict, cfg: ModelConfig, bound_min, bound_max, resolution: int,
                     block: int = 64) -> torch.Tensor:
    """-sdf on a dense [res, res, res] grid over the box, on the device the
    parameters lie on, swept in blocks of ``block``**3 points through the
    plain f32 ``sdf_only`` (marching cubes then run on the host)."""
    dev = params["sdf"]["out_sdf"]["b"].device
    axes = [torch.linspace(float(lo), float(hi), resolution, device=dev) for lo, hi in zip(bound_min, bound_max)]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)
    chunk = block**3
    vals = torch.cat([-sdf_only(params["sdf"], cfg.sdf_network, grid[i : i + chunk])
                      for i in range(0, grid.shape[0], chunk)])
    return vals.reshape(resolution, resolution, resolution)
