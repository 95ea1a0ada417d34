"""NeuS-with-hints volume renderer (port of
``nrhints_tpu/render/renderer.py``).

``render_rays`` routes as the JAX package does.  Where the fused kernels
apply (``fused_kernels`` "auto" or "on", the frequency encoding, the
canonical 64 + 4 x 16 geometry) it takes the fused path: 64 stratified
samples (jittered in training) refined by a 4 x 16 importance march (under
the shipping ``RendererConfig`` plain sweeps and kernel B; the round-4
knobs ``importance_split``, ``march_sweep_impl``, ``march_rounds_impl``,
``march_merge`` route it through kernels K, L or M as in JAX), the SDF core
with normals (kernel A without a gradient; with one, the ``core_backward``
schedule: kernels D and E for "stash", their variants that also stash the
reverse sweep for "stash_all", A and H for "recompute", D and E's plain
version for "stash_xla"), and the shadow hint as the transmittance of
a 64 + 4 x 16 march from the light (kernels B and C, or under
``shadow_split=False`` the monolith N).  Everywhere else it takes the
unfused path, the plain PyTorch program of JAX's XLA path: the march as
``sdf_only`` sweeps, ``neus_up_sample`` rounds at inv_s = 64 * 2^i and
``merge_z_vals``; the core as ``sdf_value_feat_grad`` (autograd); the
shadow march's final sweep through ``sdf_value_and_dirderiv`` (one
forward-mode tangent), differentiable end to end under
``shadow_hint_gradient``; and the plain trunk.  The two mix: the core
stays fused whenever the encoding is the frequency one, so a
non-canonical geometry or ``shadow_hint_gradient`` still launches the core
and trunk kernels.

Around them: sigmoid-CDF alpha with cos annealing, transmittance
compositing, the background NeRF past the unit sphere
(``use_outside_nerf``), the depth as the alpha-blended, the maximum-weight
or the sphere-traced hit (``depth_type``), the shadow hint at that hit or,
under ``n_shadow_importance_clip``, at strided samples of every ray (the
partial hint), the Cook-Torrance highlight hint at 4 roughnesses, and the
reflectance trunk: ``reflectance_impl`` in training and
``eval_reflectance_impl`` in eval pick f32 plain matmuls ("xla") or the
fused trunk (kernel I without a gradient; F and G, or I and J under
"recompute", with one).  On CUDA tensors every kernel runs on the card; on
CPU tensors each kernel wrapper runs its plain version.  The march kernels
take ``march_dtype`` "bfloat16" or "float32" (their f32 instances).

Under a ``DataMesh`` with a sample axis (``parallel/mesh.py``) the marches
route as JAX's on its ('data', 'sample') mesh: the fused kernels
flatten-shard a rank's rays over its sample group where they divide it
(each rank marches its 1/k of them, then the rows are all-gathered in
sample order), else the march is sample-sharded (each round's sweep on a
1/k slice of the samples, the [rays, S] values and the final sweep's
alphas all-gathered, the CDF and the merge replicated), else it runs
whole on every rank.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch

from nrhints_torch.core.brdf import cook_torrance_specular, normalize
from nrhints_torch.core.sampling import (
    linspace01,
    merge_z_vals,
    neus_up_sample,
    perturb_z_vals_within_bins,
    stratified_z_vals,
    transmittance,
)
from nrhints_torch.core.structs import RayBundle, RenderOutput
from nrhints_torch.fields.bg_nerf import BgNeRFConfig, bg_nerf_forward, bg_nerf_init
from nrhints_torch.fields.reflectance import ReflectanceNetConfig, reflectance_forward, reflectance_init
from nrhints_torch.fields.sdf import SDFNetConfig, sdf_init, sdf_only, sdf_value_and_dirderiv, sdf_value_feat_grad
from nrhints_torch.fields.variance import VarianceConfig, inv_s_from_params, variance_init
from nrhints_torch.kernels.core_mlp import fused_reflectance_forward, fused_sdf_value_feat_grad
from nrhints_torch.kernels.march import fused_importance_z, fused_shadow_tau
from nrhints_torch.parallel.mesh import DataMesh, sample_all_gather
from nrhints_torch.utils import resolve_device


@dataclass(frozen=True)
class RendererConfig:
    """Same field names and defaults as the JAX ``RendererConfig``.

    ``fused_kernels``: "auto" and "on" both mean the kernels where JAX's
    fused path applies (on CPU tensors, their plain versions); "off" runs
    the unfused path everywhere.  The block-size knobs of the TPU kernels
    are kept so configs carry across; the march knobs (``shadow_split``, ``importance_split``,
    the three ``*_impl`` of the march, ``march_merge``) route as in JAX,
    and a value outside their JAX sets raises ``ValueError``; of the other
    implementation knobs, values the port has no path for raise
    (``core_backward`` takes "stash", "recompute" and "stash_xla" in
    training on the fused core; for both trunk knobs "xla" is the f32
    plain trunk and any other value the fused one, as in JAX)."""

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
    """All field parameters (SAL-initialized SDF, variance, reflectance, and
    under ``use_outside_nerf`` the background NeRF, drawn last so the other
    fields' draws do not move), on the card unless ``device="cpu"``;
    without CUDA the default raises."""
    device = resolve_device(device)
    params = {
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
    if cfg.renderer.use_outside_nerf:
        params["bg"] = bg_nerf_init(generator, cfg.outside_nerf, device)
    return params


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


def use_fused(rcfg: RendererConfig) -> bool:
    """The kernels ("auto" and "on"), or the unfused path everywhere ("off")."""
    return rcfg.fused_kernels in ("auto", "on")


def fused_march_compatible(rcfg: RendererConfig, sdf_cfg: SDFNetConfig) -> bool:
    """The fused importance march takes the canonical 64 + 4 x 16 geometry
    and the frequency encoding (JAX ``_fused_march_compatible``)."""
    return (rcfg.n_samples, rcfg.n_importance_samples, rcfg.up_sample_steps) == (64, 64, 4) \
        and sdf_cfg.encoding == "frequency"


def fused_shadow_compatible(rcfg: RendererConfig, sdf_cfg: SDFNetConfig) -> bool:
    """The fused shadow march: the same, and no gradient through it
    (JAX ``_fused_shadow_compatible``)."""
    return (rcfg.n_shadow_samples, rcfg.n_shadow_importance_samples, rcfg.up_sample_steps) == (64, 64, 4) \
        and not rcfg.shadow_hint_gradient and sdf_cfg.encoding == "frequency"


def use_fused_core(cfg: ModelConfig) -> bool:
    """The fused SDF core and trunk run wherever the kernels are on and the
    encoding is the frequency one (JAX's ``use_fused_core``)."""
    return use_fused(cfg.renderer) and cfg.sdf_network.encoding == "frequency"


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a router or march knob outside its JAX set."""
    r = cfg.renderer
    if r.fused_kernels not in ("auto", "on", "off"):
        raise ValueError(f"fused_kernels must be 'auto', 'on' or 'off', got {r.fused_kernels!r}")
    for knob in ("march_sweep_impl", "march_rounds_impl", "shadow_final_impl"):
        if getattr(r, knob) not in ("pallas", "xla"):
            raise ValueError(f"{knob} must be 'pallas' or 'xla', got {getattr(r, knob)!r}")
    if r.march_merge not in ("bitonic", "rank"):
        raise ValueError(f"march_merge must be 'bitonic' or 'rank', got {r.march_merge!r}")
    if r.march_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"march_dtype must be 'bfloat16' or 'float32', got {r.march_dtype!r}")
    if r.depth_type not in ("alpha_blending", "maximum_point", "sphere_tracing"):
        raise ValueError(f"unknown depth_type {r.depth_type!r}")


def _sample_axis_size(mesh: DataMesh | None) -> int:
    """k of a distributed mesh's sample axis (1 without one)."""
    return 1 if mesh is None or not mesh.distributed else mesh.sample_axis_size


def _flatten_sharded(mesh: DataMesh | None, fn, *rows):
    """``fn(*rows)`` with the rays flatten-sharded over the sample group
    (JAX's ``_ray_shard`` over both mesh axes): this rank runs its 1/k of
    the rows, then the group all-gathers them in sample order.  Every ray's
    march is independent, so the result is the unsharded call's.  Without
    a sample axis, ``fn(*rows)``."""
    k = _sample_axis_size(mesh)
    if k == 1:
        return fn(*rows)
    n = rows[0].shape[0] // k
    part = slice(mesh.sample_index * n, (mesh.sample_index + 1) * n)
    return sample_all_gather(mesh, fn(*(t[part].contiguous() for t in rows)))


def _sample_slice(mesh: DataMesh | None, t: torch.Tensor) -> torch.Tensor:
    """This rank's 1/k of the last axis of ``t`` (``t`` itself without a
    sample axis)."""
    k = _sample_axis_size(mesh)
    if k == 1:
        return t
    sl = t.shape[-1] // k
    return t[..., mesh.sample_index * sl : (mesh.sample_index + 1) * sl]


def _gather_samples(mesh: DataMesh | None, vals: torch.Tensor) -> torch.Tensor:
    """[rays, s] values of this rank's slice of the samples -> [rays, k s],
    the sample group's slices in sample order (JAX's tiled ``all_gather``
    over 'sample' on axis 1); ``vals`` itself without a sample axis."""
    k = _sample_axis_size(mesh)
    if k == 1:
        return vals
    rays, s = vals.shape
    return sample_all_gather(mesh, vals).reshape(k, rays, s).permute(1, 0, 2).reshape(rays, -1)


def _unfused_march(params, cfg: ModelConfig, rays_o, rays_d, z_vals, n_importance: int,
                   mesh: DataMesh | None = None) -> torch.Tensor:
    """The plain march: ``sdf_only`` at the samples, then ``up_sample_steps``
    rounds of ``neus_up_sample`` at inv_s = 64 * 2^i, each merged into the
    buffer (the last round's draws without their sdf) -> [B, n + n_imp].
    With ``mesh``'s sample axis (JAX's ``_importance_z_sample_sharded``),
    every sweep takes this rank's 1/k of the samples and the group
    all-gathers the [B, S] values; the CDF and the merge are replicated."""
    batch = z_vals.shape[0]
    steps = cfg.renderer.up_sample_steps

    def sdf_at(z):
        zc = _sample_slice(mesh, z)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * zc[..., :, None]
        vals = sdf_only(params["sdf"], cfg.sdf_network, pts.reshape(-1, 3)).reshape(batch, zc.shape[-1])
        return _gather_samples(mesh, vals)

    sdf = sdf_at(z_vals)
    for i in range(steps):
        new_z = neus_up_sample(rays_o, rays_d, z_vals, sdf, n_importance // steps, 64.0 * 2**i)
        if i + 1 == steps:
            z_vals, _ = merge_z_vals(z_vals, new_z)
        else:
            z_vals, sdf = merge_z_vals(z_vals, new_z, sdf, sdf_at(new_z))
    return z_vals


def _importance_sample_z(params, cfg: ModelConfig, rays_o, rays_d, z_vals, mesh: DataMesh | None = None):
    """n stratified -> n + n_importance refined z per ray, with no gradient
    (JAX cuts the march with ``stop_gradient``).  Routed as JAX's
    (renderer.py:346-409): the fused march where JAX takes it, split where
    JAX splits it, flatten-sharded over a sample group where the rays divide
    it; else, with a sample axis that divides the samples, the
    sample-sharded plain march; else the plain march."""
    r = cfg.renderer
    k = _sample_axis_size(mesh)
    steps = r.up_sample_steps
    sample_ok = k > 1 and z_vals.shape[-1] % k == 0 and (steps == 0 or (r.n_importance_samples // steps) % k == 0)
    fused_ok = use_fused(r) and fused_march_compatible(r, cfg.sdf_network)
    march_full = k > 1 and z_vals.shape[0] % k == 0
    with torch.no_grad():
        if fused_ok and (march_full or not sample_ok):
            def march(o, d, z):
                return fused_importance_z(
                    params["sdf"], cfg.sdf_network, o, d, z, mlp_dtype=r.march_dtype, merge=r.march_merge,
                    split=r.importance_split or r.march_sweep_impl == "xla" or r.march_rounds_impl == "xla",
                    sweep_impl=r.march_sweep_impl, rounds_impl=r.march_rounds_impl,
                )

            return _flatten_sharded(mesh if march_full else None, march, rays_o, rays_d, z_vals)
        return _unfused_march(params, cfg, rays_o, rays_d, z_vals, r.n_importance_samples,
                              mesh if sample_ok else None)


def _shadow_transmittance(params, cfg: ModelConfig, pls, target_points, cos_anneal_ratio, jitter: dict | None,
                          mesh: DataMesh | None = None):
    """Final transmittance of a march from the light to just before the
    target point -> [N, 1]; sample_dist = |light - target| / n per ray.
    ``jitter`` (training) moves every shadow sample inside its bin: {"u": [N,
    n] uniforms or None, "generator": ...}.  The fused march has no
    gradient; the unfused one carries the gradient of every input and
    parameter under ``shadow_hint_gradient`` (JAX puts no ``stop_gradient``
    inside it) and none otherwise.  Routed over ``mesh``'s sample axis as
    JAX's (renderer.py:489-590): the fused march flatten-sharded where the
    rays divide the sample group, else the sample-sharded plain march where
    the sample counts divide it (never under ``shadow_hint_gradient``)."""
    rcfg = cfg.renderer
    n, n_imp, steps = rcfg.n_shadow_samples, rcfg.n_shadow_importance_samples, rcfg.up_sample_steps
    k = _sample_axis_size(mesh)
    sample_ok = (k > 1 and not rcfg.shadow_hint_gradient and n % k == 0
                 and (n_imp == 0 or steps == 0 or (n_imp // steps) % k == 0) and (n + n_imp) % k == 0)
    march_full = k > 1 and pls.shape[0] % k == 0
    fused = use_fused(rcfg) and fused_shadow_compatible(rcfg, cfg.sdf_network) and (march_full or not sample_ok)
    with torch.set_grad_enabled(torch.is_grad_enabled() and rcfg.shadow_hint_gradient and not fused):
        d = target_points - pls
        light_norm = torch.linalg.norm(d, dim=-1, keepdim=True)
        sample_dist = light_norm / n
        ray_d = d / light_norm
        z_vals = linspace01(n, d.dtype, d.device)[None, :] * light_norm * (1.0 - rcfg.shadow_ray_offset)
        if jitter is not None:
            z_vals = perturb_z_vals_within_bins(z_vals, u=jitter["u"], generator=jitter["generator"])
        if fused:
            # The monolith (shadow_split=False) has no sweep / final / rounds halves:
            # the impl knobs apply to the split march only (JAX renderer.py:512-532).
            s = rcfg.shadow_split
            if not isinstance(cos_anneal_ratio, torch.Tensor):  # a fill, not a host copy: graph-safe
                cos_anneal_ratio = torch.full((), cos_anneal_ratio, dtype=torch.float32, device=d.device)
            inv_s = inv_s_from_params(params["variance"])

            def march(o, rd, z, sdist):
                return fused_shadow_tau(
                    params["sdf"], cfg.sdf_network, o, rd, z, sdist, inv_s, cos_anneal_ratio,
                    mlp_dtype=rcfg.march_dtype, split=s, merge=rcfg.march_merge,
                    sweep_impl=rcfg.march_sweep_impl if s else "pallas",
                    final_impl=rcfg.shadow_final_impl if s else "pallas",
                    rounds_impl=rcfg.march_rounds_impl if s else "pallas",
                )

            return _flatten_sharded(mesh if march_full else None, march, pls.contiguous(), ray_d, z_vals, sample_dist)
        # The plain march; with a sample axis (JAX's
        # ``_shadow_transmittance_sample_sharded``, no gradient) every sweep
        # takes this rank's 1/k of the samples, the final one its 1/k of the
        # sections, whose alphas the group all-gathers in sample order.
        shard = mesh if sample_ok else None
        if rcfg.n_shadow_importance_samples > 0:
            z_vals = _unfused_march(params, cfg, pls, ray_d, z_vals, rcfg.n_shadow_importance_samples, shard)
        batch = z_vals.shape[0]
        dists = torch.cat([z_vals[..., 1:] - z_vals[..., :-1], sample_dist], dim=-1)
        mid_z, dists = _sample_slice(shard, z_vals + dists * 0.5), _sample_slice(shard, dists)
        n_swept = mid_z.shape[-1]
        pts = (pls[:, None, :] + ray_d[:, None, :] * mid_z[..., :, None]).reshape(-1, 3)
        dirs = ray_d[:, None, :].expand(batch, n_swept, 3).reshape(-1, 3)
        sdf, dcos = sdf_value_and_dirderiv(params["sdf"], cfg.sdf_network, pts, dirs)
        alpha = _neus_alpha_from_cos(
            sdf, dcos, dists.reshape(-1), inv_s_from_params(params["variance"]), cos_anneal_ratio
        ).reshape(batch, n_swept)
        return transmittance(_gather_samples(shard, alpha))[..., -1:]


def _partial_shadow_hint(params, cfg: ModelConfig, rays_o, rays_d, rays_pl, z_vals, weights, cos_anneal_ratio,
                         jitter: dict | None, mesh: DataMesh | None = None):
    """The partial hint (``n_shadow_importance_clip`` > 0): shadow rays to
    ``n_clip`` evenly strided samples of every camera ray, marched in chunks
    of ``shadow_mini_chunk_size`` rows (the last padded with rows at
    (1, 1, 1) lit from the origin, as JAX pads) -> (per-sample visibilities
    [B * n_total, 1], the shadow map [B, 1] at each ray's largest NeuS
    weight).  ``jitter["u"]``: [B, n_clip, n_shadow_samples] uniforms, one
    row of a shadow ray."""
    rcfg = cfg.renderer
    batch, n_total = z_vals.shape
    n_clip = rcfg.n_shadow_importance_clip
    if n_total % n_clip:
        raise ValueError(f"n_shadow_importance_clip ({n_clip}) must divide the total sample count ({n_total})")
    ratio = n_total // n_clip
    hint_z = z_vals[:, ::ratio][:, :n_clip]
    hint_pts = (rays_o[:, None, :] + rays_d[:, None, :] * hint_z[..., :, None]).reshape(-1, 3)
    hint_pls = rays_pl[:, None, :].expand(batch, n_clip, 3).reshape(-1, 3)
    total = batch * n_clip
    chunk = min(cfg.shadow_mini_chunk_size, total)
    n_chunks = -(-total // chunk)
    pad = n_chunks * chunk - total
    u = None if jitter is None else jitter["u"]
    if u is not None:
        u = u.reshape(total, -1)
    if pad:
        hint_pts = torch.cat([hint_pts, torch.ones((pad, 3), dtype=hint_pts.dtype, device=hint_pts.device)])
        hint_pls = torch.cat([hint_pls, torch.zeros((pad, 3), dtype=hint_pls.dtype, device=hint_pls.device)])
        if u is not None:
            u = torch.cat([u, torch.zeros((pad, u.shape[-1]), dtype=u.dtype, device=u.device)])
    vis = []
    for c in range(n_chunks):
        rows = slice(c * chunk, (c + 1) * chunk)
        jit = None if jitter is None else {"u": None if u is None else u[rows], "generator": jitter["generator"]}
        vis.append(_shadow_transmittance(params, cfg, hint_pls[rows], hint_pts[rows], cos_anneal_ratio, jit, mesh))
    vis = torch.cat(vis)[:total].reshape(batch, n_clip, 1)
    if not rcfg.shadow_hint_gradient:
        vis = vis.detach()
    vis_full = torch.repeat_interleave(vis, ratio, dim=1)  # [B, n_total, 1]
    # Argmax over the NeuS samples only: the background NeRF extends
    # ``weights`` past n_total.
    max_idx = torch.argmax(weights[:, :n_total], dim=1, keepdim=True)
    shadow_map = torch.gather(vis_full[..., 0], 1, max_idx)
    return vis_full.reshape(-1, 1), shadow_map


SPHERE_TRACE_CHECK_EVERY = 16


def graph_capturable(cfg: ModelConfig) -> bool:
    """Whether a render of ``cfg`` can be captured in a CUDA graph: every
    path but ``depth_type="sphere_tracing"``, whose loop ends on a test of
    the data (``sphere_trace_depth``)."""
    return cfg.renderer.depth_type != "sphere_tracing"


@torch.no_grad()
def sphere_trace_depth(params, cfg: ModelConfig, rays_o, rays_d, n_iters: int = 2000, eps: float = 1e-4,
                       far: float = 100.0, check_every: int = SPHERE_TRACE_CHECK_EVERY):
    """Sphere-traced depth [B, 1] with the reference's constants (2000
    iterations, |sdf| < 1e-4 converged, escaped past depth 100), and the
    iterations run.  A converged ray is frozen, so steps past the
    all-converged point change nothing: the loop tests convergence (a host
    sync) only every ``check_every`` iterations and returns the depths of
    JAX's ``while_loop``, which stops at the first all-converged
    iteration.  The loop's length depends on the data, so it runs eagerly,
    outside any CUDA graph."""
    pts = rays_o.detach().clone()
    d = rays_d.detach()
    depths = torch.zeros_like(rays_o[:, :1])
    done = torch.zeros_like(depths, dtype=torch.bool)
    i = 0
    while i < n_iters:
        for _ in range(min(check_every, n_iters - i)):
            sdf = sdf_only(params["sdf"], cfg.sdf_network, pts)[:, None]
            done = (torch.abs(sdf) < eps) | (depths > far)
            pts = torch.where(done, pts, pts + sdf * d)
            depths = torch.where(done, depths, depths + sdf)
            i += 1
        if bool(torch.all(done)):
            break
    return depths, i


def _render_outside(params, cfg: ModelConfig, rays_o, rays_d, rays_pl, z_vals, sample_dist: float):
    """Background (alpha [B, n], colour [B, n, 3]) along ``z_vals`` of the
    NeRF++ inverted sphere (JAX ``_render_outside``)."""
    batch, n = z_vals.shape
    dists = torch.cat([z_vals[..., 1:] - z_vals[..., :-1], torch.full_like(z_vals[:, :1], sample_dist)], dim=-1)
    mid_z = z_vals + dists * 0.5
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., :, None]
    dis = torch.clamp(torch.linalg.norm(pts, dim=-1, keepdim=True), 1.0, 1e10)
    pts4 = torch.cat([pts / dis, 1.0 / dis], dim=-1).reshape(-1, 4)
    dirs = rays_d[:, None, :].expand(batch, n, 3).reshape(-1, 3)
    pls = rays_pl[:, None, :].expand(batch, n, 3).reshape(-1, 3)
    density, raw_rgb = bg_nerf_forward(params["bg"], cfg.outside_nerf, pts4, dirs, pls)
    color = torch.sigmoid(raw_rgb).reshape(batch, n, 3)
    alpha = 1.0 - torch.exp(-torch.nn.functional.softplus(density.reshape(batch, n)) * dists)
    return alpha, color


def train_uniforms(cfg: ModelConfig, n_rays: int, generator: torch.Generator | None, device, *,
                   geometry_warmup: bool = False) -> dict:
    """The uniforms of a training render's jitter, drawn from ``generator``
    on ``device`` in the order ``render_rays`` uses them: {"strat": [B, 1]};
    under ``use_outside_nerf`` {"out": [B, n_outside_samples]}; and where
    the shadow hint is marched (not in geometry warm-up) {"shadow": [B,
    n_shadow_samples]}, or for the partial hint [B, n_clip,
    n_shadow_samples], one row a shadow ray, so every entry's first axis is
    the ray.  A CUDA graph of train steps draws them outside the graph with
    this function, so a replay sees the draws the eager step makes."""
    r = cfg.renderer
    out = {"strat": torch.rand((n_rays, 1), generator=generator, device=device)}
    if r.use_outside_nerf:
        out["out"] = torch.rand((n_rays, r.n_outside_samples), generator=generator, device=device)
    if cfg.has_shadow_hint and not geometry_warmup:
        rows = (n_rays,) if r.n_shadow_importance_clip == -1 else (n_rays, r.n_shadow_importance_clip)
        out["shadow"] = torch.rand(rows + (r.n_shadow_samples,), generator=generator, device=device)
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
    mesh: DataMesh | None = None,
) -> RenderOutput:
    """Render a flat batch of rays -> RenderOutput.

    ``is_training`` jitters the stratified samples (one offset per ray),
    the background samples and the shadow samples (one per sample); the
    uniforms come from ``uniforms`` (``train_uniforms``' layout) when
    given, else from ``generator``.  The outputs carry gradients wherever
    the JAX package's do: the marches and the depth are cut, and the hints
    too unless ``shadow_hint_gradient`` / ``specular_hint_gradient`` say
    otherwise.  ``geometry_warmup`` zeroes both hints.  Under
    ``use_outside_nerf`` ``weights`` runs past the NeuS samples over the
    background's; the depth and the hints read the NeuS weights only.
    ``mesh``: the ``DataMesh`` or None, as JAX's mesh argument.  A rank
    renders its own rays; with a sample axis the ranks of a sample group
    hold the same rays, and the importance and shadow marches split their
    work over the group (see the module docstring); everything else runs
    whole on every rank of the group."""
    check_ported(cfg)
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
        z_vals = _importance_sample_z(params, cfg, rays_o.detach(), rays_d.detach(), z_vals.detach(), mesh)

    bg_alpha = bg_color = None
    if rcfg.use_outside_nerf:
        n_out = rcfg.n_outside_samples
        z_out = torch.linspace(1e-3, 1.0 - 1.0 / (n_out + 1.0), n_out, dtype=z_vals.dtype, device=z_vals.device)
        z_out = z_out.expand(batch, n_out)
        if is_training:
            z_out = perturb_z_vals_within_bins(z_out, u=uniforms.get("out"), generator=generator)
        z_out = rays.fars / torch.flip(z_out, dims=[-1]) + 1.0 / rcfg.n_samples
        z_feed, _ = merge_z_vals(z_vals, z_out)
        bg_alpha, bg_color = _render_outside(params, cfg, rays_o, rays_d, rays_pl, z_feed, sample_dist)
    n_total = z_vals.shape[-1]

    dists = torch.cat([z_vals[..., 1:] - z_vals[..., :-1], torch.full_like(z_vals[:, :1], sample_dist)], dim=-1)
    mid_z = z_vals + dists * 0.5
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., :, None]  # [B, S, 3]
    pts_flat = pts.reshape(-1, 3)
    dirs_flat = rays_d[:, None, :].expand(pts.shape).reshape(-1, 3)
    pls_flat = rays_pl[:, None, :].expand(pts.shape).reshape(-1, 3)

    fused_core = use_fused_core(cfg)
    if fused_core:
        sdf, feat, grads = fused_sdf_value_feat_grad(
            params["sdf"], cfg.sdf_network, pts_flat, backward=rcfg.core_backward
        )
    else:
        sdf, feat, grads = sdf_value_feat_grad(params["sdf"], cfg.sdf_network, pts_flat)
    inv_s = inv_s_from_params(params["variance"])
    alpha = _neus_alpha(sdf, grads, dirs_flat, dists.reshape(-1), inv_s, cos_anneal_ratio).reshape(batch, n_total)
    inside_sphere = (torch.linalg.norm(pts_flat.detach(), dim=-1).reshape(batch, n_total) < 1.0).to(alpha.dtype)

    if bg_alpha is not None:
        alpha = torch.cat(
            [alpha * inside_sphere + bg_alpha[:, :n_total] * (1.0 - inside_sphere), bg_alpha[:, n_total:]], dim=-1
        )
    weights = alpha * transmittance(alpha)
    weights_sum = torch.sum(weights, dim=-1, keepdim=True)
    neus_weights = weights[:, :n_total]

    if rcfg.depth_type == "alpha_blending":
        depths = torch.sum(mid_z * neus_weights, dim=-1, keepdim=True).detach()
    elif rcfg.depth_type == "maximum_point":
        depths = torch.gather(mid_z, -1, torch.argmax(neus_weights, dim=-1, keepdim=True)).detach()
    else:
        depths, _ = sphere_trace_depth(params, cfg, rays_o, rays_d)
    hit_points = rays_o + rays_d * depths

    visibilities = shadow_map = None
    if cfg.has_shadow_hint and geometry_warmup:
        visibilities = torch.zeros((batch * n_total, 1), dtype=alpha.dtype, device=alpha.device)
        shadow_map = visibilities[:batch]
    elif cfg.has_shadow_hint:
        jitter = {"u": uniforms.get("shadow"), "generator": generator} if is_training else None
        if rcfg.n_shadow_importance_clip == -1:
            shadow_map = _shadow_transmittance(params, cfg, rays_pl, hit_points, cos_anneal_ratio, jitter, mesh)
            if not rcfg.shadow_hint_gradient:
                shadow_map = shadow_map.detach()
            visibilities = shadow_map[:, None, :].expand(batch, n_total, 1).reshape(-1, 1)
        else:
            visibilities, shadow_map = _partial_shadow_hint(
                params, cfg, rays_o, rays_d, rays_pl, z_vals, weights, cos_anneal_ratio, jitter, mesh
            )

    normalized_normal = normalize(grads)
    specular_cue = None
    if cfg.has_specular_hint and geometry_warmup:
        specular_cue = torch.zeros(
            (batch * n_total, len(rcfg.specular_roughness)), dtype=alpha.dtype, device=alpha.device
        )
    elif cfg.has_specular_hint:
        with torch.set_grad_enabled(torch.is_grad_enabled() and rcfg.specular_hint_gradient):
            hit_normal = normalize(
                torch.sum(normalized_normal.reshape(batch, n_total, 3) * neus_weights[..., None], dim=1)
            )
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
    # As JAX renderer.py: the unfused path and the "xla" trunk knob run the
    # plain trunk (with autograd when training), anything else the fused
    # trunk under core_backward.
    trunk_impl = rcfg.reflectance_impl if is_training else rcfg.eval_reflectance_impl
    if not fused_core or trunk_impl == "xla":
        sampled_color = reflectance_forward(*color_args)
    else:
        sampled_color = fused_reflectance_forward(*color_args, backward=rcfg.core_backward)
    sampled_color = sampled_color.reshape(batch, n_total, 3)
    if bg_color is not None:
        inside = inside_sphere[..., None]
        sampled_color = torch.cat(
            [sampled_color * inside + bg_color[:, :n_total] * (1.0 - inside), bg_color[:, n_total:]], dim=1
        )
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
