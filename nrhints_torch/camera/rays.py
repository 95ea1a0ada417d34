"""Pixel -> ray generation with the optional learned pose and light deltas
and the synthetic noise buffers (port of ``nrhints_tpu/camera/rays.py``).

+0.5 pixel centres, OpenGL (-y, -z) directions, deltas left-multiplied as
[R|t], near/far from the unit sphere's mid-point +- 1 or the camera's
zn/zf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import torch

from nrhints_torch.camera.model import CameraModel
from nrhints_torch.core.brdf import normalize
from nrhints_torch.core.lie import exp_map_SE3, exp_map_SO3xR3
from nrhints_torch.core.structs import PixelBundle, RayBundle
from nrhints_torch.utils import resolve_device


@dataclass(frozen=True)
class RayGeneratorConfig:
    override_near_far_from_sphere: bool = True
    cam_opt_mode: Literal["off", "SO3xR3", "SE3"] = "off"
    pl_opt: bool = False
    opt_lr: float = 3e-5
    cam_position_noise_std: float = 0.0
    cam_orientation_noise_std: float = 0.0
    pl_position_noise_std: float = 0.0


def ray_generator_init(
    generator: torch.Generator, cfg: RayGeneratorConfig, num_cameras: int, device="cuda"
) -> tuple[dict, dict]:
    """-> (trainable params, fixed noise buffers), on the card unless
    ``device="cpu"`` (without CUDA the default raises)."""
    device = resolve_device(device)
    params: dict = {}
    buffers: dict = {}
    if cfg.cam_opt_mode in ("SO3xR3", "SE3"):
        params["cam_pose_adjustment"] = torch.zeros((num_cameras, 6), device=device)
    elif cfg.cam_opt_mode != "off":
        raise ValueError(f"Unknown cam_opt_mode: {cfg.cam_opt_mode}")
    if cfg.pl_opt:
        params["pl_adjustment"] = torch.zeros((num_cameras, 3), device=device)
    if cfg.cam_position_noise_std != 0.0 or cfg.cam_orientation_noise_std != 0.0:
        std = torch.tensor([cfg.cam_position_noise_std] * 3 + [cfg.cam_orientation_noise_std] * 3)
        tangent = torch.randn((num_cameras, 6), generator=generator) * std[None, :]
        buffers["cam_pose_noise"] = exp_map_SE3(tangent).to(device)
    if cfg.pl_position_noise_std != 0.0:
        noise = torch.randn((num_cameras, 3), generator=generator) * cfg.pl_position_noise_std
        buffers["pl_noise"] = noise.to(device)
    return params, buffers


def generate_rays(
    params: dict,
    buffers: dict,
    camera: CameraModel,
    cfg: RayGeneratorConfig,
    pixels: PixelBundle,
) -> RayBundle:
    """Flat pixel batch -> rays.  Views without ``img_indices`` (video
    views) get no noise and no learned deltas."""
    x = pixels.w_indices.float() + 0.5
    y = pixels.h_indices.float() + 0.5
    img = pixels.img_indices
    dirs = torch.stack(
        [(x - camera.cx) / camera.fx, -(y - camera.cy) / camera.fy, -torch.ones_like(x)], dim=-1
    )
    R = pixels.poses[..., :3, :3]
    t = pixels.poses[..., :3, 3:]
    if "cam_pose_noise" in buffers and img is not None:
        dRt = buffers["cam_pose_noise"][img]
        dR, dt = dRt[..., :3, :3], dRt[..., :3, 3:]
        R, t = dR @ R, dt + dR @ t
    if cfg.cam_opt_mode != "off" and img is not None:
        exp = exp_map_SO3xR3 if cfg.cam_opt_mode == "SO3xR3" else exp_map_SE3
        dRt = exp(params["cam_pose_adjustment"][img])
        dR, dt = dRt[..., :3, :3], dRt[..., :3, 3:]
        R, t = dR @ R, dt + dR @ t

    pls = pixels.pls
    if "pl_noise" in buffers and img is not None:
        pls = pls + buffers["pl_noise"][img]
    if cfg.pl_opt and img is not None:
        pls = pls + params["pl_adjustment"][img]

    rays_d = normalize(torch.sum(dirs[..., None, :] * R, dim=-1))
    rays_o = t[..., 0]
    if cfg.override_near_far_from_sphere:
        a = torch.sum(rays_d**2, dim=-1, keepdim=True)
        b = 2.0 * torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
        mid = 0.5 * (-b) / a
        near, far = mid - 1.0, mid + 1.0
    else:
        near = torch.full_like(rays_o[..., :1], camera.zn)
        far = torch.full_like(rays_o[..., :1], camera.zf)
    return RayBundle(origins=rays_o, directions=rays_d, pl_positions=pls, nears=near, fars=far)
