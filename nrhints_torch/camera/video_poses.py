"""Turntable pose and light synthesis for the video views (port of
``nrhints_tpu/camera/video_poses.py``, numpy only): two clips, the view
orbiting under a fixed light and the light orbiting a fixed view, from
spherical poses with an optional z-up remap.
"""
from __future__ import annotations

import numpy as np


def _trans_t(t):
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def _rot_phi(phi):
    c, s = np.cos(phi), np.sin(phi)
    return np.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def _rot_theta(th):
    c, s = np.cos(th), np.sin(th)
    return np.array(
        [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def pose_spherical(theta: float, phi: float, radius: float, is_z_up: bool = False) -> np.ndarray:
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    if is_z_up:
        c2w = (
            np.array(
                [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                dtype=np.float32,
            )
            @ c2w
        )
    return c2w


def gen_fix_light_rot_view(
    num_views: int = 60,
    radius: float = 4.5,
    pl_pos=None,
    pl_intensity=None,
    is_z_up: bool = False,
):
    """Clip 1: orbiting camera at elevation -30deg, fixed point light."""
    if pl_intensity is None:
        pl_intensity = [25.0, 25.0, 25.0]
    if pl_pos is None:
        pl_pos = [0.0, 0.5 * 4.5, 0.866 * 4.5]
    angles = np.linspace(-180, 180, num_views + 1)[:-1]
    poses = np.stack([pose_spherical(a, -30.0, radius, is_z_up) for a in angles], 0)
    pls = np.array([list(pl_pos) + list(pl_intensity)], dtype=np.float32).repeat(
        poses.shape[0], axis=0
    )
    return poses.astype(np.float32), pls


def gen_fix_view_rot_light(
    num_lights: int = 60,
    radius: float = 4.5,
    pl_intensity=None,
    view_theta: float = -180.0,
    view_phi: float = -30.0,
    view_radius: float = 4.5,
    is_z_up: bool = False,
):
    """Clip 2: fixed camera, point light orbiting at elevation -30deg."""
    if pl_intensity is None:
        pl_intensity = [25.0, 25.0, 25.0]
    angles = np.linspace(-180, 180, num_lights + 1)[:-1]
    pls = np.stack(
        [
            np.concatenate(
                (pose_spherical(a, -30.0, radius, is_z_up)[0:3, 3], np.array(pl_intensity)),
                -1,
            )
            for a in angles
        ],
        0,
    )
    poses = pose_spherical(view_theta, view_phi, view_radius, is_z_up)[None].repeat(
        pls.shape[0], axis=0
    )
    return poses.astype(np.float32), pls.astype(np.float32)
