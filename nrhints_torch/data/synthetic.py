"""The procedural NRHints-style scene (port of the image renderer of
``nrhints_tpu/data/synthetic.py``, numpy only): a glossy sphere over a
matte disc lit by a point light, ray-traced analytically.  The sphere casts
a hard shadow on the disc and has a GGX highlight, so a model trained on it
needs both hints.  Everything fits in the unit sphere: sphere radius 0.35
at y = -0.05, disc radius 0.85 at y = -0.4.  ``make_hints_scene`` writes
the scene to disk in the original code's Blender-json format
(``transforms_*.json`` with a ``pl_pos`` per frame, RGBA PNGs);
``scene_views`` keeps a train split in memory.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np

SPHERE_C = np.array([0.0, -0.05, 0.0], dtype=np.float64)
SPHERE_R = 0.35
PLANE_Y = -0.4
DISC_R = 0.85

SPHERE_ALBEDO = np.array([0.75, 0.30, 0.20])
DISC_ALBEDO = np.array([0.45, 0.50, 0.60])
SPHERE_ROUGH = 0.25  # glossy but with a multi-pixel lobe at 128px (subpixel
# highlights alias across views and are unlearnable at these resolutions)
DISC_ROUGH = 0.6
LIGHT_POWER = 14.0  # radiant intensity; shading uses inverse-square falloff


def look_at_pose(eye: np.ndarray, target: np.ndarray | None = None) -> np.ndarray:
    """OpenGL-convention camera-to-world (-z forward) looking at ``target``."""
    target = np.zeros(3) if target is None else target
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(forward, up)) > 0.95:
        up = np.array([0.0, 0.0, 1.0])
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    c2w = np.eye(4, dtype=np.float64)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -forward
    c2w[:3, 3] = eye
    return c2w


def _sphere_hit(o, d):
    """Nearest positive sphere intersection -> (t, hit_mask)."""
    oc = o - SPHERE_C
    b = 2.0 * np.sum(oc * d, axis=-1)
    c = np.sum(oc * oc, axis=-1) - SPHERE_R ** 2
    disc = b * b - 4.0 * c
    ok = disc > 0.0
    sq = np.sqrt(np.maximum(disc, 0.0))
    t0 = (-b - sq) / 2.0
    t1 = (-b + sq) / 2.0
    t = np.where(t0 > 1e-4, t0, t1)
    return np.where(ok & (t > 1e-4), t, np.inf), ok & (t > 1e-4)


def _disc_hit(o, d):
    dy = d[..., 1]
    t = (PLANE_Y - o[..., 1]) / np.where(np.abs(dy) < 1e-9, 1e-9, dy)
    p = o + d * t[..., None]
    r2 = p[..., 0] ** 2 + p[..., 2] ** 2
    ok = (t > 1e-4) & (r2 <= DISC_R ** 2)
    return np.where(ok, t, np.inf), ok


def _segment_shadowed(p, light):
    """True where the segment p -> light is blocked by the sphere."""
    to_l = light - p
    dist = np.linalg.norm(to_l, axis=-1)
    d = to_l / dist[..., None]
    t, ok = _sphere_hit(p + d * 1e-4, d)
    return ok & (t < dist - 1e-4)


def _ggx_specular(n, v, l, rough):
    """Cook-Torrance GGX with Schlick G (k=(r+1)^2/8) and F0=0.04 — the
    same lobe family the renderer's highlight hint evaluates
    (reference ``models/neus_hint_model.py:588-616``)."""
    h = v + l
    h = h / (np.linalg.norm(h, axis=-1, keepdims=True) + 1e-9)
    nh = np.clip(np.sum(n * h, axis=-1), 0.0, 1.0)
    nv = np.clip(np.sum(n * v, axis=-1), 1e-4, 1.0)
    nl = np.clip(np.sum(n * l, axis=-1), 0.0, 1.0)
    vh = np.clip(np.sum(v * h, axis=-1), 0.0, 1.0)
    a2 = rough ** 4
    D = a2 / (np.pi * ((nh * nh) * (a2 - 1.0) + 1.0) ** 2 + 1e-12)
    k = (rough + 1.0) ** 2 / 8.0
    G = (nv / (nv * (1 - k) + k)) * (nl / (nl * (1 - k) + k))
    F = 0.04 + 0.96 * (1.0 - vh) ** 5
    return D * G * F / (4.0 * nv + 1e-9)


def render_scene_image(
    c2w: np.ndarray, pl: np.ndarray, H: int, W: int, focal: float,
    specular: bool = True,
) -> np.ndarray:
    """Ray-trace the scene -> [H, W, 4] RGBA in [0, 1] (premultiplied rgb)."""
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dirs = np.stack(
        [
            (xs + 0.5 - W / 2.0) / focal,
            -(ys + 0.5 - H / 2.0) / focal,
            -np.ones_like(xs, dtype=np.float64),
        ],
        axis=-1,
    )
    R, t = c2w[:3, :3], c2w[:3, 3]
    d = dirs @ R.T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(t, d.shape)

    t_s, hit_s = _sphere_hit(o, d)
    t_d, hit_d = _disc_hit(o, d)
    take_s = hit_s & (t_s <= t_d)
    take_d = hit_d & (t_d < t_s)
    hit = take_s | take_d
    t_hit = np.where(take_s, t_s, t_d)

    p = o + d * np.where(hit, t_hit, 1.0)[..., None]
    n = np.where(
        take_s[..., None],
        (p - SPHERE_C) / SPHERE_R,
        np.broadcast_to(np.array([0.0, 1.0, 0.0]), p.shape),
    )
    albedo = np.where(take_s[..., None], SPHERE_ALBEDO, DISC_ALBEDO)
    rough = np.where(take_s, SPHERE_ROUGH, DISC_ROUGH)

    to_l = pl - p
    dist2 = np.sum(to_l * to_l, axis=-1)
    l = to_l / np.sqrt(dist2)[..., None]
    v = -d
    nl = np.clip(np.sum(n * l, axis=-1), 0.0, 1.0)
    vis = (~_segment_shadowed(p, pl)).astype(np.float64)
    irradiance = LIGHT_POWER * vis * nl / np.maximum(dist2, 1e-6)

    diffuse = albedo / np.pi
    spec = _ggx_specular(n, v, l, rough)[..., None] if specular else 0.0
    rgb = (diffuse + spec) * irradiance[..., None]
    # simple filmic-ish tone map + gamma so PNGs aren't blown out
    rgb = rgb / (1.0 + rgb)
    rgb = np.clip(rgb, 0.0, 1.0) ** (1.0 / 2.2)

    alpha = hit.astype(np.float64)
    return np.concatenate([rgb * alpha[..., None], alpha[..., None]], axis=-1).astype(
        np.float32
    )


def _draw_view(rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """(camera-to-world, light position) of one view: the camera on the
    upper hemisphere at radius 2.7 looking at the origin, the light at
    radius 3.2 above the disc, drawn apart from the camera."""
    theta = rng.uniform(0.0, 2.0 * np.pi)
    phi = rng.uniform(0.25, 1.25)  # stay above the disc
    eye = 2.7 * np.array([np.cos(theta) * np.sin(phi), np.cos(phi), np.sin(theta) * np.sin(phi)])
    lt = rng.uniform(0.0, 2.0 * np.pi)
    lp = rng.uniform(0.2, 1.1)
    pl = 3.2 * np.array([np.cos(lt) * np.sin(lp), np.cos(lp), np.sin(lt) * np.sin(lp)])
    return look_at_pose(eye), pl


def make_hints_scene(
    basedir,
    n_train: int = 100,
    n_val: int = 5,
    n_test: int = 10,
    H: int = 128,
    W: int = 128,
    seed: int = 0,
    camera_angle_x: float = 0.8,
) -> pathlib.Path:
    """Write the whole procedural dataset to ``basedir`` (the views and
    files of the JAX ``make_hints_scene`` for the same arguments)."""
    from nrhints_torch.data.png import write_png

    basedir = pathlib.Path(basedir)
    basedir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        (basedir / split).mkdir(exist_ok=True)
        frames = []
        for i in range(n):
            c2w, pl = _draw_view(rng)
            rgba = render_scene_image(c2w, pl, H, W, focal)
            rel = f"{split}/r_{i}"
            write_png(basedir / f"{rel}.png", (np.clip(rgba, 0, 1) * 255).astype(np.uint8))
            frames.append({"file_path": rel, "transform_matrix": c2w.tolist(), "pl_pos": pl.tolist()})
        meta = {"camera_angle_x": camera_angle_x, "frames": frames}
        (basedir / f"transforms_{split}.json").write_text(json.dumps(meta))
    return basedir


def scene_views(n_views: int, H: int = 128, W: int = 128, seed: int = 0, camera_angle_x: float = 0.8) -> dict:
    """``n_views`` training views of the scene in memory, with the camera
    and light draws of ``make_hints_scene``'s train split.  -> numpy
    {"images" [n, H, W, 3] composited on white as the data parser does,
    "poses" [n, 4, 4], "pls" [n, 3], "focal"}."""
    rng = np.random.default_rng(seed)
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    images, poses, pls = [], [], []
    for _ in range(n_views):
        c2w, pl = _draw_view(rng)
        rgba = render_scene_image(c2w, pl, H, W, focal)
        images.append(rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:]))
        poses.append(c2w)
        pls.append(pl)
    return {
        "images": np.stack(images).astype(np.float32),
        "poses": np.stack(poses).astype(np.float32),
        "pls": np.stack(pls).astype(np.float32),
        "focal": float(focal),
    }
