"""Whole-image evaluation (port of ``nrhints_tpu/eval/evaluator.py``):
the chunked view render, test-time pose registration and the metrics of a
view.

A view renders as a sweep over fixed-size chunks of rays.  For a plain
full-image view (one pose, one light, the meshgrid of pixels) the pixel
grid is built on the device, its padded tail clamped to the last pixel;
any other bundle is padded on the host by repeating its last ray.  The
per-pixel reductions (weighted normals, shadow map, specular hint) happen on
the device per chunk, and the normal maps are rotated into the camera frame
on the host.

``register_view`` runs the original code's test-time registration: 500
Adam steps on copies of the ray generator's pose and light deltas only,
each on ``batch_size`` pixels of the view drawn afresh, through the eval
render with the L1 loss.  Gradients flow through the rays only: the SDF
core runs its differentiable stash op (kernels D and E on the card), the
renderer's parameters are detached and the training optimizer is not
touched.  Mesh-sharded eval is a later slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from nrhints_torch.camera.model import CameraModel
from nrhints_torch.configs.config import SystemConfig
from nrhints_torch.core.structs import PixelBundle
from nrhints_torch.eval.metrics import lpips, lpips_available, psnr, ssim
from nrhints_torch.train.step import forward_pipeline
from nrhints_torch.utils import resolve_device


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def register_view_key(pixels: PixelBundle, device="cpu") -> torch.Generator:
    """The generator of a view's registration draws, seeded by its image
    index, so each view registers on its own pixel sequence and a rerun
    draws the same pixels."""
    idx = int(_host(pixels.img_indices).reshape(-1)[0])
    return torch.Generator(device=device).manual_seed(idx)


class Evaluator:
    def __init__(self, cfg: SystemConfig, camera: CameraModel, buffers: dict, *, device="cuda", mesh=None):
        """``device``: "cuda" (the default) or "cpu"; with no CUDA device
        the default raises rather than running on the CPU."""
        if mesh is not None:
            raise NotImplementedError("mesh-sharded eval is a later slice (parallel/)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.camera = camera
        self.buffers = self._on_device(buffers)

    def _on_device(self, tree):
        if isinstance(tree, dict):
            return {k: self._on_device(v) for k, v in tree.items()}
        return torch.as_tensor(tree).to(self.device)

    def _render_chunk(self, params, chunk: PixelBundle) -> Dict[str, torch.Tensor]:
        out = forward_pipeline(
            params, self.buffers, self.cfg, self.camera, chunk,
            is_training=False, geometry_warmup=False, cos_anneal_ratio=1.0,
        )
        w_in = out.weights[..., : out.inside_sphere.shape[-1]] * out.inside_sphere
        res = {
            "rgb": out.rgb,
            "depth": out.depth,
            "normal": torch.einsum("bsc,bs->bc", out.analytic_normals, w_in),
            "normalized_normal": torch.einsum("bsc,bs->bc", out.normalized_analytic_normals, w_in),
        }
        if out.visibilities is not None:
            res["shadow_map"] = out.visibilities
        if out.specular_cue is not None:
            res["specular_hint"] = torch.einsum(
                "bsr,bs->br", out.specular_cue, out.weights[..., : out.specular_cue.shape[1]]
            )
        return res

    def _view_chunking(self, n: int):
        """(chunk, n_chunks, total) for an n-ray render, the chunk clamped
        to the image size."""
        chunk = min(self.cfg.model.inference_chunk_size, n)
        n_chunks = -(-n // chunk)
        return chunk, n_chunks, n_chunks * chunk

    def _regular_view(self, pixels: PixelBundle, H: int, W: int):
        """(pose, pl, img_idx) if ``pixels`` is a plain full-image view,
        else None (host-side checks)."""
        p, l = _host(pixels.poses), _host(pixels.pls)
        if not (np.all(p == p[0, 0]) and np.all(l == l[0, 0])):
            return None
        h, w = _host(pixels.h_indices), _host(pixels.w_indices)
        if h.shape != (H, W) or not (
            np.array_equal(h, np.broadcast_to(np.arange(H, dtype=h.dtype)[:, None], (H, W)))
            and np.array_equal(w, np.broadcast_to(np.arange(W, dtype=w.dtype)[None, :], (H, W)))
        ):
            return None
        img_idx = None
        if pixels.img_indices is not None:
            ii = _host(pixels.img_indices)
            if not np.all(ii == ii.flat[0]):
                return None
            img_idx = int(ii.flat[0])
        return p[0, 0], l[0, 0], img_idx

    def _view_chunks(self, pose, pl, img_idx, H: int, W: int):
        """The pixel grid of a full view, built on the device, as chunks."""
        chunk, n_chunks, total = self._view_chunking(H * W)
        idx = torch.clamp(torch.arange(total, device=self.device), max=H * W - 1)
        h, w = (idx // W).float(), (idx % W).float()
        pose = torch.as_tensor(pose, dtype=torch.float32, device=self.device)
        pl = torch.as_tensor(pl, dtype=torch.float32, device=self.device)
        for c in range(n_chunks):
            s = slice(c * chunk, (c + 1) * chunk)
            yield PixelBundle(
                h_indices=h[s], w_indices=w[s],
                poses=pose.expand(chunk, 4, 4), pls=pl.expand(chunk, 3),
                img_indices=None if img_idx is None else torch.full((chunk,), img_idx, device=self.device),
            )

    def _bundle_chunks(self, pixels: PixelBundle, n: int):
        """Any other bundle: flatten, pad by repeating the last ray, chunk."""
        chunk, n_chunks, total = self._view_chunking(n)

        def leaf(x):
            if x is None:
                return None
            x = _host(x).reshape((n,) + _host(x).shape[pixels.h_indices.ndim :])
            x = np.concatenate([x, np.repeat(x[-1:], total - n, axis=0)], axis=0)
            return torch.as_tensor(x).to(self.device)

        flat = PixelBundle(
            h_indices=leaf(pixels.h_indices), w_indices=leaf(pixels.w_indices),
            poses=leaf(pixels.poses), pls=leaf(pixels.pls), img_indices=leaf(pixels.img_indices),
        )
        for c in range(n_chunks):
            yield flat[c * chunk : (c + 1) * chunk]

    @torch.no_grad()
    def render_image_async(self, params, pixels: PixelBundle) -> Callable[[], Dict[str, np.ndarray]]:
        """Queue a [H, W] render on the device; return ``finalize()`` ->
        host dict of [H, W, C] images.  Queueing view k+1 before finalizing
        view k overlaps k's copy to the host with k+1's render."""
        H, W = pixels.h_indices.shape[:2]
        n = H * W
        params = self._on_device(params)
        reg = self._regular_view(pixels, H, W)
        chunks = self._view_chunks(*reg, H, W) if reg is not None else self._bundle_chunks(pixels, n)
        parts = [self._render_chunk(params, c) for c in chunks]
        res = {k: torch.cat([p[k] for p in parts], dim=0) for k in parts[0]}
        pose_rot = _host(pixels.poses)[0, 0, :3, :3]

        def finalize() -> Dict[str, np.ndarray]:
            out = {k: v[:n].cpu().numpy().reshape(H, W, -1) for k, v in res.items()}
            rot = np.linalg.inv(pose_rot)
            for k in ("normal", "normalized_normal"):
                out[k] = (out[k].reshape(-1, 3) @ rot.T).reshape(H, W, 3)
            return out

        return finalize

    def render_image(self, params, pixels: PixelBundle) -> Dict[str, np.ndarray]:
        """Render a [H, W] pixel bundle -> host dict of [H, W, C] images."""
        return self.render_image_async(params, pixels)()

    def get_eval_dicts(
        self, params, pixels: PixelBundle
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, float], Dict[str, np.ndarray], dict]:
        """(img_dict, metrics, tensor_dict, params) of one view.  With pose
        or light optimization on and a ground truth, the view is registered
        first, and the returned params carry the registered raygen tables
        (the original code updates its live ray generator, so callers thread
        them on)."""
        rg = self.cfg.ray_generator
        if (rg.cam_opt_mode != "off" or rg.pl_opt) and pixels.rgb_gt is not None:
            params = self.register_view(params, pixels)

        res = self.render_image(params, pixels)
        img_dict = {
            "rgb": res["rgb"],
            "analytic_normals": res["normal"],
            "normalized_analytic_normals": res["normalized_normal"],
        }
        metrics: Dict[str, float] = {}
        if pixels.rgb_gt is not None:
            gt = _host(pixels.rgb_gt)
            img_dict["rgb_gt"] = gt
            metrics["psnr"] = psnr(res["rgb"], gt)
            metrics["ssim"] = ssim(res["rgb"], gt)
            if lpips_available():
                metrics["lpips"] = lpips(res["rgb"], gt)
        if "shadow_map" in res:
            img_dict["shadow_map"] = res["shadow_map"]

        tensor_dict = {"depth": res["depth"]}
        if "specular_hint" in res:
            tensor_dict["specular_hint"] = res["specular_hint"]
        return img_dict, metrics, tensor_dict, params

    def register_view(self, params, pixels: PixelBundle, steps: int = 500,
                      pixel_draws: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None) -> dict:
        """``steps`` Adam steps (lr ``ray_generator.opt_lr``) on copies of
        the raygen leaves -> {"renderer": the same renderer params, "raygen":
        the registered leaves}.  ``pixel_draws`` ([(rows, cols)] a step)
        replaces the draws of ``register_view_key``."""
        if not params["raygen"]:
            return params
        cfg, dev = self.cfg, self.device
        renderer = _tree_map(self._on_device(params["renderer"]), torch.Tensor.detach)
        raygen = {k: torch.as_tensor(v).detach().to(dev).clone().requires_grad_(True)
                  for k, v in params["raygen"].items()}
        opt = torch.optim.Adam(list(raygen.values()), lr=cfg.ray_generator.opt_lr, betas=(0.9, 0.999), eps=1e-8)
        image = pixels.to(dev)
        H, W = image.h_indices.shape[:2]
        bs = cfg.model.batch_size
        gen = register_view_key(pixels, dev) if pixel_draws is None else None
        for i in range(steps):
            if pixel_draws is None:
                h_idx = torch.randint(0, H, (bs,), generator=gen, device=dev)
                w_idx = torch.randint(0, W, (bs,), generator=gen, device=dev)
            else:
                h_idx, w_idx = (torch.as_tensor(a, device=dev).long() for a in pixel_draws[i])
            batch = image[h_idx, w_idx]
            out = forward_pipeline(
                {"renderer": renderer, "raygen": raygen}, self.buffers, cfg, self.camera, batch,
                is_training=False, geometry_warmup=False, cos_anneal_ratio=1.0,
            )
            loss = torch.sum(torch.abs(out.rgb - batch.rgb_gt)) / (bs + 1e-5)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        return {"renderer": params["renderer"], "raygen": {k: v.detach() for k, v in raygen.items()}}


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)
