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
core runs its differentiable stash op (kernels D and E on the card, E
without its weight-gradient passes), the renderer's parameters are
detached and the training optimizer is not touched.

An evaluator keeps to its rank's card.  JAX's per-host eval mesh shards a
view's rays over the host's chips; here each process owns one card, so the
parallelism of evaluation is the Trainer's: test views and video frames
strided over the ranks.  Under a (data, sample) grid that is the flattened
1-D mesh of all ranks, as JAX's Evaluator flattens each host's devices: a
view renders whole on one rank, no march split over a sample group.

On the card both loops are CUDA graphs, as JAX runs each as one jit: a
view's chunk sweep is captured once per (H, W, bundle path) and replayed
per view on static copies of the parameters, pose, light and image index;
registration captures one step (pixel draw, forward, loss, backward,
Adam) on static copies of the parameters and the view and replays it once
a step, the pixel draws drawn ahead from the view's generator.  The first
call of a key runs eagerly and then captures (``graphs.py``).  On the CPU
both are the eager loops (``_render_eager``, ``_register_view_eager``),
which stay callable on the card for comparison.  Under
``depth_type="sphere_tracing"`` the card runs the eager loops too: the
sphere tracer's loop ends on a test of the data, which a graph cannot hold
(``renderer.graph_capturable``); the kernels are the same.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from nrhints_torch import graphs
from nrhints_torch.camera.model import CameraModel
from nrhints_torch.configs.config import SystemConfig
from nrhints_torch.core.structs import PixelBundle
from nrhints_torch.eval.metrics import lpips, lpips_available, psnr, ssim
from nrhints_torch.parallel.mesh import DataMesh
from nrhints_torch.render.renderer import graph_capturable
from nrhints_torch.train.step import forward_pipeline
from nrhints_torch.utils import resolve_device, tree_items, tree_map


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def register_view_key(pixels: PixelBundle, device="cpu") -> torch.Generator:
    """The generator of a view's registration draws, seeded by its image
    index, so each view registers on its own pixel sequence and a rerun
    draws the same pixels."""
    idx = int(_host(pixels.img_indices).reshape(-1)[0])
    return torch.Generator(device=device).manual_seed(idx)


class _ViewGraph:
    """A captured chunk sweep: static parameters and view inputs, the graph
    and its outputs."""

    def __init__(self, params, inputs, pool):
        self.params = tree_map(params, _detached_copy)
        self.inputs = tree_map(inputs, _detached_copy)
        self.graph = graphs.Graph(pool)
        self.out = None


class _RegistrationGraph:
    """A captured registration step: static renderer parameters (detached),
    raygen leaves and their capturable Adam, the view and one step's pixel
    draw [2, batch]."""

    def __init__(self, renderer, raygen, image: PixelBundle, lr: float, bs: int, pool):
        self.renderer = tree_map(renderer, _detached_copy)
        self.raygen = {k: v.detach().clone().requires_grad_(True) for k, v in raygen.items()}
        self.opt = _registration_adam(list(self.raygen.values()), lr)
        self.image = PixelBundle(**{f: None if getattr(image, f) is None else getattr(image, f).clone()
                                    for f in _BUNDLE_FIELDS})
        self.draw = torch.empty((2, bs), dtype=torch.long, device=image.h_indices.device)
        self.graph = graphs.Graph(pool)
        self.captured = False

    def load(self, renderer, raygen, image: PixelBundle) -> None:
        """The view's parameters and image into the static tensors, and a
        fresh Adam (zero moments and step, as a new optimizer starts)."""
        graphs.copy_tree_(self.renderer, renderer)
        graphs.copy_tree_(self.raygen, raygen)
        with torch.no_grad():
            for f in _BUNDLE_FIELDS:
                if getattr(image, f) is not None:
                    getattr(self.image, f).copy_(getattr(image, f))
            for st in self.opt.state.values():
                for t in st.values():
                    t.zero_()


_BUNDLE_FIELDS = ("h_indices", "w_indices", "poses", "pls", "img_indices", "rgb_gt")


def _registration_adam(leaves, lr: float) -> torch.optim.Adam:
    """Registration's Adam: capturable on the card, as its graph needs."""
    cuda = leaves[0].device.type == "cuda"
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=cuda)


class Evaluator:
    def __init__(self, cfg: SystemConfig, camera: CameraModel, buffers: dict, *, device="cuda",
                 mesh: Optional[DataMesh] = None, pool=None):
        """``device``: "cuda" (the default) or "cpu"; with no CUDA device
        the default raises rather than running on the CPU.  ``mesh``: the
        Trainer's ``DataMesh``, of which only the device is used (this
        rank's card): a view's rays are not split over ranks.  ``pool``: a
        CUDA graph memory pool to share with the caller's graphs (the
        Trainer's); by default the evaluator's graphs share one of their own."""
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.cfg = cfg
        self.camera = camera
        self.buffers = self._on_device(buffers)
        if pool is None and self.device.type == "cuda":
            pool = torch.cuda.graph_pool_handle()
        self._pool = pool
        self._view_graphs: dict = {}
        self._registration_graphs: dict = {}

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

    def _view_inputs(self, pixels: PixelBundle, H: int, W: int) -> dict:
        """The device tensors a view's sweep reads: for a plain full-image
        view {"pose" [4, 4], "pl" [3], "img" [1] (absent for a view with no
        image index)}; for any other bundle its fields flattened and padded
        by repeating the last ray {"bundle": {field: [total, ...]}}."""
        reg = self._regular_view(pixels, H, W)
        if reg is not None:
            pose, pl, img_idx = reg
            out = {"pose": torch.as_tensor(pose, dtype=torch.float32).to(self.device),
                   "pl": torch.as_tensor(pl, dtype=torch.float32).to(self.device)}
            if img_idx is not None:
                out["img"] = torch.tensor([img_idx], device=self.device)
            return out
        n = H * W
        _, _, total = self._view_chunking(n)

        def leaf(x):
            x = _host(x).reshape((n,) + _host(x).shape[pixels.h_indices.ndim :])
            x = np.concatenate([x, np.repeat(x[-1:], total - n, axis=0)], axis=0)
            return torch.as_tensor(x).to(self.device)

        return {"bundle": {f: leaf(getattr(pixels, f)) for f in _BUNDLE_FIELDS[:5]
                           if getattr(pixels, f) is not None}}

    def _chunks(self, inputs: dict, H: int, W: int):
        """The sweep's chunks of ``_view_inputs``: a full view's pixel grid
        is built on the device, its padded tail clamped to the last pixel;
        a bundle is cut into chunks."""
        chunk, n_chunks, total = self._view_chunking(H * W)
        if "bundle" in inputs:
            flat = PixelBundle(**{f: inputs["bundle"].get(f) for f in _BUNDLE_FIELDS[:5]})
            for c in range(n_chunks):
                yield flat[c * chunk : (c + 1) * chunk]
            return
        idx = torch.clamp(torch.arange(total, device=self.device), max=H * W - 1)
        h, w = (idx // W).float(), (idx % W).float()
        img = inputs.get("img")
        for c in range(n_chunks):
            s = slice(c * chunk, (c + 1) * chunk)
            yield PixelBundle(
                h_indices=h[s], w_indices=w[s],
                poses=inputs["pose"].expand(chunk, 4, 4), pls=inputs["pl"].expand(chunk, 3),
                img_indices=None if img is None else img.expand(chunk),
            )

    def _sweep(self, params, inputs: dict, H: int, W: int) -> Dict[str, torch.Tensor]:
        """Every chunk of a view -> {name: [total, C]} on the device."""
        parts = [self._render_chunk(params, c) for c in self._chunks(inputs, H, W)]
        return {k: torch.cat([p[k] for p in parts], dim=0) for k in parts[0]}

    @torch.no_grad()
    def _render_eager(self, params, pixels: PixelBundle) -> Dict[str, torch.Tensor]:
        """The eager chunk sweep of a [H, W] view -> {name: [total, C]} on
        the device (the CPU's path; on the card the reference of the view
        graph)."""
        H, W = pixels.h_indices.shape[:2]
        return self._sweep(self._on_device(params), self._view_inputs(pixels, H, W), H, W)

    @torch.no_grad()
    def _render_graph(self, params, pixels: PixelBundle) -> Dict[str, torch.Tensor]:
        """The chunk sweep as a CUDA graph, keyed by (H, W, the bundle path
        and its fields, the parameter tree): static copies of the
        parameters and the view's inputs filled, then one replay; outputs
        cloned, so the next replay cannot overwrite them before they are
        read."""
        H, W = pixels.h_indices.shape[:2]
        params = self._on_device(params)
        inputs = self._view_inputs(pixels, H, W)
        key = (H, W, tuple(n for n, _ in tree_items(inputs)), tuple(n for n, _ in tree_items(params)))
        vg = self._view_graphs.get(key)
        if vg is None:
            vg = _ViewGraph(params, inputs, self._pool)
            res = graphs.warm_up(lambda: self._sweep(vg.params, vg.inputs, H, W))
            vg.out = vg.graph.capture(lambda: self._sweep(vg.params, vg.inputs, H, W))
            self._view_graphs[key] = vg
            return res
        graphs.copy_tree_(vg.params, params)
        graphs.copy_tree_(vg.inputs, inputs)
        vg.graph.replay()
        return {k: v.clone() for k, v in vg.out.items()}

    @torch.no_grad()
    def render_image_async(self, params, pixels: PixelBundle) -> Callable[[], Dict[str, np.ndarray]]:
        """Queue a [H, W] render on the device (a CUDA graph replay on the
        card, the eager sweep on the CPU and under sphere tracing); return
        ``finalize()`` -> host dict of [H, W, C] images.  Queueing view k+1
        before finalizing view k overlaps k's copy to the host with k+1's
        render."""
        H, W = pixels.h_indices.shape[:2]
        n = H * W
        eager = self.device.type == "cpu" or not graph_capturable(self.cfg.model)
        res = self._render_eager(params, pixels) if eager else self._render_graph(params, pixels)
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
        replaces the draws of ``register_view_key``.  On the card one
        captured step is replayed ``steps`` times; on the CPU, and under
        sphere tracing, the eager loop runs."""
        if not params["raygen"]:
            return params
        if self.device.type == "cpu" or not graph_capturable(self.cfg.model):
            return self._register_view_eager(params, pixels, steps, pixel_draws)
        image = pixels.to(self.device)
        H, W = image.h_indices.shape[:2]
        draws = self._registration_draws(pixels, H, W, steps, pixel_draws)
        renderer = self._on_device(params["renderer"])
        raygen = self._on_device(params["raygen"])
        key = (H, W, tuple(f for f in _BUNDLE_FIELDS if getattr(image, f) is not None),
               tuple(n for n, _ in tree_items(renderer)), tuple(n for n, _ in tree_items(raygen)))
        rg = self._registration_graphs.get(key)
        if rg is None:
            rg = _RegistrationGraph(renderer, raygen, image, self.cfg.ray_generator.opt_lr, self.cfg.model.batch_size,
                                    self._pool)
            self._registration_graphs[key] = rg
        else:
            rg.load(renderer, raygen, image)

        def step():
            self._registration_step(rg.renderer, rg.raygen, rg.opt, rg.image, rg.draw[0], rg.draw[1])

        for i in range(steps):
            rg.draw.copy_(draws[i])
            if rg.captured:
                rg.graph.replay()
            else:
                graphs.warm_up(step)  # the first step, run eagerly: kernels, handles, Adam's state
                rg.opt.zero_grad(set_to_none=True)
                rg.graph.capture(step)
                rg.captured = True
        return {"renderer": params["renderer"], "raygen": {k: v.detach().clone() for k, v in rg.raygen.items()}}

    def _registration_draws(self, pixels: PixelBundle, H: int, W: int, steps: int, pixel_draws=None) -> torch.Tensor:
        """Every step's pixel draw -> int64 [steps, 2, batch] on the device:
        from ``register_view_key``'s generator, rows then columns a step, in
        the eager loop's order, or the given ``pixel_draws``."""
        dev, bs = self.device, self.cfg.model.batch_size
        if pixel_draws is not None:
            draws = [torch.stack([torch.as_tensor(a).long() for a in d]) for d in pixel_draws[:steps]]
            return torch.stack(draws).to(dev)
        gen = register_view_key(pixels, dev)
        return torch.stack([torch.stack([torch.randint(0, H, (bs,), generator=gen, device=dev),
                                         torch.randint(0, W, (bs,), generator=gen, device=dev)])
                            for _ in range(steps)])

    def _registration_step(self, renderer, raygen, opt, image: PixelBundle, h_idx, w_idx) -> None:
        """One registration step in place: the batch at (h_idx, w_idx) of the
        view, the eval render, the L1 loss, its backward through the rays
        and Adam's update of the raygen leaves."""
        batch = image[h_idx, w_idx]
        out = forward_pipeline(
            {"renderer": renderer, "raygen": raygen}, self.buffers, self.cfg, self.camera, batch,
            is_training=False, geometry_warmup=False, cos_anneal_ratio=1.0,
        )
        loss = torch.sum(torch.abs(out.rgb - batch.rgb_gt)) / (self.cfg.model.batch_size + 1e-5)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    def _register_view_eager(self, params, pixels: PixelBundle, steps: int = 500,
                             pixel_draws: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None) -> dict:
        """``register_view`` as an eager loop of ``_registration_step`` (the
        CPU's path; on the card the reference of the registration graph,
        with the same capturable Adam)."""
        if not params["raygen"]:
            return params
        dev = self.device
        renderer = tree_map(self._on_device(params["renderer"]), torch.Tensor.detach)
        raygen = {k: torch.as_tensor(v).detach().to(dev).clone().requires_grad_(True)
                  for k, v in params["raygen"].items()}
        opt = _registration_adam(list(raygen.values()), self.cfg.ray_generator.opt_lr)
        image = pixels.to(dev)
        H, W = image.h_indices.shape[:2]
        draws = self._registration_draws(pixels, H, W, steps, pixel_draws)
        for i in range(steps):
            self._registration_step(renderer, raygen, opt, image, draws[i, 0], draws[i, 1])
        return {"renderer": params["renderer"], "raygen": {k: v.detach() for k, v in raygen.items()}}


def _detached_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone()
