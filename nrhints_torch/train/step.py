"""Loss, optimizer, train state and the train step (port of
``nrhints_tpu/train/step.py``).

* loss = L1(rgb) / batch + igr_weight * the eikonal loss over the
  inside-sphere samples (``relax_inside_sphere`` carries the r < 1.0 mask);
* Adam in two groups, the renderer at ``cfg.model.lr`` and the ray
  generator's pose and light deltas at ``cfg.ray_generator.opt_lr``, under
  one warm-up-then-cosine factor of the step count;
* cos_anneal_ratio = min(1, step / anneal_end).

The step runs on the device its state lies on (``init_model_params`` and
``ray_generator_init`` build it on the card by default), through the
``core_backward`` schedule of the config: "stash" (kernels D-G),
"recompute" (A, H, I, J: nothing is kept between the core's forward and
backward) or "stash_xla" (D and F, then the stash backward as full-batch
PyTorch).

The JAX step is one jitted function of an immutable state; here the step
runs eagerly and updates the state's parameters and optimizer in place
(``torch.optim.Adam``; optax's Adam computes the same update).  The random
key becomes a ``torch.Generator`` on the step's device; explicit uniforms
may replace it (``render_rays``).  Several steps per dispatch (a CUDA
graph) are a later slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from nrhints_torch.camera.model import CameraModel
from nrhints_torch.camera.rays import generate_rays
from nrhints_torch.configs.config import SystemConfig
from nrhints_torch.core.structs import PixelBundle, RenderOutput
from nrhints_torch.render.renderer import render_rays
from nrhints_torch.utils import tree_leaves


def lr_factor_schedule(warm_up_end: int, end_iter: int, alpha: float) -> Callable[[int], float]:
    """Warm-up-then-cosine learning-rate factor of the step count."""

    def factor(step: int) -> float:
        if step < warm_up_end:
            return step / max(warm_up_end, 1)
        progress = (step - warm_up_end) / max(end_iter - warm_up_end, 1)
        return (math.cos(math.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha

    return factor


def batch_scale_lr_factor(cfg: SystemConfig, global_batch: int) -> float:
    """LR compensation for a scaled global batch: k = global_batch /
    configured batch, under ``cfg.parallel.batch_scale_lr_rule``."""
    k = global_batch / cfg.model.batch_size
    rule = cfg.parallel.batch_scale_lr_rule
    if k == 1.0 or rule == "none":
        return 1.0
    if rule == "sqrt":
        return float(k**0.5)
    if rule == "linear":
        return float(k)
    raise ValueError(f"unknown batch_scale_lr_rule: {rule!r}")


def make_optimizer(cfg: SystemConfig, params: dict, lr_scale: float = 1.0) -> torch.optim.Adam:
    """Two Adam groups over the {renderer, raygen} parameter tree; each group
    keeps its base rate as ``base_lr``, and the train step sets ``lr`` =
    base_lr * the schedule's factor before every update.  The leaves are
    made to require gradients."""
    groups = []
    for name, base in (("renderer", cfg.model.lr), ("raygen", cfg.ray_generator.opt_lr)):
        leaves = tree_leaves(params[name])
        for t in leaves:
            t.requires_grad_(True)
        if leaves:
            groups.append({"params": leaves, "name": name, "base_lr": lr_scale * base, "lr": lr_scale * base})
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


@dataclass
class TrainState:
    """The step count, the {renderer, raygen} parameter tree (leaf tensors
    that require gradients) and the optimizer over them."""

    step: int
    params: Any
    optimizer: torch.optim.Adam


def init_train_state(params: dict, optimizer: torch.optim.Adam) -> TrainState:
    return TrainState(step=0, params=params, optimizer=optimizer)


def compute_loss_dict(out: RenderOutput, rgb_gt: torch.Tensor, igr_weight: float) -> tuple[torch.Tensor, dict]:
    batch = out.rgb.shape[0]
    rgb_loss = torch.sum(torch.abs(out.rgb - rgb_gt)) / (batch + 1e-5)
    grad_err = (torch.linalg.norm(out.analytic_normals, dim=-1) - 1.0) ** 2
    mask = out.relax_inside_sphere
    eikonal_loss = torch.sum(mask * grad_err) / (torch.sum(mask) + 1e-5)
    loss = rgb_loss + eikonal_loss * igr_weight
    mse = torch.mean((out.rgb - rgb_gt) ** 2)
    psnr = -10.0 * torch.log10(mse + 1e-10)
    return loss, {
        "loss": loss,
        "rgb_loss": rgb_loss,
        "eikonal_loss": eikonal_loss,
        "s_val": torch.mean(out.s_val),
        "psnr": psnr,
    }


def forward_pipeline(
    params: dict,
    buffers: dict,
    cfg: SystemConfig,
    camera: CameraModel,
    batch: PixelBundle,
    generator: torch.Generator | None = None,
    *,
    is_training: bool,
    geometry_warmup: bool,
    cos_anneal_ratio,
    uniforms: dict | None = None,
    mesh=None,
) -> RenderOutput:
    """{renderer, raygen} params + a flat pixel batch -> RenderOutput."""
    rays = generate_rays(params["raygen"], buffers, camera, cfg.ray_generator, batch)
    bg = 1.0 if cfg.data.white_background else 0.0
    return render_rays(
        params["renderer"],
        cfg.model,
        rays,
        generator,
        is_training=is_training,
        geometry_warmup=geometry_warmup,
        cos_anneal_ratio=cos_anneal_ratio,
        background_rgb=torch.full((1, 3), bg, device=rays.origins.device),
        uniforms=uniforms,
        mesh=mesh,
    )


def loss_and_grads(state: TrainState, cfg: SystemConfig, camera: CameraModel, buffers: dict, batch: PixelBundle,
                   generator: torch.Generator | None = None, *, geometry_warmup: bool = False,
                   uniforms: dict | None = None) -> dict:
    """One forward and backward at ``state``: fills every leaf's ``.grad``
    (zeros for a leaf the loss does not reach, as JAX's grad gives) and
    returns the detached metrics."""
    anneal_end = cfg.model.anneal_end
    cos_anneal_ratio = min(1.0, state.step / anneal_end) if anneal_end > 0 else 1.0
    state.optimizer.zero_grad(set_to_none=True)
    out = forward_pipeline(
        state.params, buffers, cfg, camera, batch, generator, is_training=True, geometry_warmup=geometry_warmup,
        cos_anneal_ratio=cos_anneal_ratio, uniforms=uniforms,
    )
    loss, metrics = compute_loss_dict(out, batch.rgb_gt, cfg.model.igr_weight)
    loss.backward()
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(
    cfg: SystemConfig,
    camera: CameraModel,
    buffers: dict,
    optimizer: torch.optim.Adam,
    *,
    geometry_warmup: bool = False,
    mesh=None,
):
    """-> ``step_fn(state, batch, generator, uniforms=None) -> (state,
    metrics)`` for one phase (``geometry_warmup`` or not).  The step updates
    ``state`` in place and returns it; the metrics are detached 0-d tensors
    (reading them waits for the device)."""
    if mesh is not None:
        raise NotImplementedError("mesh sharding: the data-parallel step is a later slice")
    if cfg.parallel.steps_per_dispatch > 1:
        raise NotImplementedError("steps_per_dispatch > 1: several steps per dispatch (a CUDA graph) are a later slice")
    factor = lr_factor_schedule(cfg.model.warm_up_end, cfg.model.end_iter, cfg.model.lr_alpha)

    def step_fn(state: TrainState, batch: PixelBundle, generator: torch.Generator | None = None,
                uniforms: dict | None = None):
        if state.optimizer is not optimizer:
            raise ValueError("the state's optimizer is not the one this step was made with")
        metrics = loss_and_grads(state, cfg, camera, buffers, batch, generator, geometry_warmup=geometry_warmup,
                                 uniforms=uniforms)
        f = factor(state.step)
        for group in optimizer.param_groups:
            group["lr"] = group["base_lr"] * f
        optimizer.step()
        state.step += 1
        return state, metrics

    return step_fn


def make_train_step_scan(*args, **kwargs):
    """Several steps in one dispatch: a CUDA graph in a later slice."""
    raise NotImplementedError("make_train_step_scan: several steps per dispatch (a CUDA graph) are a later slice")
