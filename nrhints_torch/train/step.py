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
updates the state's parameters and optimizer in place (``torch.optim.Adam``;
optax's Adam computes the same update).  The random key becomes a
``torch.Generator`` on the step's device; explicit uniforms may replace it
(``render_rays``).

One step body serves the eager step and the CUDA graph of
``make_train_step_scan``: every value that changes from step to step
reaches it as a device tensor (the batch, the jitter uniforms,
cos_anneal_ratio, each group's learning rate), and on the card the
optimizer is ``Adam(capturable=True)`` with a 0-d tensor ``lr`` per group
and its step count on the device.  On the CPU the optimizer keeps float
learning rates.  ``make_train_step_scan`` runs K steps as one graph replay
on the card (the JAX package's ``lax.scan``) and as K eager steps on the
CPU.

With a distributed ``DataMesh`` (``parallel/mesh.py``) each rank steps on
its own rows of the global batch and takes its rows of the global batch's
jitter, drawn from the step's generator.  Its loss is its share of the
global loss, as GSPMD differentiates the JAX step: its rgb L1 sum over the
global batch, and its masked eikonal sum over the mask count of every rank
(one scalar all-reduce in the forward).  After the backward one all-reduce
sums every gradient and the metric shares through one flat f32 buffer, so
every rank's Adam runs on the same bytes and the parameters stay equal bit
for bit; the metrics are the global ones.  On the card, under NCCL, both
collectives are captured in the K-step graph.  Without a process group
the step is the single-device step, with no collective.

With a sample axis (the (data, k) grid of ``parallel/mesh.py``) the k ranks
of a sample group step on the same rows with the same jitter (the rows of
their data index), their marches split over the group
(``render/renderer.py``), and both collectives run over the data group:
every rank of a sample group computes the same gradients, so a sum over
the whole world would count each row k times.  Under NCCL the marches'
all-gathers are captured in the K-step graph with the rest.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch

from nrhints_torch import graphs
from nrhints_torch.camera.model import CameraModel
from nrhints_torch.camera.rays import generate_rays
from nrhints_torch.configs.config import SystemConfig
from nrhints_torch.core.structs import PixelBundle, RenderOutput
from nrhints_torch.parallel.mesh import DataMesh, all_reduce_grads, all_reduce_scalar, rank_rows
from nrhints_torch.render.renderer import graph_capturable, render_rays, train_uniforms
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
    made to require gradients.  On the card the optimizer is capturable
    and each group's ``lr`` a 0-d tensor on the card (``set_lr``)."""
    groups, dev = [], None
    for name, base in (("renderer", cfg.model.lr), ("raygen", cfg.ray_generator.opt_lr)):
        leaves = tree_leaves(params[name])
        for t in leaves:
            t.requires_grad_(True)
        if leaves:
            dev = leaves[0].device
            groups.append({"params": leaves, "name": name, "base_lr": lr_scale * base, "lr": lr_scale * base})
    if dev is None or dev.type == "cpu":
        return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
    for g in groups:
        g["lr"] = torch.tensor(g["lr"], dtype=torch.float32, device=dev)
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8, capturable=True)


def set_lr(optimizer: torch.optim.Optimizer, values) -> None:
    """Each group's learning rate for the next update: a float, or a 0-d
    tensor on the card, copied into the group's tensor ``lr`` where it has
    one (so a CUDA graph that captured the update reads it)."""
    for g, v in zip(optimizer.param_groups, values):
        if isinstance(g["lr"], torch.Tensor):
            if isinstance(v, torch.Tensor):
                g["lr"].copy_(v)
            else:
                g["lr"].fill_(v)
        else:
            g["lr"] = v


def step_scalars(cfg: SystemConfig, optimizer: torch.optim.Optimizer, step: int) -> tuple[float, list[float]]:
    """(cos_anneal_ratio, each group's learning rate) of train step
    ``step``: min(1, step / anneal_end), and base_lr times the warm-up-then-
    cosine factor."""
    m = cfg.model
    cos = min(1.0, step / m.anneal_end) if m.anneal_end > 0 else 1.0
    f = lr_factor_schedule(m.warm_up_end, m.end_iter, m.lr_alpha)(step)
    return cos, [g["base_lr"] * f for g in optimizer.param_groups]


@dataclass
class TrainState:
    """The step count, the {renderer, raygen} parameter tree (leaf tensors
    that require gradients) and the optimizer over them."""

    step: int
    params: Any
    optimizer: torch.optim.Adam


def init_train_state(params: dict, optimizer: torch.optim.Adam) -> TrainState:
    return TrainState(step=0, params=params, optimizer=optimizer)


def compute_loss_dict(out: RenderOutput, rgb_gt: torch.Tensor, igr_weight: float,
                      mesh: DataMesh | None = None) -> tuple[torch.Tensor, dict]:
    """(loss, metric shares) of this rank's rows: its share of the global
    loss (the rgb L1 sum over the global batch, the masked eikonal sum over
    every data index's mask count) and its shares {rgb_loss, eikonal_loss,
    s_val, mse}, which ``global_metrics`` turns into the global metrics once
    summed over the data group.  Only a distributed ``mesh`` runs the mask
    count's scalar all-reduce (over the data group); without one the shares
    are the batch's own."""
    batch = out.rgb.shape[0]
    world = 1 if mesh is None else mesh.data_size
    rgb_loss = torch.sum(torch.abs(out.rgb - rgb_gt)) / (batch * world + 1e-5)
    grad_err = (torch.linalg.norm(out.analytic_normals, dim=-1) - 1.0) ** 2
    mask = out.relax_inside_sphere
    count = torch.sum(mask) if mesh is None else all_reduce_scalar(torch.sum(mask), mesh.data_group)
    eikonal_loss = torch.sum(mask * grad_err) / (count + 1e-5)
    loss = rgb_loss + eikonal_loss * igr_weight
    mse = torch.mean((out.rgb - rgb_gt) ** 2)
    return loss, {"rgb_loss": rgb_loss, "eikonal_loss": eikonal_loss, "s_val": torch.mean(out.s_val) / world,
                  "mse": mse / world}


def global_metrics(shares: dict, igr_weight: float) -> dict:
    """The metrics {loss, rgb_loss, eikonal_loss, s_val, psnr} of the global
    batch from the summed shares of ``compute_loss_dict`` (PSNR from the
    global MSE)."""
    rgb_loss, eikonal_loss = shares["rgb_loss"], shares["eikonal_loss"]
    return {
        "loss": rgb_loss + eikonal_loss * igr_weight,
        "rgb_loss": rgb_loss,
        "eikonal_loss": eikonal_loss,
        "s_val": shares["s_val"],
        "psnr": -10.0 * torch.log10(shares["mse"] + 1e-10),
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
    mesh: DataMesh | None = None,
) -> RenderOutput:
    """{renderer, raygen} params + a flat pixel batch -> RenderOutput.  A
    rank's rays are its own; ``mesh`` goes to ``render_rays``, whose marches
    split over a sample axis."""
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


def _live_mesh(mesh: DataMesh | None) -> DataMesh | None:
    """The mesh the step runs collectives over: None without a process
    group, so one rank alone runs the single-device step unchanged."""
    return mesh if mesh is not None and mesh.distributed else None


def rank_uniforms(cfg: SystemConfig, mesh: DataMesh | None, n_rays: int, generator: torch.Generator | None, device,
                  *, geometry_warmup: bool = False) -> dict:
    """This rank's rows of the jitter uniforms of the global batch of
    ``n_rays`` x data size rays, drawn from the step's ``generator`` in
    ``render_rays``' order, as JAX's global key and sharded uniforms give
    them: the rows of its data index, so the ranks of a sample group draw
    alike (all rows where there is no group)."""
    mesh = _live_mesh(mesh)
    world = 1 if mesh is None else mesh.data_size
    u = train_uniforms(cfg.model, n_rays * world, generator, device, geometry_warmup=geometry_warmup)
    return u if mesh is None else {k: v[rank_rows(mesh, n_rays)] for k, v in u.items()}


def loss_and_grads(state: TrainState, cfg: SystemConfig, camera: CameraModel, buffers: dict, batch: PixelBundle,
                   generator: torch.Generator | None = None, *, geometry_warmup: bool = False,
                   uniforms: dict | None = None, cos_anneal_ratio: torch.Tensor | None = None,
                   mesh: DataMesh | None = None) -> dict:
    """One forward and backward at ``state``: fills every leaf's ``.grad``
    (zeros for a leaf the loss does not reach, as JAX's grad gives) and
    returns the detached metrics.  ``cos_anneal_ratio``: a 0-d tensor on
    the step's device; by default ``step_scalars``' value at ``state.step``.

    With a distributed ``mesh``, ``batch`` and ``uniforms`` are this rank's
    rows (a ``generator`` gives the global draw's rows), and after the
    backward one all-reduce over the data group sums the gradients and the
    metric shares: the leaves then hold the global loss's gradients, the
    same bytes on every rank, and the metrics are the global batch's."""
    mesh = _live_mesh(mesh)
    if cos_anneal_ratio is None:
        cos = step_scalars(cfg, state.optimizer, state.step)[0]
        cos_anneal_ratio = torch.full((), cos, device=batch.h_indices.device)
    if mesh is not None and uniforms is None:
        uniforms = rank_uniforms(cfg, mesh, batch.h_indices.shape[0], generator, batch.h_indices.device,
                                 geometry_warmup=geometry_warmup)
        generator = None
    state.optimizer.zero_grad(set_to_none=True)
    out = forward_pipeline(
        state.params, buffers, cfg, camera, batch, generator, is_training=True, geometry_warmup=geometry_warmup,
        cos_anneal_ratio=cos_anneal_ratio, uniforms=uniforms, mesh=mesh,
    )
    loss, shares = compute_loss_dict(out, batch.rgb_gt, cfg.model.igr_weight, mesh)
    loss.backward()
    leaves = [p for group in state.optimizer.param_groups for p in group["params"]]
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    shares = {k: v.detach() for k, v in shares.items()}
    if mesh is not None:
        shares = {k: v.clone() for k, v in shares.items()}
        all_reduce_grads([p.grad for p in leaves] + list(shares.values()), mesh.data_group)
    return global_metrics(shares, cfg.model.igr_weight)


def _step_body(state: TrainState, cfg: SystemConfig, camera: CameraModel, buffers: dict, batch: PixelBundle,
               generator, uniforms, cos_anneal_ratio: torch.Tensor, lrs, *, geometry_warmup: bool,
               mesh: DataMesh | None = None) -> dict:
    """One train step in place: forward, backward (and with a mesh the
    gradients' all-reduce), the learning rates ``lrs`` set, Adam's update.
    The eager step and every step of a captured K-step graph run this."""
    metrics = loss_and_grads(state, cfg, camera, buffers, batch, generator, geometry_warmup=geometry_warmup,
                             uniforms=uniforms, cos_anneal_ratio=cos_anneal_ratio, mesh=mesh)
    set_lr(state.optimizer, lrs)
    state.optimizer.step()
    return metrics


def make_train_step(
    cfg: SystemConfig,
    camera: CameraModel,
    buffers: dict,
    optimizer: torch.optim.Adam,
    *,
    geometry_warmup: bool = False,
    mesh: DataMesh | None = None,
):
    """-> ``step_fn(state, batch, generator, uniforms=None) -> (state,
    metrics)`` for one phase (``geometry_warmup`` or not).  The step updates
    ``state`` in place and returns it; the metrics are detached 0-d tensors
    (reading them waits for the device).  ``parallel.steps_per_dispatch``
    is the Trainer's choice, as in JAX; this step is always one step.
    ``mesh``: the Trainer's ``DataMesh``; the batch (and any ``uniforms``)
    are then this rank's rows, and the step is the global batch's."""
    mesh = _live_mesh(mesh)

    def step_fn(state: TrainState, batch: PixelBundle, generator: torch.Generator | None = None,
                uniforms: dict | None = None):
        if state.optimizer is not optimizer:
            raise ValueError("the state's optimizer is not the one this step was made with")
        cos, lrs = step_scalars(cfg, optimizer, state.step)
        cos_t = torch.full((), cos, device=batch.h_indices.device)
        metrics = _step_body(state, cfg, camera, buffers, batch, generator, uniforms, cos_t, lrs,
                             geometry_warmup=geometry_warmup, mesh=mesh)
        state.step += 1
        return state, metrics

    return step_fn


def stack_bundles(batches) -> PixelBundle:
    """K flat PixelBundles -> one with a leading [K] axis on every field."""
    return PixelBundle(**{f.name: None if getattr(batches[0], f.name) is None
                          else torch.stack([getattr(b, f.name) for b in batches])
                          for f in dataclasses.fields(PixelBundle)})


class _ScanGraph:
    """The static inputs of a captured K-step dispatch (the stacked batch,
    each step's uniforms, cos_anneal_ratio and learning rates), its graph
    and its last step's metrics."""

    def __init__(self, batches: PixelBundle, uniforms: list, n_groups: int, pool):
        k, dev = batches.h_indices.shape[0], batches.h_indices.device
        self.batches = PixelBundle(**{f.name: None if getattr(batches, f.name) is None
                                      else torch.empty_like(getattr(batches, f.name))
                                      for f in dataclasses.fields(PixelBundle)})
        self.uniforms = {key: torch.empty((k,) + tuple(u.shape), device=dev) for key, u in uniforms[0].items()}
        self.cos = torch.empty(k, device=dev)
        self.lrs = torch.empty((k, n_groups), device=dev)
        self.graph = graphs.Graph(pool)
        self.metrics = None

    def fill(self, batches: PixelBundle, uniforms: list, scalars: list) -> None:
        with torch.no_grad():
            for f in dataclasses.fields(PixelBundle):
                if getattr(batches, f.name) is not None:
                    getattr(self.batches, f.name).copy_(getattr(batches, f.name))
            for key, t in self.uniforms.items():
                t.copy_(torch.stack([u[key] for u in uniforms]))
            # f32 values of the host's doubles, as the eager step's fill_ rounds them.
            self.cos.copy_(torch.tensor([c for c, _ in scalars], dtype=torch.float32))
            self.lrs.copy_(torch.tensor([lrs for _, lrs in scalars], dtype=torch.float32))

    def run(self, state, cfg, camera, buffers, geometry_warmup: bool, mesh: DataMesh | None) -> dict:
        """The K steps on the static inputs (eagerly, or under capture),
        with their collectives where there is a mesh."""
        metrics = None
        for i in range(self.cos.shape[0]):
            u = {key: t[i] for key, t in self.uniforms.items()}
            lrs = [self.lrs[i, g] for g in range(self.lrs.shape[1])]
            metrics = _step_body(state, cfg, camera, buffers, self.batches[i], None, u, self.cos[i], lrs,
                                 geometry_warmup=geometry_warmup, mesh=mesh)
        return metrics


def make_train_step_scan(
    cfg: SystemConfig,
    camera: CameraModel,
    buffers: dict,
    optimizer: torch.optim.Adam,
    *,
    n_steps: int,
    geometry_warmup: bool = False,
    mesh: DataMesh | None = None,
    pool=None,
):
    """``n_steps`` train steps in one dispatch (JAX's ``lax.scan``) ->
    ``scan_fn(state, batches, randomness) -> (state, the last step's
    metrics)``.  ``batches``: a PixelBundle stacked on a leading
    [n_steps] axis (``stack_bundles``); ``randomness``: one generator or
    one ``uniforms`` dict per step, as ``make_train_step``'s step takes
    them.  The state is updated in place, as by ``n_steps`` calls of
    ``make_train_step``'s step.

    On the card the K steps (forward, backward and Adam each) are one
    ``torch.cuda.CUDAGraph``: the first call runs them eagerly on a side
    stream (the warm-up, whose result is returned), then captures them;
    every later call fills the static inputs and replays.  Each step's
    uniforms are drawn outside the graph from its generator in
    ``render_rays``' order (``render/renderer.py::train_uniforms``).
    ``pool``: a graph memory pool to share with the caller's other graphs.
    On the CPU the steps run eagerly, one by one, and so they do on the
    card under ``depth_type="sphere_tracing"``: its loop ends on a test of
    the data, which a graph cannot hold, so the K steps run the same step
    body eagerly, with the same kernels (``renderer.graph_capturable``).

    ``mesh``: as ``make_train_step``'s; ``batches`` are this rank's rows.
    Under NCCL the graph holds every step's two collectives (the mask
    count's and the gradients'), and with a sample axis the marches'
    all-gathers, which every rank replays in the same order.  A gloo group cannot be captured, so on the card it raises
    ``ValueError`` rather than running the steps eagerly."""
    mesh = _live_mesh(mesh)
    if n_steps < 1:
        raise ValueError(f"n_steps must be at least 1, got {n_steps}")
    if mesh is not None and mesh.device.type == "cuda" and mesh.backend != "nccl":
        raise ValueError(f"a {mesh.backend} group's collectives cannot be captured in a CUDA graph: "
                         f"steps_per_dispatch > 1 on the card needs NCCL")
    step_fn = make_train_step(cfg, camera, buffers, optimizer, geometry_warmup=geometry_warmup, mesh=mesh)
    captured: _ScanGraph | None = None

    def scan_fn(state: TrainState, batches: PixelBundle, randomness: Sequence):
        nonlocal captured
        if state.optimizer is not optimizer:
            raise ValueError("the state's optimizer is not the one this step was made with")
        if batches.h_indices.shape[0] != n_steps or len(randomness) != n_steps:
            raise ValueError(f"scan_fn takes {n_steps} stacked batches and {n_steps} generators or uniforms")
        dev = batches.h_indices.device
        if dev.type == "cpu" or not graph_capturable(cfg.model):
            metrics = None
            for i, r in enumerate(randomness):
                gen, u = (None, r) if isinstance(r, dict) else (r, None)
                state, metrics = step_fn(state, batches[i], gen, u)
            return state, metrics
        n_rays = batches.h_indices.shape[1]
        uniforms = [r if isinstance(r, dict) else
                    rank_uniforms(cfg, mesh, n_rays, r, dev, geometry_warmup=geometry_warmup) for r in randomness]
        scalars = [step_scalars(cfg, optimizer, state.step + i) for i in range(n_steps)]
        if captured is None:
            sg = _ScanGraph(batches, uniforms, len(optimizer.param_groups), pool)
            sg.fill(batches, uniforms, scalars)
            metrics = graphs.warm_up(lambda: sg.run(state, cfg, camera, buffers, geometry_warmup, mesh))
            optimizer.zero_grad(set_to_none=True)
            sg.metrics = sg.graph.capture(lambda: sg.run(state, cfg, camera, buffers, geometry_warmup, mesh))
            captured = sg
        else:
            captured.fill(batches, uniforms, scalars)
            captured.graph.replay()
            metrics = {k: v.clone() for k, v in captured.metrics.items()}
        state.step += n_steps
        return state, metrics

    return scan_fn
