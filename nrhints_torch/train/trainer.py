"""Training orchestration (port of ``nrhints_tpu/train/trainer.py``): the
run directory, the train loop with hooks that fire when the step crosses an
interval (log, checkpoint, test views, mesh, video), resume, a profiler
window, and data parallelism over ranks, one process a card
(``parallel/mesh.py``).

The loop draws each batch on the host (``DataManager``), copies it to the
card and runs one eager train step, or, with ``parallel.steps_per_dispatch``
K > 1, draws K batches, stacks them on the host, copies them once and runs
the K steps as one dispatch (``make_train_step_scan``: one CUDA graph
replay on the card, K eager steps on the CPU).  A chunk that would cross
``geometry_warmup_end`` or ``end_iter`` runs as single steps, as in JAX.
The metrics are read, which waits for the device, only at a log crossing,
and the hooks fire when a dispatch crosses their interval.  Each step's
jitter comes from a ``torch.Generator`` seeded by (seed, step) alone, as
JAX folds the step into one key, so a resumed or chunked run draws what the
unbroken single-step run drew.  The checkpoint holds the params, Adam's
moments and step and the raygen buffers; its sidecar the sampler's streams
and the jitter seed.  Test-time registration copies the registered pose
and light rows back into the live raygen tensors in place, so Adam keeps
its references and moments.  The train graphs and the evaluator's graphs
share one memory pool and live as long as the Trainer.

Under a process group (``launch`` spawns one rank a device, or torchrun
starts them) every rank runs this loop in step with the others.  A host
draws the host batch as a JAX process does and each rank steps on its
rows; the parameters start from one seed and are broadcast from rank 0,
and every step sums the gradients over the ranks, so the ranks' states
stay equal bit for bit.  Rank 0 alone writes ``config.json``, the logs,
the logged images, the checkpoint and the mesh; each host's first rank
writes its sidecar.  Test views and video frames are strided over the
ranks: the metrics are gathered (NaN-padded rows, as JAX's), each rank's
registered rows merged by ownership into every rank's live tables, and
rank 0 writes every frame.  ``sample_axis_size`` > 1 is not ported.  Under
``depth_type="sphere_tracing"`` the card runs every loop eagerly (the
sphere tracer cannot be captured), and the Trainer says so once.
"""
from __future__ import annotations

import gc
import json
import os
import pathlib
import time
import uuid
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from nrhints_torch.camera.rays import ray_generator_init
from nrhints_torch.configs.cli import config_to_dict
from nrhints_torch.configs.config import SystemConfig
from nrhints_torch.data.manager import DataManager
from nrhints_torch.data.parser import SceneData, parse_load_nr_data
from nrhints_torch.data.png import read_png, write_png
from nrhints_torch.eval.evaluator import Evaluator
from nrhints_torch.parallel import mesh as mesh_lib
from nrhints_torch.render.renderer import extract_sdf_grid, graph_capturable, init_model_params
from nrhints_torch.train.checkpoint import CheckpointIO
from nrhints_torch.train.logging import MetricsLogger
from nrhints_torch.train.step import (
    TrainState, batch_scale_lr_factor, init_train_state, make_optimizer, make_train_step, make_train_step_scan,
    stack_bundles,
)
from nrhints_torch.utils import resolve_device, tree_items


def global_batch_sizes(config: SystemConfig, mesh: mesh_lib.DataMesh) -> tuple[int, int]:
    """(global batch, a host's batch): ``model.batch_size``, times the world
    size under ``scale_global_batch`` (JAX's times ``len(jax.devices())``),
    split evenly over the hosts and their ranks."""
    global_batch = config.model.batch_size
    if config.parallel.scale_global_batch:
        global_batch *= mesh.world_size
    if global_batch % mesh.host_count:
        raise ValueError(f"global batch size ({global_batch}) must be divisible by the number of hosts "
                         f"({mesh.host_count})")
    if global_batch % mesh.world_size:
        raise ValueError(f"global batch size ({global_batch}) must be divisible by the number of ranks "
                         f"({mesh.world_size})")
    return global_batch, global_batch // mesh.host_count


class Trainer:
    def __init__(self, config: SystemConfig, scene: Optional[SceneData] = None, *, device="cuda"):
        self.config = config
        device = resolve_device(device)
        if config.parallel.multihost and not dist.is_initialized():
            mesh_lib.initialize_multihost(device=device)
        self.mesh = mesh_lib.make_mesh(config.parallel.data_axis_size,
                                       sample_axis_size=config.parallel.sample_axis_size, device=device)
        self.device = self.mesh.device

        self.log_dir = pathlib.Path(config.base_dir) / config.exp_name / config.scene_name
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.logger = None
        if self.is_main_process:
            (self.log_dir / "config.json").write_text(json.dumps(config_to_dict(config), indent=2))
            self.logger = MetricsLogger(
                self.log_dir,
                use_wandb=config.use_wandb,
                wandb_kwargs={
                    "project": "NR2023",  # the original code's project name
                    "group": config.exp_name,
                    "name": config.scene_name,
                    "id": f"{config.exp_name}_{config.scene_name}".replace("/", "_"),
                    "resume": "allow",
                },
            )

        if scene is None:
            scene = parse_load_nr_data(
                config.data.path, half_res=config.data.half_res, white_background=config.data.white_background
            )
        self.scene = scene
        self.camera = scene.camera
        # The global batch is constant across world sizes (the original
        # code's rule) unless scale_global_batch is set; a host draws its
        # share, and each of its ranks steps on its rows.
        self.global_batch, self.local_batch = global_batch_sizes(config, self.mesh)
        self.data_manager = DataManager(
            scene,
            batch_size=self.local_batch,
            strategy=config.data.pixel_sampling_strategy,
            training_view_num_limit=config.data.view_num_limit,
            image_idx_rng_seed=config.seed,
            pixel_idx_rng_seed=config.seed,
            local_rank=self.mesh.host_index,
        )

        gen = torch.Generator().manual_seed(config.seed)
        params = {"renderer": init_model_params(config.model, gen, device=self.device)}
        params["raygen"], self.buffers = ray_generator_init(
            gen, config.ray_generator, scene.total_image_num, device=self.device
        )
        mesh_lib.replicate(self.mesh, params)
        mesh_lib.replicate(self.mesh, self.buffers)
        self.optimizer = make_optimizer(config, params, lr_scale=batch_scale_lr_factor(config, self.global_batch))
        self.state: TrainState = init_train_state(params, self.optimizer)
        self._jitter_seed = config.seed

        self._step_normal = make_train_step(config, self.camera, self.buffers, self.optimizer, geometry_warmup=False,
                                            mesh=self.mesh)
        self._step_warmup = (
            make_train_step(config, self.camera, self.buffers, self.optimizer, geometry_warmup=True, mesh=self.mesh)
            if config.model.geometry_warmup_end > 0
            else None
        )
        # K-step dispatches, built at first use, keyed by (geometry_warmup,
        # n_steps); on the card their graphs and the evaluator's share a pool.
        self._scan_steps: dict[tuple, object] = {}
        self._graph_pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        if self.device.type == "cuda" and not graph_capturable(config.model) and self.is_main_process:
            print("depth_type='sphere_tracing': its loop ends on a test of the data, so K-step dispatches, "
                  "test views and registrations run as eager loops on the card, not as CUDA graphs")

        self.evaluator = Evaluator(config, self.camera, self.buffers, mesh=self.mesh, pool=self._graph_pool)
        self.ckpt_io = CheckpointIO(self.log_dir)
        self.global_step = 0
        self._load_ckpt()

        # The torch.profiler window ("A-B" step range), if asked for.
        self._profile_range = None
        if config.profile_steps:
            a, b = (int(v) for v in config.profile_steps.split("-"))
            self._profile_range = (a, b)
        self._profiler = None
        self._profile_done = False

    # ------------------------------------------------------------------

    @property
    def is_main_process(self) -> bool:
        return self.mesh.is_main

    def _state_dict(self) -> dict:
        return {
            "step": self.state.step,
            "params": {name: t.detach() for name, t in tree_items(self.state.params)},
            "optimizer": self.optimizer.state_dict(),
            "buffers": dict(tree_items(self.buffers)),
        }

    @torch.no_grad()
    def _load_state_dict(self, saved: dict) -> None:
        """Copy a checkpoint into the live tensors in place, so the train
        steps, the evaluator and Adam keep their references."""
        for what, tree in (("params", self.state.params), ("buffers", self.buffers)):
            live = dict(tree_items(tree))
            if sorted(live) != sorted(saved[what]):
                raise ValueError(f"checkpoint {what} {sorted(saved[what])} do not match the config's {sorted(live)}")
            for name, t in live.items():
                t.copy_(saved[what][name])
        # The learning rates come from the config, as JAX's schedule does,
        # and ``capturable`` from this device (``import_ckpt`` writes a
        # fresh CPU optimizer's state); the checkpoint gives Adam's moments
        # and step.  The load
        # makes new moment tensors, so a captured dispatch would hold stale
        # ones.
        live = [(g["base_lr"], g["lr"], g["capturable"]) for g in self.optimizer.param_groups]
        self.optimizer.load_state_dict(saved["optimizer"])
        for g, (base, lr, capturable) in zip(self.optimizer.param_groups, live):
            g["base_lr"], g["lr"], g["capturable"] = base, lr, capturable
        self.state.step = int(saved["step"])
        self._scan_steps.clear()

    def _load_ckpt(self) -> None:
        """Resume: rank 0 loads the newest checkpoint and broadcasts it with
        its recorded host count; each host restores its own sidecar only if
        that count is its own (JAX's rule)."""
        m = self.mesh
        saved, step, last_hosts = None, None, None
        if m.is_main:
            saved, step = self.ckpt_io.load_newest(self.config.ckpt_path)
            if saved is not None:
                step = int(step) if step is not None else int(saved["step"])
                last_hosts = self.ckpt_io.load_world_size(step)
        saved, step, last_hosts = mesh_lib.broadcast_object(m, (saved, step, last_hosts))
        if saved is None:
            return
        self._load_state_dict(saved)
        self.global_step = step
        if last_hosts is None or last_hosts == m.host_count:
            sidecar = self.ckpt_io.load_rng_sidecar(self.global_step, m.host_index)
            if sidecar is not None:
                self.data_manager.sampler.set_state(sidecar["sampler"])
                self._jitter_seed = int(sidecar["jitter_seed"])

    def _save_ckpt(self) -> None:
        """Rank 0 writes the state and ``meta.json``, each host's first rank
        its sidecar; every rank waits for all of it."""
        m = self.mesh
        self.ckpt_io.save(
            self.global_step,
            self._state_dict() if m.is_main else None,
            rng_sidecar={"sampler": self.data_manager.sampler.get_state(), "jitter_seed": self._jitter_seed}
            if m.local_rank == 0 else None,
            world_size=m.host_count,
            host_index=m.host_index,
            ranks=m.world_size,
        )
        mesh_lib.barrier(m)

    def _merge_registered_raygen(self, baseline: dict, updated: dict, owned_rows: list) -> dict:
        """Every rank's registered raygen rows in one table (JAX's ownership
        merge): each test view is registered by one rank, so each row is
        taken from the rank that owns it as its registration left it, and
        from ``baseline`` where no rank does; the merged tables equal one
        rank registering every view, bit for bit.  Every rank enters, with
        or without views of its own.  -> {name: numpy table}."""
        rows = mesh_lib.all_gather_object_or_array(self.mesh, sorted(owned_rows))
        merged = {}
        for k in sorted(baseline):  # the same collective order on every rank
            tables = mesh_lib.all_gather_object_or_array(self.mesh, updated[k].detach().cpu().numpy())
            out = baseline[k].detach().cpu().numpy().copy()
            for r, own in enumerate(rows):
                out[own] = tables[r][own]
            merged[k] = out
        return merged

    # ------------------------------------------------------------------

    def _maybe_profile(self) -> None:
        """Start or stop the profiler window at a crossing of its ends (on
        rank 0)."""
        if self._profile_range is None or not self.is_main_process:
            return
        a, b = self._profile_range
        if self._profiler is None and not self._profile_done and self.global_step >= a:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            self._profiler = profile(activities=acts)
            self._profiler.__enter__()
        elif self._profiler is not None and self.global_step >= b:
            self._stop_profile()

    def _stop_profile(self) -> None:
        if self._profiler is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._profiler.__exit__(None, None, None)
            out = self.log_dir / "profile"
            out.mkdir(exist_ok=True)
            a, b = self._profile_range
            self._profiler.export_chrome_trace(str(out / f"trace_steps_{a}-{b}.json"))
            self._profiler = None
            self._profile_done = True

    def _in_warmup(self) -> bool:
        return self._step_warmup is not None and self.global_step < self.config.model.geometry_warmup_end

    def _jitter_generator(self, step: int) -> torch.Generator:
        """The generator of step ``step``'s jitter: a function of the jitter
        seed and the step only."""
        return torch.Generator(device=self.device).manual_seed((self._jitter_seed * 2**32 + step) % 2**63)

    def _next_chunk_size(self) -> int:
        """Steps for the next dispatch: ``parallel.steps_per_dispatch``,
        unless the chunk would cross ``geometry_warmup_end`` or ``end_iter``;
        such a partial chunk runs as single steps, so only the one K-step
        dispatch is ever captured (JAX's ``_next_chunk_size``)."""
        k = self.config.parallel.steps_per_dispatch
        if k <= 1:
            return 1
        gs = self.global_step
        limit = self.config.model.end_iter - gs
        wend = self.config.model.geometry_warmup_end
        if self._step_warmup is not None and gs < wend:
            limit = min(limit, wend - gs)
        return k if k <= limit else 1

    def train_iter(self, n_steps: int = 1) -> dict:
        """``n_steps`` train steps from ``global_step`` in one dispatch ->
        the last step's metrics (0-d device tensors)."""
        self._maybe_profile()
        warmup = self._in_warmup()
        if n_steps == 1:
            batch = mesh_lib.shard_batch(self.mesh, self.data_manager.next_train_batch()).to(self.device)
            step_fn = self._step_warmup if warmup else self._step_normal
            self.state, metrics = step_fn(self.state, batch, self._jitter_generator(self.global_step))
            return metrics
        scan_fn = self._scan_steps.get((warmup, n_steps))
        if scan_fn is None:
            scan_fn = self._scan_steps[(warmup, n_steps)] = make_train_step_scan(
                self.config, self.camera, self.buffers, self.optimizer, n_steps=n_steps, geometry_warmup=warmup,
                mesh=self.mesh, pool=self._graph_pool,
            )
        stacked = stack_bundles([self.data_manager.next_train_batch() for _ in range(n_steps)])
        stacked = mesh_lib.shard_batch(self.mesh, stacked, batch_axis=1).to(self.device)
        gens = [self._jitter_generator(self.global_step + i) for i in range(n_steps)]
        self.state, metrics = scan_fn(self.state, stacked, gens)
        return metrics

    @staticmethod
    def _crossed(prev: int, cur: int, interval: int) -> bool:
        return (cur // interval) > (prev // interval)

    def run(self) -> None:
        cfg = self.config
        intervals = cfg.intervals
        if not cfg.evaluation_only:
            last_log_t = time.time()
            last_log_step = self.global_step
            while self.global_step < cfg.model.end_iter:
                n_steps = self._next_chunk_size()
                metrics = self.train_iter(n_steps)
                prev = self.global_step
                self.global_step += n_steps
                gs = self.global_step
                if self._crossed(prev, gs, intervals.log_metrics):
                    m = {k: float(v) for k, v in metrics.items()}
                    now = time.time()
                    steps = gs - last_log_step
                    if steps > 0 and now > last_log_t:
                        m["steps_per_sec"] = steps / (now - last_log_t)
                        m["rays_per_sec"] = m["steps_per_sec"] * self.global_batch
                    last_log_t, last_log_step = now, gs
                    if self.is_main_process:
                        self.logger.log(m, gs)
                if self._crossed(prev, gs, intervals.save_ckpt):
                    self._save_ckpt()
                if self._crossed(prev, gs, intervals.render_test_views):
                    self.render_test_views()
                if self._crossed(prev, gs, intervals.dump_mesh):
                    self.dump_mesh()
                if self._crossed(prev, gs, intervals.render_video):
                    self.render_video()
            self._stop_profile()  # a window left open at end_iter

        self.dump_mesh(resolution=cfg.final_mesh_resolution)
        self.render_test_views(is_final=True)

    # ------------------------------------------------------------------

    def render_test_views(self, is_final: bool = False) -> dict:
        """Register (with pose or light optimization on), render, score and
        dump every ``testset_skip``-th test view (every one at the end),
        strided over the ranks as the original trainer strides them; gather
        the metrics and log their means."""
        m = self.mesh
        total = self.data_manager.test_view_num
        skip = 1 if is_final else self.config.data.testset_skip
        rg = self.config.ray_generator
        rg_on = rg.cam_opt_mode != "off" or rg.pl_opt
        params = self.state.params
        # The tables before registration, equal on every rank: the merge's baseline.
        baseline = {k: v.detach().clone() for k, v in params["raygen"].items()} if rg_on else None
        metrics_list, owned_rows = [], []
        for idx in range(m.rank * skip, total, skip * m.world_size):
            pixels = self.data_manager.get_test_view(idx)
            if rg_on and pixels.rgb_gt is not None:
                owned_rows.append(int(pixels.img_indices.reshape(-1)[0]))
            img_dict, metrics, tensor_dict, params = self.evaluator.get_eval_dicts(params, pixels)
            self._save_dumps(idx, img_dict, tensor_dict)
            if idx == 0 and self.is_main_process:
                for k, v in img_dict.items():
                    self.logger.log_image(k, v * 0.5 + 0.5 if "normal" in k else v, self.global_step)
            metrics_list.append(metrics)

        # The registered rows persist into training, as the original code's
        # in-place ray generator makes them; test rows are never sampled.
        # Copied into the live tensors in place, so Adam keeps them.
        if rg_on:
            registered = self._merge_registered_raygen(baseline, params["raygen"], owned_rows)
            with torch.no_grad():
                for k, t in self.state.params["raygen"].items():
                    t.copy_(torch.as_tensor(registered[k]))

        n_rows = -(-total // (skip * m.world_size))
        all_metrics = _array_to_metrics(mesh_lib.all_gather_object_or_array(m, _metrics_to_array(metrics_list, n_rows)))
        means: dict = {}
        if all_metrics:
            means = {f"val/{k}": float(np.mean([mt[k] for mt in all_metrics])) for k in all_metrics[0]}
            if self.is_main_process:
                self.logger.log(means, self.global_step)
        return means

    def _save_dumps(self, view_idx: int, img_dict: dict, tensor_dict: dict) -> None:
        dump_dir = self.log_dir / "test_views" / f"step_{self.global_step:07d}"
        dump_dir.mkdir(parents=True, exist_ok=True)
        for k, v in img_dict.items():
            if "normal" in k:
                v = v * 0.5 + 0.5
            if v.shape[-1] == 1:
                v = v[..., 0]
            write_png(dump_dir / f"{k}_{view_idx:03d}.png", np.clip(v * 255, 0, 255).astype(np.uint8))
        for k, v in tensor_dict.items():
            np.save(dump_dir / f"{k}_{view_idx:03d}.npy", v)

    # ------------------------------------------------------------------

    def dump_mesh(self, resolution: int = 256) -> Optional[pathlib.Path]:
        """The SDF grid on the device, marching cubes on the host, the OBJ
        to disk (the raw grid as .npy when the marching cubes cannot
        build).  Rank 0 alone; the others return None."""
        if not self.is_main_process:
            return None
        mesh_dir = self.log_dir / "mesh"
        mesh_dir.mkdir(parents=True, exist_ok=True)
        bmin, bmax = [-1.01] * 3, [1.01] * 3
        grid = extract_sdf_grid(self.state.params["renderer"], self.config.model, bmin, bmax, resolution)
        grid = grid.cpu().numpy()
        out_path = mesh_dir / f"step_{self.global_step:07d}_res_{resolution}.obj"
        try:
            from nrhints_torch.eval.mesh_export import marching_cubes_to_obj

            marching_cubes_to_obj(grid, 0.0, bmin, bmax, out_path)
            return out_path
        except Exception as e:
            npy_path = mesh_dir / f"step_{self.global_step:07d}_res_{resolution}_sdfgrid.npy"
            np.save(npy_path, grid)
            print(f"marching cubes unavailable ({e!r}); dumped SDF grid to {npy_path}")
            return npy_path

    # ------------------------------------------------------------------

    def render_video(self) -> None:
        """Render both turntable clips' frames, strided over the ranks;
        rank 0 writes every frame (gathered from the others) as PNGs and
        encodes them.  Frame i + 1 is queued on the device before frame i is
        read back, so a frame's copy to the host overlaps the next frame's
        render.  Every rank enters every gather; one with no frame left
        sends a black one."""
        m = self.mesh
        video_dir = self.log_dir / "video"
        frame_dir = video_dir / f"step_{self.global_step:07d}"
        if self.is_main_process:
            frame_dir.mkdir(parents=True, exist_ok=True)
        bundles = self.data_manager.get_video_pixel_bundles(
            self.config.data.video_frame_num, is_z_up=self.config.data.is_z_up
        )
        params = self.state.params
        n, H, W = bundles.shape
        rounds = -(-n // m.world_size)

        def dispatch(i: int):
            idx = i * m.world_size + m.rank
            return self.evaluator.render_image_async(params, bundles[idx]) if idx < n else None

        pending = dispatch(0) if rounds else None
        for i in range(rounds):
            fin = pending
            if i + 1 < rounds:
                pending = dispatch(i + 1)
            rgb = np.clip(fin()["rgb"] * 255, 0, 255).astype(np.uint8) if fin is not None else \
                np.zeros((H, W, 3), np.uint8)
            frames = mesh_lib.all_gather_object_or_array(m, rgb)
            for r in range(m.world_size):
                if self.is_main_process and i * m.world_size + r < n:
                    write_png(frame_dir / f"{i * m.world_size + r:03d}.png", frames[r])
        if self.is_main_process:
            self._encode_videos(frame_dir, video_dir, n)

    def _encode_videos(self, frame_dir, video_dir, n_frames: int) -> None:
        """The two clips as mp4 through imageio where it can, else the PNG
        frames stay the result."""
        frames = []
        for idx in range(n_frames):
            p = frame_dir / f"{idx:03d}.png"
            if not p.exists():
                print(f"video frame {idx} missing; skipping mp4 encode")
                return
            frames.append(read_png(p))
        video = np.stack(frames)
        half = self.config.data.video_frame_num
        try:
            import imageio.v3 as iio

            iio.imwrite(video_dir / f"step_{self.global_step:06d}_rot_view.mp4", video[:half], fps=30)
            iio.imwrite(video_dir / f"step_{self.global_step:06d}_rot_light.mp4", video[half:], fps=30)
        except Exception as e:
            print(f"mp4 encode unavailable ({e!r}); PNG frames kept in {frame_dir}")


_METRIC_KEYS = ("psnr", "ssim", "lpips")
JOIN_POLL_S = 60.0


def _metrics_to_array(metrics_list, n_rows: int) -> np.ndarray:
    """Metric dicts -> [n_rows, 3] f64 (psnr, ssim, lpips) for a gather, the
    same shape on every rank: rows past a rank's views and absent metrics
    are NaN (JAX's ``_metrics_to_array``, in f64)."""
    arr = np.full((max(n_rows, 1), len(_METRIC_KEYS)), np.nan)
    for i, mt in enumerate(metrics_list):
        for j, k in enumerate(_METRIC_KEYS):
            if k in mt:
                arr[i, j] = mt[k]
    return arr


def _array_to_metrics(arr) -> list:
    """Gathered rows -> the metric dicts of the views, NaN left out."""
    out = []
    for row in np.asarray(arr).reshape(-1, len(_METRIC_KEYS)):
        mt = {k: float(v) for k, v in zip(_METRIC_KEYS, row) if np.isfinite(v)}
        if mt:
            out.append(mt)
    return out


def devices_wanted(config: SystemConfig, device) -> int:
    """The ranks ``parallel.data_axis_size`` asks for on ``device``: -1 is
    every visible card on the card and one process on the CPU; more cards
    than are visible raise ``ValueError``."""
    n = config.parallel.data_axis_size
    if torch.device(device).type == "cuda":
        visible = torch.cuda.device_count()
        n = visible if n == -1 else n
        if n > visible:
            raise ValueError(f"data_axis_size {n} > the {visible} visible card(s)")
    elif n == -1:
        n = 1
    if n < 1:
        raise ValueError(f"data_axis_size must be -1 or at least 1, got {config.parallel.data_axis_size}")
    return n


def _spawned_rank(rank: int, config: SystemConfig, device: str, init_method: str, world_size: int) -> None:
    """One rank of ``launch``'s workers: join the group, train, leave.  The
    trainer and its CUDA graphs go before the group: NCCL does not destroy
    a communicator that a live graph's kernels still use.  A rank that
    fails leaves its group as it is (a peer may be waiting in a
    collective); ``launch`` then stops every rank."""
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    mesh_lib.initialize_multihost(init_method, rank, world_size, device=device)
    _train(config, device)
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()  # the freed graphs release their NCCL resources
    dist.destroy_process_group()


def _train(config: SystemConfig, device: str) -> None:
    Trainer(config, device=device).run()


def launch(config: SystemConfig, device="cuda") -> Optional[Trainer]:
    """Build a trainer and run it, on as many ranks as the config asks for.

    * Under torchrun, or with ``parallel.multihost``: join the group torchrun
      describes and run this rank's trainer -> the trainer.
    * Else, where ``data_axis_size`` resolves to more than one device: start
      one worker a device (``torch.multiprocessing``, spawn; a ``file://``
      rendezvous in the run directory; NCCL on "cuda", gloo on "cpu"),
      join them, and raise if any fails -> None, as the original launcher
      did.
    * With one device, one trainer in this process -> the trainer."""
    device = resolve_device(device)
    if mesh_lib.under_torchrun() and not dist.is_initialized():
        mesh_lib.initialize_multihost(device=device)
    n = 1 if dist.is_initialized() or config.parallel.multihost else devices_wanted(config, device)
    if n == 1:
        trainer = Trainer(config, device=device)
        trainer.run()
        return trainer
    run_dir = pathlib.Path(config.base_dir) / config.exp_name / config.scene_name
    run_dir.mkdir(parents=True, exist_ok=True)
    rendezvous = (run_dir / f".rendezvous_{uuid.uuid4().hex}").resolve()
    try:
        ctx = torch.multiprocessing.start_processes(
            _spawned_rank, args=(config, device.type, f"file://{rendezvous}", n), nprocs=n, join=False,
            start_method="spawn")
        while not ctx.join(timeout=JOIN_POLL_S):
            pass
    finally:
        rendezvous.unlink(missing_ok=True)
    return None
