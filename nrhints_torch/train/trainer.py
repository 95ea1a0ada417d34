"""Training orchestration (port of ``nrhints_tpu/train/trainer.py``, one
process on one device): the run directory, the train loop with hooks that
fire when the step crosses an interval (log, checkpoint, test views, mesh,
video), resume, and a profiler window.

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

Not ported yet (``NotImplementedError``): several processes or devices
(``parallel.multihost``, ``data_axis_size`` or ``sample_axis_size`` > 1)
and ``scale_global_batch``.
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Optional

import numpy as np
import torch

from nrhints_torch.camera.rays import ray_generator_init
from nrhints_torch.configs.cli import config_to_dict
from nrhints_torch.configs.config import SystemConfig
from nrhints_torch.data.manager import DataManager
from nrhints_torch.data.parser import SceneData, parse_load_nr_data
from nrhints_torch.data.png import read_png, write_png
from nrhints_torch.eval.evaluator import Evaluator
from nrhints_torch.render.renderer import extract_sdf_grid, init_model_params
from nrhints_torch.train.checkpoint import CheckpointIO
from nrhints_torch.train.logging import MetricsLogger
from nrhints_torch.train.step import (
    TrainState, init_train_state, make_optimizer, make_train_step, make_train_step_scan, stack_bundles,
)
from nrhints_torch.utils import resolve_device, tree_items


def check_single_device(config: SystemConfig) -> None:
    """Raise for the parallel settings the port does not have yet."""
    p = config.parallel
    later = {
        "parallel.multihost": p.multihost,
        "parallel.data_axis_size > 1": p.data_axis_size > 1,
        "parallel.sample_axis_size > 1": p.sample_axis_size > 1,
        "parallel.scale_global_batch": p.scale_global_batch,
    }
    missing = [name for name, hit in later.items() if hit]
    if missing:
        raise NotImplementedError(
            "nrhints_torch's trainer runs one process on one device; not ported: " + ", ".join(missing)
        )


class Trainer:
    def __init__(self, config: SystemConfig, scene: Optional[SceneData] = None, *, device="cuda"):
        check_single_device(config)
        self.config = config
        self.device = resolve_device(device)

        self.log_dir = pathlib.Path(config.base_dir) / config.exp_name / config.scene_name
        self.log_dir.mkdir(parents=True, exist_ok=True)
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
        self.global_batch = config.model.batch_size
        self.data_manager = DataManager(
            scene,
            batch_size=self.global_batch,
            strategy=config.data.pixel_sampling_strategy,
            training_view_num_limit=config.data.view_num_limit,
            image_idx_rng_seed=config.seed,
            pixel_idx_rng_seed=config.seed,
        )

        gen = torch.Generator().manual_seed(config.seed)
        params = {"renderer": init_model_params(config.model, gen, device=self.device)}
        params["raygen"], self.buffers = ray_generator_init(
            gen, config.ray_generator, scene.total_image_num, device=self.device
        )
        self.optimizer = make_optimizer(config, params)
        self.state: TrainState = init_train_state(params, self.optimizer)
        self._jitter_seed = config.seed

        self._step_normal = make_train_step(config, self.camera, self.buffers, self.optimizer, geometry_warmup=False)
        self._step_warmup = (
            make_train_step(config, self.camera, self.buffers, self.optimizer, geometry_warmup=True)
            if config.model.geometry_warmup_end > 0
            else None
        )
        # K-step dispatches, built at first use, keyed by (geometry_warmup,
        # n_steps); on the card their graphs and the evaluator's share a pool.
        self._scan_steps: dict[tuple, object] = {}
        self._graph_pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None

        self.evaluator = Evaluator(config, self.camera, self.buffers, device=self.device, pool=self._graph_pool)
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
        # The learning rates come from the config, as JAX's schedule does;
        # the checkpoint gives Adam's moments and step.  The load makes new
        # moment tensors, so a captured dispatch would hold stale ones.
        live = [(g["base_lr"], g["lr"]) for g in self.optimizer.param_groups]
        self.optimizer.load_state_dict(saved["optimizer"])
        for g, (base, lr) in zip(self.optimizer.param_groups, live):
            g["base_lr"], g["lr"] = base, lr
        self.state.step = int(saved["step"])
        self._scan_steps.clear()

    def _load_ckpt(self) -> None:
        saved, step = self.ckpt_io.load_newest(self.config.ckpt_path)
        if saved is None:
            return
        self._load_state_dict(saved)
        self.global_step = int(step) if step is not None else self.state.step
        last_world = self.ckpt_io.load_world_size(self.global_step)
        if last_world is None or last_world == 1:
            sidecar = self.ckpt_io.load_rng_sidecar(self.global_step)
            if sidecar is not None:
                self.data_manager.sampler.set_state(sidecar["sampler"])
                self._jitter_seed = int(sidecar["jitter_seed"])

    def _save_ckpt(self) -> None:
        self.ckpt_io.save(
            self.global_step,
            self._state_dict(),
            rng_sidecar={"sampler": self.data_manager.sampler.get_state(), "jitter_seed": self._jitter_seed},
            world_size=1,
        )

    @staticmethod
    def _merge_registered_raygen(baseline: dict, updated: dict, owned_rows: list) -> dict:
        raise NotImplementedError("merging registered raygen rows across hosts: the multi-host trainer is a later slice")

    # ------------------------------------------------------------------

    def _maybe_profile(self) -> None:
        """Start or stop the profiler window at a crossing of its ends."""
        if self._profile_range is None:
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
            batch = self.data_manager.next_train_batch().to(self.device)
            step_fn = self._step_warmup if warmup else self._step_normal
            self.state, metrics = step_fn(self.state, batch, self._jitter_generator(self.global_step))
            return metrics
        scan_fn = self._scan_steps.get((warmup, n_steps))
        if scan_fn is None:
            scan_fn = self._scan_steps[(warmup, n_steps)] = make_train_step_scan(
                self.config, self.camera, self.buffers, self.optimizer, n_steps=n_steps, geometry_warmup=warmup,
                pool=self._graph_pool,
            )
        stacked = stack_bundles([self.data_manager.next_train_batch() for _ in range(n_steps)]).to(self.device)
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
        dump every ``testset_skip``-th test view (every one at the end);
        log the metric means."""
        skip = 1 if is_final else self.config.data.testset_skip
        rg = self.config.ray_generator
        params = self.state.params
        metrics_list = []
        for idx in range(0, self.data_manager.test_view_num, skip):
            pixels = self.data_manager.get_test_view(idx)
            img_dict, metrics, tensor_dict, params = self.evaluator.get_eval_dicts(params, pixels)
            self._save_dumps(idx, img_dict, tensor_dict)
            if idx == 0:
                for k, v in img_dict.items():
                    self.logger.log_image(k, v * 0.5 + 0.5 if "normal" in k else v, self.global_step)
            metrics_list.append(metrics)

        # The registered rows persist into training, as the original code's
        # in-place ray generator makes them; test rows are never sampled.
        if metrics_list and (rg.cam_opt_mode != "off" or rg.pl_opt):
            with torch.no_grad():
                for k, t in self.state.params["raygen"].items():
                    t.copy_(params["raygen"][k])

        all_metrics = [m for m in metrics_list if m]
        means: dict = {}
        if all_metrics:
            means = {f"val/{k}": float(np.mean([m[k] for m in all_metrics])) for k in all_metrics[0]}
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
        build)."""
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
        """Render both turntable clips' frames to PNGs, then encode them.
        Frame i + 1 is queued on the device before frame i is read back, so
        a frame's copy to the host overlaps the next frame's render."""
        video_dir = self.log_dir / "video"
        frame_dir = video_dir / f"step_{self.global_step:07d}"
        frame_dir.mkdir(parents=True, exist_ok=True)
        bundles = self.data_manager.get_video_pixel_bundles(
            self.config.data.video_frame_num, is_z_up=self.config.data.is_z_up
        )
        params = self.state.params
        n = len(bundles)
        pending = self.evaluator.render_image_async(params, bundles[0]) if n else None
        for idx in range(n):
            fin = pending
            if idx + 1 < n:
                pending = self.evaluator.render_image_async(params, bundles[idx + 1])
            rgb = np.clip(fin()["rgb"] * 255, 0, 255).astype(np.uint8)
            write_png(frame_dir / f"{idx:03d}.png", rgb)
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


def launch(config: SystemConfig, device="cuda") -> Trainer:
    """Build a trainer and run it."""
    trainer = Trainer(config, device=device)
    trainer.run()
    return trainer
