"""System configuration and the three presets (port of
``nrhints_tpu/configs/config.py``); ``configs/cli.py`` sets any leaf from
the command line."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from nrhints_torch.camera.rays import RayGeneratorConfig
from nrhints_torch.data.manager import DataManagerConfig
from nrhints_torch.render.renderer import ModelConfig, RendererConfig


@dataclass(frozen=True)
class IntervalsConfig:
    log_metrics: int = 200
    save_ckpt: int = 5_000
    render_test_views: int = 250_000
    render_video: int = 1_000_000
    dump_mesh: int = 500_000


@dataclass(frozen=True)
class ParallelConfig:
    """Distribution settings; only their defaults (one device, no scaled
    batch) are meaningful until the parallel slice."""

    data_axis_size: int = -1
    sample_axis_size: int = 1
    scale_global_batch: bool = False
    batch_scale_lr_rule: str = "linear"
    multihost: bool = False
    steps_per_dispatch: int = 1


@dataclass(frozen=True)
class SystemConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataManagerConfig = field(default_factory=DataManagerConfig)
    ray_generator: RayGeneratorConfig = field(default_factory=RayGeneratorConfig)
    intervals: IntervalsConfig = field(default_factory=IntervalsConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    ckpt_path: Optional[str] = None
    base_dir: str = "outputs"
    exp_name: str = "baseline"
    scene_name: str = "scene"
    seed: int = 3407
    evaluation_only: bool = False
    final_mesh_resolution: int = 1024
    profile_steps: Optional[str] = None
    use_wandb: bool = False


def nr_hints() -> SystemConfig:
    """NeuS Relighting with Hints."""
    return SystemConfig()


def nr_hints_cam_opt() -> SystemConfig:
    """NeuS Relighting with Hints and Camera Optimization."""
    return SystemConfig(ray_generator=RayGeneratorConfig(cam_opt_mode="SO3xR3"))


def pl_naive() -> SystemConfig:
    """NeuS Relighting with Naive Point Light (no hints)."""
    return SystemConfig(model=ModelConfig(renderer=RendererConfig(shadow_hint=False, specular_hint=False)))


PRESETS = {
    "nr-hints": nr_hints,
    "nr-hints-cam-opt": nr_hints_cam_opt,
    "pl-naive": pl_naive,
}

DEFAULT_PRESET = "nr-hints-cam-opt"
