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
    """Data parallelism over ranks, one process a card (``parallel/mesh.py``;
    the JAX package's mesh settings, rewritten for ranks)."""

    data_axis_size: int = -1
    """Ranks on the 'data' axis: -1 = every visible card on "cuda" (one
    process on "cpu"); any other value must be the world size.  Above one,
    ``python -m nrhints_torch`` starts one rank per device itself
    (``train/trainer.py::launch``); under torchrun it must equal
    torchrun's world size."""
    sample_axis_size: int = 1
    """Ranks on the 'sample' axis (JAX's): above 1 the ranks form a
    (data, sample) grid (``parallel/mesh.py::make_mesh``), each sample group
    of this many ranks splitting the marches' samples (or, on the fused
    route, its rays) and all-gathering them, and the gradients summed over
    the data group; the world size must be this times the 'data' axis's
    ranks."""
    scale_global_batch: bool = False
    """If True, global batch = batch_size * world size (the original code
    keeps the global batch constant whatever the world size; that is the
    default here too).  512 rays over 4 cards leave 128 rays a card;
    scaling the batch is how more cards train faster per step."""
    batch_scale_lr_rule: str = "linear"
    """LR compensation when scale_global_batch multiplies the batch by k:
    "linear" (lr *= k), "sqrt" (lr *= sqrt(k)), or "none"."""
    multihost: bool = False
    """Join the process group torchrun describes (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``) before building the mesh; ``launch`` does so
    under torchrun whatever this says."""
    steps_per_dispatch: int = 1
    """Train steps a dispatch: K > 1 runs K steps as one CUDA graph replay
    on the card, bit for bit the single steps (on the CPU, K eager steps).
    Under NCCL the graph holds the steps' collectives; a gloo group on the
    card cannot be captured and raises.  Interval hooks fire when a
    dispatch crosses the interval boundary."""


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
