"""Import a checkpoint of the original PyTorch NRHints code into a run
directory of this package:

    python -m nrhints_torch.import_ckpt path/to/Cat_step_1000000.ckpt config:nr-hints-cam-opt \\
        --config.exp-name baseline --config.scene-name Cat [--config...]

The original code saves ``torch.save({world_size, global_step, pipeline,
optimizer, scheduler})``.  This converts ``pipeline``, the state dict of
the renderer and the ray generator, into this package's parameter tree
(the keys ``convert.params_from_jax`` gives), checks it against a fresh
``init_model_params`` and ``ray_generator_init`` of the given config
(structure and every leaf's shape, the per-image raygen tables at the
checkpoint's image count), and writes a checkpoint step at
``base_dir/exp_name/scene_name`` that the Trainer resumes from.  The config
must describe the architecture the checkpoint was trained with (the presets
are the original code's); any mismatch is refused.  Adam's moments and the
learning-rate schedule are not imported: the step holds a fresh
optimizer's state, so Adam restarts on resume.  The synthetic noise
buffers ``cam_pose_noise`` / ``pl_noise``, if any, go beside the step as
``imported_noise_buffers.npz``; the Trainer draws its own from
``--config.seed``.  The conversion is the JAX package's importer
(``scripts/import_reference_ckpt.py``), kept here as a copy of its own.

It builds and checks on the card unless ``import_checkpoint`` or ``main``
is given ``device="cpu"``; what it writes is on the CPU, as every
checkpoint of ``train/checkpoint.py``.
"""
from __future__ import annotations

import pathlib
import sys
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from nrhints_torch.utils import resolve_device, tree_items, tree_map


def _strip_prefix(sd: dict, prefix: str = "module.") -> dict:
    """Drop a DistributedDataParallel ``module.`` prefix if present."""
    if any(k.startswith(prefix) for k in sd):
        return {k[len(prefix) :] if k.startswith(prefix) else k: v for k, v in sd.items()}
    return sd


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32)


def _wn_linear(sd: dict, key: str) -> dict:
    """A weight-normed ``nn.Linear``'s entries -> {"v": [in, out], "g":
    [out], "b": [out]}."""
    return {
        "v": _f32(sd[f"{key}.weight_v"]).t().contiguous(),
        "g": _f32(sd[f"{key}.weight_g"]).reshape(-1).clone(),
        "b": _f32(sd[f"{key}.bias"]).clone(),
    }


def _linear(sd: dict, key: str) -> dict:
    return {"w": _f32(sd[f"{key}.weight"]).t().contiguous(), "b": _f32(sd[f"{key}.bias"]).clone()}


def _count(sd: dict, prefix: str, field: int) -> int:
    """How many distinct names follow ``prefix`` at dot-separated ``field``."""
    return len({k.split(".")[field] for k in sd if k.startswith(prefix)})


def convert_pipeline_state_dict(sd: dict) -> tuple[dict, dict]:
    """The original code's ``pipeline.state_dict()`` -> (params {"renderer",
    "raygen"} of f32 CPU tensors, the synthetic noise buffers).  The SDF
    network's hidden ``lin{i}`` and its ``out_sdf`` / ``out_feat`` heads and
    the colour network's ``lin{i}`` are weight-normed; the background
    NeRF's layers are plain; ``deviation_network.variance`` is the
    variance."""
    sd = _strip_prefix(sd)
    sdf = {f"lin{i}": _wn_linear(sd, f"renderer.sdf_network.lin{i}")
           for i in range(_count(sd, "renderer.sdf_network.lin", 2))}
    sdf["out_sdf"] = _wn_linear(sd, "renderer.sdf_network.out_sdf")
    sdf["out_feat"] = _wn_linear(sd, "renderer.sdf_network.out_feat")
    color = {f"lin{i}": _wn_linear(sd, f"renderer.color_network.lin{i}")
             for i in range(_count(sd, "renderer.color_network.lin", 2))}
    renderer = {"sdf": sdf, "variance": {"variance": _f32(sd["renderer.deviation_network.variance"]).clone()},
                "color": color}
    if any(k.startswith("renderer.outside_nerf.") for k in sd):
        nerf = "renderer.outside_nerf"
        bg = {f"pts_lin{i}": _linear(sd, f"{nerf}.pts_linears.{i}")
              for i in range(_count(sd, f"{nerf}.pts_linears.", 3))}
        bg["views_lin0"] = _linear(sd, f"{nerf}.views_linears.0")
        bg["feature"] = _linear(sd, f"{nerf}.feature_linear")
        bg["alpha"] = _linear(sd, f"{nerf}.alpha_linear")
        bg["rgb"] = _linear(sd, f"{nerf}.rgb_linear")
        renderer["bg"] = bg
    raygen = {name: _f32(sd[f"ray_generator.{name}"]).clone() for name in ("cam_pose_adjustment", "pl_adjustment")
              if f"ray_generator.{name}" in sd}
    noise = {name: _f32(sd[f"ray_generator.{name}"]).clone() for name in ("cam_pose_noise", "pl_noise")
             if f"ray_generator.{name}" in sd}
    return {"renderer": renderer, "raygen": raygen}, noise


def _load(ckpt_path) -> dict:
    try:
        return torch.load(ckpt_path, map_location="cpu", weights_only=True)
    except Exception:
        # An older pickle (the scheduler entry, say) may need full
        # unpickling; the file is the user's own training artifact.
        warnings.warn("weights_only load failed; falling back to full unpickle")
        return torch.load(ckpt_path, map_location="cpu", weights_only=False)


def check_against_config(params: dict, want: dict) -> None:
    """Refuse (``SystemExit``) a converted tree whose structure or any leaf
    shape differs from ``want``, a fresh init of the config."""
    got_items, want_items = dict(tree_items(params)), dict(tree_items(want))
    if sorted(got_items) != sorted(want_items):
        raise SystemExit(
            "checkpoint structure does not match the given config:\n"
            f"  checkpoint: {sorted(got_items)}\n  config:     {sorted(want_items)}\n"
            "Pick the preset/flags the scene was trained with (e.g. config:nr-hints-cam-opt for real scenes, "
            "--config.model.renderer.use-outside-nerf True for black-background captures)."
        )
    for name, t in got_items.items():
        if tuple(t.shape) != tuple(want_items[name].shape):
            raise SystemExit(f"shape mismatch at {name}: checkpoint {tuple(t.shape)} vs config "
                             f"{tuple(want_items[name].shape)}")


def import_checkpoint(ckpt_path, cfg, step: Optional[int] = None, device="cuda") -> pathlib.Path:
    """Convert ``ckpt_path``, check it against ``cfg`` on ``device`` and
    write it as checkpoint step ``step`` (default: the checkpoint's
    ``global_step``) of ``cfg``'s run directory -> that step's directory.
    The step holds the Trainer's layout: the step, the params by their
    ``tree_items`` names, a fresh optimizer's state and the buffers the
    Trainer builds for the config, at the checkpoint's image count."""
    from nrhints_torch.camera.rays import ray_generator_init
    from nrhints_torch.render.renderer import init_model_params
    from nrhints_torch.train.checkpoint import CheckpointIO
    from nrhints_torch.train.step import make_optimizer

    device = resolve_device(device)
    blob = _load(ckpt_path)
    params, noise = convert_pipeline_state_dict(blob["pipeline"])
    step = int(blob.get("global_step", 0)) if step is None else int(step)
    tables = [*params["raygen"].values(), *noise.values()]
    n_images = tables[0].shape[0] if tables else 1

    # The Trainer's draws: the fields, then the ray generator's buffers.
    gen = torch.Generator().manual_seed(cfg.seed)
    want = {"renderer": init_model_params(cfg.model, gen, device=device)}
    want["raygen"], buffers = ray_generator_init(gen, cfg.ray_generator, n_images, device=device)
    check_against_config(params, want)
    params = tree_map(params, lambda t: t.to(device))

    state = {
        "step": step,
        "params": {name: t.detach().cpu() for name, t in tree_items(params)},
        "optimizer": make_optimizer(cfg, tree_map(params, lambda t: t.detach().cpu().clone())).state_dict(),
        "buffers": {name: t.cpu() for name, t in tree_items(buffers)},
    }
    io = CheckpointIO(pathlib.Path(cfg.base_dir) / cfg.exp_name / cfg.scene_name)
    io.save(step, state, world_size=1)
    out = io.ckpt_dir / f"step_{step:07d}"
    if noise:
        np.savez(out / "imported_noise_buffers.npz", **{k: v.numpy() for k, v in noise.items()})
        warnings.warn(
            "checkpoint carries synthetic pose/pl noise buffers; saved to "
            f"{out / 'imported_noise_buffers.npz'}. The trainer regenerates noise from --config.seed: rendering "
            "with the exact trained noise requires matching the original seed (noise ablations only; released "
            "scene checkpoints train without noise)."
        )
    print(f"imported step {step} -> {out}")
    return out


def main(argv: Optional[Sequence[str]] = None, *, device="cuda") -> pathlib.Path:
    """``python -m nrhints_torch.import_ckpt <ckpt> [config:<preset>]
    --config.<path> <value> ...`` -> the written step's directory."""
    from nrhints_torch.configs.cli import parse_cli
    from nrhints_torch.configs.config import DEFAULT_PRESET, PRESETS

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        raise SystemExit(0)
    return import_checkpoint(argv[0], parse_cli(PRESETS, DEFAULT_PRESET, argv[1:]), device=device)


if __name__ == "__main__":
    main()
