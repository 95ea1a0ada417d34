"""The port's importer of the original code's checkpoints
(``nrhints_torch/import_ckpt.py``) against the JAX package's
(``scripts/import_reference_ckpt.py``, loaded by path), on fake
checkpoints of the original format (``chip_smoke.reference_state_dict``:
the original code's key names, shapes taken from a fresh init of a tiny
config, weights stored [out, in], weight norm's g as [out, 1], random
values), so no checkout of the original code is needed.  The conversion
must equal JAX's (through ``convert.params_from_jax``) bit for bit; a
structure or shape mismatch is refused; the port's Trainer on the CPU
resumes from the imported step with those weights bit for bit and takes a
step."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import reference_state_dict
from nrhints_torch import import_ckpt
from nrhints_torch.configs import config as tconf
from nrhints_torch.convert import params_from_jax
from nrhints_torch.data.synthetic import make_hints_scene
from nrhints_torch.utils import tree_items
from tests.torch_port_utils import N_RAYS, model_configs

REPO = Path(__file__).resolve().parents[1]
SPLITS = (4, 1, 2)  # 7 images


def _jax_importer():
    spec = importlib.util.spec_from_file_location("import_reference_ckpt", REPO / "scripts" / "import_reference_ckpt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config(base_dir, scene=None, bg: bool = False, pl_opt: bool = True, **model_kw):
    """The tiny model (f32 march) in the nr-hints-cam-opt preset with light
    deltas, optionally with the background NeRF at a tiny width."""
    kw = {"bg_kw": dict(d_hidden=16, n_layers=2, skips=()), "use_outside_nerf": True} if bg else {}
    _, tm = model_configs(march_dtype="float32", **kw)
    cfg = tconf.PRESETS["nr-hints-cam-opt"]()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(tm, warm_up_end=2, end_iter=1000, anneal_end=0, batch_size=N_RAYS, **model_kw),
        data=dataclasses.replace(cfg.data, path=str(scene or ""), video_frame_num=1),
        parallel=dataclasses.replace(cfg.parallel, data_axis_size=1),
        ray_generator=dataclasses.replace(cfg.ray_generator, pl_opt=pl_opt),
        base_dir=str(base_dir), exp_name="imported", scene_name="scene",
    )


def _reference_state_dict(cfg, n_images: int, seed: int, prefix: str = "", noise: bool = False) -> dict:
    """``chip_smoke.reference_state_dict`` with the noise buffers and a key
    prefix."""
    sd = reference_state_dict(cfg, n_images, seed)
    if noise:
        g = torch.Generator().manual_seed(seed + 1)
        sd["ray_generator.cam_pose_noise"] = torch.randn((n_images, 4, 4), generator=g)
        sd["ray_generator.pl_noise"] = torch.randn((n_images, 3), generator=g)
    return {prefix + k: v for k, v in sd.items()}


def _write(path, sd, step=123):
    torch.save({"world_size": 1, "global_step": step, "pipeline": sd, "optimizer": {}, "scheduler": {}}, path)
    return path


@pytest.mark.parametrize("prefix,bg,noise", [("", False, False), ("module.", True, True)],
                         ids=["plain", "ddp-prefix-bg-noise"])
def test_conversion_matches_jax(tmp_path, prefix, bg, noise):
    """The port's conversion against ``params_from_jax`` of JAX's
    ``convert_pipeline_state_dict`` on the same dict, bit for bit, with and
    without a DistributedDataParallel ``module.`` prefix, the background
    NeRF and the noise buffers."""
    sd = _reference_state_dict(_config(tmp_path, bg=bg), 7, seed=1, prefix=prefix, noise=noise)
    params, buffers = import_ckpt.convert_pipeline_state_dict(sd)
    j_params, j_buffers = _jax_importer().convert_pipeline_state_dict(sd)
    want = params_from_jax(j_params, device="cpu")
    got_items, want_items = dict(tree_items(params)), dict(tree_items(want))
    assert sorted(got_items) == sorted(want_items)
    assert ("/renderer/bg/rgb/w" in got_items) == bg and "/raygen/pl_adjustment" in got_items
    for name, t in want_items.items():
        assert got_items[name].dtype == torch.float32 and torch.equal(got_items[name], t), name
    assert sorted(buffers) == sorted(j_buffers) == (["cam_pose_noise", "pl_noise"] if noise else [])
    for k, v in j_buffers.items():
        assert torch.equal(buffers[k], torch.as_tensor(v)), k


def test_import_refuses_a_mismatched_config(tmp_path):
    """A config whose structure (no light deltas, or a background NeRF the
    checkpoint lacks) or whose widths differ from the checkpoint's is
    refused with JAX's messages, and nothing is written; so is the full
    preset through ``main``."""
    cfg = _config(tmp_path / "runs")
    path = _write(tmp_path / "scene_step_0000123.ckpt", _reference_state_dict(cfg, 7, seed=2))
    bad = [
        (_config(tmp_path / "runs", pl_opt=False), "does not match"),
        (_config(tmp_path / "runs", bg=True), "does not match"),
        (dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, reflectance_network=dataclasses.replace(cfg.model.reflectance_network, d_hidden=48))),
         "shape mismatch at /renderer/color/lin0"),
    ]
    for c, match in bad:
        with pytest.raises(SystemExit, match=match):
            import_ckpt.import_checkpoint(path, c, device="cpu")
    with pytest.raises(SystemExit, match="does not match"):
        import_ckpt.main([str(path), "config:nr-hints-cam-opt", "--config.base-dir", str(tmp_path / "runs")],
                         device="cpu")
    assert not (tmp_path / "runs" / "imported" / "scene" / "ckpt" / "step_0000123").exists()


def test_trainer_resumes_from_the_imported_step(tmp_path):
    """Import on the CPU, then the port's Trainer on the CPU: it resumes at
    the checkpoint's step with the converted weights bit for bit, Adam
    fresh and its buffers the Trainer's, and takes a step with a finite
    loss."""
    from nrhints_torch.train.trainer import Trainer

    scene = make_hints_scene(tmp_path / "scene", *SPLITS, H=16, W=16)
    cfg = _config(tmp_path / "runs", scene)
    sd = _reference_state_dict(cfg, 7, seed=3)
    out = import_ckpt.import_checkpoint(_write(tmp_path / "ref.ckpt", sd), cfg, device="cpu")
    assert out == tmp_path / "runs" / "imported" / "scene" / "ckpt" / "step_0000123" and (out / "state.pt").exists()
    saved = torch.load(out / "state.pt", weights_only=True)
    assert sorted(saved) == ["buffers", "optimizer", "params", "step"] and saved["optimizer"]["state"] == {}
    assert all(t.device.type == "cpu" for t in saved["params"].values())

    trainer = Trainer(cfg, device="cpu")
    assert trainer.global_step == trainer.state.step == 123
    converted = dict(tree_items(import_ckpt.convert_pipeline_state_dict(sd)[0]))
    live = dict(tree_items(trainer.state.params))
    assert sorted(live) == sorted(converted)
    for name, t in converted.items():
        assert torch.equal(live[name].detach(), t), name
    assert not trainer.optimizer.state and not trainer.optimizer.param_groups[0]["capturable"]
    metrics = trainer.train_iter()
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.equal(trainer.state.params["renderer"]["sdf"]["lin0"]["v"].detach(),
                           converted["/renderer/sdf/lin0/v"])
