"""The trajectory gate (slow tier): a few hundred steps of the port's
Trainer against the JAX package's Trainer on the CPU, on the procedural
hints scene at PARITY.md's trajectory geometry (16 + 2 x 8 camera samples,
16 + 16 shadow samples) and the tiny MLP of torch_port_utils.py.

Both Trainers start from JAX's initial parameters and draw the same pixel
batches (their samplers share the seed), but each draws its own jitter, so
the yardstick is a control: JAX's Trainer against itself under another
jitter key.  The port's smoothed loss and PSNR curves must stay within
three times the control's largest gap (with absolute floors, as
tests/test_trajectory_parity.py holds the JAX package to the original
code), and both must train: the loss falls.  ``NRHINTS_TORCH_TRAJ_STEPS``
overrides the 300 steps.
"""
from __future__ import annotations

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from nrhints_torch.configs import config as tconf
from nrhints_torch.convert import params_from_jax
from nrhints_torch.data.synthetic import make_hints_scene
from nrhints_torch.train import trainer as ttrainer
from nrhints_torch.utils import tree_items
from nrhints_tpu.configs import config as jconf
from tests.torch_port_utils import model_configs

pytestmark = pytest.mark.slow

PARITY = dict(n_samples=16, n_importance_samples=16, up_sample_steps=2, n_shadow_samples=16,
              n_shadow_importance_samples=16)
BATCH, HW, WINDOW = 48, 32, 50


def _configs(scene_dir, base_dir, steps: int):
    jm, tm = model_configs(march_dtype="float32", **PARITY)
    sched = dict(warm_up_end=0, end_iter=steps, anneal_end=steps // 2, batch_size=BATCH)
    iv = dict(log_metrics=1, save_ckpt=10**7, render_test_views=10**7, render_video=10**7, dump_mesh=10**7)
    out = []
    for conf, m in ((jconf, jm), (tconf, tm)):
        cfg = conf.PRESETS["nr-hints"]()
        out.append(dataclasses.replace(
            cfg, model=dataclasses.replace(m, **sched), intervals=conf.IntervalsConfig(**iv),
            data=dataclasses.replace(cfg.data, path=str(scene_dir), video_frame_num=1),
            parallel=dataclasses.replace(cfg.parallel, data_axis_size=1), base_dir=str(base_dir),
        ))
    return out


def _curves(trainer) -> dict:
    lines = [json.loads(x) for x in (trainer.log_dir / "metrics.jsonl").read_text().splitlines()]
    return {k: np.array([r[k] for r in lines if k in r]) for k in ("loss", "psnr")}


def _smooth(x):
    return np.convolve(x, np.ones(WINDOW) / WINDOW, mode="valid")


def _gap(a: dict, b: dict, k: str) -> float:
    return float(np.abs(_smooth(a[k]) - _smooth(b[k])).max())


def _no_final_eval(trainer):
    trainer.dump_mesh = lambda resolution=256: None
    trainer.render_test_views = lambda is_final=False: {}
    return trainer


def test_trainer_trajectory_within_jax_control_band(tmp_path):
    from nrhints_tpu.train.trainer import Trainer as JTrainer

    steps = int(os.environ.get("NRHINTS_TORCH_TRAJ_STEPS", "300"))
    scene = make_hints_scene(tmp_path / "scene", 6, 1, 2, H=HW, W=HW)
    jcfg, tcfg = _configs(scene, tmp_path / "runs", steps)
    ref = _no_final_eval(JTrainer(dataclasses.replace(jcfg, exp_name="jax")))
    ctrl = _no_final_eval(JTrainer(dataclasses.replace(jcfg, exp_name="jax-control")))
    ctrl._train_key = jax.random.PRNGKey(12345)  # only the jitter differs
    port = _no_final_eval(ttrainer.Trainer(dataclasses.replace(tcfg, exp_name="port"), device="cpu"))
    start = params_from_jax(jax.device_get(ref.state.params), device="cpu")
    with torch.no_grad():
        for name, t in tree_items(port.state.params):
            t.copy_(dict(tree_items(start))[name])
    for t in (ref, ctrl, port):
        t.run()
    r, c, p = (_curves(t) for t in (ref, ctrl, port))
    assert len(r["loss"]) == len(p["loss"]) == steps
    for run in (r, p):
        assert np.mean(run["loss"][-WINDOW:]) < 0.8 * np.mean(run["loss"][:WINDOW])
    summary = {k: (_gap(p, r, k), _gap(c, r, k)) for k in ("loss", "psnr")}
    print("trajectory gap (port vs JAX, JAX control):", summary)
    assert summary["loss"][0] <= max(0.01, 3.0 * summary["loss"][1]), summary
    assert summary["psnr"][0] <= max(0.5, 3.0 * summary["psnr"][1]), summary
