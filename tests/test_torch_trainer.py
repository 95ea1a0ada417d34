"""The port's training entry point on the CPU: the logger, checkpoints,
metrics, the SDF grid, marching cubes, test-view registration and the
Trainer, against the JAX package where it has the same function, on the
tiny configs of torch_port_utils.py and a 16 x 16 scene of 4 train, 1 val
and 2 test views that ``make_hints_scene`` writes to a temporary directory.

Tolerances: log files, checkpointed resume and marching cubes are exact
(the same arithmetic, and the same C++ source built with the same flags);
PSNR and SSIM 1e-5 (f32 sums in another order); LPIPS 1e-4 relative (f32
convolutions in another order); the SDF grid 1e-5 (f32 matmuls; the grid's
coordinates differ by an ulp of linspace); registration's raygen leaves
2e-3 of each leaf's scale after 3 Adam steps (both sides round the SDF
core's dot operands to bf16, and Adam's first steps move each entry by
about lr whatever its gradient's size, so only a gradient near 0 could
move further); the Trainer's logged losses over 4 steps 5e-3 relative, the
train step tests' loss tolerance (tests/test_torch_train.py: with the pose
deltas on, an ulp of the rays flips the r < 1 mask of a sample on the
unit sphere).
"""
import csv
import dataclasses
import json
import warnings

import jax
import numpy as np
import pytest
import torch

from nrhints_torch.configs import config as tconf
from nrhints_torch.configs.cli import config_to_dict
from nrhints_torch.convert import params_from_jax
from nrhints_torch.data.manager import DataManager as TDM
from nrhints_torch.data.parser import parse_load_nr_data as tparse
from nrhints_torch.data.png import read_png
from nrhints_torch.data.synthetic import make_hints_scene
from nrhints_torch.eval import evaluator as tev
from nrhints_torch.eval import mesh_export as tmesh
from nrhints_torch.eval import metrics as tmetrics
from nrhints_torch.render import renderer as tr
from nrhints_torch.train import trainer as ttrainer
from nrhints_torch.train.checkpoint import CheckpointIO
from nrhints_torch.train.logging import MetricsLogger as TLogger
from nrhints_torch.utils import tree_items
from nrhints_tpu.configs import config as jconf
from tests.torch_port_utils import N_RAYS, model_configs, model_params, to_torch

SPLITS = (4, 1, 2)
HW = 16


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return make_hints_scene(tmp_path_factory.mktemp("scene"), *SPLITS, H=HW, W=HW)


def _configs(scene_dir, base_dir, preset="nr-hints-cam-opt", end_iter=4, **intervals):
    """(JAX SystemConfig on its fused interpret-mode path, the port's):
    the tiny model at the f32 march, 24-ray batches, every hook but the
    log off unless ``intervals`` turns it on."""
    jm, tm = model_configs(march_dtype="float32")
    sched = dict(warm_up_end=2, end_iter=end_iter, anneal_end=0, batch_size=N_RAYS)
    iv = dict(log_metrics=1, save_ckpt=10**7, render_test_views=10**7, render_video=10**7, dump_mesh=10**7)
    iv.update(intervals)
    out = []
    for conf, m in ((jconf, jm), (tconf, tm)):
        cfg = conf.PRESETS[preset]()
        out.append(dataclasses.replace(
            cfg, model=dataclasses.replace(m, **sched), intervals=conf.IntervalsConfig(**iv),
            data=dataclasses.replace(cfg.data, path=str(scene_dir), video_frame_num=1),
            parallel=dataclasses.replace(cfg.parallel, data_axis_size=1),
            base_dir=str(base_dir), final_mesh_resolution=16,
        ))
    return out


def _no_final_eval(trainer):
    """Leave out run()'s closing mesh and test views (tested on their own)."""
    trainer.dump_mesh = lambda resolution=256: None
    trainer.render_test_views = lambda is_final=False: {}
    return trainer


def _log_lines(trainer) -> list:
    return [json.loads(line) for line in (trainer.log_dir / "metrics.jsonl").read_text().splitlines()]


def _jax_uniforms(key, batch: int, n_shadow: int) -> dict:
    """The uniforms JAX's training render draws from ``key``."""
    k_strat, _, k_shadow = jax.random.split(key, 3)
    return {"strat": to_torch(jax.random.uniform(k_strat, (batch, 1))),
            "shadow": to_torch(jax.random.uniform(k_shadow, (batch, n_shadow)))}


# ---------------------------------------------------------------------------
# Logger and checkpoints


def _log_sequence(logger_cls, run_dir):
    rng = np.random.default_rng(0)
    lg = logger_cls(run_dir)
    lg.log({"loss": 1.5, "psnr": 20.25}, 1)
    lg.log({"val/psnr": 3.0, "val/ssim": 0.5}, 1)
    lg.log({"loss": 1.25, "psnr": 21.0}, 2)
    lg.log({"other": 7.0}, 3)
    lg.log_image("rgb", rng.random((5, 6, 3)), 3)
    lg.log_image("shadow_map", rng.random((5, 6, 1)), 3)
    lg.log_image("u8", rng.integers(0, 256, (5, 6, 3), dtype=np.uint8), 3)
    lg.close()
    lg = logger_cls(run_dir)  # a resumed run appends
    lg.log({"loss": 1.0, "psnr": 22.0}, 4)
    lg.close()


def test_logger_files_match_jax(tmp_path):
    """JSONL, one CSV per schema with no second header on resume, and the
    logged images: equal to JAX's apart from the time stamps."""
    from nrhints_tpu.train.logging import MetricsLogger as JLogger

    _log_sequence(TLogger, tmp_path / "t")
    _log_sequence(JLogger, tmp_path / "j")
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert {"metrics.jsonl", "metrics.csv", "val_metrics.csv", "metrics_2.csv"} <= set(names)
    for side in ("t", "j"):
        rows = list(csv.DictReader(open(tmp_path / side / "metrics.csv")))
        assert [r["step"] for r in rows] == ["1", "2", "4"]

    def strip(side, name):
        if name.endswith(".jsonl"):
            return [{k: v for k, v in json.loads(line).items() if k != "ts"}
                    for line in (tmp_path / side / name).read_text().splitlines()]
        return [{k: v for k, v in r.items() if k != "ts"} for r in csv.DictReader(open(tmp_path / side / name))]

    for name in names:
        if name != "logged_images":
            assert strip("t", name) == strip("j", name), name
    import imageio.v3 as iio

    for p in sorted((tmp_path / "j" / "logged_images").iterdir()):
        np.testing.assert_array_equal(read_png(tmp_path / "t" / "logged_images" / p.name), iio.imread(p))


def test_checkpoint_io_layout_and_fallback(tmp_path):
    """The JAX package's layout (ckpt/step_%07d with meta.json, per-host RNG
    pickles); the newest checkpoint that loads wins; an explicit path is
    honoured."""
    io = CheckpointIO(tmp_path)
    for step in (3, 7):
        io.save(step, {"step": step, "w": torch.full((2,), float(step))}, rng_sidecar={"s": step}, world_size=1)
    assert io.available_steps() == [3, 7]
    assert (tmp_path / "ckpt" / "step_0000007" / "meta.json").exists()
    assert (tmp_path / "rng_state" / "step_0000007_host_0.pickle").exists()
    state, step = io.load_newest()
    assert step == 7 and torch.equal(state["w"], torch.full((2,), 7.0))
    assert io.load_rng_sidecar(7) == {"s": 7} and io.load_world_size(7) == 1
    (tmp_path / "ckpt" / "step_0000007" / "state.pt").write_bytes(b"truncated")
    with pytest.warns(UserWarning, match="falling back"):
        state, step = io.load_newest()
    assert step == 3 and torch.equal(state["w"], torch.full((2,), 3.0))
    state, step = io.load_newest(str(tmp_path / "ckpt" / "step_0000003"))
    assert step == 3
    with pytest.warns(UserWarning):
        assert io.load_rng_sidecar(5) is None


# ---------------------------------------------------------------------------
# Metrics, SDF grid, marching cubes


def test_psnr_ssim_match_jax():
    from nrhints_tpu.eval import metrics as jm

    rng = np.random.default_rng(0)
    a = rng.random((32, 24, 3)).astype(np.float32)
    for b in (rng.random((32, 24, 3)).astype(np.float32), np.clip(a + 0.01 * rng.normal(size=a.shape), 0, 1)):
        b = b.astype(np.float32)
        assert abs(tmetrics.psnr(a, b) - jm.psnr(a, b)) <= 1e-5 * abs(jm.psnr(a, b))
        assert abs(tmetrics.ssim(a, b) - jm.ssim(a, b)) <= 1e-5
    assert abs(tmetrics.ssim(a, a) - 1.0) <= 1e-5


def test_lpips_matches_jax(tmp_path, monkeypatch):
    """From a random weights file both packages read: 1e-4 relative; NaN
    and unavailable without one."""
    from nrhints_tpu.eval import metrics as jm

    monkeypatch.delenv("NRHINTS_LPIPS_WEIGHTS", raising=False)
    tmetrics._load_lpips_weights.cache_clear()
    assert not tmetrics.lpips_available() and np.isnan(tmetrics.lpips(np.zeros((8, 8, 3)), np.zeros((8, 8, 3))))
    rng = np.random.default_rng(0)
    weights = {}
    for i, (cin, cout, k) in enumerate([(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3), (256, 256, 3)]):
        weights[f"conv{i}_w"] = rng.normal(0, 0.05, (cout, cin, k, k)).astype(np.float32)
        weights[f"conv{i}_b"] = rng.normal(0, 0.01, cout).astype(np.float32)
        weights[f"lin{i}_w"] = np.abs(rng.normal(0, 0.1, (1, cout, 1, 1))).astype(np.float32)
    path = tmp_path / "lpips.npz"
    np.savez(path, **weights)
    monkeypatch.setenv("NRHINTS_LPIPS_WEIGHTS", str(path))
    tmetrics._load_lpips_weights.cache_clear()
    jm._load_lpips_weights.cache_clear()
    try:
        a = rng.random((64, 64, 3)).astype(np.float32)
        b = np.clip(a + 0.05 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
        assert tmetrics.lpips_available()
        ref = jm.lpips(a, b)
        assert ref > 0 and abs(tmetrics.lpips(a, b) - ref) <= 1e-4 * ref
        assert tmetrics.lpips(a, a) < 1e-7
    finally:
        tmetrics._load_lpips_weights.cache_clear()
        jm._load_lpips_weights.cache_clear()


def test_sdf_grid_and_marching_cubes_match_jax(tmp_path):
    """extract_sdf_grid at resolution 16: 1e-5.  Marching cubes on one grid:
    the same vertices and triangles, and the same OBJ text; the library
    builds into build/nrhints_torch/."""
    from nrhints_tpu.eval import mesh_export as jmesh
    from nrhints_tpu.render.renderer import extract_sdf_grid as jgrid

    jc, tc = model_configs()
    jp, tp = model_params(jc)
    box = ([-1.01] * 3, [1.01] * 3)
    j = np.asarray(jgrid(jp, jc, *box, 16, block=8))
    t = tr.extract_sdf_grid(tp, tc, *box, 16, block=8)
    assert t.shape == (16, 16, 16) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-5)
    assert (j > 0).any() and (j < 0).any()

    tv, tt = tmesh.marching_cubes_to_obj(j, 0.0, *box, tmp_path / "t.obj")
    jv, jt = jmesh.marching_cubes_to_obj(j, 0.0, *box, tmp_path / "j.obj")
    assert len(tt) > 0
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)
    assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj").read_text()
    assert tmesh._build_library().parent == tmesh.BUILD_DIR and tmesh.BUILD_DIR.parts[-2:] == ("build", "nrhints_torch")


# ---------------------------------------------------------------------------
# Test-view registration


def test_register_view_matches_jax(scene_dir):
    """3 steps of register_view on a test view with JAX's pixel draws and
    JAX's params: every raygen leaf at 2e-3 of its scale; the renderer's
    params untouched and with no gradient."""
    from nrhints_tpu.camera.model import CameraModel as JCam
    from nrhints_tpu.data.manager import DataManager as JDM
    from nrhints_tpu.data.parser import parse_load_nr_data
    from nrhints_tpu.eval import evaluator as jev

    jcfg, tcfg = _configs(scene_dir, "unused")
    scene = parse_load_nr_data(scene_dir)
    jpix = JDM(scene, batch_size=N_RAYS).get_test_view(1)
    jr, _ = model_params(jcfg.model)
    adj = (np.random.default_rng(3).normal(size=(sum(SPLITS), 6)) * 0.02).astype(np.float32)
    jp = {"renderer": jr, "raygen": {"cam_pose_adjustment": adj}}
    jout = jev.Evaluator(jcfg, scene.camera, {}).register_view(jp, jpix, steps=3)

    key = jev.register_view_key(jpix)
    draws = []
    for _ in range(3):
        key, sub = jax.random.split(key)
        kh, kw = jax.random.split(sub)
        draws.append((np.array(jax.random.randint(kh, (N_RAYS,), 0, HW)),
                      np.array(jax.random.randint(kw, (N_RAYS,), 0, HW))))
    tp = params_from_jax(jp, device="cpu")
    before = {n: t.clone() for n, t in tree_items(tp["renderer"])}
    for _, t in tree_items(tp["renderer"]):
        t.requires_grad_(True)  # as the trainer's live params
    tscene = tparse(scene_dir)
    tpix = TDM(tscene, batch_size=N_RAYS).get_test_view(1)
    ev = tev.Evaluator(tcfg, tscene.camera, {}, device="cpu")
    tout = ev.register_view(tp, tpix, steps=3, pixel_draws=draws)

    j_adj = np.asarray(jout["raygen"]["cam_pose_adjustment"])
    t_adj = tout["raygen"]["cam_pose_adjustment"].numpy()
    row = SPLITS[0] + SPLITS[1] + 1
    assert np.abs(j_adj[row] - adj[row]).max() > 1e-5  # the view's row moved
    np.testing.assert_array_equal(np.delete(j_adj, row, 0), np.delete(adj, row, 0))
    assert np.abs(t_adj - j_adj).max() <= 2e-3 * np.abs(j_adj).max()
    assert tout["renderer"] is tp["renderer"]
    for n, t in tree_items(tp["renderer"]):
        assert torch.equal(t.detach(), before[n]) and t.grad is None, n
    # The default draws are a function of the view alone.
    a = ev.register_view(tp, tpix, steps=2)["raygen"]["cam_pose_adjustment"]
    assert torch.equal(a, ev.register_view(tp, tpix, steps=2)["raygen"]["cam_pose_adjustment"])


# ---------------------------------------------------------------------------
# The Trainer


def test_trainer_losses_match_jax(scene_dir, tmp_path):
    """4 steps of the port's Trainer.run against JAX's Trainer.run from
    JAX's initial params, the port's step handed JAX's per-step uniforms
    (fold_in(train_key, step)): every logged loss at 5e-3 relative."""
    from nrhints_tpu.train.trainer import Trainer as JTrainer

    jcfg, tcfg = _configs(scene_dir, tmp_path)
    jcfg = dataclasses.replace(jcfg, exp_name="jax")
    jt = _no_final_eval(JTrainer(jcfg))
    tt = _no_final_eval(ttrainer.Trainer(tcfg, device="cpu"))
    jp = params_from_jax(jax.device_get(jt.state.params), device="cpu")
    with torch.no_grad():
        for name, t in tree_items(tt.state.params):
            t.copy_(dict(tree_items(jp))[name])
    step_fn = tt._step_normal

    def with_jax_uniforms(state, batch, generator=None):
        key = jax.random.fold_in(jt._train_key, state.step)
        return step_fn(state, batch, uniforms=_jax_uniforms(key, N_RAYS, tcfg.model.renderer.n_shadow_samples))

    tt._step_normal = with_jax_uniforms
    jt.run()
    tt.run()
    jl, tl = _log_lines(jt), _log_lines(tt)
    assert [r["step"] for r in tl] == [r["step"] for r in jl] == [1, 2, 3, 4]
    for t, j in zip(tl, jl):
        assert t.keys() == j.keys() and {"rays_per_sec", "steps_per_sec"} <= t.keys()
        for k in ("loss", "rgb_loss", "eikonal_loss", "psnr"):
            assert abs(t[k] - j[k]) <= 5e-3 * abs(j[k]), (t["step"], k, t[k], j[k])


def _params(trainer) -> dict:
    return {n: t.detach().clone() for n, t in tree_items(trainer.state.params)}


def test_resume_is_exact_and_falls_back(scene_dir, tmp_path):
    """2 steps, a checkpoint, and a new Trainer that resumes for 2 more give
    the params, Adam's moments and the logged losses of 4 unbroken steps,
    bit for bit.  With the newest checkpoint corrupted, a new Trainer falls
    back to the one before."""
    _, cfg = _configs(scene_dir, tmp_path / "a", save_ckpt=2)
    whole = _no_final_eval(ttrainer.Trainer(cfg, device="cpu"))
    whole.run()

    cfg_b = dataclasses.replace(cfg, base_dir=str(tmp_path / "b"))
    first = ttrainer.Trainer(cfg_b, device="cpu")
    for _ in range(2):
        first.train_iter()
        first.global_step += 1
    first._save_ckpt()
    at_two = _params(first)
    resumed = _no_final_eval(ttrainer.Trainer(cfg_b, device="cpu"))
    assert resumed.global_step == resumed.state.step == 2
    resumed.run()
    assert resumed.global_step == 4
    for n, t in _params(whole).items():
        assert torch.equal(_params(resumed)[n], t), n
    for tw, tr_ in zip(whole.optimizer.param_groups, resumed.optimizer.param_groups):
        for pw, pr in zip(tw["params"], tr_["params"]):
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(whole.optimizer.state[pw][k], resumed.optimizer.state[pr][k]), k
    losses = {r["step"]: r["loss"] for r in _log_lines(whole)}
    assert {r["step"]: r["loss"] for r in _log_lines(resumed) if r["step"] > 2} == {3: losses[3], 4: losses[4]}

    assert resumed.ckpt_io.available_steps() == [2, 4]
    (resumed.ckpt_io.ckpt_dir / "step_0000004" / "state.pt").write_bytes(b"corrupted")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        again = ttrainer.Trainer(cfg_b, device="cpu")
    assert any("falling back" in str(w.message) for w in caught)
    assert again.global_step == 2
    for n, t in at_two.items():
        assert torch.equal(_params(again)[n], t), n


def test_registered_poses_persist_in_the_optimizers_tensors(scene_dir, tmp_path, monkeypatch):
    """render_test_views copies the registered rows into the live raygen
    tensor in place: the optimizer's own tensor, with its Adam moments kept;
    training rows are untouched and training goes on."""
    register = tev.Evaluator.register_view
    monkeypatch.setattr(tev.Evaluator, "register_view", lambda self, p, px, steps=500: register(self, p, px, 3))
    _, cfg = _configs(scene_dir, tmp_path)
    t = ttrainer.Trainer(cfg, device="cpu")
    t.train_iter()
    t.global_step += 1
    live = t.state.params["raygen"]["cam_pose_adjustment"]
    before, moments = live.detach().clone(), t.optimizer.state[live]["exp_avg"].clone()
    means = t.render_test_views(is_final=True)
    assert {"val/psnr", "val/ssim"} <= means.keys() and all(np.isfinite(v) for v in means.values())
    assert t.state.params["raygen"]["cam_pose_adjustment"] is live
    assert any(p is live for g in t.optimizer.param_groups for p in g["params"])
    assert torch.equal(t.optimizer.state[live]["exp_avg"], moments)
    test_rows = list(range(SPLITS[0] + SPLITS[1], sum(SPLITS)))
    assert (live.detach()[test_rows] - before[test_rows]).abs().min() > 0
    assert torch.equal(live.detach()[: SPLITS[0] + SPLITS[1]], before[: SPLITS[0] + SPLITS[1]])
    assert np.isfinite(float(t.train_iter()["loss"]))


def test_main_trains_logs_and_writes_outputs(scene_dir, tmp_path):
    """``python -m nrhints_torch``'s main on the CPU, the nr-hints preset (no
    registration): logs, checkpoints, the final test views, mesh and the
    video frames; a second main resumes from the newest checkpoint."""
    from nrhints_torch.__main__ import main

    tiny = ["--config.model.sdf-network.n-layers", "4", "--config.model.sdf-network.d-hidden", "32",
            "--config.model.sdf-network.d-out-feat", "16", "--config.model.sdf-network.skip-in", "2",
            "--config.model.sdf-network.multi-res", "4", "--config.model.reflectance-network.n-layers", "2",
            "--config.model.reflectance-network.d-hidden", "32", "--config.model.batch-size", "24"]
    argv = ["config:nr-hints", f"--config.data.path={scene_dir}", "--config.base-dir", str(tmp_path),
            "--config.model.end-iter", "4", "--config.intervals.log-metrics", "2", "--config.intervals.save-ckpt",
            "2", "--config.intervals.render-video", "4", "--config.data.video-frame-num", "1",
            "--config.final-mesh-resolution", "16", "--config.profile-steps", "1-3", *tiny]
    t = main(argv, device="cpu")
    log = t.log_dir
    assert json.loads((log / "config.json").read_text()) == config_to_dict(t.config)
    lines = _log_lines(t)
    train = [r for r in lines if "loss" in r]
    assert [r["step"] for r in train] == [2, 4] and all(np.isfinite(r["loss"]) and r["rays_per_sec"] > 0
                                                        for r in train)
    val = [r for r in lines if "val/psnr" in r]
    assert len(val) == 1 and np.isfinite(val[0]["val/psnr"]) and np.isfinite(val[0]["val/ssim"])
    assert t.ckpt_io.available_steps() == [2, 4]
    dumps = log / "test_views" / "step_0000004"
    assert all((dumps / f"{k}_{i:03d}.png").exists() for k in ("rgb", "rgb_gt", "shadow_map") for i in (0, 1))
    assert read_png(dumps / "rgb_000.png").shape == (HW, HW, 3)
    obj = (log / "mesh" / "step_0000004_res_16.obj").read_text()
    assert obj.count("\nf ") > 0
    assert sorted(p.name for p in (log / "video" / "step_0000004").iterdir()) == ["000.png", "001.png"]
    assert json.loads((log / "profile" / "trace_steps_1-3.json").read_text())["traceEvents"]

    t2 = main([a if a != "4" or argv[i - 1] != "--config.model.end-iter" else "6" for i, a in enumerate(argv)],
              device="cpu")
    assert [r["step"] for r in _log_lines(t2) if "loss" in r] == [2, 4, 6]
    assert t2.ckpt_io.available_steps() == [2, 4, 6]


def _with_parallel(cfg, **kw):
    return dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, **kw))


def test_next_chunk_size_matches_jax():
    """``_next_chunk_size`` against JAX's on the same trainer state: K steps,
    or 1 where a chunk of K would cross the geometry warm-up's end or
    end_iter (with and without a warm-up phase), and 1 for K = 1."""
    import types

    from nrhints_tpu.train.trainer import Trainer as JTrainer

    base = tconf.SystemConfig()
    seen = []
    for k, wend, warm in ((4, 6, True), (4, 6, False), (1, 0, False)):
        cfg = _with_parallel(dataclasses.replace(base, model=dataclasses.replace(
            base.model, end_iter=10, geometry_warmup_end=wend)), steps_per_dispatch=k)
        for gs in range(10):
            fake = types.SimpleNamespace(config=cfg, global_step=gs, _step_warmup=object() if warm else None)
            t = ttrainer.Trainer._next_chunk_size(fake)
            assert t == JTrainer._next_chunk_size(fake), (k, wend, warm, gs)
            seen.append(t)
    assert seen[:10] == [4, 4, 4, 1, 1, 1, 4, 1, 1, 1]  # the warm-up ends at 6, the run at 10
    assert seen[10:20] == [4, 4, 4, 4, 4, 4, 4, 1, 1, 1] and set(seen[20:]) == {1}


def test_trainer_steps_per_dispatch_matches_jax(scene_dir, tmp_path):
    """A 6-step run at ``steps_per_dispatch=2`` on both packages: 3
    dispatches, a log every 3 steps and a checkpoint every 4, which fire
    where a dispatch crosses them, so at the same steps in both (logs 4 and
    6, a checkpoint at 4); finite losses, and the state at step 6."""
    from nrhints_tpu.train.trainer import Trainer as JTrainer

    jcfg, tcfg = (_with_parallel(c, steps_per_dispatch=2)
                  for c in _configs(scene_dir, tmp_path, end_iter=6, log_metrics=3, save_ckpt=4))
    jt = _no_final_eval(JTrainer(dataclasses.replace(jcfg, exp_name="jax")))
    tt = _no_final_eval(ttrainer.Trainer(tcfg, device="cpu"))
    jt.run()
    tt.run()
    jl, tl = _log_lines(jt), _log_lines(tt)
    assert [r["step"] for r in tl] == [r["step"] for r in jl] == [4, 6]
    assert all(np.isfinite(r["loss"]) for r in tl)
    assert tt.ckpt_io.available_steps() == jt.ckpt_io.available_steps() == [4]
    assert tt.global_step == tt.state.step == int(jt.state.step) == 6
    assert list(tt._scan_steps) == [(False, 2)]


def test_chunked_run_equals_single_steps(scene_dir, tmp_path):
    """On the CPU a run at ``steps_per_dispatch=2`` is the single-step run
    bit for bit: each step's jitter is seeded by (seed, step), and the
    chunks that would cross the geometry warm-up's end (3) or end_iter (6)
    run singly (dispatches 0-2, 2-3, 3-5, 5-6); its logs fire at the
    crossings of each dispatch (every 2 steps: at 2, 5 and 6)."""
    runs = []
    for k in (1, 2):
        _, cfg = _configs(scene_dir, tmp_path / f"k{k}", end_iter=6, log_metrics=2)
        cfg = _with_parallel(dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, geometry_warmup_end=3)),
                             steps_per_dispatch=k)
        t = _no_final_eval(ttrainer.Trainer(cfg, device="cpu"))
        t.run()
        runs.append(t)
    single, chunked = runs
    assert [r["step"] for r in _log_lines(chunked)] == [2, 5, 6]
    assert sorted(chunked._scan_steps) == [(False, 2), (True, 2)]
    for n, t in _params(single).items():
        assert torch.equal(_params(chunked)[n], t), n
    last = {r["step"]: r["loss"] for r in _log_lines(single)}
    assert {r["step"]: r["loss"] for r in _log_lines(chunked)}[6] == last[6]


def test_entry_points_need_the_card_unless_asked(scene_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, cfg = _configs(scene_dir, tmp_path)
    for build in (lambda: ttrainer.Trainer(cfg), lambda: ttrainer.launch(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


@pytest.mark.parametrize("parallel,error", [({"multihost": True}, ValueError), ({"data_axis_size": 2}, ValueError),
                                            ({"sample_axis_size": 2}, NotImplementedError)],
                         ids=["multihost", "data_axis", "sample_axis"])
def test_unported_settings_raise(scene_dir, tmp_path, monkeypatch, parallel, error):
    """Sample-axis sharding is not ported; ``multihost`` without torchrun's
    environment, and a ``data_axis_size`` other than the world size (here
    one process in no group), raise ``ValueError`` rather than training on
    one device.  The settings that run across ranks are tested in
    tests/test_torch_parallel.py."""
    from nrhints_torch.parallel.mesh import TORCHRUN_ENV

    for v in TORCHRUN_ENV:
        monkeypatch.delenv(v, raising=False)
    _, cfg = _configs(scene_dir, tmp_path)
    cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, **parallel))
    with pytest.raises(error):
        ttrainer.Trainer(cfg, device="cpu")
