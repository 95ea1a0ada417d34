"""Data parallelism over ranks on the CPU: ``nrhints_torch/parallel/mesh.py``,
the data-parallel step of ``train/step.py`` and the Trainer's rank branches
and ``launch``.  Two gloo ranks, spawned one process a rank by
tests/torch_dist_worker.py (which imports no JAX), meet through a
``file://`` rendezvous under tmp_path with explicit timeouts; the JAX side
runs here, on conftest's 8 virtual CPU devices, while the ranks run.

Tolerances.  The 2-rank step against JAX's ``make_train_step`` on
``make_mesh(2)``, JAX's global uniforms handed to the ranks by rows: those
of tests/test_torch_train.py (loss and metrics 5e-3 relative, every
gradient leaf of a step 2e-2 of its scale, Adam's moments and the
parameter change after two steps as its ``_hold_two_steps`` holds them),
for the same reasons.  Against the
port's own step on the whole batch in one process: parameters within 1e-6
of each leaf's scale and the metrics within 1e-6 relative (each rank sums
its 12 rays and the all-reduce adds the two sums: another order of the same
sums; measured 2.3e-7 and 1.5e-7 at most); Adam's moments, which are the
gradients themselves, within 1e-4 of each leaf's scale (a leaf's gradient
sums ~3,000 per-sample terms, and the variance's scalar gradient cancels
to 8.5e-6 in the other order); the two ranks bit for bit.  The Trainer
at two ranks: its batches, checkpoints, resume, merged raygen tables and
video frames bit for bit against the same work in one process; the
``val/`` means within 1e-6 relative (the gathered rows are averaged in
another order).
"""
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrhints_torch.data.png import read_png
from nrhints_torch.data.synthetic import make_hints_scene
from nrhints_torch.eval import evaluator as tev
from nrhints_torch.parallel import mesh as tmesh
from nrhints_torch.train import step as tstep
from nrhints_torch.train import trainer as ttrainer
from nrhints_torch.utils import tree_items
from nrhints_tpu.parallel import mesh as jmesh
from nrhints_tpu.train import step as jstep
from tests.test_torch_train import TOL, _close_scaled, _hold_two_steps, _jax_uniforms, _optax_moments, _setup
from tests.test_torch_trainer import _configs
from tests.torch_dist_worker import join_ranks, start_ranks
from tests.torch_port_utils import N_RAYS

SPLITS = (4, 1, 2)
HW = 16
REG_STEPS = 3
EXACT = 1e-6
MOMENTS = 1e-4


def _with_parallel(cfg, **kw):
    return dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, **kw))


def _log_lines(run_dir) -> list:
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


# ---------------------------------------------------------------------------
# The mesh on its own


def test_mesh_without_a_group_and_rank_rows(monkeypatch):
    """No group: one rank, no backend, the single-device step.  A
    ``data_axis_size`` other than the world size raises ``ValueError``, and
    so does a 1 x 2 sample grid, which needs two ranks (JAX's make_mesh
    raises ``ValueError`` for a grid larger than its devices; the grid
    itself is tested on gloo ranks in tests/test_torch_grid.py).  ``shard_batch`` keeps a
    rank's contiguous block of its host's rows (axis 1 of a stacked
    batch), ``rank_rows`` its block of the global batch."""
    m = tmesh.make_mesh()
    assert (m.rank, m.world_size, m.host_count, m.backend, m.distributed) == (0, 1, 1, None, False)
    with pytest.raises(ValueError):
        tmesh.make_mesh(2)
    with pytest.raises(ValueError):
        tmesh.make_mesh(sample_axis_size=2)
    b = torch.arange(2 * 24 * 3).reshape(2, 24, 3)
    r3 = tmesh.DataMesh(rank=3, world_size=4, local_rank=1, local_world_size=2, device=torch.device("cpu"),
                        backend="gloo")
    assert (r3.host_index, r3.host_count, r3.is_main) == (1, 2, False)
    assert torch.equal(tmesh.shard_batch(r3, b[0]), b[0, 12:])
    assert torch.equal(tmesh.shard_batch(r3, b, batch_axis=1), b[:, 12:])
    assert tmesh.rank_rows(r3, 6) == slice(18, 24)
    with pytest.raises(ValueError):
        tmesh.shard_batch(r3, b[0, :5])
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert tmesh.local_layout(1, 2) == (0, 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError):
        tmesh.local_layout(1, 2)


def test_initialize_multihost_reads_torchrun_env(monkeypatch):
    """Without a rendezvous the group comes from torchrun's environment
    (``env://``), gloo on the CPU, with the explicit timeout; missing
    variables raise ``ValueError`` naming them."""
    calls = []
    monkeypatch.setattr(tmesh.dist, "init_process_group", lambda backend, **kw: calls.append((backend, kw)))
    for v in tmesh.TORCHRUN_ENV:
        monkeypatch.delenv(v, raising=False)
    assert not tmesh.under_torchrun()
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        tmesh.initialize_multihost(device="cpu")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert tmesh.under_torchrun()
    tmesh.initialize_multihost(device="cpu")
    assert calls == [("gloo", {"init_method": "env://", "rank": 3, "world_size": 4,
                               "timeout": tmesh.DEFAULT_TIMEOUT})]


def test_no_fallback_where_the_card_cannot_do_it():
    """A gloo group's collectives cannot be captured: the K-step dispatch
    on the card raises rather than running eagerly.  More cards than are
    visible raise."""
    _, tcfg, _, tp, _, tcam, *_ = _setup("nr-hints")
    opt = tstep.make_optimizer(tcfg, tp)
    gloo_card = tmesh.DataMesh(0, 2, 0, 2, torch.device("cuda", 0), "gloo")
    with pytest.raises(ValueError, match="NCCL"):
        tstep.make_train_step_scan(tcfg, tcam, {}, opt, n_steps=2, mesh=gloo_card)
    with pytest.raises(ValueError, match="visible"):
        ttrainer.devices_wanted(_with_parallel(tcfg, data_axis_size=torch.cuda.device_count() + 1), "cuda")
    assert ttrainer.devices_wanted(tcfg, "cpu") == 1
    assert ttrainer.devices_wanted(_with_parallel(tcfg, data_axis_size=2), "cpu") == 2


# ---------------------------------------------------------------------------
# The data-parallel step


def _nest(flat: dict) -> dict:
    """{"/a/b": leaf} -> {"a": {"b": leaf}}."""
    tree: dict = {}
    for name, leaf in flat.items():
        *path, last = name.strip("/").split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


@pytest.fixture(scope="module")
def two_rank_steps(tmp_path_factory):
    """The ranks' steps (``torch_dist_worker.steps_body``) on the two
    24-ray batches of nr-hints-cam-opt, and meanwhile here JAX's two steps
    on ``make_mesh(2)`` from the same params, each keyed by fold_in(key,
    step).  JAX's gradients of each step come from its Adam's first moment
    (mu_1 = (1 - b1) g_0, mu_2 = b1 mu_1 + (1 - b1) g_1); step 0's lr is 0,
    so both are taken at the start."""
    setup = _setup("nr-hints-cam-opt", n_batches=2)
    jcfg, tcfg, jp, _, jcam, tcam, jbs, tbs, key = setup
    keys = [jax.random.fold_in(key, i) for i in range(2)]
    n_shadow = tcfg.model.renderer.n_shadow_samples
    payload = {"cfg": tcfg, "camera": tcam, "params": jp,
               "batches": [{f.name: getattr(b, f.name).numpy() for f in dataclasses.fields(b)} for b in tbs],
               "uniforms": [{k: v.numpy() for k, v in _jax_uniforms(k_, N_RAYS, n_shadow).items()} for k_ in keys]}
    out = tmp_path_factory.mktemp("steps")
    ctx = start_ranks("steps_body", 2, out, payload)
    try:
        mesh = jmesh.make_mesh(2)
        opt = jstep.make_optimizer(jcfg)
        state = jmesh.replicate(mesh, jstep.init_train_state(jax.tree_util.tree_map(jnp.asarray, jp), opt))
        step_fn = jstep.make_train_step(jcfg, jcam, {}, opt, mesh=mesh, donate=False)
        jmetrics, mus = [], []
        for jb, k in zip(jbs, keys):
            state, m = step_fn(state, jmesh.shard_batch(mesh, jb), k)
            jmetrics.append({n: float(v) for n, v in m.items()})
            mus.append({n: mu.astype(np.float64) for n, (mu, _) in _optax_moments(state.opt_state).items()})
    finally:
        ranks = join_ranks(ctx, out)
    b1 = 0.9
    grads = [{n: mu / (1 - b1) for n, mu in mus[0].items()},
             {n: (mu - b1 * mus[0][n]) / (1 - b1) for n, mu in mus[1].items()}]
    at_start = [(_nest(g), m) for g, m in zip(grads, jmetrics)]
    return setup, state, jmetrics, keys, at_start, ranks


def _port_state(tcfg, snapshot: dict, optimizer_state: dict):
    """A train state holding a rank's parameters and Adam's state."""
    params = _nest({name: t.clone() for name, t in snapshot.items() if " " not in name})
    state = tstep.init_train_state(params, tstep.make_optimizer(tcfg, params))
    state.optimizer.load_state_dict(optimizer_state)
    return state


def test_two_rank_step_matches_jax_mesh_step(two_rank_steps):
    """Two steps at two ranks against JAX's step on a 2-device mesh, JAX's
    global uniforms handed to the ranks by rows: each step's loss and
    metrics; every gradient leaf of the first step (the summed gradients,
    against the gradients JAX's first moment holds); after both steps
    Adam's moments and the parameter change, which hold the second step's
    gradients, as tests/test_torch_train.py holds its second step.  (JAX's
    own mesh and single-device gradients of the second batch differ by up
    to 1.2e-2 of a leaf's scale, so a leaf-by-leaf check of that step would
    measure JAX's noise twice.)  The ranks end equal bit for bit."""
    setup, jstate, jmetrics, keys, at_start, ranks = two_rank_steps
    tcfg = setup[1]
    a, b = (r["jax_uniforms"] for r in ranks)
    for name, t in a["state"].items():
        assert torch.equal(t, b["state"][name]), name
    for step, (tm, jm) in enumerate(zip(a["steps"], jmetrics)):
        assert tm["metrics"].keys() == jm.keys()
        for k, v in jm.items():
            np.testing.assert_allclose(float(tm["metrics"][k]), v, rtol=TOL["metric"], err_msg=f"{step} {k}")
    names = [n for n, _ in tree_items(at_start[0][0])]
    assert names == sorted(a["steps"][0]["grads"]) and "/raygen/cam_pose_adjustment" in names
    for name, g in tree_items(at_start[0][0]):
        _close_scaled(a["steps"][0]["grads"][name].numpy(), g, TOL["grad"], name)
    _hold_two_steps((setup, jstate, None, keys, at_start), _port_state(tcfg, a["state"], a["optimizer"]))


def test_two_rank_step_and_scan_match_one_process(two_rank_steps):
    """The 2-rank single steps and the 2-rank K = 2 scan (jitter from each
    step's generator, every rank keeping its rows of the global draw)
    against the port's own step on the whole batch in this process, with
    the same generators: parameters and the last metrics within 1e-6,
    Adam's moments within 1e-4; the two ranks bit for bit; on the CPU the
    scan is the single steps bit for bit."""
    setup, *_, ranks = two_rank_steps
    tcfg, jp, tcam, tbs = setup[1], setup[2], setup[5], setup[7]
    from nrhints_torch.convert import params_from_jax

    params = params_from_jax(jp, device="cpu")
    state = tstep.init_train_state(params, tstep.make_optimizer(tcfg, params))
    step_fn = tstep.make_train_step(tcfg, tcam, {}, state.optimizer)
    for i, b in enumerate(tbs):
        state, metrics = step_fn(state, b, torch.Generator().manual_seed(100 + i))
    ref = {}
    for name, t in tree_items(state.params):
        ref[name] = t.detach()
        ref.update({f"{name} {k}": v for k, v in state.optimizer.state[t].items()})
    for run in ("single", "scan"):
        a, b = ranks[0][run], ranks[1][run]
        assert sorted(a["state"]) == sorted(ref)
        for name, t in ref.items():
            assert torch.equal(a["state"][name], b["state"][name]), (run, name)
            tol = EXACT if " " not in name or name.endswith(" step") else MOMENTS
            _close_scaled(a["state"][name].numpy(), t.numpy(), tol, f"{run} {name}")
        for k, v in metrics.items():
            np.testing.assert_allclose(float(a["metrics"][k]), float(v), rtol=EXACT, err_msg=f"{run} {k}")
    for name, t in ranks[0]["single"]["state"].items():
        assert torch.equal(t, ranks[0]["scan"]["state"][name]), name


# ---------------------------------------------------------------------------
# The Trainer at two ranks


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return make_hints_scene(tmp_path_factory.mktemp("scene"), *SPLITS, H=HW, W=HW)


def _trainer_cfg(scene_dir, base_dir, **parallel):
    """The tiny nr-hints-cam-opt Trainer of tests/test_torch_trainer.py: 4
    steps of 24 rays, a log every step, checkpoints at 2 and 4, the video
    (1 + 1 frames) at 4."""
    _, cfg = _configs(scene_dir, base_dir, end_iter=4, save_ckpt=2, render_video=4)
    return _with_parallel(cfg, **parallel)


@pytest.fixture(scope="module")
def two_rank_trainer(scene_dir, tmp_path_factory):
    """``torch_dist_worker.trainer_body`` at two ranks -> (the config, the
    ranks' output directory, each rank's result)."""
    out = tmp_path_factory.mktemp("trainer")
    cfg = _trainer_cfg(scene_dir, out, data_axis_size=2)
    ranks = join_ranks(start_ranks("trainer_body", 2, out, cfg, REG_STEPS), out)
    return cfg, out, ranks


def _run_dir(base, cfg):
    return base / cfg.exp_name / cfg.scene_name


def test_rank_batches_are_jax_data_manager_draws(scene_dir, two_rank_trainer):
    """Each rank's batches: its block of the rows JAX's DataManager draws
    for one host (local_rank 0, the global batch), and for two hosts of one
    rank each the host's own draws (local_rank = host)."""
    from nrhints_tpu.data.manager import DataManager as JDM
    from nrhints_tpu.data.parser import parse_load_nr_data

    cfg, _, ranks = two_rank_trainer
    scene = parse_load_nr_data(scene_dir)
    one_host = JDM(scene, batch_size=N_RAYS, image_idx_rng_seed=cfg.seed, pixel_idx_rng_seed=cfg.seed, local_rank=0)
    draws = [one_host.next_train_batch() for _ in range(4)]
    hosts = [JDM(scene, batch_size=N_RAYS // 2, image_idx_rng_seed=cfg.seed, pixel_idx_rng_seed=cfg.seed,
                 local_rank=h) for h in range(2)]
    host_draws = [[d.next_train_batch() for _ in range(2)] for d in hosts]
    half = N_RAYS // 2
    for r, res in enumerate(ranks):
        assert res["w2"]["mesh"] == (r, 2, 0, 1) and res["w2"]["global_batch"] == (N_RAYS, N_RAYS)
        assert res["hosts"]["mesh"] == (r, 2, r, 2)
        for got, want in ((res["w2"]["batches"], [d[r * half:(r + 1) * half] for d in draws]),
                          (res["hosts"]["batches"], host_draws[r])):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for f in dataclasses.fields(w):
                    np.testing.assert_array_equal(g[f.name].numpy(), np.asarray(getattr(w, f.name)), f.name)


def test_rank_zero_writes_logs_and_the_checkpoint(two_rank_trainer):
    """Rank 0 alone logs (each step once) and writes the state and
    ``meta.json`` (hosts and ranks); each host's first rank writes its
    sidecar, ``step_*_host_{h}``."""
    cfg, out, ranks = two_rank_trainer
    run = _run_dir(out / "w2", cfg)
    lines = _log_lines(run)
    assert [r["step"] for r in lines if "loss" in r] == [1, 2, 3, 4]
    assert len([r for r in lines if "val/psnr" in r]) == 1
    assert [res["w2"]["logger"] for res in ranks] == [True, False]
    assert ranks[0]["w2"]["saves"] == [{"step": s, "state": True, "sidecar": True, "host_index": 0} for s in (2, 4)]
    assert ranks[1]["w2"]["saves"] == [{"step": s, "state": False, "sidecar": False, "host_index": 0} for s in (2, 4)]
    assert json.loads((run / "ckpt" / "step_0000004" / "meta.json").read_text()) == {"world_size": 1, "ranks": 2}
    assert sorted(p.name for p in (run / "rng_state").iterdir()) == [f"step_000000{s}_host_0.pickle" for s in (2, 4)]
    hosts = _run_dir(out / "hosts", cfg)
    assert [res["hosts"]["saves"] for res in ranks] == [
        [{"step": 2, "state": True, "sidecar": True, "host_index": 0}],
        [{"step": 2, "state": False, "sidecar": True, "host_index": 1}]]
    assert json.loads((hosts / "ckpt" / "step_0000002" / "meta.json").read_text()) == {"world_size": 2, "ranks": 2}
    assert sorted(p.name for p in (hosts / "rng_state").iterdir()) == [
        "step_0000002_host_0.pickle", "step_0000002_host_1.pickle"]
    assert (run / "mesh" / "step_0000004_res_16.obj").is_file()


def _ckpt(run, step):
    return torch.load(run / "ckpt" / f"step_{step:07d}" / "state.pt", map_location="cpu", weights_only=True)


def _assert_trees_equal(a, b, where=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_resume_at_world_two_is_exact(two_rank_trainer):
    """Two ranks resumed from the step-2 checkpoint run steps 3 and 4 to
    the unbroken run's step-4 checkpoint, bit for bit: params, Adam's state
    and the buffers."""
    cfg, out, ranks = two_rank_trainer
    assert all(res["w2b"] == {"steps_run": 2, "global_step": 4} for res in ranks)
    _assert_trees_equal(_ckpt(_run_dir(out / "w2b", cfg), 4), _ckpt(_run_dir(out / "w2", cfg), 4))


def test_resume_at_world_one_follows_jax_sidecar_rule(two_rank_trainer, tmp_path):
    """One process resumes either run bit for bit; the sidecar of one host
    of two ranks is its own (one host: restored), the two hosts' are not
    (skipped, as JAX skips them where the host count changed)."""
    cfg, out, _ = two_rank_trainer
    for name, step, restored in (("w2", 4, True), ("hosts", 2, False)):
        dst = _run_dir(tmp_path / name, cfg)
        shutil.copytree(_run_dir(out / name, cfg) / "ckpt", dst / "ckpt")
        shutil.copytree(_run_dir(out / name, cfg) / "rng_state", dst / "rng_state")
        t = ttrainer.Trainer(dataclasses.replace(_with_parallel(cfg, data_axis_size=1), base_dir=str(tmp_path / name)),
                             device="cpu")
        assert t.global_step == step
        for n, p in tree_items(t.state.params):
            assert torch.equal(p.detach(), _ckpt(dst, step)["params"][n]), n
        fresh = ttrainer.DataManager(t.scene, batch_size=N_RAYS, image_idx_rng_seed=cfg.seed,
                                     pixel_idx_rng_seed=cfg.seed).sampler.get_state()
        assert (t.data_manager.sampler.get_state() != fresh) == restored, name


def test_test_views_and_video_match_one_process(two_rank_trainer, tmp_path, monkeypatch):
    """From the step-4 checkpoint, one process registers, scores and
    renders what the two ranks did at step 4: the merged raygen tables
    (both ranks' live tables) equal bit for bit, the ``val/`` means within
    1e-6, the video frames bit for bit."""
    cfg, out, ranks = two_rank_trainer
    register = tev.Evaluator.register_view
    monkeypatch.setattr(tev.Evaluator, "register_view",
                        lambda self, p, px, steps=500, pixel_draws=None: register(self, p, px, REG_STEPS))
    dst = _run_dir(tmp_path, cfg)
    shutil.copytree(_run_dir(out / "w2", cfg) / "ckpt" / "step_0000004", dst / "ckpt" / "step_0000004")
    (dst / "rng_state").mkdir()
    shutil.copy(_run_dir(out / "w2", cfg) / "rng_state" / "step_0000004_host_0.pickle", dst / "rng_state")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the ranks' count: a CPU matmul's sums can depend on it
    try:
        t = ttrainer.Trainer(dataclasses.replace(_with_parallel(cfg, data_axis_size=1), base_dir=str(tmp_path)),
                             device="cpu")
        assert t.global_step == 4
        before = {k: v.detach().clone() for k, v in t.state.params["raygen"].items()}
        means = t.render_test_views(is_final=True)
        t.render_video()
    finally:
        torch.set_num_threads(threads)
    test_rows = list(range(SPLITS[0] + SPLITS[1], sum(SPLITS)))
    for k, v in t.state.params["raygen"].items():
        assert (v.detach()[test_rows] != before[k][test_rows]).any(), k
        for res in ranks:
            assert torch.equal(res["w2"]["raygen"][k], v.detach()), k
    for res in ranks:
        assert res["w2"]["means"].keys() == means.keys() and {"val/psnr", "val/ssim"} <= means.keys()
        for k, v in means.items():
            assert abs(res["w2"]["means"][k] - v) <= EXACT * abs(v), k
    frames = dst / "video" / "step_0000004"
    names = sorted(p.name for p in frames.iterdir())
    assert names == ["000.png", "001.png"]
    for n in names:
        np.testing.assert_array_equal(read_png(_run_dir(out / "w2", cfg) / "video" / "step_0000004" / n),
                                      read_png(frames / n), n)


def test_scale_global_batch_and_multihost_run(two_rank_trainer):
    """``scale_global_batch`` at two ranks: JAX's rule, the batch times the
    world size (48 rays, each rank 24) and the learning rates times JAX's
    ``batch_scale_lr_factor`` (linear: 2); one step runs.  With
    ``multihost`` and the group already joined, the Trainer joins it."""
    from nrhints_tpu.configs import config as jconf

    cfg, _, ranks = two_rank_trainer
    jc = dataclasses.replace(jconf.SystemConfig(), model=dataclasses.replace(jconf.SystemConfig().model,
                                                                             batch_size=N_RAYS))
    factor = jstep.batch_scale_lr_factor(jc, 2 * N_RAYS)
    assert factor == tstep.batch_scale_lr_factor(cfg, 2 * N_RAYS) == 2.0
    for r, res in enumerate(ranks):
        assert res["scaled"]["global_batch"] == (2 * N_RAYS, 2 * N_RAYS)
        assert res["scaled"]["base_lr"] == [factor * cfg.model.lr, factor * cfg.ray_generator.opt_lr]
        assert np.isfinite(res["scaled"]["loss"]) and np.isfinite(res["multihost"]["loss"])
        assert res["multihost"]["mesh"] == (r, 2, "gloo")
    assert ranks[0]["scaled"]["loss"] == ranks[1]["scaled"]["loss"]
    # JAX's rule at 8 devices and 2 hosts, against the port's at 8 ranks.
    eight = tmesh.DataMesh(0, 8, 0, 4, torch.device("cpu"), "gloo")
    scaled = _with_parallel(cfg, scale_global_batch=True)
    assert ttrainer.global_batch_sizes(scaled, eight) == (8 * N_RAYS, 4 * N_RAYS)
    with pytest.raises(ValueError, match="hosts"):
        ttrainer.global_batch_sizes(dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, batch_size=25)),
                                    eight)


def test_main_spawns_one_rank_a_device(scene_dir, tmp_path):
    """``main`` with ``--config.parallel.data-axis-size 2`` on the CPU
    starts two gloo ranks, joins them and returns None: rank 0's logs and
    checkpoints, the mesh, both test views (one from each rank) and the
    video frames."""
    from nrhints_torch.__main__ import main

    tiny = ["--config.model.sdf-network.n-layers", "4", "--config.model.sdf-network.d-hidden", "32",
            "--config.model.sdf-network.d-out-feat", "16", "--config.model.sdf-network.skip-in", "2",
            "--config.model.sdf-network.multi-res", "4", "--config.model.reflectance-network.n-layers", "2",
            "--config.model.reflectance-network.d-hidden", "32", "--config.model.batch-size", "24"]
    argv = ["config:nr-hints", f"--config.data.path={scene_dir}", "--config.base-dir", str(tmp_path),
            "--config.model.end-iter", "4", "--config.intervals.log-metrics", "2", "--config.intervals.save-ckpt",
            "2", "--config.intervals.render-video", "4", "--config.data.video-frame-num", "1",
            "--config.final-mesh-resolution", "16", "--config.parallel.data-axis-size", "2", *tiny]
    assert main(argv, device="cpu") is None
    run = tmp_path / "baseline" / "scene"
    lines = _log_lines(run)
    assert [r["step"] for r in lines if "loss" in r] == [2, 4] and len([r for r in lines if "val/psnr" in r]) == 1
    assert json.loads((run / "ckpt" / "step_0000004" / "meta.json").read_text()) == {"world_size": 1, "ranks": 2}
    assert (run / "mesh" / "step_0000004_res_16.obj").is_file()
    assert all((run / "test_views" / "step_0000004" / f"rgb_{i:03d}.png").is_file() for i in (0, 1))
    assert sorted(p.name for p in (run / "video" / "step_0000004").iterdir()) == ["000.png", "001.png"]
    assert not list(run.glob(".rendezvous_*"))
