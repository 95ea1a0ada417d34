"""Sample-axis sharding on the CPU: the ('data', 'sample') grid of
``nrhints_torch/parallel/mesh.py``, the marches of ``render/renderer.py``
over it and the train step and Trainer on it, against JAX's 2-D mesh
(``nrhints_tpu/parallel/mesh.py::make_mesh(d, sample_axis_size=k)`` on
conftest's 8 virtual CPU devices, JAX's own cases of tests/test_mesh2d.py)
and against the port without a grid.  The ranks are gloo processes
spawned by tests/torch_dist_worker.py, as tests/test_torch_parallel.py
spawns them, here as a 1 x 2 grid.

Tolerances are JAX's own (tests/test_mesh2d.py):
* the sample-sharded shadow march's tau against JAX's: 1e-5 (the same
  per-point math; the sliced sweeps' sums run in another order);
* the sample-sharded importance march's z against JAX's: 5e-2 and a mean
  of 5e-3 (the inverse CDF is discontinuous in the sdf values, so an ulp
  of a sliced sweep can move a sample to the next bin);
* a train step on the 1 x 2 grid against JAX's 2-D mesh step and against
  the port's one-process step: loss 1e-4 relative, params 2e-5; its
  gradients against the one-process step's within 1e-5 of each leaf's
  scale (the same marches: each rank's slice of a sweep is the same
  rows of the same product) and against JAX's within test_torch_train's
  2e-2 of a leaf's scale.
The fused route flatten-sharded over the grid (each rank marches half the
rays, then the group all-gathers them) equals the port's march with no
grid bit for bit: every ray's march is independent, and on the CPU each
kernel's plain version gives a ray the same floats at either batch.

Only the marches' case (one spawn) runs in tier-1; the step and the
Trainer, which spawn their own ranks, are ``slow``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrhints_torch.parallel import mesh as tmesh
from nrhints_torch.train import trainer as ttrainer
from nrhints_tpu.core.sampling import stratified_z_vals
from nrhints_tpu.parallel import mesh as jmesh
from nrhints_tpu.render import renderer as jr
from tests.torch_dist_worker import join_ranks, start_ranks
from tests.torch_port_utils import camera_rays, model_configs, model_params

K = 2  # the grid is 1 x K
TAU_TOL = 1e-5
Z_TOL, Z_MEAN_TOL = 5e-2, 5e-3
LOSS_RTOL, PARAM_ATOL = 1e-4, 2e-5
GRAD_SELF, GRAD_JAX = 1e-5, 2e-2


def _march_inputs(n: int, seed: int):
    """(pls, shadow targets, o, d, z0) of ``n`` rays as float32 numpy: lights
    on a sphere of radius 3.2, targets inside the SAL sphere, camera rays
    with their 64 stratified samples."""
    o, d, pl, near, far = camera_rays(seed, n)
    tp = (np.random.default_rng(seed + 10).normal(0, 0.3, (n, 3))).astype(np.float32)
    z0 = np.asarray(stratified_z_vals(jnp.asarray(near), jnp.asarray(far), 64))
    return pl, tp, o, d, z0


@pytest.fixture(scope="module")
def grid_marches(tmp_path_factory):
    """The ranks' marches (``torch_dist_worker.grid_marches_body``) and,
    meanwhile here, JAX's sample-sharded marches on ``make_mesh(1,
    sample_axis_size=2)`` at fused_kernels="off" on the same 12 rays."""
    j_off, t_off = model_configs(fused_kernels="off")
    _, t_on = model_configs(march_dtype="float32")
    jp, _ = model_params(j_off)
    sharded, fused = _march_inputs(12, 2), _march_inputs(16, 5)
    payload = {"cfg_off": t_off, "cfg_on": t_on, "params": jp, "sharded": sharded, "fused": fused}
    out = tmp_path_factory.mktemp("grid_marches")
    ctx = start_ranks("grid_marches_body", K, out, payload)
    try:
        mesh2d = jmesh.make_mesh(1, sample_axis_size=K)
        sh = jax.sharding.NamedSharding(mesh2d, jax.sharding.PartitionSpec("data"))
        p = jmesh.replicate(mesh2d, jax.tree_util.tree_map(jnp.asarray, jp))
        pls, tp, o, d, z0 = (jax.device_put(jnp.asarray(a), sh) for a in sharded)
        tau = jax.jit(lambda p, a, b: jr._shadow_transmittance(p, j_off, a, b, 1.0, None, mesh2d))(p, pls, tp)
        z = jax.jit(lambda p, o, d, z: jr._importance_sample_z(p, j_off, o, d, z, mesh2d))(p, o, d, z0)
        jax_out = {"tau": np.asarray(tau), "z": np.asarray(z)}
    finally:
        ranks = join_ranks(ctx, out)
    return jax_out, ranks


def test_grid_mesh_and_sample_sharded_shadow_match_jax(grid_marches):
    """Two gloo ranks build the 1 x 2 grid (data index 0, sample indices 0
    and 1); the sample-sharded shadow march's tau matches JAX's on its 2-D
    mesh at 1e-5, and both ranks hold the same tau bit for bit."""
    jax_out, ranks = grid_marches
    assert [r["mesh"] for r in ranks] == [(0, 2, 1, 0, 0), (1, 2, 1, 0, 1)]
    assert torch.equal(ranks[0]["sharded_tau"], ranks[1]["sharded_tau"])
    np.testing.assert_allclose(ranks[0]["sharded_tau"].numpy(), jax_out["tau"], atol=TAU_TOL)
    np.testing.assert_allclose(ranks[0]["sharded_tau"].numpy(), ranks[0]["sharded_tau_ref"].numpy(), atol=TAU_TOL)


def test_sample_sharded_importance_matches_jax(grid_marches):
    """The sample-sharded importance march's z: sorted, equal on both
    ranks, within JAX's 5e-2 (mean 5e-3) of JAX's sharded march and of the
    port's unsharded one."""
    jax_out, ranks = grid_marches
    z = ranks[0]["sharded_z"].numpy()
    assert torch.equal(ranks[0]["sharded_z"], ranks[1]["sharded_z"])
    assert (np.diff(z, axis=-1) >= -1e-5).all()
    for ref in (jax_out["z"], ranks[0]["sharded_z_ref"].numpy()):
        np.testing.assert_allclose(z, ref, atol=Z_TOL)
        assert np.abs(z - ref).mean() < Z_MEAN_TOL


def test_fused_march_flatten_sharded_equals_unsharded(grid_marches):
    """The fused route (f32 march weights, the kernels' plain versions on
    the CPU) on 16 rays of a 1 x 2 grid: each rank's kernels take its 8
    rays, and after the all-gather z and tau equal the march with no grid
    bit for bit, on both ranks."""
    _, ranks = grid_marches
    for r in ranks:
        assert [c for c in r["calls"] if c[1] != 16] == [("fused_shadow_tau", 8), ("fused_importance_z", 8)]
        assert torch.equal(r["fused_z"], r["fused_z_ref"]) and torch.equal(r["fused_tau"], r["fused_tau_ref"])
    assert torch.equal(ranks[0]["fused_z"], ranks[1]["fused_z"])


def test_make_mesh_grid_needs_its_ranks():
    """Without a process group a 1 x 2 grid has one rank for two and raises
    ``ValueError``, as JAX's make_mesh raises for a grid larger than its
    devices; so does a sample size below 1.  A rank's place on an 8-rank
    2 x 4 grid of two hosts: its data and sample index, the host batch it
    draws and its block of it, its rows of the global batch."""
    with pytest.raises(ValueError, match="grid"):
        tmesh.make_mesh(sample_axis_size=2)
    with pytest.raises(ValueError):
        jmesh.make_mesh(1, sample_axis_size=16)
    with pytest.raises(ValueError):
        tmesh.make_mesh(sample_axis_size=0)
    r6 = tmesh.DataMesh(rank=6, world_size=8, local_rank=2, local_world_size=4, device=torch.device("cpu"),
                        backend="gloo", sample_axis_size=2)
    assert (r6.data_size, r6.data_index, r6.sample_index, r6.host_data_rows, r6.draw_index, r6.draw_count) == \
        (4, 3, 0, 2, 1, 2)
    b = torch.arange(24)
    assert torch.equal(tmesh.shard_batch(r6, b), b[12:])
    assert tmesh.rank_rows(r6, 6) == slice(18, 24)
    # A sample group of 2 over two hosts of one rank: both hosts draw data row 0.
    r1 = tmesh.DataMesh(1, 2, 0, 1, torch.device("cpu"), "gloo", sample_axis_size=2)
    assert (r1.host_index, r1.draw_index, r1.draw_count, r1.data_index) == (1, 0, 1, 0)
    assert torch.equal(tmesh.shard_batch(r1, b), b)


def test_devices_wanted_counts_the_grid():
    """``launch`` starts data x sample ranks: on the CPU one data row of
    ``sample_axis_size`` ranks, or the asked data size times it."""
    from nrhints_torch.configs.config import nr_hints

    tcfg = nr_hints()
    par = lambda **kw: dataclasses.replace(tcfg, parallel=dataclasses.replace(tcfg.parallel, **kw))  # noqa: E731
    assert ttrainer.devices_wanted(par(sample_axis_size=2), "cpu") == 2
    assert ttrainer.devices_wanted(par(sample_axis_size=2, data_axis_size=2), "cpu") == 4
    with pytest.raises(ValueError):
        ttrainer.devices_wanted(par(sample_axis_size=0), "cpu")


@pytest.mark.slow
def test_grid_train_step_matches_jax_and_one_process(tmp_path):
    """One nr-hints step (fused_kernels="off": the sample-sharded marches) on
    a 1 x 2 grid of gloo ranks, JAX's global uniforms handed to both,
    against JAX's step on ``make_mesh(1, sample_axis_size=2)`` and the
    port's step in one process with no group: loss 1e-4 relative and params
    2e-5 against both; gradients 1e-5 of each leaf's scale against the
    one-process step and 2e-2 against JAX's (from its Adam's first
    moment); the ranks bit for bit."""
    from nrhints_torch.convert import params_from_jax
    from nrhints_torch.train import step as tstep
    from nrhints_torch.utils import tree_items
    from nrhints_tpu.train import step as jstep
    from tests.test_torch_train import _close_scaled, _jax_uniforms, _optax_moments, _setup

    jcfg, tcfg, jp, _, jcam, tcam, jbs, tbs, key = _setup("nr-hints", fused_kernels="off")
    n_shadow = tcfg.model.renderer.n_shadow_samples
    uniforms = {k: v.numpy() for k, v in _jax_uniforms(key, tbs[0].h_indices.shape[0], n_shadow).items()}
    payload = {"cfg": tcfg, "camera": tcam, "params": jp, "uniforms": uniforms,
               "batch": {f.name: getattr(tbs[0], f.name).numpy() for f in dataclasses.fields(tbs[0])}}
    ctx = start_ranks("grid_step_body", K, tmp_path, payload)
    try:
        mesh2d = jmesh.make_mesh(1, sample_axis_size=K)
        opt = jstep.make_optimizer(jcfg)
        state = jmesh.replicate(mesh2d, jstep.init_train_state(jax.tree_util.tree_map(jnp.asarray, jp), opt))
        step_fn = jstep.make_train_step(jcfg, jcam, {}, opt, mesh=mesh2d, donate=False)
        state, jm = step_fn(state, jmesh.shard_batch(mesh2d, jbs[0]), key)
        j_grads = {n: mu / 0.1 for n, (mu, _) in _optax_moments(state.opt_state).items()}
        j_params = dict(tree_items(jax.device_get(state.params)))
        tp = params_from_jax(jp, device="cpu")
        one = tstep.init_train_state(tp, tstep.make_optimizer(tcfg, tp))
        torch.set_num_threads(2)  # the ranks' count: a CPU matmul's sums can depend on it
        one, tm = tstep.make_train_step(tcfg, tcam, {}, one.optimizer)(
            one, tbs[0], uniforms={k: torch.as_tensor(v) for k, v in uniforms.items()})
    finally:
        ranks = join_ranks(ctx, tmp_path)
    a, b = ranks
    for name, t in a["params"].items():
        assert torch.equal(t, b["params"][name]) and torch.equal(a["grads"][name], b["grads"][name]), name
    for ref in (float(jm["loss"]), float(tm["loss"])):
        np.testing.assert_allclose(a["metrics"]["loss"], ref, rtol=LOSS_RTOL)
    one_items = dict(tree_items(one.params))
    for name, t in a["params"].items():
        np.testing.assert_allclose(t.numpy(), np.asarray(j_params[name]), atol=PARAM_ATOL, err_msg=name)
        np.testing.assert_allclose(t.numpy(), one_items[name].detach().numpy(), atol=PARAM_ATOL, err_msg=name)
        _close_scaled(a["grads"][name].numpy(), one_items[name].grad.numpy(), GRAD_SELF, f"one-process {name}")
        _close_scaled(a["grads"][name].numpy(), j_grads[name], GRAD_JAX, f"JAX {name}")


@pytest.mark.slow
def test_trainer_with_sample_axis(tmp_path):
    """``launch`` with ``parallel.sample_axis_size=2`` on the CPU spawns the
    two ranks of a 1 x 2 grid, which train (finite losses, every step
    logged once), checkpoint, register and score the test views on the
    flattened mesh of both ranks, as JAX's Trainer on its 2-D mesh."""
    from nrhints_torch.data.synthetic import make_hints_scene
    from tests.test_torch_trainer import _configs

    scene = make_hints_scene(tmp_path / "scene", 4, 1, 2, H=16, W=16)
    _, cfg = _configs(scene, tmp_path / "runs", end_iter=4, save_ckpt=2, render_video=4)
    cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, sample_axis_size=K))
    assert ttrainer.launch(cfg, device="cpu") is None
    run = tmp_path / "runs" / cfg.exp_name / cfg.scene_name
    lines = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in lines if "loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4] and all(np.isfinite(r["loss"]) for r in train)
    assert len([r for r in lines if "val/psnr" in r]) == 1
    assert json.loads((run / "ckpt" / "step_0000004" / "meta.json").read_text()) == {"world_size": 1, "ranks": 2}
