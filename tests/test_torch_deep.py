"""Networks deeper than the CUDA kernels' parameter tables in the port, on
the CPU: JAX's fused SDF core, fused marches and fused trunk with their
Pallas kernels in interpret mode against the port's same calls at 18
layers (past ``core_mlp.MAX_LAYERS`` = 16, where the CUDA kernels read the
per-layer tables from the meta vector's copy on the card and the dW passes
run in groups of ``MAX_JOBS`` products); and what those kernels read: the
packs' meta vectors and their device copies, the width classes and the dW
job table at 18 and 40 layers.  (The deep CUDA instances against their
plain versions run on the card: tests/test_torch_gpu.py.)

The SDF has 18 layers 32 wide with a skip at 4 and ``multi_res=2``; the
trunk 18 linears, 45 -> 17 x 32 -> 3.  Each JAX call runs once per module
(a module-scoped fixture, one ``jax.jit`` a call), at exact f32 dot
operands.  Tolerances are those of tests/test_torch_wide_sdf.py for the
core (outputs 1e-5; gradients 1e-4 of their scale under "recompute", 2e-2
under the stash schedules, whose bf16 stash can round a value within an ulp
of a bf16 boundary the other way), tests/test_torch_kernels.py's for the
marches (the refined z by its metric, tau within 1e-3), and
tests/test_torch_trunk_f32.py's for the f32 trunk (1e-5 and 1e-4).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrhints_torch.convert import params_from_jax
from nrhints_torch.fields.sdf import SDFNetConfig
from nrhints_torch.kernels import core_mlp as tcm, cuda_lib, march as tm
from nrhints_torch.utils import tree_items
from nrhints_tpu.fields.sdf import SDFNetConfig as JSDFNetConfig, sdf_init
from nrhints_tpu.kernels import core_mlp as jcm, march as jm
from tests.test_torch_trunk_f32 import _close_scaled as _trunk_close, _leaf_params
from tests.test_torch_wide_march import ROUTES as MARCH_ROUTES, SDIST, _assert_z_close, wide_rays
from tests.test_torch_wide_sdf import _close_scaled, _port_run
from tests.test_torch_wide_trunk import _trunk_params

N_PTS = 41
DEEP_KW = dict(n_layers=18, d_hidden=32, skip_in=(4,), multi_res=2, d_out_feat=16)
CORE_BACKWARDS = ("recompute", "stash", "stash_all")
TRUNK_DIMS = tuple([45] + [32] * 17 + [3])


@pytest.fixture(scope="module")
def deep():
    """(JAX config, JAX params as numpy, the port's config, port params,
    points, cotangents, rays (o, d, z0))."""
    jc = JSDFNetConfig(**DEEP_KW)
    jp = jax.device_get(jax.jit(sdf_init, static_argnums=1)(jax.random.PRNGKey(5), jc))
    rng = np.random.default_rng(18)
    x = (rng.normal(size=(N_PTS, 3)) * 0.4).astype(np.float32)
    cots = (rng.normal(size=(N_PTS,)).astype(np.float32),
            rng.normal(size=(N_PTS, DEEP_KW["d_out_feat"])).astype(np.float32),
            rng.normal(size=(N_PTS, 3)).astype(np.float32))
    o, d, _, near, far = wide_rays()
    z0 = (near + (far - near) * np.linspace(0.0, 1.0, 64, dtype=np.float32)[None, :]).astype(np.float32)
    return jc, jp, SDFNetConfig(**DEEP_KW), params_from_jax(jp, device="cpu"), x, cots, (o, d, z0)


@pytest.fixture(scope="module")
def jax_runs(deep):
    """JAX's calls in interpret mode, one jit each: ("core", backward) ->
    (outputs, named parameter cotangents, x's cotangent); ("z", route) ->
    the refined z; "tau" -> fused_shadow_tau's tau."""
    jc, jp, _, _, x, cots, (o, d, z0) = deep
    params = jax.tree_util.tree_map(jnp.asarray, jp)
    out = {}
    for backward in CORE_BACKWARDS:
        @jax.jit
        def run(p, xx, c, backward=backward):
            call = lambda p_, x_: jcm.fused_sdf_value_feat_grad(  # noqa: E731
                p_, jc, x_, block_pts=32, block_pts_bwd=32, interpret=True, compute_dtype="float32",
                backward=backward)
            o_, vjp = jax.vjp(call, p, xx)
            return o_, vjp(c)

        o_, (dp, dx) = run(params, jnp.asarray(x), tuple(jnp.asarray(c) for c in cots))
        out["core", backward] = ([np.asarray(a) for a in o_], {n: np.asarray(g) for n, g in tree_items(dp)},
                                 np.asarray(dx))
    rays = [jnp.asarray(a) for a in (o, d, z0)]
    for route in ("monolith", "split"):
        run = jax.jit(lambda p, o_, d_, z_, kw=MARCH_ROUTES[route]: jm.fused_importance_z(
            p, jc, o_, d_, z_, interpret=True, mlp_dtype="float32", **kw))
        out["z", route] = np.asarray(run(params, *rays))
    run = jax.jit(lambda p, o_, d_, z_, s_: jm.fused_shadow_tau(
        p, jc, o_, d_, z_, s_, jnp.asarray(64.0), jnp.asarray(0.7), split=False, final_impl="pallas",
        interpret=True, mlp_dtype="float32"))
    out["tau"] = np.asarray(run(params, *rays, jnp.asarray(SDIST)))
    return out


@pytest.mark.parametrize("backward", CORE_BACKWARDS)
def test_deep_core_matches_jax(deep, jax_runs, backward):
    """The port's fused_sdf_value_feat_grad at 18 layers (the plain
    versions of A and H, or D and E, through SdfCoreFn or SdfStashFn)
    against JAX's fused core in interpret mode: the three outputs and the
    cotangents of x and of every weight-norm leaf."""
    jc, jp, tc, tp, x, cots, _ = deep
    leaves, out, grads = _port_run((jc, jp, tc, tp, x, cots), backward, "float32")
    j_out, j_dp, j_dx = jax_runs["core", backward]
    for a, b in zip(out, j_out):
        np.testing.assert_allclose(a.detach().numpy(), b.reshape(a.shape), rtol=1e-5, atol=1e-5)
    grad_tol = 1e-4 if backward == "recompute" else 2e-2
    _close_scaled(grads[0], j_dx, grad_tol, "dx")
    assert sorted(j_dp) == sorted(leaves)
    for (n, _), g in zip(leaves.items(), grads[1:]):
        _close_scaled(g, j_dp[n], grad_tol, n)


@pytest.mark.parametrize("route", ["monolith", "split"])
def test_deep_importance_z_matches_jax(deep, jax_runs, route):
    """fused_importance_z at 18 layers as kernel M (monolith) and as K then
    L (split), the port's plain versions, against JAX's same route."""
    _, _, tc, tp, _, _, (o, d, z0) = deep
    out = tm.fused_importance_z(tp, tc, *(torch.tensor(a) for a in (o, d, z0)), mlp_dtype="float32",
                                **MARCH_ROUTES[route])
    _assert_z_close(out.numpy(), jax_runs["z", route])


def test_deep_shadow_tau_matches_jax(deep, jax_runs):
    """fused_shadow_tau at 18 layers as one kernel N (kernel C's final sweep
    inside it): tau within 1e-3 of JAX's, and some rays cross the
    surface."""
    _, _, tc, tp, _, _, (o, d, z0) = deep
    out = tm.fused_shadow_tau(tp, tc, *(torch.tensor(a) for a in (o, d, z0, SDIST)), torch.tensor(64.0),
                              torch.tensor(0.7), split=False, final_impl="pallas", mlp_dtype="float32")
    ref = jax_runs["tau"]
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3)
    assert ref.min() < 0.9


def test_deep_trunk_matches_jax():
    """fused_mlp_apply (recompute, f32) of an 18-linear trunk, the plain
    versions of I and J through MlpFn, against JAX's in interpret mode: the
    output and the cotangents of x and of every weight-norm leaf."""
    jp, tp = _trunk_params(TRUNK_DIMS)
    n_layers = len(TRUNK_DIMS) - 2
    rng = np.random.default_rng(19)
    x = rng.normal(size=(N_PTS, TRUNK_DIMS[0])).astype(np.float32)
    g = rng.normal(size=(N_PTS, 3)).astype(np.float32)

    @jax.jit
    def run(p, xx, c):
        o_, vjp = jax.vjp(lambda p_, x_: jcm.fused_mlp_apply(p_, n_layers, x_, block_pts=32, block_pts_bwd=32,
                                                              interpret=True, compute_dtype="float32",
                                                              backward="recompute"), p, xx)
        return o_, vjp(c)

    j_out, (j_dp, j_dx) = run(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x), jnp.asarray(g))
    params, leaves = _leaf_params(tp)
    xt = torch.tensor(x, requires_grad=True)
    out = tcm.fused_mlp_apply(params, n_layers, xt, compute_dtype="float32", backward="recompute")
    assert type(out.grad_fn).__name__.startswith("MlpFn")
    grads = torch.autograd.grad(out, [xt, *leaves.values()], torch.tensor(g))
    _trunk_close(out, np.asarray(j_out), 1e-5, "out")
    _trunk_close(grads[0], np.asarray(j_dx), 1e-4, "dx")
    j_dp = {n: np.asarray(v) for n, v in tree_items(j_dp)}
    assert sorted(j_dp) == sorted(leaves)
    for (name, _), gr in zip(leaves.items(), grads[1:]):
        _trunk_close(gr, j_dp[name], 1e-4, name)


@pytest.mark.parametrize("n_layers", [18, 40])
def test_deep_packs_and_classes(n_layers):
    """At 18 and 40 layers: the SDF's and the trunk's classes are the
    64-point ones; each pack's meta vector holds every layer's row (the
    widths, skip flags and running offsets) and carries its copy for the
    kernels ("meta_dev", here on the CPU), which a shallower pack does
    not; the C entries' meta arguments are the host vector and that copy;
    the SDF backward's dW job table (L + 1 products) goes to the card too,
    past MAX_JOBS, and holds no point count, so one copy serves every n."""
    from nrhints_torch.fields.sdf import _layer_dims, sdf_init as t_sdf_init

    cfg = SDFNetConfig(n_layers=n_layers, d_hidden=32, skip_in=(4, n_layers // 2), multi_res=2, d_out_feat=16)
    assert tcm.core_class(cfg) is tcm.NARROW and tcm.core_class(cfg, with_feat=False) is tcm.NARROW
    w = tcm.materialize_sdf_weights_full(t_sdf_init(torch.Generator().manual_seed(0), cfg, "cpu"), cfg)
    for dt in (torch.bfloat16, torch.float32):
        pk = tcm.pack_sdf_mlp(w, cfg, with_feat=True, dtype=dt)
        meta = pk["meta"]
        io, _ = _layer_dims(cfg)
        assert len(meta) == 10 + 7 * n_layers and int(meta[0]) == n_layers
        w_off = b_off = 0
        for i, (din, dout) in enumerate(io):
            kp, np_ = -(-din // 16) * 16, -(-dout // 16) * 16
            assert list(meta[10 + 7 * i : 17 + 7 * i]) == [din, dout, kp, np_, int(i in cfg.skip_in), w_off, b_off]
            w_off, b_off = w_off + kp * np_, b_off + np_
        assert int(meta[9]) == b_off and int(meta[7]) == w_off
        assert pk["meta_dev"].dtype == torch.int32 and np.array_equal(pk["meta_dev"].numpy(), meta)
        assert tcm.meta_args(pk) == (meta.ctypes.data, pk["meta_dev"].data_ptr())
        rows = tcm.pack_sdf_mlp(w[: 2 * n_layers + 2], cfg, with_feat=False, dtype=dt)
        assert np.array_equal(rows["meta_dev"].numpy(), rows["meta"])
    shapes = [(2, 32, 32)] * n_layers + [(1, 32, 16)]
    jobs, n_scratch, _ = tcm.dw_jobs(shapes, 64)
    ptr, on_card, n_jobs = tcm.jobs_args(jobs, "cpu")
    assert (ptr, n_jobs) == (jobs.ctypes.data, n_layers + 1) and on_card is not None
    other, n_other, _ = tcm.dw_jobs(shapes, 4096)
    assert np.array_equal(other, jobs) and n_other == 64 * n_scratch and tcm.jobs_args(other, "cpu")[1] == on_card
    shallow = SDFNetConfig(n_layers=tcm.MAX_LAYERS, skip_in=(4,))
    sw = tcm.materialize_sdf_weights_full(t_sdf_init(torch.Generator().manual_seed(0), shallow, "cpu"), shallow)
    pk = tcm.pack_sdf_mlp(sw, shallow, with_feat=True)
    assert "meta_dev" not in pk and tcm.meta_args(pk) == (pk["meta"].ctypes.data, None)
    assert tcm.jobs_args(tcm.dw_jobs([(2, 16, 16)] * tcm.MAX_JOBS, 64)[0], "cpu")[1] is None

    dims = [45] + [32] * (n_layers - 1) + [3]
    pairs = list(zip(dims[:-1], dims[1:]))
    assert tcm.trunk_class(pairs) is tcm.TRUNK_NARROW
    tw = [torch.zeros(i, o) if k % 2 == 0 else torch.zeros(o) for i, o in pairs for k in range(2)]
    tpk = tcm.pack_mlp(tw, n_layers - 1)
    assert len(tpk["meta"]) == 4 + 7 * n_layers and int(tpk["meta"][0]) == n_layers
    assert np.array_equal(tpk["meta_dev"].numpy(), tpk["meta"])


def test_deep_constants_match_the_headers():
    """The parameter tables' depth and the meta vectors' heads are the
    constants the kernels are compiled with; the entry points take the
    device copies beside the host vectors."""
    def const(header, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", (cuda_lib.CSRC / header).read_text()).group(1))

    assert const("sdf_mlp.cuh", "kMaxLayers") == tcm.MAX_LAYERS
    assert const("sdf_mlp.cuh", "kMetaHead") == 10 and const("mlp_stash.cu", "kMlpMetaHead") == 4
    assert "constexpr int kMaxJobs = kMaxLayers + 1;" in (cuda_lib.CSRC / "dw_sum.cuh").read_text()
    assert tcm.MAX_JOBS == tcm.MAX_LAYERS + 1
    for src in ("sdf_core.cu", "sdf_stash.cu", "sdf_core_bwd.cu", "mlp_stash.cu"):
        text = (cuda_lib.CSRC / src).read_text()
        assert text.count("const int* meta_dev") >= 1, src
    assert (cuda_lib.CSRC / "sdf_stash.cu").read_text().count("const long long* jobs_dev") == 2
