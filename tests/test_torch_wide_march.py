"""The march kernels above the presets' widths in the port, on the CPU: JAX's
``fused_importance_z`` and ``fused_shadow_tau`` with their Pallas kernels
in interpret mode against the port's same calls (the plain versions of
kernels C, K, L, M and N, whose CUDA wide instances take padded widths up
to 512 and encodings up to 128), at a 3-layer SDF 288 wide with
``multi_res=11`` (a 69-wide encoding, padded 80), at ``mlp_dtype``
"float32" and "bfloat16"; and ``render_rays`` of a tiny model with that SDF
through the default routes.  Then the same calls, the bf16 monolith
(kernel M) and kernel N, above 512 / 128 (the CUDA huge instances' class,
bf16 march weights only) at the smallest SDF that reaches that class: 3
layers 160 wide with ``multi_res=24`` (a 147-wide encoding, padded 160).
(The CUDA wide and huge instances against their plain versions run on the
card: tests/test_torch_gpu.py.)

Each JAX call runs once per module (a module-scoped fixture).  Tolerances
are tests/test_torch_kernels.py's at the presets' widths: the refined z by
its metric (sorted, 90% of slots within 1e-4, every slot within one
stratified interval: the u = 1 draw and bf16 rounding flips move a ray's
low-weight tail), tau within the shadow map's 1e-3, the render at
tests/test_torch_render.py's "float32" tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrhints_torch.convert import params_from_jax
from nrhints_torch.fields.sdf import SDFNetConfig
from nrhints_torch.kernels import core_mlp as tcm, march as tm
from nrhints_torch.render import renderer as tr
from nrhints_tpu.fields.sdf import SDFNetConfig as JSDFNetConfig, sdf_init
from nrhints_tpu.kernels import march as jm
from nrhints_tpu.render import renderer as jr
from tests.torch_port_utils import N_RAYS, model_configs, model_params

WIDE_KW = dict(n_layers=3, d_hidden=288, skip_in=(2,), multi_res=11, d_out_feat=32)
DTYPES = ("float32", "bfloat16")
# fused_importance_z's routes, as the renderer's knobs select them: the
# monolith (kernel M), the split march (K, then L) and the shipping route
# (plain sweeps between kernel B's steps); the monolith at both dtypes, the
# split march at f32 and the shipping route at its bf16 (each JAX call in
# interpret mode takes 2.6-4.2 s here).
ROUTES = {
    "monolith": {},
    "split": dict(split=True, sweep_impl="pallas", rounds_impl="pallas"),
    "shipping": dict(split=True, sweep_impl="xla", rounds_impl="xla"),
}
ROUTE_CASES = [("monolith", "float32"), ("monolith", "bfloat16"), ("split", "float32"), ("shipping", "bfloat16")]
SDIST = np.full((N_RAYS, 1), 2.0 / 64, np.float32)
HUGE_KW = dict(n_layers=3, d_hidden=160, skip_in=(2,), multi_res=24, d_out_feat=32)


def wide_rays(n: int = N_RAYS):
    """torch_port_utils.camera_rays' layout, the rays aimed within 0.15 of
    the centre: at these widths the SAL init's zero level set is a sphere
    of radius about 0.17, not 0.5, and the shadow and camera marches should
    cross it.  -> (o, d, pl, near, far) as float32 numpy."""
    rng = np.random.default_rng(0)
    o = np.tile(np.array([[0.3, 0.4, -2.7]], np.float32), (n, 1))
    tgt = rng.uniform(-0.15, 0.15, (n, 3)).astype(np.float32)
    tgt[:, 2] = 0.0
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pl = rng.normal(size=(n, 3)).astype(np.float32)
    pl = 3.2 * pl / np.linalg.norm(pl, axis=-1, keepdims=True)
    mid = -np.sum(o * d, -1, keepdims=True)
    return o, d, pl.astype(np.float32), (mid - 1.0).astype(np.float32), (mid + 1.0).astype(np.float32)


@pytest.fixture(scope="module")
def wide():
    """(JAX config, JAX params, the port's config, port params, (o, d,
    z0))."""
    jc = JSDFNetConfig(**WIDE_KW)
    jp = jax.device_get(jax.jit(sdf_init, static_argnums=1)(jax.random.PRNGKey(3), jc))
    o, d, _, near, far = wide_rays()
    z0 = (near + (far - near) * np.linspace(0.0, 1.0, 64, dtype=np.float32)[None, :]).astype(np.float32)
    return jc, jp, SDFNetConfig(**WIDE_KW), params_from_jax(jp, device="cpu"), (o, d, z0)


@pytest.fixture(scope="module")
def jax_marches(wide):
    """(route or "shadow", mlp_dtype) -> JAX's refined z or tau as numpy,
    each call one ``jax.jit`` (compiled once, not run op by op); and at
    HUGE_KW ("huge", "params") -> (JAX config, JAX params) and ("huge
    monolith" or "huge shadow", "bfloat16") -> the bf16 monolith's z and
    kernel N's tau."""
    jc, jp, _, _, (o, d, z0) = wide
    rays = [jnp.asarray(a) for a in (o, d, z0)]
    hc = JSDFNetConfig(**HUGE_KW)
    hp = jax.device_get(jax.jit(sdf_init, static_argnums=1)(jax.random.PRNGKey(4), hc))
    hargs = [jax.tree_util.tree_map(jnp.asarray, hp)] + rays
    out = {("huge", "params"): (hc, hp)}
    out["huge monolith", "bfloat16"] = np.asarray(jax.jit(lambda p, o_, d_, z_: jm.fused_importance_z(
        p, hc, o_, d_, z_, interpret=True, mlp_dtype="bfloat16"))(*hargs))
    out["huge shadow", "bfloat16"] = np.asarray(jax.jit(lambda p, o_, d_, z_, s_: jm.fused_shadow_tau(
        p, hc, o_, d_, z_, s_, jnp.asarray(64.0), jnp.asarray(0.7), split=False, final_impl="pallas",
        interpret=True, mlp_dtype="bfloat16"))(*hargs, jnp.asarray(SDIST)))
    args = [jax.tree_util.tree_map(jnp.asarray, jp)] + rays
    for route, dt in ROUTE_CASES:
        run = jax.jit(lambda p, o_, d_, z_, dt=dt, kw=ROUTES[route]: jm.fused_importance_z(
            p, jc, o_, d_, z_, interpret=True, mlp_dtype=dt, **kw))
        out[route, dt] = np.asarray(run(*args))
    for dt in DTYPES:
        run = jax.jit(lambda p, o_, d_, z_, s_, dt=dt: jm.fused_shadow_tau(
            p, jc, o_, d_, z_, s_, jnp.asarray(64.0), jnp.asarray(0.7), split=False, final_impl="pallas",
            interpret=True, mlp_dtype=dt))
        out["shadow", dt] = np.asarray(run(*args, jnp.asarray(SDIST)))
    return out


def _assert_z_close(out, ref):
    """tests/test_torch_kernels.py's refined-z metric."""
    assert out.shape == (N_RAYS, 128)
    assert np.all(np.diff(out, axis=-1) >= 0)
    err = np.abs(out - ref)
    assert np.mean(err <= 1e-4) >= 0.9, np.mean(err <= 1e-4)
    assert err.max() <= 2.0 / 63 + 1e-5


def test_wide_config_takes_the_wide_row_engine(wide):
    """The module's SDF is above the presets' widths: the march kernels'
    pack is the row engine's wide class at both dtypes."""
    _, _, tc, tp, _ = wide
    for dt in DTYPES:
        w = tm.march_weights(tp, tc, dt)
        pk = tcm.pack_sdf_mlp(w, tc, with_feat=False, dtype=w[0].dtype)
        assert pk["cls"] is tcm.ROWS_WIDE and int(pk["meta"][2]) == 69
        assert tm._kernel_pack("shadow_final", w, tc)[0] == "shadow_final" + ("_f32" if dt == "float32" else "") + \
            "_wide"


@pytest.mark.parametrize("route,mlp_dtype", ROUTE_CASES)
def test_wide_importance_z_matches_jax(wide, jax_marches, route, mlp_dtype):
    """fused_importance_z on each route (the port's plain versions of M, K
    and L, and B's between plain sweeps) against JAX's same route."""
    _, _, tc, tp, (o, d, z0) = wide
    out = tm.fused_importance_z(tp, tc, *(torch.tensor(a) for a in (o, d, z0)), mlp_dtype=mlp_dtype, **ROUTES[route])
    _assert_z_close(out.numpy(), jax_marches[route, mlp_dtype])


@pytest.mark.parametrize("mlp_dtype", DTYPES)
def test_wide_shadow_tau_matches_jax(wide, jax_marches, mlp_dtype):
    """fused_shadow_tau as one kernel N (shadow_split=False, C's final sweep
    inside it): tau within 1e-3 of JAX's."""
    _, _, tc, tp, (o, d, z0) = wide
    out = tm.fused_shadow_tau(tp, tc, *(torch.tensor(a) for a in (o, d, z0, SDIST)), torch.tensor(64.0),
                              torch.tensor(0.7), split=False, final_impl="pallas", mlp_dtype=mlp_dtype)
    ref = jax_marches["shadow", mlp_dtype]
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3)
    assert ref.min() < 0.9  # some shadow rays cross the surface


def test_wide_render_rays_matches_jax():
    """render_rays of a tiny model whose SDF is the module's wide one,
    through the default routes (the shipping marches with kernel C's final
    sweep, the fused core and trunk), against JAX's fused path in
    interpret mode; the renderer's width check passes for it."""
    jc, tc = model_configs(sdf_kw=WIDE_KW, march_dtype="float32")
    tr.check_kernel_widths(tc)
    from nrhints_torch.core.structs import RayBundle as TRB
    from nrhints_tpu.core.structs import RayBundle as JRB

    jp, tp = model_params(jc)
    arrs = wide_rays()
    jrays, trays = JRB(*[jnp.asarray(a) for a in arrs]), TRB(*[torch.as_tensor(a) for a in arrs])
    jo = jax.jit(lambda p, r: jr.render_rays(p, jc, r, background_rgb=jnp.ones((1, 3))))(
        jax.tree_util.tree_map(jnp.asarray, jp), jrays)
    to = tr.render_rays(tp, tc, trays, background_rgb=torch.ones(1, 3))
    tol = {"rgb": 5e-4, "weights": 5e-4, "depth": 1e-3, "visibilities": 1e-3}
    for k, t in tol.items():
        np.testing.assert_allclose(getattr(to, k).numpy(), np.asarray(getattr(jo, k)), atol=t, err_msg=k)
    assert float(np.asarray(jo.visibilities).min()) < 0.9  # the shadow hint is exercised


def _huge(jax_marches):
    """(the port's HUGE_KW config, its params from JAX's)."""
    _, hp = jax_marches["huge", "params"]
    return SDFNetConfig(**HUGE_KW), params_from_jax(hp, device="cpu")


def test_huge_config_takes_the_huge_row_engine(jax_marches):
    """HUGE_KW is above 512 / 128 by its encoding alone: the march kernels'
    pack is the row engine's huge class at bf16 march weights (counted as
    *_huge), and f32 march weights raise naming item 15."""
    tc, tp = _huge(jax_marches)
    w = tm.march_weights(tp, tc, "bfloat16")
    pk = tcm.pack_sdf_mlp(w, tc, with_feat=False)
    assert pk["cls"] is tcm.ROWS_HUGE and int(pk["meta"][2]) == 147 and tcm.huge_tiles(pk["meta"]) == (160, 160)
    assert tm._kernel_pack("shadow_final", w, tc)[0] == "shadow_final_huge"
    with pytest.raises(NotImplementedError, match="march kernels .* item 15"):
        tm._kernel_pack("march_sweep", tm.march_weights(tp, tc, "float32"), tc)


def test_huge_importance_z_matches_jax(wide, jax_marches):
    """fused_importance_z as one kernel M at bf16 (the port's plain version,
    which the huge instance holds to on the card) against JAX's monolith in
    interpret mode, by the refined-z metric."""
    o, d, z0 = wide[4]
    tc, tp = _huge(jax_marches)
    out = tm.fused_importance_z(tp, tc, *(torch.tensor(a) for a in (o, d, z0)), mlp_dtype="bfloat16")
    _assert_z_close(out.numpy(), jax_marches["huge monolith", "bfloat16"])


def test_huge_shadow_tau_matches_jax(wide, jax_marches):
    """fused_shadow_tau as one kernel N at bf16 above 512 / 128: tau within
    1e-3 of JAX's."""
    o, d, z0 = wide[4]
    tc, tp = _huge(jax_marches)
    out = tm.fused_shadow_tau(tp, tc, *(torch.tensor(a) for a in (o, d, z0, SDIST)), torch.tensor(64.0),
                              torch.tensor(0.7), split=False, final_impl="pallas", mlp_dtype="bfloat16")
    ref = jax_marches["huge shadow", "bfloat16"]
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3)
    assert ref.min() < 0.9  # some shadow rays cross the surface
