"""The port's unfused renderer and what rides on it, on the CPU against the
JAX package: the samplers of the plain march (``sample_pdf``,
``neus_up_sample``, ``merge_z_vals``), the plain SDF's autograd normal and
forward-mode tangent, the bf16 ``compute_dtype`` of the SDF and the trunk,
the hash, SH and RFF encodings, the background NeRF, every ``render_rays``
route these open (``fused_kernels="off"``, PARITY.md's 16 + 2 x 8 geometry,
the hash encoding, the two other depth modes, the partial shadow hint, the
background NeRF) and train-step gradients through them, on the tiny
configs of torch_port_utils.py with numpy-seeded inputs.

Each route is held against JAX's same route: unfused features against JAX
at ``fused_kernels="off"`` (plain XLA, f32 end to end), features that ride
the fused path against JAX at "on" (Pallas interpret mode, few rays).
Tolerances: the samplers, the SDF helpers and the bg NeRF 1e-5; the
encodings 1e-6; an eikonal loss's parameter gradient through the SDF
helpers 2e-3 of each leaf's scale; the bf16 ``compute_dtype`` at
test_torch_render.py's bf16 TOLS, against each output's scale (a value
within an ulp of a bf16 rounding boundary rounds the other way on either
side); renders rgb and weights 5e-4, depth and shadow map 1e-3; train steps
the train tests' (loss 5e-3 relative, every gradient leaf 2e-2 of its
scale).  ``merge_z_vals`` is exact, values and gradients.  The last draw
of an up-sampling round (u = 1) depends on the prefix sum's last ulp
(ROADMAP Queue 3), so it is held to its last bin.  On the fused route the
two packages' marches (interpret kernels, plain versions) place a ray's
last low-weight samples differently, past the surface and outside the
sphere, and the unfused march's u = 1 draws land there too; the background
NeRF weights those samples by their spacing, so with it on the weights are
held per slot inside the sphere and by their NeuS and background sums.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrhints_torch.convert import params_from_jax
from nrhints_torch.core import encodings as tenc
from nrhints_torch.core import sampling as tsamp
from nrhints_torch.fields import bg_nerf as tbg
from nrhints_torch.fields import reflectance as trefl
from nrhints_torch.fields import sdf as tsdf
from nrhints_torch.render import renderer as tr
from nrhints_torch.utils import tree_items
from nrhints_tpu.core import encodings as jenc
from nrhints_tpu.core import sampling as jsamp
from nrhints_tpu.fields import bg_nerf as jbg
from nrhints_tpu.fields import reflectance as jrefl
from nrhints_tpu.fields import sdf as jsdf
from nrhints_tpu.render import renderer as jr
from tests.test_torch_render import TOLS
from tests.torch_port_utils import REFL_KW, SDF_KW, model_configs, model_params, ray_bundles, to_torch

PARITY = dict(n_samples=16, n_importance_samples=16, up_sample_steps=2, n_shadow_samples=16,
              n_shadow_importance_samples=16)
HASH = dict(encoding="hash", hash_levels=4, hash_min_res=4, hash_max_res=64, hash_log2_size=10)
BG_KW = dict(d_hidden=32, n_layers=4, skips=(2,), multi_res=4, multi_res_view=2)
BG = dict(use_outside_nerf=True, bg_kw=BG_KW)
RENDER_TOL = {"rgb": 5e-4, "weights": 5e-4, "depth": 1e-3, "visibilities": 1e-3}


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _jit(fn, *args):
    """``fn(*args)`` as one jitted JAX program (one compile, where the eager
    op-by-op run of an unrolled march compiles every op)."""
    return jax.jit(fn)(*args)


def _scaled_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


# ---------------------------------------------------------------------------
# The samplers


def _pdf_inputs(seed=0, batch=12, n_bins=17):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(0.0, 2.0, (batch, n_bins)).astype(np.float32), -1)
    w = rng.uniform(0.0, 1.0, (batch, n_bins - 1)).astype(np.float32)
    w[:3] = 0.0  # rays of zero weight: the 1e-5 floor makes their pdf uniform
    return bins, w


@pytest.mark.parametrize("det", [True, False], ids=["det", "given-u"])
def test_sample_pdf_matches_jax(det):
    bins, w = _pdf_inputs()
    key = jax.random.PRNGKey(1)
    a = jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 12, det=det, key=None if det else key)
    u = None if det else to_torch(jax.random.uniform(key, (bins.shape[0], 12)))
    b = tsamp.sample_pdf(torch.tensor(bins), torch.tensor(w), 12, det=det, u=u)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


def test_sample_pdf_gradient_matches_jax():
    """The gradient through the inverse-CDF positions (``shadow_hint_gradient``
    takes it): the gathers of cdf and bins, and t; the port sums repeated
    indices by comparison (a fixed order), JAX by its scatter-add."""
    bins, w = _pdf_inputs()
    cot = np.random.default_rng(2).normal(size=(bins.shape[0], 12)).astype(np.float32)
    jg = jax.grad(lambda b, w: jnp.sum(jsamp.sample_pdf(b, w, 12) * cot), argnums=(0, 1))(
        jnp.asarray(bins), jnp.asarray(w))
    tb, tw = torch.tensor(bins, requires_grad=True), torch.tensor(w, requires_grad=True)
    torch.sum(tsamp.sample_pdf(tb, tw, 12) * torch.tensor(cot)).backward()
    for port, ref in ((tb.grad, jg[0]), (tw.grad, jg[1])):
        assert _scaled_err(port.numpy(), ref) <= 1e-5


def test_gather_backward_equals_scatter_add():
    """The deterministic gather's backward sums what ``torch.gather``'s
    scatter-add backward sums (here to f32 rounding of one order)."""
    rng = np.random.default_rng(3)
    src = torch.tensor(rng.normal(size=(5, 9)).astype(np.float32), requires_grad=True)
    idx = torch.tensor(rng.integers(0, 9, (5, 20)))
    g = torch.tensor(rng.normal(size=(5, 20)).astype(np.float32))
    (a,) = torch.autograd.grad(tsamp._gather_last(src, idx), src, g)
    (b,) = torch.autograd.grad(torch.gather(src, -1, idx), src, g)
    assert torch.equal(tsamp._gather_last(src, idx), torch.gather(src, -1, idx))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_neus_up_sample_matches_jax():
    rng = np.random.default_rng(4)
    n = 10
    o = np.tile(np.array([[0.1, 0.2, -2.0]], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.tile(np.linspace(1.0, 3.0, 16, dtype=np.float32), (n, 1))
    sdf = (np.linalg.norm(o[:, None] + d[:, None] * z[..., None], axis=-1) - 0.5).astype(np.float32)
    a = np.asarray(jsamp.neus_up_sample(*map(jnp.asarray, (o, d, z, sdf)), 8, 64.0))
    b = tsamp.neus_up_sample(*map(torch.tensor, (o, d, z, sdf)), 8, 64.0).numpy()
    np.testing.assert_allclose(b[:, :-1], a[:, :-1], atol=1e-5)
    # The u = 1 draw: in the last bin on both sides.
    assert np.all(b[:, -1] >= z[:, -2] - 1e-6) and np.all(b[:, -1] <= z[:, -1] + 1e-6)
    assert np.all(a[:, -1] >= z[:, -2] - 1e-6)


def test_merge_z_vals_exact_with_gradient():
    """Sorted inputs with ties (old before new): values, merged sdf and the
    gradient in both value buffers bit for bit."""
    rng = np.random.default_rng(5)
    z = np.sort(rng.uniform(0, 1, (6, 10)).astype(np.float32), -1)
    nz = np.sort(np.concatenate([rng.uniform(0, 1, (6, 4)), z[:, 3:5]], -1).astype(np.float32), -1)
    s1, s2 = rng.normal(size=(6, 10)).astype(np.float32), rng.normal(size=(6, 6)).astype(np.float32)
    a = jsamp.merge_z_vals(*map(jnp.asarray, (z, nz, s1, s2)))
    b = tsamp.merge_z_vals(*map(torch.tensor, (z, nz, s1, s2)))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    assert tsamp.merge_z_vals(torch.tensor(z), torch.tensor(nz))[1] is None
    cot = rng.normal(size=(6, 16)).astype(np.float32)
    jg = jax.grad(lambda p, q, r, s: jnp.sum((jsamp.merge_z_vals(p, q, r, s)[0] + jsamp.merge_z_vals(p, q, r, s)[1] ** 2)
                                             * cot), argnums=(0, 1, 2, 3))(*map(jnp.asarray, (z, nz, s1, s2)))
    ts = [torch.tensor(v, requires_grad=True) for v in (z, nz, s1, s2)]
    mz, ms = tsamp.merge_z_vals(*ts)
    torch.sum((mz + ms**2) * torch.tensor(cot)).backward()
    for t, g in zip(ts, jg):
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(g))


# ---------------------------------------------------------------------------
# The plain SDF, the trunk's compute dtype, the encodings


def _sdf_pair(**extra):
    jc, tc = jsdf.SDFNetConfig(**{**SDF_KW, **extra}), tsdf.SDFNetConfig(**{**SDF_KW, **extra})
    jp = jax.device_get(jsdf.sdf_init(jax.random.PRNGKey(0), jc))
    return jc, tc, jp, params_from_jax(jp, device="cpu")


def _sdf_points(n=60):
    rng = np.random.default_rng(6)
    x = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return x, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("sdf_kw", [{}, HASH], ids=["frequency", "hash"])
def test_sdf_helpers_match_jax(sdf_kw):
    """sdf, feat and the autograd normal (with grad, and under no_grad as
    the evaluator calls it: detached outputs), and the forward-mode
    directional derivative (also under no_grad)."""
    jc, tc, jp, tp = _sdf_pair(**sdf_kw)
    x, d = _sdf_points()
    ref = _jit(lambda p, x: jsdf.sdf_value_feat_grad(p, jc, x), jp, jnp.asarray(x))
    for grad_mode in (True, False):
        with torch.set_grad_enabled(grad_mode):
            out = tsdf.sdf_value_feat_grad(tp, tc, torch.tensor(x))
        for a, b in zip(ref, out):
            assert not b.requires_grad
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    ref = _jit(lambda p, x, d: jsdf.sdf_value_and_dirderiv(p, jc, x, d), jp, jnp.asarray(x), jnp.asarray(d))
    for grad_mode in (True, False):
        with torch.set_grad_enabled(grad_mode):
            out = tsdf.sdf_value_and_dirderiv(tp, tc, torch.tensor(x), torch.tensor(d))
        for a, b in zip(ref, out):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


@pytest.mark.parametrize("sdf_kw", [{}, HASH], ids=["frequency", "hash"])
def test_eikonal_gradient_matches_jax(sdf_kw):
    """d/dparams of an eikonal loss on the autograd normal plus the sdf,
    the feature and the squared forward-mode tangent: the double backward
    through ``create_graph=True`` and the backward through the tangent,
    2e-3 of each leaf's scale (the hash table's too)."""
    jc, tc, jp, tp = _sdf_pair(**sdf_kw)
    x, d = _sdf_points()

    def j_loss(p):
        s, f, g = jsdf.sdf_value_feat_grad(p, jc, jnp.asarray(x))
        _, dc = jsdf.sdf_value_and_dirderiv(p, jc, jnp.asarray(x), jnp.asarray(d))
        return jnp.sum((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2) + jnp.sum(s) + 0.1 * jnp.sum(f**2) + jnp.sum(dc**2)

    jg = _jit(jax.grad(j_loss), jp)
    for _, t in tree_items(tp):
        t.requires_grad_(True)
    s, f, g = tsdf.sdf_value_feat_grad(tp, tc, torch.tensor(x))
    _, dc = tsdf.sdf_value_and_dirderiv(tp, tc, torch.tensor(x), torch.tensor(d))
    (torch.sum((torch.linalg.norm(g, dim=-1) - 1.0) ** 2) + s.sum() + 0.1 * (f**2).sum() + (dc**2).sum()).backward()
    port = dict(tree_items(tp))
    names = [n for n, _ in tree_items(jg)]
    assert names == sorted(port) and (("/hash/table" in names) == bool(sdf_kw))
    for name, ref in tree_items(jg):
        ref = np.asarray(ref)
        assert np.abs(port[name].grad.numpy() - ref).max() <= 2e-3 * np.abs(ref).max(), name


def test_sdf_bf16_compute_matches_jax():
    """``compute_dtype="bfloat16"``: bf16 activations, f32 accumulation
    against the unrounded f32 weight, on both sides."""
    tol = TOLS["bfloat16"]
    jc, tc, jp, tp = _sdf_pair(compute_dtype="bfloat16")
    x, d = _sdf_points()
    ref = _jit(lambda p, x: jsdf.sdf_value_feat_grad(p, jc, x), jp, jnp.asarray(x))
    out = tsdf.sdf_value_feat_grad(tp, tc, torch.tensor(x))
    for a, b, k in zip(ref, out, ("depth", "weights", "normal")):
        assert _scaled_err(b.numpy(), a) <= tol[k], k
    ref = _jit(lambda p, x, d: jsdf.sdf_value_and_dirderiv(p, jc, x, d), jp, jnp.asarray(x), jnp.asarray(d))
    out = tsdf.sdf_value_and_dirderiv(tp, tc, torch.tensor(x), torch.tensor(d))
    for a, b in zip(ref, out):
        assert _scaled_err(b.numpy(), a) <= tol["normal"]
    f32 = tsdf.sdf_forward(tp, dataclasses.replace(tc, compute_dtype="float32"), torch.tensor(x))
    assert 0 < _scaled_err(tsdf.sdf_forward(tp, tc, torch.tensor(x)).numpy(), f32.numpy())  # bf16 took effect


def test_reflectance_bf16_compute_matches_jax():
    rng = np.random.default_rng(7)
    n, feat = 50, SDF_KW["d_out_feat"]
    jc, tc = jrefl.ReflectanceNetConfig(compute_dtype="bfloat16", **REFL_KW), \
        trefl.ReflectanceNetConfig(compute_dtype="bfloat16", **REFL_KW)
    jp = jax.device_get(jrefl.reflectance_init(jax.random.PRNGKey(1), jc, d_feature=feat))
    jp = jax.tree_util.tree_map(lambda v: np.asarray(v) * 4.0, jp)
    args = [rng.normal(size=(n, k)).astype(np.float32) for k in (3, 3, 3, feat, 3, 1, 4)]
    a = jrefl.reflectance_forward(jp, jc, *map(jnp.asarray, args))
    b = trefl.reflectance_forward(params_from_jax(jp, device="cpu"), tc, *map(torch.tensor, args))
    assert _scaled_err(b.numpy(), a) <= TOLS["bfloat16"]["rgb"]


def test_hash_encoding_matches_jax():
    """Corners whose uint32 products with the primes wrap past 2^32 (points
    up to the unit cube's far corner at a 4..64 grid), a 2^10 table, and the
    table's gradient (an ``index_select`` backward)."""
    cfg_j = jenc.HashEncodingConfig(num_levels=4, min_res=4, max_res=64, log2_hashmap_size=10)
    cfg_t = tenc.HashEncodingConfig(*cfg_j)
    table = np.asarray(jenc.hash_encoding_init(jax.random.PRNGKey(2), cfg_j)["table"])
    x = np.random.default_rng(8).uniform(0.0, 1.0, (200, 3)).astype(np.float32)
    x[:4] = [[1.0, 1.0, 1.0], [0.0, 0.0, 0.0], [0.999, 0.5, 1.0], [0.25, 0.75, 0.125]]
    assert 64 * 2654435761 > 2**32
    cot = np.random.default_rng(9).normal(size=(200, cfg_j.out_dim)).astype(np.float32)
    a, vjp = jax.vjp(lambda t: jenc.hash_encoding_apply({"table": t}, jnp.asarray(x), cfg_j), jnp.asarray(table))
    (ga,) = vjp(jnp.asarray(cot))
    tt = torch.tensor(table, requires_grad=True)
    b = tenc.hash_encoding_apply({"table": tt}, torch.tensor(x), cfg_t)
    (b * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(ga), atol=1e-6)


def test_hash_level_scalings_in_float32():
    """At the defaults the finest level is JAX's float32 1024, not the
    float64 1023, and the port's init draws a table of the JAX shape."""
    cfg = tenc.HashEncodingConfig()
    assert tenc._level_scalings(cfg)[-1] == 1024.0 and tenc._level_scalings(cfg)[0] == 16.0
    t = tenc.hash_encoding_init(torch.Generator().manual_seed(0), cfg._replace(log2_hashmap_size=8), device="cpu")
    assert tuple(t["table"].shape) == (16, 256, 2) and float(t["table"].abs().max()) <= cfg.init_scale


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_spherical_harmonics_match_jax(levels):
    d = np.random.default_rng(10).normal(size=(30, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    a = jenc.spherical_harmonics_encoding(jnp.asarray(d), levels)
    b = tenc.spherical_harmonics_encoding(torch.tensor(d), levels)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


@pytest.mark.parametrize("include_input", [False, True])
def test_rff_matches_jax(include_input):
    p = jax.device_get(jenc.rff_encoding_init(jax.random.PRNGKey(3), 3, 8, 2.0))
    x = np.random.default_rng(11).uniform(-1, 1, (30, 3)).astype(np.float32)
    a = jenc.rff_encoding_apply(p, jnp.asarray(x), include_input)
    b = tenc.rff_encoding_apply(params_from_jax(p, device="cpu"), torch.tensor(x), include_input)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    ported = tenc.rff_encoding_init(torch.Generator().manual_seed(0), 3, 8, 2.0, device="cpu")
    assert tuple(ported["b_matrix"].shape) == (3, 8)


# ---------------------------------------------------------------------------
# The background NeRF


def test_bg_nerf_forward_matches_jax():
    jc, tc = jbg.BgNeRFConfig(**BG_KW), tbg.BgNeRFConfig(**BG_KW)
    jp = jax.device_get(jbg.bg_nerf_init(jax.random.PRNGKey(4), jc))
    tp = tbg.bg_nerf_init(torch.Generator().manual_seed(0), tc, device="cpu")
    assert {k: tuple(v.shape) for k, v in tree_items(tp)} == {k: np.shape(v) for k, v in tree_items(jp)}
    rng = np.random.default_rng(12)
    args = [rng.normal(size=(40, k)).astype(np.float32) for k in (4, 3, 3)]
    a = jbg.bg_nerf_forward(jp, jc, *map(jnp.asarray, args))
    b = tbg.bg_nerf_forward(params_from_jax(jp, device="cpu"), tc, *map(torch.tensor, args))
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-5)


def test_init_model_params_draws_bg_last():
    """With ``use_outside_nerf`` the bg subtree is drawn after the other
    fields, so their draws do not move; the tree matches JAX's, and
    ``params_from_jax`` carries "bg" and the hash table across."""
    _, t_off = model_configs()
    j_on, t_on = model_configs(**BG)
    a = tr.init_model_params(t_off, torch.Generator().manual_seed(0), device="cpu")
    b = tr.init_model_params(t_on, torch.Generator().manual_seed(0), device="cpu")
    assert "bg" not in a and "bg" in b
    for name, t in tree_items(a):
        assert torch.equal(t, dict(tree_items(b))[name]), name
    jp = jax.device_get(jr.init_model_params(jax.random.PRNGKey(0), j_on))
    assert {k: tuple(v.shape) for k, v in tree_items(b)} == {k: np.shape(v) for k, v in tree_items(jp)}
    j_hash, _ = model_configs(sdf_kw=HASH)
    jh = jax.device_get(jr.init_model_params(jax.random.PRNGKey(0), j_hash))
    th = params_from_jax(jh, device="cpu")
    np.testing.assert_array_equal(th["sdf"]["hash"]["table"].numpy(), jh["sdf"]["hash"]["table"])
    np.testing.assert_array_equal(params_from_jax(jp, device="cpu")["bg"]["rgb"]["w"].numpy(), jp["bg"]["rgb"]["w"])


# ---------------------------------------------------------------------------
# render_rays, each route against JAX's same route

# name -> (sdf_kw, renderer_kw, model_kw, rays)
ROUTES = {
    "unfused": ({}, dict(fused_kernels="off"), {}, 24),
    "parity_geometry": ({}, PARITY, {}, 24),
    "hash": (HASH, {}, {}, 24),
    "maximum_point": ({}, dict(depth_type="maximum_point"), {}, 12),
    "sphere_tracing": ({}, dict(depth_type="sphere_tracing"), {}, 12),
    "partial_hint": ({}, dict(n_shadow_importance_clip=32), dict(shadow_mini_chunk_size=200), 8),
    "bg_unfused": ({}, dict(fused_kernels="off", **PARITY, **BG), {}, 24),
    "bg_fused": ({}, BG, {}, 12),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_render_route_matches_jax(route):
    """The eval render of each route at the f32 march: rgb and weights
    5e-4, depth and shadow map 1e-3, the weighted normals 1e-3."""
    sdf_kw, renderer_kw, model_kw, n = ROUTES[route]
    jc, tc = model_configs(sdf_kw=sdf_kw, model_kw=model_kw, march_dtype="float32", **renderer_kw)
    jp, tp = model_params(jc)
    jrays, trays = _near_rays(n) if route == "sphere_tracing" else ray_bundles(0, n)
    jo = _jit(lambda p, r: jr.render_rays(p, jc, r, background_rgb=jnp.ones((1, 3))), jp, jrays)
    with torch.no_grad():
        to = tr.render_rays(tp, tc, trays, background_rgb=torch.ones(1, 3))
    for k in ("rgb", "depth", "visibilities"):
        np.testing.assert_allclose(_np(getattr(to, k)), np.asarray(getattr(jo, k)), atol=RENDER_TOL[k], err_msg=k)
    tw, jw = _np(to.weights), np.asarray(jo.weights)
    assert tw.shape == jw.shape
    if renderer_kw.get("use_outside_nerf"):
        s = tc.renderer.n_samples + tc.renderer.n_importance_samples
        inside = _np(to.inside_sphere)
        np.testing.assert_allclose(tw[:, :s] * inside, jw[:, :s] * inside, atol=RENDER_TOL["weights"])
        for part in (slice(0, s), slice(s, None)):
            np.testing.assert_allclose(tw[:, part].sum(1), jw[:, part].sum(1), atol=RENDER_TOL["weights"])
    else:
        np.testing.assert_allclose(tw, jw, atol=RENDER_TOL["weights"])
    s = np.asarray(jo.analytic_normals).shape[1]
    for k in ("analytic_normals", "normalized_analytic_normals"):
        a = np.einsum("bsc,bs->bc", np.asarray(getattr(jo, k)), jw[:, :s])
        b = np.einsum("bsc,bs->bc", _np(getattr(to, k)), tw[:, :s])
        np.testing.assert_allclose(b, a, atol=1e-3, err_msg=k)
    assert float(np.asarray(jo.visibilities).min()) < 0.9  # the shadow hint is exercised
    if route == "sphere_tracing":  # some rays converge on the surface, others escape past 100
        assert 0 < int(np.sum(np.asarray(jo.depth) < 100.0)) < n


def _near_rays(n: int):
    """Rays from radius 1.2 aimed near the centre, so sphere tracing meets
    the random-weight SDF (about 2.1 (|x| - 0.48) at the tiny config, which
    overshoots from the camera rays' radius 2.7 and lets every ray escape):
    as a JAX and a port RayBundle."""
    from nrhints_torch.core.structs import RayBundle as TRB
    from nrhints_tpu.core.structs import RayBundle as JRB
    from tests.torch_port_utils import camera_rays

    rng = np.random.default_rng(13)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = 1.2 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / 1.2 + 0.3 * rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mid = -np.sum(o * d, -1, keepdims=True)
    arrs = (o, d, camera_rays(0, n)[2], (mid - 1.0).astype(np.float32), (mid + 1.0).astype(np.float32))
    return JRB(*[jnp.asarray(a) for a in arrs]), TRB(*[torch.as_tensor(a) for a in arrs])


def _count_calls(monkeypatch, names):
    counts = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(tr, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(tr, name, wrapped)
    return counts


@pytest.mark.parametrize("route,expect", [
    ("unfused", dict(fused_importance_z=0, fused_shadow_tau=0, fused_sdf_value_feat_grad=0, fused_reflectance_forward=0)),
    ("parity_geometry", dict(fused_importance_z=0, fused_shadow_tau=0, fused_sdf_value_feat_grad=1)),
    ("hash", dict(fused_importance_z=0, fused_shadow_tau=0, fused_sdf_value_feat_grad=0)),
    ("shadow_hint_gradient", dict(fused_importance_z=1, fused_shadow_tau=0, fused_sdf_value_feat_grad=1,
                                  fused_reflectance_forward=1)),
    ("partial_hint", dict(fused_importance_z=1, fused_shadow_tau=2, fused_sdf_value_feat_grad=1)),
])
def test_routes_take_jax_kernels(monkeypatch, route, expect):
    """Where the kernels run, as JAX routes them: a training render (the
    fused trunk under "pallas") counts the calls of each kernel entry point.
    The partial hint marches 8 x 32 = 256 shadow rays in 2 chunks of 200
    (the last padded), one fused march each."""
    sdf_kw, renderer_kw, model_kw, n = ROUTES.get(route, ({}, dict(shadow_hint_gradient=True), {}, 8))
    _, tc = model_configs(sdf_kw=sdf_kw, model_kw=model_kw, march_dtype="float32", **renderer_kw)
    counts = _count_calls(monkeypatch, ["fused_importance_z", "fused_shadow_tau", "fused_sdf_value_feat_grad",
                                        "fused_reflectance_forward"])
    params = tr.init_model_params(tc, torch.Generator().manual_seed(0), device="cpu")
    _, trays = ray_bundles(0, min(n, 8))
    tr.render_rays(params, tc, trays, torch.Generator().manual_seed(1), is_training=True)
    for k, v in expect.items():
        assert counts[k] == v, (k, counts)


def test_check_ported_raises_only_for_stash_all():
    _, tc = model_configs(core_backward="stash_all")
    with pytest.raises(NotImplementedError):
        tr.check_ported(tc, is_training=True)
    tr.check_ported(tc)  # eval has no backward schedule
    _, th = model_configs(sdf_kw=HASH, core_backward="stash_all")
    tr.check_ported(th, is_training=True)  # the hash encoding never reaches the fused core
    for kw in (dict(fused_kernels="sometimes"), dict(depth_type="median")):
        with pytest.raises(ValueError):
            tr.check_ported(model_configs(**kw)[1])


def test_train_uniforms_layout_and_draws():
    """With the bg NeRF and the partial hint the render draws {"strat",
    "out", "shadow" [B, n_clip, n_shadow]}, and handed the drawn uniforms it
    renders the same bit for bit; with neither, the draws are the ones the
    port always drew."""
    _, tc = model_configs(march_dtype="float32", n_shadow_importance_clip=32, **BG)
    u = tr.train_uniforms(tc, 5, torch.Generator().manual_seed(2), "cpu")
    assert {k: tuple(v.shape) for k, v in u.items()} == {"strat": (5, 1), "out": (5, 32), "shadow": (5, 32, 64)}
    _, plain = model_configs(march_dtype="float32")
    v = tr.train_uniforms(plain, 5, torch.Generator().manual_seed(2), "cpu")
    g = torch.Generator().manual_seed(2)
    assert torch.equal(v["strat"], torch.rand((5, 1), generator=g)) and torch.equal(v["shadow"], torch.rand((5, 64), generator=g))
    params = tr.init_model_params(tc, torch.Generator().manual_seed(0), device="cpu")
    _, trays = ray_bundles(0, 5)
    a = tr.render_rays(params, tc, trays, torch.Generator().manual_seed(2), is_training=True)
    b = tr.render_rays(params, tc, trays, uniforms=u, is_training=True)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        assert (va is None and vb is None) or torch.equal(va, vb), f.name


def test_sphere_trace_checks_every_k_iterations():
    """Testing convergence every 16 iterations gives the depths of testing
    every iteration bit for bit (a converged ray is frozen); the loop ran
    past the all-converged point by fewer than 16 iterations."""
    _, tc = model_configs(depth_type="sphere_tracing")
    params = tr.init_model_params(tc, torch.Generator().manual_seed(0), device="cpu")
    _, trays = _near_rays(12)
    d1, i1 = tr.sphere_trace_depth(params, tc, trays.origins, trays.directions, check_every=1)
    d16, i16 = tr.sphere_trace_depth(params, tc, trays.origins, trays.directions)
    assert torch.equal(d1, d16) and i1 <= i16 < i1 + 16 and i16 % 16 == 0
    assert not tr.graph_capturable(tc) and tr.graph_capturable(model_configs()[1])


# ---------------------------------------------------------------------------
# Train steps: gradients against JAX's with JAX's uniforms handed in


def _jax_train_uniforms(key, jcfg, batch: int) -> dict:
    """The uniforms JAX's training render draws from ``key`` (its key split
    into strat, out and shadow), in the port's layout."""
    r = jcfg.model.renderer
    k_strat, k_out, k_shadow = jax.random.split(key, 3)
    u = {"strat": to_torch(jax.random.uniform(k_strat, (batch, 1))),
         "shadow": to_torch(jax.random.uniform(k_shadow, (batch, r.n_shadow_samples)))}
    if r.use_outside_nerf:
        u["out"] = to_torch(jax.random.uniform(k_out, (batch, r.n_outside_samples)))
    return u


TRAIN_CASES = {
    "parity_shadow_hint_gradient": ({}, dict(**PARITY, shadow_hint_gradient=True)),
    "unfused": ({}, dict(fused_kernels="off", **PARITY)),
    "hash": (HASH, PARITY),
    "bg": ({}, dict(fused_kernels="off", **PARITY, **BG)),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_gradients_match_jax(case):
    """One nr-hints-cam-opt step's loss, metrics and every gradient leaf
    (the hash table and the bg NeRF's included) against JAX's, at the
    train tests' tolerances.  Under ``shadow_hint_gradient`` the shadow
    march's gradient reaches the SDF, the variance, the poses and the
    lights' hint through the whole unfused march."""
    from nrhints_torch.train import step as tstep
    from nrhints_tpu.train import step as jstep
    from tests.test_torch_train import TOL, _close_scaled

    sdf_kw, renderer_kw = TRAIN_CASES[case]
    jcfg, tcfg, jp, tp, jcam, tcam, jb, tb, key = _train_setup(sdf_kw, renderer_kw)
    def loss_fn(params):
        out = jstep.forward_pipeline(params, {}, jcfg, jcam, jb, key, is_training=True, geometry_warmup=False,
                                     cos_anneal_ratio=1.0)
        return jstep.compute_loss_dict(out, jb.rgb_gt, jcfg.model.igr_weight)

    jgrads, jmetrics = _jit(jax.grad(loss_fn, has_aux=True), jax.tree_util.tree_map(jnp.asarray, jp))
    state = tstep.init_train_state(tp, tstep.make_optimizer(tcfg, tp))
    tmetrics = tstep.loss_and_grads(state, tcfg, tcam, {}, tb, uniforms=_jax_train_uniforms(key, jcfg, tb.rgb_gt.shape[0]))
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(tmetrics[k]), float(v), rtol=TOL["metric"], err_msg=k)
    port = dict(tree_items(tp))
    assert [n for n, _ in tree_items(jgrads)] == sorted(port)
    for name, g in tree_items(jgrads):
        _close_scaled(port[name].grad.numpy(), g, TOL["grad"], name)
    if case == "parity_shadow_hint_gradient":
        # The hint's gradient reaches the pose deltas only through the march.
        assert np.abs(np.asarray(jgrads["raygen"]["cam_pose_adjustment"])).max() > 0


def _train_setup(sdf_kw, renderer_kw, n_rays: int = 16):
    """nr-hints-cam-opt at the tiny config and the f32 march with
    ``renderer_kw``: (JAX cfg, port cfg, params both ways, cameras, one
    sampler batch both ways, key), as tests/test_torch_train.py sets up."""
    from nrhints_torch.camera.model import CameraModel as TCam
    from nrhints_torch.configs import config as tconf
    from nrhints_torch.core.structs import PixelBundle as TPB
    from nrhints_torch.data.sampler import PixelSampler
    from nrhints_torch.data.synthetic import scene_views
    from nrhints_tpu.camera.model import CameraModel as JCam
    from nrhints_tpu.configs import config as jconf
    from nrhints_tpu.core.structs import PixelBundle as JPB

    hw, views = 24, 3
    jm, tm = model_configs(sdf_kw=sdf_kw, march_dtype="float32", **renderer_kw)
    sched = dict(warm_up_end=2, end_iter=100, anneal_end=0, batch_size=n_rays)
    jcfg, tcfg = (dataclasses.replace(conf.PRESETS["nr-hints-cam-opt"](), model=dataclasses.replace(m, **sched))
                  for conf, m in ((jconf, jm), (tconf, tm)))
    jr_params, _ = model_params(jm)
    pose = (np.random.default_rng(3).normal(size=(views, 6)) * 0.02).astype(np.float32)
    jp = {"renderer": jr_params, "raygen": {"cam_pose_adjustment": pose}}
    sc = scene_views(views, hw, hw, seed=1)
    cam = (hw, hw, hw / 2.0, hw / 2.0, sc["focal"], sc["focal"], 0.1, 6.0)
    s = PixelSampler(views, hw, hw, n_rays).sample_batch()
    pix = dict(h_indices=s.h_indices.astype(np.float32), w_indices=s.w_indices.astype(np.float32),
               poses=sc["poses"][s.img_indices], pls=sc["pls"][s.img_indices],
               img_indices=s.img_indices.astype(np.int32), rgb_gt=sc["images"][s.img_indices, s.h_indices, s.w_indices])
    return (jcfg, tcfg, jp, params_from_jax(jp, device="cpu"), JCam(*cam), TCam(*cam),
            JPB(**{k: jnp.asarray(v) for k, v in pix.items()}), TPB(**{k: torch.as_tensor(v) for k, v in pix.items()}),
            jax.random.PRNGKey(7))


# ---------------------------------------------------------------------------
# The configuration and the checkpoint carry the new subtrees

OFFPATH_ARGV = ["config:nr-hints", "--config.model.renderer.fused-kernels", "off",
                "--config.model.sdf-network.encoding", "hash", "--config.model.sdf-network.hash-log2-size", "12",
                "--config.model.renderer.use-outside-nerf", "True", "--config.model.outside-nerf.d-hidden", "64",
                "--config.model.renderer.depth-type", "maximum_point",
                "--config.model.renderer.n-shadow-importance-clip", "32",
                "--config.model.renderer.shadow-hint-gradient", "True",
                "--config.model.sdf-network.compute-dtype", "bfloat16"]


def test_offpath_cli_matches_jax():
    from nrhints_torch.configs import cli as tcli
    from nrhints_torch.configs import config as tconf
    from nrhints_tpu.configs import cli as jcli
    from nrhints_tpu.configs import config as jconf

    t = tcli.parse_cli(tconf.PRESETS, tconf.DEFAULT_PRESET, list(OFFPATH_ARGV))
    j = jcli.parse_cli(jconf.PRESETS, jconf.DEFAULT_PRESET, list(OFFPATH_ARGV))
    assert tcli.config_to_dict(t) == jcli.config_to_dict(j)
    assert t.model.sdf_network.encoding == "hash" and t.model.renderer.fused_kernels == "off"


def test_trainer_checkpoint_round_trips_hash_and_bg(tmp_path):
    """A Trainer of the hash encoding and the background NeRF writes
    config.json (``config_to_dict``) and a checkpoint at step 2; a second
    Trainer of the same config resumes from it with every parameter,
    the hash table and the bg NeRF's included, bit for bit."""
    import json

    from nrhints_torch.configs import config as tconf
    from nrhints_torch.configs.cli import config_to_dict
    from nrhints_torch.data.synthetic import make_hints_scene
    from nrhints_torch.train import trainer as ttrainer

    scene = make_hints_scene(tmp_path / "scene", 2, 1, 1, H=8, W=8)
    _, tm = model_configs(sdf_kw=dict(HASH, d_hidden=48), march_dtype="float32", **PARITY, **BG)
    cfg = tconf.PRESETS["nr-hints"]()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(tm, end_iter=2, batch_size=16, warm_up_end=1),
        intervals=tconf.IntervalsConfig(log_metrics=1, save_ckpt=2, render_test_views=10**7, render_video=10**7,
                                        dump_mesh=10**7),
        data=dataclasses.replace(cfg.data, path=str(scene)), parallel=dataclasses.replace(cfg.parallel, data_axis_size=1),
        base_dir=str(tmp_path / "runs"))
    first = ttrainer.Trainer(cfg, device="cpu")
    first.dump_mesh = lambda resolution=256: None
    first.render_test_views = lambda is_final=False: {}
    first.run()
    saved = json.loads((first.log_dir / "config.json").read_text())
    assert saved == json.loads(json.dumps(config_to_dict(cfg)))
    assert saved["model"]["sdf_network"]["encoding"] == "hash" and saved["model"]["renderer"]["use_outside_nerf"]
    again = ttrainer.Trainer(cfg, device="cpu")
    assert again.global_step == 2
    names = [n for n, _ in tree_items(again.state.params)]
    assert "/renderer/sdf/hash/table" in names and "/renderer/bg/pts_lin0/w" in names
    for (name, a), (_, b) in zip(tree_items(first.state.params), tree_items(again.state.params)):
        assert torch.equal(a.detach(), b.detach()), name
