"""The port's field and core modules against their JAX counterparts, on the
same numpy-seeded inputs, in float32 on the CPU (rtol 1e-5: the same
arithmetic, summed in another order by another BLAS)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrhints_torch.convert import params_from_jax
from nrhints_torch.core import brdf as tbrdf, encodings as tenc, lie as tlie, sampling as tsamp
from nrhints_torch.fields import reflectance as trefl, sdf as tsdf, variance as tvar
from nrhints_tpu.core import brdf as jbrdf, encodings as jenc, lie as jlie, sampling as jsamp
from nrhints_tpu.fields import reflectance as jrefl, sdf as jsdf, variance as jvar
from tests.torch_port_utils import SDF_KW, jax_sdf_params, to_torch

RTOL, ATOL = 1e-5, 1e-6


def close(port: torch.Tensor, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n_freq,d", [(4, 3), (6, 3), (4, 1), (4, 4)])
def test_nerf_encoding(n_freq, d):
    x = np.random.default_rng(0).normal(size=(50, d)).astype(np.float32) * 2
    assert tenc.nerf_encoding_dim(d, n_freq) == jenc.nerf_encoding_dim(d, n_freq)
    close(tenc.nerf_encoding(torch.tensor(x), n_freq), jenc.nerf_encoding(jnp.asarray(x), n_freq))


def test_cook_torrance_and_normalize():
    rng = np.random.default_rng(1)
    n, l, v = (rng.normal(size=(40, 3)).astype(np.float32) for _ in range(3))
    close(tbrdf.normalize(torch.tensor(n)), jbrdf.normalize(jnp.asarray(n)))
    args = [jbrdf.normalize(jnp.asarray(a)) for a in (n, l, v)]
    rough = (0.02, 0.05, 0.13, 0.34)
    ref = jbrdf.cook_torrance_specular(*args, rough)
    close(tbrdf.cook_torrance_specular(*[to_torch(a) for a in args], rough), ref, atol=1e-7)


@pytest.mark.parametrize("fn", ["exp_map_SO3xR3", "exp_map_SE3"])
def test_lie_exp_maps(fn):
    rng = np.random.default_rng(2)
    tangent = rng.normal(size=(16, 6)).astype(np.float32) * 0.5
    tangent[:4, 3:] *= 1e-4  # the near-zero (Taylor) branch
    close(getattr(tlie, fn)(torch.tensor(tangent)), getattr(jlie, fn)(jnp.asarray(tangent)))


def test_stratified_and_transmittance():
    rng = np.random.default_rng(3)
    near = rng.uniform(1.0, 2.0, (10, 1)).astype(np.float32)
    far = near + 2.0
    np.testing.assert_array_equal(
        tsamp.stratified_z_vals(torch.tensor(near), torch.tensor(far), 64).numpy(),
        np.asarray(jsamp.stratified_z_vals(jnp.asarray(near), jnp.asarray(far), 64)),
    )
    alpha = rng.uniform(0, 1, (10, 128)).astype(np.float32)
    close(tsamp.transmittance(torch.tensor(alpha)), jsamp.transmittance(jnp.asarray(alpha)))


def test_variance():
    tp = tvar.variance_init(device="cpu")
    jp = jvar.variance_init()
    close(tp["variance"], jp["variance"])
    close(tvar.inv_s_from_params(tp), jvar.inv_s_from_params(jp))


@pytest.mark.parametrize("full_width", [False, True])
def test_sdf_forward(full_width):
    kw = {} if full_width else SDF_KW
    jc = jsdf.SDFNetConfig(**kw)
    jp = jax.device_get(jsdf.sdf_init(jax.random.PRNGKey(0), jc))
    x = np.random.default_rng(4).normal(size=(33, 3)).astype(np.float32) * 0.6
    ref = jsdf.sdf_forward(jp, jc, jnp.asarray(x))
    out = tsdf.sdf_forward(params_from_jax(jp, device="cpu"), tsdf.SDFNetConfig(**kw), torch.tensor(x))
    close(out, ref, rtol=1e-5, atol=1e-5)
    close(tsdf.sdf_only(params_from_jax(jp, device="cpu"), tsdf.SDFNetConfig(**kw), torch.tensor(x)), jsdf.sdf_only(jp, jc, jnp.asarray(x)), rtol=1e-5, atol=1e-5)
    assert tsdf._layer_dims(tsdf.SDFNetConfig(**kw)) == jsdf._layer_dims(jc)


@pytest.mark.parametrize("hints", [(True, True), (False, False)])
def test_reflectance_forward(hints):
    shadow, spec = hints
    jc, tc = jrefl.ReflectanceNetConfig(n_layers=2, d_hidden=32), trefl.ReflectanceNetConfig(n_layers=2, d_hidden=32)
    dims = dict(d_feature=16, shadow_hint=shadow, specular_hint=spec, specular_hint_len=4)
    assert trefl.reflectance_input_dim(tc, **dims) == jrefl.reflectance_input_dim(jc, **dims)
    jp = jax.device_get(jrefl.reflectance_init(jax.random.PRNGKey(1), jc, d_out=3, **dims))
    rng = np.random.default_rng(5)
    args = [rng.normal(size=(20, w)).astype(np.float32) for w in (3, 3, 3, 16, 3)]
    args += [rng.uniform(size=(20, 1)).astype(np.float32) if shadow else None]
    args += [rng.uniform(size=(20, 4)).astype(np.float32) if spec else None]
    ref = jrefl.reflectance_forward(jp, jc, *[None if a is None else jnp.asarray(a) for a in args])
    out = trefl.reflectance_forward(params_from_jax(jp, device="cpu"), tc, *[None if a is None else torch.tensor(a) for a in args])
    close(out, ref)


def test_params_from_jax_keys_and_layout():
    """Same keys, same [in, out] layout, same values, effective weights equal."""
    from nrhints_torch.fields.mlp import effective_weight as teff
    from nrhints_tpu.fields.mlp import effective_weight as jeff

    jc, jp, tc, tp = jax_sdf_params()
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: t.numpy(), tp)
    )
    for name, layer in jp.items():
        for k, v in layer.items():
            assert tp[name][k].shape == tuple(np.shape(v)) and tp[name][k].dtype == torch.float32
            np.testing.assert_array_equal(tp[name][k].numpy(), np.asarray(v))
        w, b = jeff(layer)
        tw, tb = teff(tp[name])
        close(tw, w)
        close(tb, b)


@pytest.mark.parametrize("cam_opt_mode,sphere", [("SO3xR3", True), ("SE3", False), ("off", True)])
def test_generate_rays_with_deltas_and_noise(cam_opt_mode, sphere):
    """Learned pose and light deltas plus the fixed noise buffers, indexed
    per pixel by image; buffers made by the JAX init and carried across."""
    from nrhints_torch.camera import model as tcm, rays as trays
    from nrhints_torch.core.structs import PixelBundle as TPB
    from nrhints_tpu.camera import model as jcm, rays as jrays
    from nrhints_tpu.core.structs import PixelBundle as JPB

    kw = dict(cam_opt_mode=cam_opt_mode, override_near_far_from_sphere=sphere, pl_opt=True,
              cam_position_noise_std=0.01, cam_orientation_noise_std=0.02, pl_position_noise_std=0.05)
    jcfg, tcfg = jrays.RayGeneratorConfig(**kw), trays.RayGeneratorConfig(**kw)
    jparams, jbuf = jax.device_get(jrays.ray_generator_init(jax.random.PRNGKey(0), jcfg, 5))
    tparams, tbuf = trays.ray_generator_init(torch.Generator().manual_seed(0), tcfg, 5, device="cpu")
    assert {k: tuple(v.shape) for k, v in tparams.items()} == {k: np.shape(v) for k, v in jparams.items()}
    assert {k: tuple(v.shape) for k, v in tbuf.items()} == {k: np.shape(v) for k, v in jbuf.items()}
    rng = np.random.default_rng(6)
    jparams = {k: (rng.normal(size=np.shape(v)) * 0.05).astype(np.float32) for k, v in jparams.items()}
    n = 30
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(n, 3)) + np.array([0.0, 0.0, 2.7])
    pix = dict(
        h_indices=rng.integers(0, 12, n).astype(np.float32), w_indices=rng.integers(0, 16, n).astype(np.float32),
        poses=poses, pls=rng.normal(size=(n, 3)).astype(np.float32), img_indices=rng.integers(0, 5, n).astype(np.int32),
    )
    cam = (12, 16, 8.0, 6.0, 19.0, 19.0, 0.1, 6.0)
    ref = jrays.generate_rays(jparams, jbuf, jcm.CameraModel(*cam), jcfg, JPB(**{k: jnp.asarray(v) for k, v in pix.items()}))
    out = trays.generate_rays(
        params_from_jax(jparams, device="cpu"), params_from_jax(jbuf, device="cpu"), tcm.CameraModel(*cam), tcfg,
        TPB(**{k: torch.tensor(v) for k, v in pix.items()}),
    )
    for k in ("origins", "directions", "pl_positions", "nears", "fars"):
        close(getattr(out, k), getattr(ref, k), atol=1e-5)


def test_sdf_init_structure_matches_jax():
    """The port's own SAL init: same keys and shapes, the encoding rows of
    the input and skip layers zeroed, heads near sqrt(pi)/sqrt(d_feat + 1)."""
    jc, jp, tc, _ = jax_sdf_params()
    tp = tsdf.sdf_init(torch.Generator().manual_seed(0), tc, device="cpu")
    for name, layer in jp.items():
        assert set(tp[name]) == set(layer)
        for k in layer:
            assert tuple(tp[name][k].shape) == np.shape(layer[k])
    d0 = tc.d_encoded
    assert torch.all(tp["lin0"]["v"][3:] == 0)
    assert torch.all(tp["lin2"]["v"][-(d0 - 3):] == 0)
    mean = np.sqrt(np.pi) / np.sqrt(tc.d_out_feat + 1)
    np.testing.assert_allclose(tp["out_sdf"]["v"].numpy(), mean, atol=1e-3)
    np.testing.assert_allclose(tp["out_sdf"]["b"].numpy(), -tc.init_bias * tc.scale)
