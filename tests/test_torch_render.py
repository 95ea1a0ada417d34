"""The port's ``render_rays(is_training=False)`` on the CPU against the JAX
``render_rays`` on its fused path (``fused_kernels="on"``, Pallas interpret
mode), with the same converted weights and rays.

Tolerances: at ``march_dtype="float32"`` the roadmap's: rgb and weights
5e-4, depth and shadow map 1e-3.  Both sides still round the SDF core's dot
operands to bf16 (the shipping core), and the march's u = 1 draw is decided
by the last ulp of a prefix sum (see test_torch_kernels.py), which moves
one sample inside a ray's low-weight tail.  At the shipping
``march_dtype="bfloat16"`` the march sweeps also round every activation to
bf16, so a rounding flip on either side moves importance samples by up to
a bf16 ulp of the sdf's effect: rgb 1e-3, weights 1e-2 (a single weight
moves with its sample), depth and shadow map 5e-3.  Per-sample normals are
compared through their weighted sum per ray, as the evaluator uses them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrhints_torch.render import renderer as tr
from nrhints_tpu.render import renderer as jr
from tests.torch_port_utils import model_configs, model_params, ray_bundles

TOLS = {
    "float32": {"rgb": 5e-4, "weights": 5e-4, "depth": 1e-3, "visibilities": 1e-3, "normal": 1e-3},
    "bfloat16": {"rgb": 1e-3, "weights": 1e-2, "depth": 5e-3, "visibilities": 5e-3, "normal": 5e-3},
}


@pytest.mark.parametrize("march_dtype", ["float32", "bfloat16"])
def test_render_rays_matches_jax(march_dtype):
    jc, tc = model_configs(march_dtype=march_dtype)
    jp, tp = model_params(jc)
    jrays, trays = ray_bundles(0)
    jo = jr.render_rays(jp, jc, jrays, background_rgb=jnp.ones((1, 3)))
    to = tr.render_rays(tp, tc, trays, background_rgb=torch.ones(1, 3))
    tol = TOLS[march_dtype]
    for k in ("rgb", "weights", "depth", "visibilities"):
        np.testing.assert_allclose(getattr(to, k).numpy(), np.asarray(getattr(jo, k)), atol=tol[k], err_msg=k)
    for k in ("analytic_normals", "normalized_analytic_normals"):
        a = np.einsum("bsc,bs->bc", np.asarray(getattr(jo, k)), np.asarray(jo.weights))
        b = torch.einsum("bsc,bs->bc", getattr(to, k), to.weights).numpy()
        np.testing.assert_allclose(b, a, atol=tol["normal"], err_msg=k)
    np.testing.assert_allclose(
        np.einsum("bsr,bs->br", to.specular_cue.numpy(), to.weights.numpy()),
        np.einsum("bsr,bs->br", np.asarray(jo.specular_cue), np.asarray(jo.weights)),
        atol=1e-4,
    )
    for k in ("s_val", "inside_sphere", "relax_inside_sphere"):
        assert getattr(to, k).shape == np.asarray(getattr(jo, k)).shape, k
    np.testing.assert_allclose(to.s_val.numpy(), np.asarray(jo.s_val), rtol=1e-6)
    assert float(np.asarray(jo.visibilities).min()) < 0.9  # the shadow hint is exercised


@pytest.mark.parametrize(
    "call_kw", [{"is_training": True}, {"geometry_warmup": True}, {"is_training": True, "geometry_warmup": True}],
    ids=["is_training", "geometry_warmup", "training_geometry_warmup"],
)
def test_training_branches_match_jax(call_kw):
    """The training render (jittered samples, the stash ops) and the
    geometry warm-up (hints zeroed) against JAX with the same uniforms,
    at the f32 march's tolerances."""
    import jax

    jc, tc = model_configs(march_dtype="float32")
    jp, tp = model_params(jc)
    jrays, trays = ray_bundles(0)
    key = jax.random.PRNGKey(3)
    k_strat, _, k_shadow = jax.random.split(key, 3)
    uniforms = {
        "strat": torch.tensor(np.asarray(jax.random.uniform(k_strat, (trays.origins.shape[0], 1)))),
        "shadow": torch.tensor(np.asarray(jax.random.uniform(k_shadow, (trays.origins.shape[0], 64)))),
    }
    jo = jr.render_rays(jp, jc, jrays, key, background_rgb=jnp.ones((1, 3)), **call_kw)
    to = tr.render_rays(tp, tc, trays, background_rgb=torch.ones(1, 3), uniforms=uniforms, **call_kw)
    tol = TOLS["float32"]
    for k in ("rgb", "weights", "depth", "visibilities"):
        np.testing.assert_allclose(getattr(to, k).detach().numpy(), np.asarray(getattr(jo, k)), atol=tol[k], err_msg=k)
    warm = call_kw.get("geometry_warmup", False)
    assert (float(to.visibilities.abs().max()) == 0.0) == warm
    assert (float(to.specular_cue.abs().max()) == 0.0) == warm


# The round-4 march: the monolith (kernels M and N) and the split march
# (K, L, and the shadow rays' M and C, by rank).
MONOLITH = {"march_sweep_impl": "pallas", "march_rounds_impl": "pallas", "shadow_split": False}
SPLIT = {"importance_split": True, "march_sweep_impl": "pallas", "march_rounds_impl": "pallas", "march_merge": "rank"}
PORTED = [
    ({"core_backward": "recompute"}, True),
    ({"core_backward": "stash_xla"}, True),
    ({"core_backward": "stash_all"}, True),
    ({"reflectance_impl": "xla"}, True),
    ({"eval_reflectance_impl": "pallas"}, False),
    (MONOLITH, False),
    (MONOLITH, True),
    (SPLIT, False),
    ({"march_merge": "rank"}, False),
    ({"march_sweep_impl": "pallas"}, False),
    ({"march_rounds_impl": "pallas"}, False),
    ({"shadow_final_impl": "xla"}, False),
    ({"shadow_hint": False, "specular_hint": False}, False),
    ({"shadow_hint": False, "force_shadow_map": True}, False),
    ({"specular_hint": False, "force_specular_cue": True}, False),
    ({"normal_type": "analytic"}, False),
]


@pytest.mark.parametrize("renderer_kw,is_training", PORTED, ids=[
    "recompute", "stash_xla", "stash_all", "train_trunk_xla", "eval_trunk_pallas", "monolith_march", "monolith_march_training",
    "split_march_rank", "merge_rank", "sweep_pallas", "rounds_pallas", "shadow_final_xla", "pl_naive_no_hints",
    "force_shadow_map", "force_specular_cue", "normal_analytic"])
def test_ported_settings_match_jax(renderer_kw, is_training):
    """The backward schedules, trunk choices, march routes and the hint and
    normal switches the port has, through ``render_rays`` against JAX at the
    f32 march's tolerances (the specular cue at rgb's).  Training
    cases run with parameters that need gradients, so the autograd ops of
    the schedule run, and also compare the gradient of sum(rgb) + the
    eikonal term at every leaf (2e-2 of its scale, the train tests'
    gradient tolerance).  The eval trunk under "pallas" rounds its dot
    operands to bf16 on both sides; rgb still agrees to the f32 5e-4."""
    import jax

    from nrhints_torch.utils import tree_items

    jc, tc = model_configs(march_dtype="float32", **renderer_kw)
    jp, tp = model_params(jc)
    jrays, trays = ray_bundles(0)
    key = jax.random.PRNGKey(3)
    k_strat, _, k_shadow = jax.random.split(key, 3)
    uniforms = {
        "strat": torch.tensor(np.asarray(jax.random.uniform(k_strat, (trays.origins.shape[0], 1)))),
        "shadow": torch.tensor(np.asarray(jax.random.uniform(k_shadow, (trays.origins.shape[0], 64)))),
    }

    def j_loss(p):
        o = jr.render_rays(p, jc, jrays, key, background_rgb=jnp.ones((1, 3)), is_training=is_training)
        return jnp.sum(o.rgb) + jnp.sum((jnp.linalg.norm(o.analytic_normals, axis=-1) - 1.0) ** 2), o

    tol = TOLS["float32"]
    if is_training:
        (_, jo), jgrads = jax.value_and_grad(j_loss, has_aux=True)(jax.tree_util.tree_map(jnp.asarray, jp))
        for _, t in tree_items(tp):
            t.requires_grad_(True)
        to = tr.render_rays(tp, tc, trays, background_rgb=torch.ones(1, 3), uniforms=uniforms, is_training=True)
        loss = torch.sum(to.rgb) + torch.sum((torch.linalg.norm(to.analytic_normals, dim=-1) - 1.0) ** 2)
        loss.backward()
        for name, g in tree_items(jgrads):
            port = dict(tree_items(tp))[name].grad.numpy()
            scale = float(np.abs(np.asarray(g)).max())
            assert np.abs(port - np.asarray(g)).max() <= 2e-2 * scale, name
    else:
        _, jo = j_loss(jp)
        with torch.no_grad():
            to = tr.render_rays(tp, tc, trays, background_rgb=torch.ones(1, 3))
    for k in ("rgb", "weights", "depth", "visibilities", "specular_cue"):
        jv, tv = getattr(jo, k), getattr(to, k)
        assert (jv is None) == (tv is None), k
        if jv is not None:
            np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), atol=tol.get(k, tol["rgb"]), err_msg=k)


@pytest.mark.parametrize("renderer_kw", [{"march_sweep_impl": "mosaic"}, {"march_rounds_impl": "fori"},
                                         {"shadow_final_impl": "cuda"}, {"march_merge": "odd_even"}])
def test_bad_march_knobs_raise(renderer_kw):
    """A march knob outside its JAX set raises ``ValueError``."""
    _, tc = model_configs(**renderer_kw)
    with pytest.raises(ValueError):
        tr.check_ported(tc)
