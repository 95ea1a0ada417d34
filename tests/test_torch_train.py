"""The port's train step on the CPU against the JAX package's, on the tiny
configs of torch_port_utils.py (4 x 32 SDF with a skip at 2, 2 x 32 trunk,
24 rays of a 24 x 24 procedural scene).  JAX runs its fused path with the
Pallas kernels in interpret mode; both sides start from the same converted
parameters, take the same pixels, and see the same jitter: the test draws
JAX's own uniforms (``renderer.py``'s key split, ``sampling.py``'s draws)
and hands them to the port.

Tolerances: both steps round the SDF core's and the trunk's dot operands to
bf16 (the shipping kernels; the JAX renderer has no f32 switch), and a
value within an ulp of a bf16 rounding boundary can round the other way on
either side.  The march runs in f32 (``march_dtype="float32"``) so no
importance sample moves by a bf16 flip.  Loss and metrics agree to 5e-3
relative: with the pose deltas (nr-hints-cam-opt) the two packages' rays
differ in their last ulp, which flips the r < 1 mask of samples that lie on
the unit sphere (2 of 1,577 in this case) and moves the eikonal loss by
2e-3; without them they agree to 1e-6.  Every gradient leaf agrees to 2e-2
of its largest entry.  Two Adam steps on two batches: Adam's first moment,
linear in the gradients, agrees to 2e-2 of its leaf's largest entry (as
the gradients; measured 8.2e-3), its second moment, quadratic, to 4e-2
(twice that; measured 5.1e-3).  The parameter change mhat / sqrt(vhat) is
steep where the two gradients nearly cancel in mhat, so it is compared on
the entries where both gradients and mhat exceed 5e-2 of their leaf's
largest entry, 2.5 times the gradients' noise floor: there it agrees to
5e-2 of the leaf's largest change plus 1e-6 (measured 2.1e-2).  The JAX
side of the two steps is one run of its ``make_train_step_scan`` at K = 2
(the step of ``make_train_step`` twice), shared by the port's two single
steps and its K = 2 scan; the scan's parameters also agree to 2e-3 of
each leaf's scale where the leaf does not start at 0.  The gradient cases
include the branches only a train step reaches: the specular hint's
gradient, SE(3) pose deltas, light deltas and the hint-less pl-naive.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrhints_torch.camera.model import CameraModel as TCam
from nrhints_torch.configs import config as tconf
from nrhints_torch.core.structs import PixelBundle as TPB
from nrhints_torch.data.sampler import PixelSampler as TSampler
from nrhints_torch.data.synthetic import scene_views
from nrhints_torch.kernels import core_stash as tcs
from nrhints_torch.render import renderer as tr
from nrhints_torch.train import step as tstep
from nrhints_torch.utils import tree_items
from nrhints_tpu.camera.model import CameraModel as JCam
from nrhints_tpu.configs import config as jconf
from nrhints_tpu.core.structs import PixelBundle as JPB
from nrhints_tpu.data.sampler import PixelSampler as JSampler
from nrhints_tpu.train import step as jstep
from tests.torch_port_utils import N_RAYS, model_configs, model_params, to_torch

HW = 24
N_VIEWS = 3
TOL = {"metric": 5e-3, "grad": 2e-2, "moment2": 4e-2, "clear": 5e-2, "update": 5e-2}


def _close_scaled(a, b, tol, what, atol=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    err = float(np.abs(a - b).max()) if a.size else 0.0
    scale = float(np.abs(b).max()) if b.size else 0.0
    assert err <= tol * scale + atol, f"{what}: err {err:.3e} vs scale {scale:.3e}"


def _setup(preset: str, n_batches: int = 1, raygen_kw: dict | None = None, **renderer_kw):
    """(JAX cfg, port cfg, JAX params, port params, cameras, the first
    ``n_batches`` PixelSampler batches as JAX and port lists, key).  The
    preset's hints and ray generator, with ``raygen_kw`` and
    ``renderer_kw`` over them; pose and light deltas of about 0.02 where
    the ray generator learns them."""
    r = tconf.PRESETS[preset]().model.renderer
    jm, tm = model_configs(march_dtype="float32", **{"shadow_hint": r.shadow_hint, "specular_hint": r.specular_hint,
                                                     **renderer_kw})
    # anneal_end=0: cos_anneal_ratio stays 1, so both steps see one gradient.
    sched = dict(warm_up_end=2, end_iter=100, anneal_end=0, batch_size=N_RAYS)
    cfgs = []
    for conf, m in ((jconf, jm), (tconf, tm)):
        c = conf.PRESETS[preset]()
        cfgs.append(dataclasses.replace(c, model=dataclasses.replace(m, **sched),
                                        ray_generator=dataclasses.replace(c.ray_generator, **(raygen_kw or {}))))
    jcfg, tcfg = cfgs
    jr, _ = model_params(jm)
    raygen = {}
    if jcfg.ray_generator.cam_opt_mode != "off":
        raygen["cam_pose_adjustment"] = (np.random.default_rng(3).normal(size=(N_VIEWS, 6)) * 0.02).astype(np.float32)
    if jcfg.ray_generator.pl_opt:
        raygen["pl_adjustment"] = (np.random.default_rng(4).normal(size=(N_VIEWS, 3)) * 0.02).astype(np.float32)
    jp = {"renderer": jr, "raygen": raygen}
    from nrhints_torch.convert import params_from_jax

    tp = params_from_jax(jp, device="cpu")
    sc = scene_views(N_VIEWS, HW, HW, seed=1)
    cam = (HW, HW, HW / 2.0, HW / 2.0, sc["focal"], sc["focal"], 0.1, 6.0)
    sampler = TSampler(N_VIEWS, HW, HW, N_RAYS)
    jbs, tbs = [], []
    for _ in range(n_batches):
        s = sampler.sample_batch()
        pix = dict(
            h_indices=s.h_indices.astype(np.float32), w_indices=s.w_indices.astype(np.float32),
            poses=sc["poses"][s.img_indices], pls=sc["pls"][s.img_indices], img_indices=s.img_indices.astype(np.int32),
            rgb_gt=sc["images"][s.img_indices, s.h_indices, s.w_indices],
        )
        jbs.append(JPB(**{k: jnp.asarray(v) for k, v in pix.items()}))
        tbs.append(TPB(**{k: torch.as_tensor(v) for k, v in pix.items()}))
    return jcfg, tcfg, jp, tp, JCam(*cam), TCam(*cam), jbs, tbs, jax.random.PRNGKey(7)


def _jax_uniforms(key, batch: int, n_shadow: int) -> dict:
    """The uniforms JAX's training render draws from ``key``."""
    k_strat, _, k_shadow = jax.random.split(key, 3)
    return {
        "strat": to_torch(jax.random.uniform(k_strat, (batch, 1), dtype=jnp.float32)),
        "shadow": to_torch(jax.random.uniform(k_shadow, (batch, n_shadow), dtype=jnp.float32)),
    }


def _jax_grads(jcfg, jp, jcam, jb, key, geometry_warmup):
    def loss_fn(params):
        out = jstep.forward_pipeline(params, {}, jcfg, jcam, jb, key, is_training=True,
                                     geometry_warmup=geometry_warmup, cos_anneal_ratio=1.0)
        return jstep.compute_loss_dict(out, jb.rgb_gt, jcfg.model.igr_weight)

    return jax.grad(loss_fn, has_aux=True)(jax.tree_util.tree_map(jnp.asarray, jp))


@pytest.mark.parametrize(
    "preset,geometry_warmup,core_backward,raygen_kw,renderer_kw",
    [("nr-hints", False, "stash", {}, {}), ("nr-hints-cam-opt", False, "stash", {}, {}),
     ("nr-hints", True, "stash", {}, {}), ("nr-hints-cam-opt", False, "recompute", {}, {}),
     ("nr-hints-cam-opt", False, "stash_xla", {}, {}), ("nr-hints-cam-opt", False, "stash_all", {}, {}),
     ("nr-hints", False, "stash", {}, {"specular_hint_gradient": True}),
     ("nr-hints-cam-opt", False, "stash", {"cam_opt_mode": "SE3"}, {}),
     ("nr-hints", False, "stash", {"pl_opt": True}, {}), ("pl-naive", False, "stash", {}, {})],
    ids=["nr-hints", "nr-hints-cam-opt", "geometry-warmup", "nr-hints-cam-opt-recompute", "nr-hints-cam-opt-stash_xla",
         "nr-hints-cam-opt-stash_all",
         "specular-hint-gradient", "cam-opt-SE3", "pl-opt", "pl-naive"],
)
def test_step_gradients_match_jax(preset, geometry_warmup, core_backward, raygen_kw, renderer_kw):
    """One step's loss, metrics and every gradient leaf under each ported
    backward schedule (the recompute op: kernels A, H, I, J on the card;
    stash_xla: D, F and the stash backward as full-batch PyTorch;
    stash_all: D's and E's variants with the reverse sweep stashed), and on
    the branches the step reaches with the specular hint's gradient, SE(3)
    pose deltas, light deltas (``pl_opt``) and no hints (``pl-naive``)."""
    jcfg, tcfg, jp, tp, jcam, tcam, (jb,), (tb,), key = _setup(preset, raygen_kw=raygen_kw,
                                                               core_backward=core_backward, **renderer_kw)
    jgrads, jmetrics = _jax_grads(jcfg, jp, jcam, jb, key, geometry_warmup)
    state = tstep.init_train_state(tp, tstep.make_optimizer(tcfg, tp))
    tmetrics = tstep.loss_and_grads(
        state, tcfg, tcam, {}, tb, geometry_warmup=geometry_warmup,
        uniforms=_jax_uniforms(key, N_RAYS, tcfg.model.renderer.n_shadow_samples),
    )
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(tmetrics[k]), float(v), rtol=TOL["metric"], err_msg=k)
    port = dict(tree_items(tp))
    names = [n for n, _ in tree_items(jgrads)]
    assert names == sorted(port) and "/renderer/variance/variance" in names
    if tcfg.ray_generator.cam_opt_mode != "off":
        assert "/raygen/cam_pose_adjustment" in names
    if tcfg.ray_generator.pl_opt:
        assert "/raygen/pl_adjustment" in names
    for name, g in tree_items(jgrads):
        _close_scaled(port[name].grad.numpy(), g, TOL["grad"], name)
    assert np.abs(np.asarray(jgrads["renderer"]["variance"]["variance"])) > 0


def _optax_moments(opt_state) -> dict:
    """name -> (mu, nu): Adam's moments of every leaf in the JAX step's
    multi_transform state (each group's state masks the other's leaves)."""
    import optax

    is_adam = lambda st: isinstance(st, optax.ScaleByAdamState)  # noqa: E731
    out = {}
    for st in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam):
        if is_adam(st):
            nus = dict(tree_items(st.nu))
            out.update({n: (np.asarray(mu), np.asarray(nus[n])) for n, mu in tree_items(st.mu)
                        if not isinstance(mu, optax.MaskedNode)})
    return out


@pytest.fixture(scope="module")
def jax_two_steps():
    """Two whole steps of nr-hints-cam-opt in JAX, from the converted state,
    on the first two sampler batches, as one dispatch of JAX's
    ``make_train_step_scan`` at K = 2 (the step of ``make_train_step``
    twice, each step's key folded from the carried step): (the _setup
    tuple, JAX's state after the two steps, its last metrics, each step's
    key, each step's (gradients, metrics) at the starting parameters).  The
    first step (lr factor 0) moves nothing, so both steps' gradients are
    taken there."""
    setup = _setup("nr-hints-cam-opt", n_batches=2)
    jcfg, _, jp, _, jcam, _, jbs, _, key = setup
    opt = jstep.make_optimizer(jcfg)
    state = jstep.init_train_state(jax.tree_util.tree_map(jnp.asarray, jp), opt)
    scan = jstep.make_train_step_scan(jcfg, jcam, {}, opt, n_steps=2, donate=False)
    state, metrics = scan(state, jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jbs), key)
    keys = [jax.random.fold_in(key, i) for i in range(2)]
    at_start = [_jax_grads(jcfg, jp, jcam, jb, k, False) for jb, k in zip(jbs, keys)]
    return setup, state, metrics, keys, at_start


def _fresh_port_state(setup):
    """A port train state on the CPU from the fixture's JAX params (the
    fixture's own port tree stays untouched)."""
    from nrhints_torch.convert import params_from_jax

    tcfg, jp = setup[1], setup[2]
    tp = params_from_jax(jp, device="cpu")
    return tstep.init_train_state(tp, tstep.make_optimizer(tcfg, tp))


def _hold_two_steps(jax_two_steps, tstate) -> None:
    """The port's state after two steps against JAX's: both Adam moments,
    and the parameter change where it is clear of the gradients' noise."""
    (_, tcfg, jp, _, _, _, _, _, _), jstate, _, _, at_start = jax_two_steps
    topt = tstate.optimizer
    grads = [dict(tree_items(g)) for g, _ in at_start]
    assert all(np.abs(grads[0][n] - grads[1][n]).max() > 0.1 * np.abs(grads[0][n]).max() for n in grads[0])
    moments = _optax_moments(jstate.opt_state)
    port = dict(tree_items(tstate.params))
    assert sorted(moments) == sorted(port)
    p0s = dict(tree_items(jp))
    # |mhat| / sqrt(vhat) <= sqrt(sum_t a_t^2 / c_t) (Cauchy-Schwarz) for
    # mhat = sum_t a_t g_t and vhat = sum_t c_t g_t^2 over the two steps.
    (b1, b2), n_steps = topt.defaults["betas"], 2
    a = [(1 - b1) * b1 ** (n_steps - 1 - t) / (1 - b1**n_steps) for t in range(n_steps)]
    c = [(1 - b2) * b2 ** (n_steps - 1 - t) / (1 - b2**n_steps) for t in range(n_steps)]
    ratio_max = float(np.sqrt(sum(x * x / y for x, y in zip(a, c))))
    moved = 0
    for name, p1 in tree_items(jax.device_get(jstate.params)):
        st = topt.state[port[name]]
        mu, nu = moments[name]
        _close_scaled(st["exp_avg"].numpy(), mu, TOL["grad"], f"{name} exp_avg")
        _close_scaled(st["exp_avg_sq"].numpy(), nu, TOL["moment2"], f"{name} exp_avg_sq")
        d_jax, d_port = np.asarray(p1) - p0s[name], port[name].detach().numpy() - p0s[name]
        step_max = 0.5 * (tcfg.model.lr if name.startswith("/renderer") else tcfg.ray_generator.opt_lr) * ratio_max
        ulp = np.spacing(np.float32(np.abs(p0s[name]).max()))  # rounding of the stored parameter
        assert np.abs(d_port).max() <= step_max + 4 * ulp, name
        clear = np.ones(np.shape(p1), bool)
        for g in (*(np.asarray(g[name]) for g in grads), mu):
            clear &= np.abs(g) > TOL["clear"] * np.abs(g).max()
        _close_scaled(d_port[clear], d_jax[clear], TOL["update"], name, atol=1e-6)
        moved += bool(clear.any() and np.abs(d_jax[clear]).min() > 0)
    assert moved == len(port)  # every leaf moved, raygen's pose deltas included


@pytest.fixture(scope="module")
def port_two_steps(jax_two_steps):
    """The port's two steps from the same state, handed JAX's per-step
    uniforms, two ways: ``make_train_step`` twice (-> the state and each
    step's metrics) and ``make_train_step_scan`` at K = 2 (-> the state and
    the last metrics)."""
    setup, _, _, keys, _ = jax_two_steps
    tcfg, tcam, tbs = setup[1], setup[5], setup[7]
    uniforms = [_jax_uniforms(k, N_RAYS, tcfg.model.renderer.n_shadow_samples) for k in keys]
    single = _fresh_port_state(setup)
    tfn = tstep.make_train_step(tcfg, tcam, {}, single.optimizer)
    per_step = []
    for tb, u in zip(tbs, uniforms):
        single, m = tfn(single, tb, uniforms=u)
        per_step.append(m)
    scanned = _fresh_port_state(setup)
    scan = tstep.make_train_step_scan(tcfg, tcam, {}, scanned.optimizer, n_steps=2)
    scanned, last = scan(scanned, tstep.stack_bundles(tbs), uniforms)
    return (single, per_step), (scanned, last)


def test_two_steps_match_jax(jax_two_steps, port_two_steps):
    """Two whole steps of nr-hints-cam-opt through ``make_train_step``
    against JAX's two steps (``jax_two_steps``), the port handed JAX's
    per-step uniforms: each step's loss; Adam's moments and the parameter
    change (``_hold_two_steps``).  The second step moves every entry by lr
    * 0.5 * mhat / (sqrt(vhat) + eps), which depends on both gradients,
    both betas and the bias corrections."""
    (tstate, per_step), _ = port_two_steps
    for tm, (_, jm) in zip(per_step, jax_two_steps[4]):
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=TOL["metric"])
    assert tstate.step == 2
    _hold_two_steps(jax_two_steps, tstate)


def test_scan_matches_jax(jax_two_steps, port_two_steps):
    """``make_train_step_scan`` at K = 2 on the CPU against JAX's, the port
    handed JAX's per-step uniforms: the last step's metrics at the step's
    5e-3, the step count, Adam's moments and the parameter change as
    ``test_two_steps_match_jax`` holds them, and every parameter leaf that
    does not start at 0 within 2e-3 of its scale (a leaf that starts at 0,
    a bias, has the step's own size for scale, and Adam moves an entry whose
    two gradients nearly cancel by noise: the change check holds those)."""
    setup, jstate, jmetrics, _, _ = jax_two_steps
    _, (tstate, metrics) = port_two_steps
    assert tstate.step == 2 == int(jstate.step)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=TOL["metric"], err_msg=k)
    _hold_two_steps(jax_two_steps, tstate)
    port, p0s = dict(tree_items(tstate.params)), dict(tree_items(setup[2]))
    for name, p1 in tree_items(jax.device_get(jstate.params)):
        if np.abs(p0s[name]).max() > 0:
            _close_scaled(port[name].detach().numpy(), p1, 2e-3, name)


def test_scan_matches_single_steps(jax_two_steps, port_two_steps):
    """On the CPU the K-step dispatch is K of ``make_train_step``'s steps:
    from the same state and uniforms, the parameters, Adam's moments and
    step counts and the last metrics are equal bit for bit; a dispatch of
    the wrong length raises."""
    (a, per_step), (b, mb) = port_two_steps
    ma = per_step[-1]
    assert a.step == b.step == 2 and ma.keys() == mb.keys()
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for (name, pa), (_, pb) in zip(tree_items(a.params), tree_items(b.params)):
        assert torch.equal(pa.detach(), pb.detach()), name
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq")), name
    setup = jax_two_steps[0]
    scan3 = tstep.make_train_step_scan(setup[1], setup[5], {}, b.optimizer, n_steps=3)
    with pytest.raises(ValueError):
        scan3(b, tstep.stack_bundles(setup[7]), [torch.Generator()] * 2)


@pytest.mark.parametrize("geometry_warmup", [False, True], ids=["normal", "geometry-warmup"])
def test_train_uniforms_are_the_renders_draws(geometry_warmup):
    """``train_uniforms`` draws from a generator what ``render_rays`` draws
    from it, in its order (a CUDA graph of train steps draws them outside
    the graph): the render with the generator and the render with the drawn
    uniforms are equal bit for bit."""
    from nrhints_torch.core.structs import RayBundle
    from tests.torch_port_utils import camera_rays

    _, tm = model_configs(march_dtype="float32")
    params = tr.init_model_params(tm, torch.Generator().manual_seed(0), device="cpu")
    rays = RayBundle(*[torch.as_tensor(a) for a in camera_rays(0)])
    kw = dict(is_training=True, geometry_warmup=geometry_warmup)
    a = tr.render_rays(params, tm, rays, torch.Generator().manual_seed(5), **kw)
    u = tr.train_uniforms(tm, N_RAYS, torch.Generator().manual_seed(5), "cpu", geometry_warmup=geometry_warmup)
    assert sorted(u) == (["strat"] if geometry_warmup else ["shadow", "strat"])
    b = tr.render_rays(params, tm, rays, uniforms=u, **kw)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        assert (va is None and vb is None) or torch.equal(va, vb), f.name


def test_pixel_sampler_matches_jax():
    for strategy in ("all_images", "same_image"):
        from nrhints_torch.data.sampler import PixelSamplingStrategy as TS
        from nrhints_tpu.data.sampler import PixelSamplingStrategy as JS

        kw = dict(image_idx_rng_seed=5, pixel_idx_rng_seed=9, local_rank=1)
        t = TSampler(7, 30, 40, 64, strategy=TS(strategy), **kw)
        j = JSampler(7, 30, 40, 64, strategy=JS(strategy), **kw)
        for _ in range(3):
            a, b = t.sample_batch(), j.sample_batch()
            for f in ("img_indices", "h_indices", "w_indices"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        j.set_state(t.get_state())
        np.testing.assert_array_equal(t.sample_batch().h_indices, j.sample_batch().h_indices)


def test_scene_views_match_jax_renderer():
    from nrhints_tpu.data.synthetic import look_at_pose, render_scene_image

    sc = scene_views(2, 16, 20, seed=4)
    rgba = render_scene_image(look_at_pose(sc["poses"][1][:3, 3].astype(np.float64)), sc["pls"][1].astype(np.float64),
                              16, 20, sc["focal"])
    np.testing.assert_allclose(sc["images"][1], rgba[..., :3] * rgba[..., 3:] + 1.0 - rgba[..., 3:], atol=1e-5)
    assert sc["images"].min() >= 0.0 and sc["images"].max() <= 1.0 and sc["images"].std() > 0.05


def test_params_from_jax_carries_the_train_tree():
    """The converted tree holds every leaf of the step's {renderer, raygen}
    tree with its shape, the 0-d variance and the pose deltas included."""
    jcfg, tcfg, jp, tp, *_ = _setup("nr-hints-cam-opt")
    j_items, t_items = list(tree_items(jp)), dict(tree_items(tp))
    assert [n for n, _ in j_items] == sorted(t_items)
    for name, a in j_items:
        assert tuple(t_items[name].shape) == np.shape(a) and t_items[name].dtype == torch.float32, name
        np.testing.assert_array_equal(t_items[name].numpy(), np.asarray(a))
    assert t_items["/renderer/variance/variance"].dim() == 0
    assert tuple(t_items["/raygen/cam_pose_adjustment"].shape) == (N_VIEWS, 6)


def test_lr_schedule_matches_jax():
    j = jstep.lr_factor_schedule(100, 1000, 0.05)
    t = tstep.lr_factor_schedule(100, 1000, 0.05)
    for s in (0, 1, 50, 99, 100, 101, 550, 999, 1000):
        np.testing.assert_allclose(t(s), float(j(s)), rtol=1e-6, atol=1e-7)
    cfg = tconf.SystemConfig()
    for rule, k in (("linear", 4.0), ("sqrt", 2.0), ("none", 1.0)):
        c = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, batch_scale_lr_rule=rule))
        jc = dataclasses.replace(jconf.SystemConfig(), parallel=dataclasses.replace(
            jconf.SystemConfig().parallel, batch_scale_lr_rule=rule))
        assert tstep.batch_scale_lr_factor(c, 2048) == k == jstep.batch_scale_lr_factor(jc, 2048)


def test_optimizer_groups_and_unported_step_options():
    jcfg, tcfg, jp, tp, jcam, tcam, *_ = _setup("nr-hints-cam-opt")
    opt = tstep.make_optimizer(tcfg, tp)
    assert [(g["name"], g["base_lr"]) for g in opt.param_groups] == [
        ("renderer", tcfg.model.lr), ("raygen", tcfg.ray_generator.opt_lr)]
    assert all(t.requires_grad for _, t in tree_items(tp))


def test_eval_render_uses_no_stash_op(monkeypatch):
    """Under ``torch.no_grad()`` the render never reaches the stash ops
    (kernel A and the f32 trunk serve eval, as in the JAX package) and
    builds no graph, though the parameters require gradients."""
    _, tcfg, _, tp, _, tcam, _, (tb,), _ = _setup("nr-hints")
    for _, t in tree_items(tp):
        t.requires_grad_(True)

    def refuse(*args, **kwargs):
        raise AssertionError("a stash op ran on the eval path")

    monkeypatch.setattr(tcs.SdfStashFn, "apply", refuse)
    monkeypatch.setattr(tcs.MlpStashFn, "apply", refuse)
    with torch.no_grad():
        out = tstep.forward_pipeline(tp, {}, tcfg, tcam, tb, is_training=False, geometry_warmup=False,
                                     cos_anneal_ratio=1.0)
    for f in dataclasses.fields(out):
        v = getattr(out, f.name)
        assert v is None or (v.grad_fn is None and not v.requires_grad), f.name


def test_training_render_needs_randomness():
    _, tcfg, _, tp, _, tcam, _, (tb,), _ = _setup("nr-hints")
    with pytest.raises(ValueError):
        tr.render_rays(tp["renderer"], tcfg.model, _rays(tcfg, tcam, tb, tp), is_training=True)


def _rays(tcfg, tcam, tb, tp):
    from nrhints_torch.camera.rays import generate_rays

    return generate_rays(tp["raygen"], {}, tcam, tcfg.ray_generator, tb)


@pytest.mark.parametrize("preset", ["nr-hints", "nr-hints-cam-opt"])
def test_presets_carry_the_training_fields(preset):
    """The port's presets hold the JAX presets' training settings: the
    schedule, the loss weight, the batch, both learning rates, the pose
    deltas and the shipping backward schedule."""
    j, t = jconf.PRESETS[preset](), tconf.PRESETS[preset]()
    for f in ("igr_weight", "lr", "lr_alpha", "warm_up_end", "end_iter", "anneal_end", "geometry_warmup_end",
              "batch_size", "training_chunk_size"):
        assert getattr(t.model, f) == getattr(j.model, f), f
    for f in ("cam_opt_mode", "pl_opt", "opt_lr"):
        assert getattr(t.ray_generator, f) == getattr(j.ray_generator, f), f
    for f in ("core_backward", "reflectance_impl", "n_shadow_samples", "shadow_ray_offset"):
        assert getattr(t.model.renderer, f) == getattr(j.model.renderer, f), f
    assert t.parallel.steps_per_dispatch == 1 and t.data.white_background == j.data.white_background
    assert tconf.DEFAULT_PRESET == jconf.DEFAULT_PRESET == "nr-hints-cam-opt"
