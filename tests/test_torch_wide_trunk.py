"""The reflectance trunk above the presets' widths in the port, on the CPU:
JAX's ``fused_mlp_apply`` (recompute), ``fused_mlp_apply_stash`` (each
(compute, stash) dtype pair, and ``bwd_impl="xla"``) and
``fused_reflectance_forward`` with their Pallas kernels in interpret mode
against the port's same calls (the plain versions of kernels F, G, I and J,
whose CUDA wide instances take padded hidden widths up to 512 and inputs up
to 640), on a 400 -> 2 x 272 -> 3 trunk (wide by its hidden widths and by
its padded input, 400 > 384) at 61 points (two of JAX's 32-point blocks,
the second ragged); ``render_rays`` in training of a tiny model whose trunk
is 272 wide; and what the wide instances read: the width class and its
limits, the pack, the 32-point layout, the launch counters and the
constants the kernels are compiled with.  (The CUDA wide instances against
their plain versions run on the card: tests/test_torch_gpu.py.)

Each JAX call runs once per module (a module-scoped fixture, one jitted
``jax.vjp`` a route).  Tolerances, each of a tensor's own scale, are
tests/test_torch_trunk_f32.py's: f32 dot operands with an f32 stash, and the
f32 recompute schedule, outputs 1e-5 and gradients 1e-4 (exact f32 on both
sides, summed in other orders); any bf16 in the pair, outputs 2e-3 where
the operands are bf16 (1e-5 where they are f32) and gradients 2e-2 (an f32
value within an ulp of a bf16 rounding boundary can round the other way on
either side).  ``render_rays`` at tests/test_torch_render.py's "float32"
tolerances.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrhints_torch.kernels import core_mlp as tcm, core_stash as tcs, cuda_lib
from nrhints_torch.utils import tree_items
from nrhints_tpu.kernels import core_mlp as jcm, core_stash as jcs
from tests.test_torch_trunk_f32 import _close_scaled, _leaf_params, _tols

N_PTS, N_LAYERS = 61, 2
DIMS = (400, 272, 272, 3)
# route -> (the port's entry point and keywords, compute dtype, stash dtype)
ROUTES = {
    "recompute bf16": ("apply", dict(backward="recompute"), "bfloat16", None),
    "recompute f32": ("apply", dict(backward="recompute"), "float32", None),
    "bf16/bf16": ("stash", dict(stash_dtype="bfloat16"), "bfloat16", "bfloat16"),
    "f32/f32": ("stash", dict(stash_dtype="float32"), "float32", "float32"),
    "f32/bf16": ("stash", dict(stash_dtype="bfloat16"), "float32", "bfloat16"),
    "bf16/f32": ("stash", dict(stash_dtype="float32"), "bfloat16", "float32"),
    "f32/f32 xla": ("stash", dict(stash_dtype="float32", bwd_impl="xla"), "float32", "float32"),
}


def _trunk_params(dims, seed: int = 7):
    """A weight-norm trunk of widths ``dims``: (JAX params as numpy, port
    params)."""
    from nrhints_torch.convert import params_from_jax
    from nrhints_tpu.fields.mlp import torch_default_linear_init, weight_norm_params

    key = jax.random.PRNGKey(seed)
    params = {}
    for i in range(len(dims) - 1):
        key, k = jax.random.split(key)
        params[f"lin{i}"] = weight_norm_params(*torch_default_linear_init(k, dims[i], dims[i + 1]))
    jp = jax.device_get(params)
    return jp, params_from_jax(jp, device="cpu")


@pytest.fixture(scope="module")
def case():
    jp, tp = _trunk_params(DIMS)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(N_PTS, DIMS[0])).astype(np.float32)
    g = rng.normal(size=(N_PTS, 3)).astype(np.float32)
    return jp, tp, x, g


@pytest.fixture(scope="module")
def jax_runs(case):
    """route -> (output, named parameter cotangents, x's cotangent) of the
    JAX package's call, one jitted vjp each."""
    jp, _, x, g = case
    params = jax.tree_util.tree_map(jnp.asarray, jp)
    out = {}
    for route, (fn, kw, compute, _) in ROUTES.items():
        common = dict(block_pts=32, block_pts_bwd=32, interpret=True, compute_dtype=compute)
        mod = jcm.fused_mlp_apply if fn == "apply" else jcs.fused_mlp_apply_stash

        @jax.jit
        def run(p, xx, c, mod=mod, kw=kw, common=common):
            o, vjp = jax.vjp(lambda p_, x_: mod(p_, N_LAYERS, x_, **common, **kw), p, xx)
            return o, vjp(c)

        o, (dp, dx) = run(params, jnp.asarray(x), jnp.asarray(g))
        out[route] = (np.asarray(o), {n: np.asarray(v) for n, v in tree_items(dp)}, np.asarray(dx))
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_wide_trunk_entry_points_match_jax(case, jax_runs, route):
    """The port's trunk entry point at a wide-class trunk on the CPU (the
    plain versions through ``MlpFn`` or ``MlpStashFn``) against JAX's same
    call in interpret mode: the output and the cotangents of x and of every
    weight-norm leaf."""
    _, tp, x, g = case
    fn, kw, compute, stash = ROUTES[route]
    out_tol, grad_tol = _tols(compute, stash)
    params, leaves = _leaf_params(tp)
    xt = torch.tensor(x, requires_grad=True)
    call = tcm.fused_mlp_apply if fn == "apply" else tcs.fused_mlp_apply_stash
    out = call(params, N_LAYERS, xt, compute_dtype=compute, **kw)
    assert type(out.grad_fn).__name__.startswith("MlpFn" if fn == "apply" else "MlpStashFn")
    grads = torch.autograd.grad(out, [xt, *leaves.values()], torch.tensor(g))
    j_out, j_dp, j_dx = jax_runs[route]
    _close_scaled(out, j_out, out_tol, "out")
    _close_scaled(grads[0], j_dx, grad_tol, "dx")
    assert sorted(j_dp) == sorted(leaves)
    for (name, _), gr in zip(leaves.items(), grads[1:]):
        _close_scaled(gr, j_dp[name], grad_tol, name)


def test_wide_reflectance_forward_matches_jax():
    """``fused_reflectance_forward(compute_dtype="float32")`` with both hints
    and a 300-wide feature (405 inputs, padded 416: the wide class by its
    input alone) against JAX's same call in interpret mode: the sigmoid
    output and the cotangents of every input and weight-norm leaf, 1e-5 /
    1e-4."""
    from nrhints_torch.convert import params_from_jax
    from nrhints_torch.fields.reflectance import ReflectanceNetConfig as TCfg, reflectance_input_dim
    from nrhints_tpu.fields.reflectance import ReflectanceNetConfig as JCfg, reflectance_init

    kw, d_feat = dict(n_layers=2, d_hidden=32), 300
    assert reflectance_input_dim(TCfg(**kw), d_feat, True, True, 4) == 405
    jp = jax.device_get(reflectance_init(jax.random.PRNGKey(3), JCfg(**kw), d_feature=d_feat))
    rng = np.random.default_rng(5)
    shapes = ((N_PTS, 3), (N_PTS, 3), (N_PTS, 3), (N_PTS, d_feat), (N_PTS, 3), (N_PTS, 1), (N_PTS, 4))
    ins = [rng.normal(size=s).astype(np.float32) for s in shapes]
    ins[5], ins[6] = np.abs(ins[5]), np.abs(ins[6])
    cot = rng.normal(size=(N_PTS, 3)).astype(np.float32)

    def jcall(p, *a):
        return jcm.fused_reflectance_forward(p, JCfg(**kw), *a, block_pts=32, block_pts_bwd=32, interpret=True,
                                             compute_dtype="float32")

    j_out, vjp = jax.vjp(jcall, jax.tree_util.tree_map(jnp.asarray, jp), *map(jnp.asarray, ins))
    j_dp, *j_dins = vjp(jnp.asarray(cot))
    params, leaves = _leaf_params(params_from_jax(jp, device="cpu"))
    assert tcm.pack_mlp(tcm.materialize_mlp_weights(params, 2), 2)["cls"] is tcm.TRUNK_WIDE
    tins = [torch.tensor(a, requires_grad=True) for a in ins]
    out = tcm.fused_reflectance_forward(params, TCfg(**kw), *tins, compute_dtype="float32")
    grads = torch.autograd.grad(out, [*tins, *leaves.values()], torch.tensor(cot))
    _close_scaled(out, j_out, 1e-5, "out")
    for k, (a, b) in enumerate(zip(grads, j_dins)):
        _close_scaled(a, b, 1e-4, f"input {k}")
    j_named = dict(tree_items(j_dp))
    for (name, _), gr in zip(leaves.items(), grads[len(tins):]):
        _close_scaled(gr, j_named[name], 1e-4, name)


def test_wide_trunk_render_rays_training_matches_jax():
    """``render_rays(is_training=True)`` of a tiny model whose trunk is 272
    wide (the fused trunk in training, ``reflectance_impl="pallas"``)
    against JAX's fused path in interpret mode with the same uniforms, at
    the f32 march's tolerances; the renderer's width check passes for it."""
    from nrhints_torch.render import renderer as tr
    from nrhints_tpu.render import renderer as jr
    from tests.test_torch_render import TOLS
    from tests.torch_port_utils import model_configs, model_params, ray_bundles

    jc, tc = model_configs(march_dtype="float32", reflectance_kw=dict(n_layers=2, d_hidden=272))
    tr.check_kernel_widths(tc)
    jp, tp = model_params(jc)
    jrays, trays = ray_bundles(0)
    key = jax.random.PRNGKey(3)
    k_strat, _, k_shadow = jax.random.split(key, 3)
    uniforms = {
        "strat": torch.tensor(np.asarray(jax.random.uniform(k_strat, (trays.origins.shape[0], 1)))),
        "shadow": torch.tensor(np.asarray(jax.random.uniform(k_shadow, (trays.origins.shape[0], 64)))),
    }
    jo = jax.jit(lambda p, r: jr.render_rays(p, jc, r, key, background_rgb=jnp.ones((1, 3)), is_training=True))(
        jax.tree_util.tree_map(jnp.asarray, jp), jrays)
    to = tr.render_rays(tp, tc, trays, background_rgb=torch.ones(1, 3), uniforms=uniforms, is_training=True)
    for k in ("rgb", "weights", "depth", "visibilities"):
        np.testing.assert_allclose(getattr(to, k).detach().numpy(), np.asarray(getattr(jo, k)),
                                   atol=TOLS["float32"][k], err_msg=k)
    assert float(np.asarray(jo.visibilities).min()) < 0.9  # the shadow hint is exercised


@pytest.mark.parametrize("dims,cls", [
    ((361, 256, 256, 256, 256, 3), "narrow"),  # the presets' trunk
    ((45, 272, 272, 3), "wide"),  # wide by its hidden widths
    ((400, 32, 32, 3), "wide"),  # wide by its padded input alone
    ((617, 512, 512, 512, 512, 3), "wide"),  # the 512-wide model's
    ((640, 512, 3), "wide"),
])
def test_trunk_width_class(dims, cls):
    """``trunk_class`` picks the 64-point instances up to padded hidden 256
    and input 384, the wide ones above; the pack carries the class, and
    ``check_trunk_widths`` passes."""
    pairs = list(zip(dims[:-1], dims[1:]))
    want = tcm.TRUNK_NARROW if cls == "narrow" else tcm.TRUNK_WIDE
    assert tcm.trunk_class(pairs) is want
    tcm.check_trunk_widths(pairs)
    w = [torch.zeros(i, o) if k % 2 == 0 else torch.zeros(o) for i, o in pairs for k in range(2)]
    assert tcm.pack_mlp(w, len(pairs) - 1)["cls"] is want


@pytest.mark.parametrize("dims,what", [
    ((45, 528, 3), "hidden 528"),
    ((641, 32, 3), "input 656"),
    ((45, 32, 513, 3), "hidden 528"),
    (tuple([45] + [32] * 17 + [3]), None),
])
def test_trunk_limits_raise(dims, what):
    """Above the wide class (padded hidden 512, input 640) ``trunk_class``,
    ``check_trunk_widths`` and ``pack_mlp`` raise NotImplementedError
    naming ROADMAP Queue 2 item 15.  Depth is no limit (what=None): 18
    linears take the 64-point class, and the pack carries its meta vector's
    device copy (on the CPU, a CPU copy) for the kernels to read."""
    pairs = list(zip(dims[:-1], dims[1:]))
    w = [torch.zeros(i, o) if k % 2 == 0 else torch.zeros(o) for i, o in pairs for k in range(2)]
    if what is None:
        assert tcm.trunk_class(pairs) is tcm.TRUNK_NARROW
        tcm.check_trunk_widths(pairs)
        pk = tcm.pack_mlp(w, len(pairs) - 1)
        assert int(pk["meta"][0]) == 18 and torch.equal(pk["meta_dev"], torch.from_numpy(pk["meta"]))
        return
    for call in (lambda: tcm.trunk_class(pairs), lambda: tcm.check_trunk_widths(pairs),
                 lambda: tcm.pack_mlp(w, len(pairs) - 1)):
        with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP.md Queue 2 item 15"):
            call()


def test_wide_pack_and_layout():
    """The 512-wide model's trunk (617 -> 4 x 512 -> 3): the pack's meta
    and block offsets (layer 0's block [624][512] at 0, each hidden block
    [512][512] after it, the output block [512][16]; the stash's 2,048
    columns), its f32 pack's transposed blocks, and the 32-point layout
    (J's transient stash 268 MB in bf16 at one train step's 65,536
    points)."""
    from nrhints_torch.fields.mlp import torch_default_linear_init

    dims = (617, 512, 512, 512, 512, 3)
    gen = torch.Generator().manual_seed(1)
    w = []
    for i in range(len(dims) - 1):
        w += list(torch_default_linear_init(gen, dims[i], dims[i + 1], "cpu"))
    p16, p32 = tcm.pack_mlp(w, 4), tcm.pack_mlp(w, 4, torch.float32)
    meta = [int(v) for v in p16["meta"]]
    assert meta[:4] == [5, 617, 3, 2048] and p16["cls"] is p32["cls"] is tcm.TRUNK_WIDE
    offs = [0, 624 * 512, 624 * 512 + 512 * 512, 624 * 512 + 2 * 512 * 512, 624 * 512 + 3 * 512 * 512]
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        kp, np_ = -(-din // 16) * 16, -(-dout // 16) * 16
        assert meta[4 + 7 * i : 11 + 7 * i] == [din, dout, kp, np_, offs[i], 512 * i, 512 * i if i < 4 else 2048]
        blk = p32["wpack"][offs[i] : offs[i] + kp * np_].view(kp, np_)
        assert torch.equal(blk[:din, :dout], w[2 * i]) and not blk[din:].any() and not blk[:, dout:].any()
        assert torch.equal(p32["wtpack"][offs[i] : offs[i] + kp * np_].view(np_, kp), blk.t())
    assert p16["wpack"].numel() == offs[-1] + 512 * 16 and p16["bpack"].numel() == 4 * 512 + 16
    assert tcs.mlp_stash_columns(p16) == [(512 * i, 512) for i in range(4)]
    nblk, npad, rows, n_zs = tcm.trunk_layout(65536, 2048, tcm.TRUNK_WIDE)
    assert (nblk, npad, rows) == (2048, 65536, 4096) and n_zs * 2 == 268_435_456
    for n, blocks in ((1, 1), (31, 1), (32, 1), (33, 2), (1000, 32)):
        got_blk, npad, rows, _ = tcm.trunk_layout(n, 2048, tcm.TRUNK_WIDE)
        assert (got_blk, npad, rows) == (blocks, 32 * blocks, 2 * blocks)
    assert tcm.dw_jobs([(1, 624, 512), (1, 512, 512), (1, 512, 16)], npad)[0].shape == (3, 6)


@pytest.mark.parametrize("compute,stash,bits,suffix", [
    ("bfloat16", "bfloat16", 4, "_wide"), ("float32", "float32", 7, "_f32_wide"),
    ("float32", "bfloat16", 5, "_f32_bf16stash_wide"), ("bfloat16", "float32", 6, "_f32stash_wide")])
def test_wide_trunk_instances(compute, stash, bits, suffix):
    """Each wide instance's launch counter and dtypes int (kWideClass, bit
    2, beside the dtype bits): F and G at every pair, I and J at each
    operand dtype; every counter exists."""
    from nrhints_torch.fields.mlp import torch_default_linear_init

    gen = torch.Generator().manual_seed(1)
    w = list(torch_default_linear_init(gen, 45, 272, "cpu")) + list(torch_default_linear_init(gen, 272, 3, "cpu"))
    pk = tcm.pack_mlp(w, 1, torch.float32 if compute == "float32" else torch.bfloat16)
    for kernel in ("mlp_stash_fwd", "mlp_stash_bwd"):
        assert tcm.core_instance(kernel, pk, compute, stash) == (kernel + suffix, bits)
        assert kernel + suffix in cuda_lib.launch_counts
    for kernel in ("mlp_fwd", "mlp_bwd"):
        want = kernel + ("_f32" if compute == "float32" else "") + "_wide"
        assert tcm.core_instance(kernel, pk, compute) == (want, (bits & 1) | 4) and want in cuda_lib.launch_counts


def test_wide_trunk_constants_match_the_source():
    """IN_WIDE and TRUNK_WIDE's points, width and bit are the constants the
    CUDA trunk kernels are compiled with (kInWide, kWidePts, kWideWMax,
    kWideClass), and each template has a wide kernel."""
    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", (cuda_lib.CSRC / src).read_text()).group(1))

    src = (cuda_lib.CSRC / "mlp_stash.cu").read_text()
    assert const("mlp_stash.cu", "kInWide") == tcm.IN_WIDE == tcm.TRUNK_WIDE.in_max == 640
    assert const("staged_mma.cuh", "kWidePts") == tcm.TRUNK_WIDE.pts
    assert 2 * const("sdf_mlp.cuh", "kWMax") == tcm.TRUNK_WIDE.width
    assert const("mma_rows.cuh", "kWideClass") == tcm.TRUNK_WIDE.bit
    assert "static constexpr int kPts = kWidePts, kIn = kInWide, kW = kWideWMax" in src
    for kernel in ("mlp_fwd_wide_kernel", "mlp_bwd_chain_wide_kernel"):
        assert f"__launch_bounds__(kChainThreads)\n    {kernel}(" in src
