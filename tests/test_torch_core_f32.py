"""The SDF core's f32 branches in the port, on the CPU: the entry points
``fused_sdf_value_feat_grad(compute_dtype="float32", backward=b)`` under
every schedule and ``fused_sdf_value_feat_grad_stash`` at each (compute,
stash) dtype pair, against the JAX package's same calls with its Pallas
kernels in interpret mode (``_sdf_core_fwd_pallas``, ``_sdf_core_bwd_pallas``,
``_sdf_stash_fwd_pallas``, ``_sdf_stash_bwd_pallas``), at an odd point count
(77: padded rows on JAX's 32-point blocks); and the layouts the CUDA f32
instances read.  (The f32 CUDA instances against their plain versions run on
the card: tests/test_torch_gpu.py.)

Each JAX call runs once per module (a module-scoped fixture, one ``jax.jit``
of its ``jax.vjp`` a route).  Tolerances, each of a tensor's own scale:
* f32 dot operands with an f32 stash, and the recompute schedule: outputs
  1e-5, gradients 1e-4 (exact f32 on both sides, summed in other orders;
  the dW sums run over the points).
* any bf16 in the pair (bf16 operands, or the bf16 stash that
  ``fused_sdf_value_feat_grad``'s stash schedules keep): as the port's
  stash tests, outputs 2e-3 where the operands are bf16 (1e-5 where they
  are f32), gradients 2e-2: an f32 value within an ulp of a bf16 rounding
  boundary can round the other way on either side.
* the "bf16/f32" route at the inputs of seed 11, a case of its own
  (test_bf16_f32stash_seed11_matches_jax): there /out_sdf/g, a scalar
  gain whose gradient sums every point's sdf cotangent, reads 2.18e-2 of
  its scale against JAX, while JAX's own bf16 result lies 4.94e-2 of that
  scale from JAX's exact f32 one (and the port's 2.76e-2 from it): the two
  bf16 results differ by less than half of what bf16 operands move that
  leaf.  So it is held to JAX's own bf16-to-f32 spread there, and every
  other output and leaf to the tolerances above (measured: the worst other
  leaf, /lin1/b, 1.04e-2).
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
from tests.torch_port_utils import jax_sdf_params

N_PTS = 77
# route -> (the port's entry point and keywords, compute dtype, stash dtype)
ROUTES = {
    "recompute": ("feat_grad", dict(backward="recompute"), "float32", None),
    "stash": ("feat_grad", dict(backward="stash"), "float32", "bfloat16"),
    "stash_all": ("feat_grad", dict(backward="stash_all"), "float32", "bfloat16"),
    "stash_xla": ("feat_grad", dict(backward="stash_xla"), "float32", "bfloat16"),
    "f32/f32": ("stash", dict(stash_dtype="float32"), "float32", "float32"),
    "f32/f32 stash_all": ("stash", dict(stash_dtype="float32", stash_us=True), "float32", "float32"),
    "f32/bf16": ("stash", dict(stash_dtype="bfloat16"), "float32", "bfloat16"),  # JAX's call is "stash"'s
    "bf16/f32": ("stash", dict(stash_dtype="float32"), "bfloat16", "float32"),
    "bf16/f32 xla": ("stash", dict(stash_dtype="float32", bwd_impl="xla"), "bfloat16", "float32"),
}


def _tols(compute, stash):
    """(output tol, gradient tol) of a route."""
    exact = compute == "float32" and stash in (None, "float32")
    return (1e-5 if compute == "float32" else 2e-3), (1e-4 if exact else 2e-2)


def _close_scaled(port, ref, tol, what=""):
    ref = np.asarray(ref, dtype=np.float64)
    port = np.asarray(port.detach() if isinstance(port, torch.Tensor) else port, dtype=np.float64).reshape(ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(port - ref).max())
    assert err <= tol * scale, f"{what}: err {err:.3e} vs scale {scale:.3e}"


@pytest.fixture(scope="module")
def case():
    """The inputs of tests/test_torch_kernels.py's stash cases (seed 4)."""
    jc, jp, tc, tp = jax_sdf_params()
    return (jc, jp, tc, tp, *_inputs(4, tc))


def _jax_call(jc, route):
    fn, kw, compute, _ = ROUTES[route]
    common = dict(block_pts=32, block_pts_bwd=32, interpret=True, compute_dtype=compute)
    if fn == "feat_grad":
        return lambda p, xx: jcm.fused_sdf_value_feat_grad(p, jc, xx, **common, **kw)
    return lambda p, xx: jcs.fused_sdf_value_feat_grad_stash(p, jc, xx, **common, **kw)


@pytest.fixture(scope="module")
def jax_runs(case):
    """route -> (outputs, named parameter cotangents, x's cotangent) of the
    JAX package's call, one jitted vjp each."""
    jc, jp, _, _, x, cots = case
    out = {route: _jax_run(jc, jp, route, x, cots) for route in ROUTES if route != "f32/bf16"}
    out["f32/bf16"] = out["stash"]
    return out


def _port_call(tc, tp, route, x):
    fn, kw, compute, _ = ROUTES[route]
    leaves = {n: t.detach().clone().requires_grad_(True) for n, t in tree_items(tp)}
    params = {}
    for n, t in leaves.items():
        layer, key = n.strip("/").split("/")
        params.setdefault(layer, {})[key] = t
    if fn == "feat_grad":
        out = tcm.fused_sdf_value_feat_grad(params, tc, x, compute_dtype=compute, **kw)
    else:
        out = tcs.fused_sdf_value_feat_grad_stash(params, tc, x, compute_dtype=compute, **kw)
    return out, leaves


def _inputs(seed, tc):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(N_PTS, 3)) * 0.4).astype(np.float32)
    cots = (rng.normal(size=(N_PTS,)).astype(np.float32), rng.normal(size=(N_PTS, tc.d_out_feat)).astype(np.float32),
            rng.normal(size=(N_PTS, 3)).astype(np.float32))
    return x, cots


def _jax_run(jc, jp, route, x, cots):
    """(outputs, named parameter cotangents, x's cotangent) of one jitted
    vjp of JAX's call on a route."""
    call = _jax_call(jc, route)

    @jax.jit
    def run(p, xx, c):
        o, vjp = jax.vjp(call, p, xx)
        return o, vjp(c)

    o, (dp, dx) = run(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x), tuple(jnp.asarray(c) for c in cots))
    return [np.asarray(a) for a in o], {n: np.asarray(g) for n, g in tree_items(dp)}, np.asarray(dx)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_f32_entry_points_match_jax(case, jax_runs, route):
    """The port's entry point on the CPU (the plain versions through
    ``SdfCoreFn`` or ``SdfStashFn``) against JAX's same call in interpret
    mode: the three outputs and the cotangents of x and of every
    weight-norm leaf."""
    _, _, tc, tp, x, cots = case
    _, _, compute, stash = ROUTES[route]
    out_tol, grad_tol = _tols(compute, stash)
    xt = torch.tensor(x, requires_grad=True)
    out, leaves = _port_call(tc, tp, route, xt)
    want_fn = "SdfCoreFn" if route == "recompute" else "SdfStashFn"
    assert type(out[0].grad_fn).__name__.startswith(want_fn)
    grads = torch.autograd.grad(out, [xt, *leaves.values()], tuple(torch.tensor(c) for c in cots))
    j_out, j_dp, j_dx = jax_runs[route]
    for name, a, b in zip(("sdf", "feat", "grad"), out, j_out):
        _close_scaled(a, b, out_tol, name)
    _close_scaled(grads[0], j_dx, grad_tol, "dx")
    assert sorted(j_dp) == sorted(leaves)
    for (name, _), g in zip(leaves.items(), grads[1:]):
        _close_scaled(g, j_dp[name], grad_tol, name)


def test_bf16_f32stash_seed11_matches_jax():
    """The "bf16/f32" route (bf16 operands, an f32 stash) at the inputs of
    seed 11, against JAX's same call, with JAX's exact "f32/f32" call on
    the same inputs as the yardstick of /out_sdf/g (see the module
    docstring): there the port's bf16 gradient lies no farther from JAX's
    than JAX's bf16 gradient lies from its f32 one; every other output and
    leaf within the route's tolerances."""
    jc, jp, tc, tp = jax_sdf_params()
    x, cots = _inputs(11, tc)
    j_out, j_dp, j_dx = _jax_run(jc, jp, "bf16/f32", x, cots)
    j_dp_f32 = _jax_run(jc, jp, "f32/f32", x, cots)[1]
    out_tol, grad_tol = _tols("bfloat16", "float32")
    xt = torch.tensor(x, requires_grad=True)
    out, leaves = _port_call(tc, tp, "bf16/f32", xt)
    grads = torch.autograd.grad(out, [xt, *leaves.values()], tuple(torch.tensor(c) for c in cots))
    for name, a, b in zip(("sdf", "feat", "grad"), out, j_out):
        _close_scaled(a, b, out_tol, name)
    _close_scaled(grads[0], j_dx, grad_tol, "dx")
    assert sorted(j_dp) == sorted(leaves)
    for (name, _), g in zip(leaves.items(), grads[1:]):
        if name != "/out_sdf/g":
            _close_scaled(g, j_dp[name], grad_tol, name)
            continue
        port, ref = g.detach().numpy().reshape(j_dp[name].shape), j_dp[name]
        spread = np.abs(ref - j_dp_f32[name]).max()
        assert np.abs(port - ref).max() <= spread, (np.abs(port - ref).max(), spread)


@pytest.mark.parametrize("compute,stash", [("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "float32")])
def test_stash_entry_undifferentiated_runs_the_core(case, compute, stash):
    """Without a gradient, ``fused_sdf_value_feat_grad_stash`` gives the
    recompute op's outputs bit for bit (JAX's stash op dispatches its
    non-stash forward for the undifferentiated primal); a wrong
    ``bwd_impl`` or dtype name raises."""
    _, _, tc, tp, x, _ = case
    xt = torch.tensor(x)
    with torch.no_grad():
        a = tcs.fused_sdf_value_feat_grad_stash(tp, tc, xt, compute_dtype=compute, stash_dtype=stash)
    b = tcm.fused_sdf_value_feat_grad(tp, tc, xt, compute_dtype=compute, backward="recompute")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    with pytest.raises(ValueError):
        tcs.fused_sdf_value_feat_grad_stash(tp, tc, xt, compute_dtype=compute, stash_dtype=stash, bwd_impl="kernel")
    with pytest.raises(ValueError):
        tcs.fused_sdf_value_feat_grad_stash(tp, tc, xt, compute_dtype="float16", stash_dtype=stash)


@pytest.mark.parametrize("stash_us", [False, True], ids=["stash", "stash_all"])
def test_f32_stash_layout(stash_us):
    """An f32 stash keeps ``sdf_stash_columns``' offsets and
    ``sdf_stash_width`` in f32 columns, the same as a bf16 stash's: 528 MB
    (stash) and 1.07 GB (stash_all) at 65,536 points at full width; split
    views of an f32 packed stash are f32 and as wide as each layer."""
    from nrhints_torch.fields.sdf import SDFNetConfig

    cfg = SDFNetConfig()
    cols, width = tcs.sdf_stash_columns(cfg, stash_us), tcs.sdf_stash_width(cfg, stash_us)
    assert width == (4080 if stash_us else 2016) and all(off % 16 == 0 for off, _ in cols)
    assert 65536 * width * 4 == (1_069_547_520 if stash_us else 528_482_304)
    packed = torch.zeros((5, width), dtype=torch.float32)
    parts = tcs.split_stash(packed, cols)
    assert all(p.dtype == torch.float32 and p.shape == (5, w) for p, (_, w) in zip(parts, cols))
    assert len(parts) == (2 * cfg.n_layers + 1 if stash_us else cfg.n_layers)


@pytest.mark.parametrize("with_feat", [True, False], ids=["core", "march"])
def test_f32_pack(case, with_feat):
    """The f32 pack: the same layout and meta as the bf16 pack, f32 weights;
    the core layout (``with_feat``) also holds every block transposed at
    its own offset (wtpack), the reverse products' B; the march's f32 pack
    has none.  ``core_pack`` refuses a pack of the other dtype."""
    _, _, tc, tp, _, _ = case
    w = tcm.materialize_sdf_weights_full(tp, tc)
    if not with_feat:
        w = w[: 2 * tc.n_layers + 2]
    p32 = tcm.pack_sdf_mlp(w, tc, with_feat=with_feat, dtype=torch.float32)
    p16 = tcm.pack_sdf_mlp(w, tc, with_feat=with_feat)
    assert p32["wpack"].dtype == torch.float32 and np.array_equal(p32["meta"], p16["meta"])
    assert torch.equal(p32["wpack"].to(torch.bfloat16), p16["wpack"])
    assert ("wtpack" in p32) == with_feat and "wtpack" not in p16
    if with_feat:
        meta = p32["meta"]
        blocks = [(int(meta[10 + 7 * i + 5]), int(meta[10 + 7 * i + 2]), int(meta[10 + 7 * i + 3]))
                  for i in range(tc.n_layers)] + [(int(meta[7]), int(meta[5]), int(meta[6]))]
        for off, kp, np_ in blocks:
            blk = p32["wpack"][off : off + kp * np_].view(kp, np_)
            assert torch.equal(p32["wtpack"][off : off + kp * np_].view(np_, kp), blk.t())
        assert tcm.core_pack(w, tc, "float32", p32) is p32
        with pytest.raises(ValueError):
            tcm.core_pack(w, tc, "bfloat16", p32)


@pytest.mark.parametrize("compute,stash,bits,suffix", [
    ("bfloat16", "bfloat16", 0, ""), ("float32", "float32", 3, "_f32"),
    ("float32", "bfloat16", 1, "_f32_bf16stash"), ("bfloat16", "float32", 2, "_f32stash")])
def test_instance_names_and_dtype_bits(compute, stash, bits, suffix):
    """The dtypes int the C entry points read (bit 0 f32 operands, bit 1 an
    f32 stash: csrc/mma_rows.cuh's kF32Compute and kF32Stash) and the launch
    counter of each instance of D and E; A and H count by their operands
    alone; every instance has a counter and dispatches in the sources."""
    assert tcm.dtype_bits(compute, stash) == bits
    for kernel in ("sdf_stash_fwd", "sdf_stash_bwd", "sdf_stash_all_fwd", "sdf_stash_all_bwd"):
        name = tcm.instance_name(kernel, compute, stash)
        assert name == kernel + suffix and name in cuda_lib.launch_counts
    for kernel in ("sdf_core_fwd", "sdf_core_bwd"):
        assert tcm.instance_name(kernel, compute) == kernel + ("_f32" if compute == "float32" else "")
        assert tcm.instance_name(kernel, compute) in cuda_lib.launch_counts
    rows = (cuda_lib.CSRC / "mma_rows.cuh").read_text()
    assert "constexpr int kF32Compute = 1, kF32Stash = 2;" in rows
    T, S = ("float" if d == "float32" else "bf16" for d in (compute, stash))
    fwd = (cuda_lib.CSRC / "sdf_fwd.cuh").read_text()
    bwd = (cuda_lib.CSRC / "sdf_bwd.cuh").read_text()
    assert f"launch_sdf_fwd<Cls, {T}, {S}, MODE>(a...)" in fwd
    assert f"launch_sdf_bwd<Cls, {T}, {S}, GATES, US>(a...)" in bwd
    for src in ("sdf_core.cu", "sdf_stash.cu", "sdf_core_bwd.cu"):
        text = (cuda_lib.CSRC / src).read_text()
        assert all(sig[-3:-1] == [cuda_lib._F, cuda_lib._I] for sig in cuda_lib._SIGNATURES[src[:-3]].values())
        assert len(re.findall(r"float scale, int dtypes, void\* stream\)", text)) == len(
            cuda_lib._SIGNATURES[src[:-3]])
