"""The reflectance trunk's f32 branches in the port, on the CPU: the entry
points ``fused_mlp_apply(compute_dtype="float32", backward=b)`` under every
schedule, ``fused_mlp_apply_stash`` at each (compute, stash) dtype pair and
``fused_reflectance_forward(compute_dtype="float32")``, against the JAX
package's same calls with its Pallas kernels in interpret mode
(``_mlp_fwd_pallas``, ``_mlp_bwd_pallas``, ``_mlp_stash_fwd_pallas``,
``_mlp_stash_bwd_pallas``), on tests/test_torch_kernels.py's tiny trunk
(45 -> 2 x 32 -> 3) at an odd point count (61: padded rows on JAX's 32-point
blocks); and the layouts the CUDA f32 instances read.  (The f32 CUDA
instances against their plain versions run on the card:
tests/test_torch_gpu.py.)

Each JAX call runs once per module (a module-scoped fixture, one ``jax.jit``
of its ``jax.vjp`` a route).  Tolerances, each of a tensor's own scale:
* f32 dot operands with an f32 stash, and the recompute schedule: outputs
  1e-5, gradients 1e-4 (exact f32 on both sides, summed in other orders;
  the dW sums run over the points).
* any bf16 in the pair (bf16 operands, or the bf16 stash that
  ``fused_mlp_apply``'s stash schedules keep): outputs 2e-3 where the
  operands are bf16 (1e-5 where they are f32), gradients 2e-2: an f32 value
  within an ulp of a bf16 rounding boundary can round the other way on
  either side.
"""
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrhints_torch.kernels import core_mlp as tcm, core_stash as tcs, cuda_lib
from nrhints_torch.utils import tree_items
from nrhints_tpu.kernels import core_mlp as jcm, core_stash as jcs
from tests.test_torch_kernels import _trunk_params

N_PTS, N_LAYERS = 61, 2
# route -> (the port's entry point and keywords, compute dtype, stash dtype)
ROUTES = {
    "recompute": ("apply", dict(backward="recompute"), "float32", None),
    "stash": ("apply", dict(backward="stash"), "float32", "bfloat16"),
    "stash_all": ("apply", dict(backward="stash_all"), "float32", "bfloat16"),
    "stash_xla": ("apply", dict(backward="stash_xla"), "float32", "bfloat16"),
    "f32/f32": ("stash", dict(stash_dtype="float32"), "float32", "float32"),
    "f32/bf16": ("stash", dict(stash_dtype="bfloat16"), "float32", "bfloat16"),
    "bf16/f32": ("stash", dict(stash_dtype="float32"), "bfloat16", "float32"),
    "bf16/f32 xla": ("stash", dict(stash_dtype="float32", bwd_impl="xla"), "bfloat16", "float32"),
}
PAIRS = [("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "float32")]


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


def _leaf_params(tp):
    """(the port's params rebuilt from fresh leaves that want a gradient,
    those leaves by name)."""
    leaves = {n: t.detach().clone().requires_grad_(True) for n, t in tree_items(tp)}
    params = {}
    for n, t in leaves.items():
        layer, key = n.strip("/").split("/")
        params.setdefault(layer, {})[key] = t
    return params, leaves


@pytest.fixture(scope="module")
def case():
    """tests/test_torch_kernels.py's trunk inputs (seed 11)."""
    jp, tp = _trunk_params()
    rng = np.random.default_rng(11)
    x = rng.normal(size=(N_PTS, 45)).astype(np.float32)
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
        if fn == "apply":
            call = lambda p, xx, kw=kw, common=common: jcm.fused_mlp_apply(p, N_LAYERS, xx, **common, **kw)  # noqa: E731
        else:
            call = lambda p, xx, kw=kw, common=common: jcs.fused_mlp_apply_stash(p, N_LAYERS, xx, **common, **kw)  # noqa: E731

        @jax.jit
        def run(p, xx, c, call=call):
            o, vjp = jax.vjp(call, p, xx)
            return o, vjp(c)

        o, (dp, dx) = run(params, jnp.asarray(x), jnp.asarray(g))
        out[route] = (np.asarray(o), {n: np.asarray(v) for n, v in tree_items(dp)}, np.asarray(dx))
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_f32_trunk_entry_points_match_jax(case, jax_runs, route):
    """The port's entry point on the CPU (the plain versions through
    ``MlpFn`` or ``MlpStashFn``) against JAX's same call in interpret mode:
    the output and the cotangents of x and of every weight-norm leaf."""
    _, tp, x, g = case
    fn, kw, compute, stash = ROUTES[route]
    out_tol, grad_tol = _tols(compute, stash)
    params, leaves = _leaf_params(tp)
    xt = torch.tensor(x, requires_grad=True)
    if fn == "apply":
        out = tcm.fused_mlp_apply(params, N_LAYERS, xt, compute_dtype=compute, **kw)
    else:
        out = tcs.fused_mlp_apply_stash(params, N_LAYERS, xt, compute_dtype=compute, **kw)
    assert type(out.grad_fn).__name__.startswith("MlpFn" if route == "recompute" else "MlpStashFn")
    grads = torch.autograd.grad(out, [xt, *leaves.values()], torch.tensor(g))
    j_out, j_dp, j_dx = jax_runs[route]
    _close_scaled(out, j_out, out_tol, "out")
    _close_scaled(grads[0], j_dx, grad_tol, "dx")
    assert sorted(j_dp) == sorted(leaves)
    for (name, _), gr in zip(leaves.items(), grads[1:]):
        _close_scaled(gr, j_dp[name], grad_tol, name)


def test_f32_reflectance_forward_matches_jax():
    """``fused_reflectance_forward(compute_dtype="float32")`` under its
    default schedule (JAX's "recompute"), with the shadow and specular
    hints, against JAX's same call in interpret mode: the sigmoid output
    and the cotangents of every input and weight-norm leaf, 1e-5 / 1e-4."""
    from nrhints_torch.convert import params_from_jax
    from nrhints_torch.fields.reflectance import ReflectanceNetConfig as TCfg
    from nrhints_tpu.fields.reflectance import ReflectanceNetConfig as JCfg, reflectance_init

    kw = dict(n_layers=2, d_hidden=32)
    jp = jax.device_get(reflectance_init(jax.random.PRNGKey(3), JCfg(**kw), d_feature=8))
    rng = np.random.default_rng(5)
    shapes = ((N_PTS, 3), (N_PTS, 3), (N_PTS, 3), (N_PTS, 8), (N_PTS, 3), (N_PTS, 1), (N_PTS, 4))
    ins = [rng.normal(size=s).astype(np.float32) for s in shapes]
    ins[5], ins[6] = np.abs(ins[5]), np.abs(ins[6])
    cot = rng.normal(size=(N_PTS, 3)).astype(np.float32)

    def jcall(p, *a):
        return jcm.fused_reflectance_forward(p, JCfg(**kw), *a, block_pts=32, block_pts_bwd=32, interpret=True,
                                             compute_dtype="float32")

    j_out, vjp = jax.vjp(jcall, jax.tree_util.tree_map(jnp.asarray, jp), *map(jnp.asarray, ins))
    j_dp, *j_dins = vjp(jnp.asarray(cot))
    params, leaves = _leaf_params(params_from_jax(jp, device="cpu"))
    tins = [torch.tensor(a, requires_grad=True) for a in ins]
    out = tcm.fused_reflectance_forward(params, TCfg(**kw), *tins, compute_dtype="float32")
    assert type(out.grad_fn).__name__.startswith("Sigmoid")
    grads = torch.autograd.grad(out, [*tins, *leaves.values()], torch.tensor(cot))
    _close_scaled(out, j_out, 1e-5, "out")
    for k, (a, b) in enumerate(zip(grads, j_dins)):
        _close_scaled(a, b, 1e-4, f"input {k}")
    j_named = dict(tree_items(j_dp))
    for (name, _), gr in zip(leaves.items(), grads[len(tins):]):
        _close_scaled(gr, j_named[name], 1e-4, name)


def test_trunk_entry_defaults_are_jax_s():
    """The three entry points take JAX's dtype and schedule keywords with
    JAX's defaults ("recompute" for both trunk entry points)."""
    for port, ref in ((tcm.fused_mlp_apply, jcm.fused_mlp_apply),
                      (tcs.fused_mlp_apply_stash, jcs.fused_mlp_apply_stash),
                      (tcm.fused_reflectance_forward, jcm.fused_reflectance_forward)):
        ps, rs = inspect.signature(port).parameters, inspect.signature(ref).parameters
        for key in ("compute_dtype", "stash_dtype", "backward", "bwd_impl"):
            assert (key in ps) == (key in rs), (port.__name__, key)
            if key in ps:
                assert ps[key].default == rs[key].default, (port.__name__, key)


@pytest.mark.parametrize("compute,stash", PAIRS)
def test_trunk_stash_entry_undifferentiated_runs_kernel_i(case, compute, stash):
    """Without a gradient, ``fused_mlp_apply_stash`` and ``fused_mlp_apply``
    (under every schedule) give ``mlp_relu_plain``'s output at the operand
    dtype bit for bit (kernel I on the card, as JAX's stash op dispatches its
    non-stash forward for the undifferentiated primal); a wrong ``bwd_impl``
    or dtype name raises."""
    _, tp, x, _ = case
    xt = torch.tensor(x)
    want = tcm.mlp_relu_plain(tcm.materialize_mlp_weights(tp, N_LAYERS), xt, N_LAYERS, compute)
    with torch.no_grad():
        got = [tcs.fused_mlp_apply_stash(tp, N_LAYERS, xt, compute_dtype=compute, stash_dtype=stash)]
        got += [tcm.fused_mlp_apply(tp, N_LAYERS, xt, compute_dtype=compute, backward=b)
                for b in ("recompute", "stash", "stash_all", "stash_xla")]
    assert all(torch.equal(a, want) for a in got)
    with pytest.raises(ValueError):
        tcs.fused_mlp_apply_stash(tp, N_LAYERS, xt, compute_dtype=compute, stash_dtype=stash, bwd_impl="kernel")
    with pytest.raises(ValueError):
        tcs.fused_mlp_apply_stash(tp, N_LAYERS, xt, compute_dtype=compute, stash_dtype="float16")
    with pytest.raises(ValueError):
        tcm.fused_mlp_apply(tp, N_LAYERS, xt, compute_dtype="float16")


@pytest.mark.parametrize("dims", [(45, 32, 32, 3), (361, 256, 256, 256, 256, 3)], ids=["small", "full"])
def test_f32_trunk_pack(dims):
    """The f32 trunk pack: the bf16 pack's layout and meta with f32 blocks,
    and every block transposed at its own offset (wtpack: layer 0's is
    [256][368] at full width), the chain's B operand; the bf16 pack has
    none.  ``trunk_pack`` refuses a pack of the other dtype, ``pack_mlp`` a
    dtype other than bf16 and f32."""
    from nrhints_torch.fields.mlp import torch_default_linear_init

    gen = torch.Generator().manual_seed(1)
    w = []
    for i in range(len(dims) - 1):
        w += list(torch_default_linear_init(gen, dims[i], dims[i + 1], "cpu"))
    n_layers = len(dims) - 2
    p32, p16 = tcm.pack_mlp(w, n_layers, torch.float32), tcm.pack_mlp(w, n_layers)
    assert p32["wpack"].dtype == p32["wtpack"].dtype == torch.float32 and "wtpack" not in p16
    assert np.array_equal(p32["meta"], p16["meta"]) and torch.equal(p32["bpack"], p16["bpack"])
    assert torch.equal(p32["wpack"].to(torch.bfloat16), p16["wpack"])
    meta = p32["meta"]
    for i in range(n_layers + 1):
        din, dout, kp, np_, off = (int(v) for v in meta[4 + 7 * i : 9 + 7 * i])
        blk = p32["wpack"][off : off + kp * np_].view(kp, np_)
        assert torch.equal(blk[:din, :dout], w[2 * i]) and not blk[din:].any() and not blk[:, dout:].any()
        assert torch.equal(p32["wtpack"][off : off + kp * np_].view(np_, kp), blk.t())
    if dims[0] == 361:
        assert (int(meta[6]), int(meta[7])) == (368, 256)
    assert tcm.trunk_pack(w, n_layers, "float32", p32) is p32
    assert tcm.trunk_pack(w, n_layers, "bfloat16", p16) is p16
    for compute, pk in (("bfloat16", p32), ("float32", p16)):
        with pytest.raises(ValueError):
            tcm.trunk_pack(w, n_layers, compute, pk)
    with pytest.raises(ValueError):
        tcm.pack_mlp(w, n_layers, torch.float16)


@pytest.mark.parametrize("compute,stash,bits,suffix", [
    ("bfloat16", "bfloat16", 0, ""), ("float32", "float32", 3, "_f32"),
    ("float32", "bfloat16", 1, "_f32_bf16stash"), ("bfloat16", "float32", 2, "_f32stash")])
def test_trunk_instance_names_and_dtype_bits(compute, stash, bits, suffix):
    """The dtypes int the trunk's C entry points read (bit 0 f32 operands,
    bit 1 an f32 stash) and the launch counter of each instance of F and G;
    I and J count by their operands alone; every instance has a counter and
    dispatches in csrc/mlp_stash.cu, and every entry point takes the dtypes
    int before the stream."""
    assert tcm.dtype_bits(compute, stash) == bits
    for kernel in ("mlp_stash_fwd", "mlp_stash_bwd"):
        name = tcm.instance_name(kernel, compute, stash)
        assert name == kernel + suffix and name in cuda_lib.launch_counts
    for kernel in ("mlp_fwd", "mlp_bwd"):
        assert tcm.instance_name(kernel, compute) == kernel + ("_f32" if compute == "float32" else "")
        assert tcm.instance_name(kernel, compute) in cuda_lib.launch_counts
    T, S = ("float" if d == "float32" else "bf16" for d in (compute, stash))
    src = (cuda_lib.CSRC / "mlp_stash.cu").read_text()
    assert f"launch_fwd<{T}, {S}, MODE>(a...)" in src and f"launch_chain<{T}, {S}>(a...)" in src
    sigs = cuda_lib._SIGNATURES["mlp_stash"]
    assert all(sig[-2:] == [cuda_lib._I, cuda_lib._P] for sig in sigs.values())
    assert len(re.findall(r"int dtypes,\s+void\* stream\)", src)) == len(sigs)
