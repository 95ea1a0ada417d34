"""The plain versions of kernels A-J against the JAX package's Pallas
kernels run in interpret mode on the CPU (as the JAX tests run them), on the
same numpy-seeded inputs, and the port's autograd ops against autograd.  (Each CUDA kernel against its plain version, on
the card, is tests/test_torch_gpu.py.)

Tolerances and why:
* A, float32: rtol 1e-5 / atol 1e-5 (same arithmetic, other sum order).
* A, bf16 operands: atol 1e-4.  Both round the dot operands to bf16, but
  the f32 activations feeding a rounding can differ in the last bit, and a
  value that close to a bf16 rounding boundary rounds the other way.
* B: the merge is a fixed comparison network on identical inputs, so the
  merged z and sdf must be identical.  The draw at u = 1 compares the total
  cdf with 1 exactly, so the last ulp of the prefix sums decides whether
  that sample lands on the last valid z or inside the last valid interval:
  it is checked to lie in that interval; the other 15 draws agree to 1e-5.
  Through a whole march that one sample moves later draws in the ray's
  low-weight tail, so the refined z agree to 1e-4 in at least 90% of the
  slots and to one stratified interval everywhere.
* C: float32 rtol 1e-5; bf16 atol 1e-4 (bf16 rounding flips, as A).
* K (the initial sweep): as C.
* L and M (the round-4 marches) and B under merge="rank": the z metric of
  B's whole march above; the rank merge places every element where JAX's
  shift network does, so the merged buffers are identical.
* N (the monolithic shadow march): tau within the roadmap's shadow-map
  1e-3, as the split march.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nrhints_torch.kernels import core_mlp as tcm, core_stash as tcs, cuda_lib, march as tm
from nrhints_tpu.kernels import core_mlp as jcm, march as jm
from tests.torch_port_utils import N_RAYS, camera_rays, jax_sdf_params


@pytest.fixture(scope="module")
def sdf():
    return jax_sdf_params()


@pytest.fixture(scope="module")
def rays():
    o, d, pl_, near, far = camera_rays(0)
    z0 = (near + (far - near) * np.linspace(0.0, 1.0, 64, dtype=np.float32)[None, :]).astype(np.float32)
    return o, d, pl_, z0


# ---------------------------------------------------------------------------
# Kernel A


@pytest.mark.parametrize("cdt,atol", [("float32", 1e-5), ("bfloat16", 1e-4)])
def test_sdf_core_plain_matches_pallas(sdf, cdt, atol):
    jc, jp, tc, tp = sdf
    x = (np.random.default_rng(0).normal(size=(100, 3)) * 0.5).astype(np.float32)
    jw = jcm.materialize_sdf_weights_full(jp, jc)
    pallas = jcm._sdf_core_fwd_pallas((jc, 64, 64, True, cdt), jw, jnp.asarray(x))
    ref = jcm.sdf_core_ref(jw, jnp.asarray(x), jc, cdt)
    port = tcm.sdf_core_plain(tcm.materialize_sdf_weights_full(tp, tc), torch.tensor(x), tc, cdt)
    for p, a, r in zip(port, pallas, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(a).reshape(p.shape), rtol=1e-5, atol=atol)
        np.testing.assert_allclose(p.numpy(), np.asarray(r).reshape(p.shape), rtol=1e-5, atol=atol)


def test_cpu_wrappers_take_plain_path(sdf, rays):
    """On CPU tensors every wrapper runs its plain version and launches
    nothing."""
    jc, jp, tc, tp = sdf
    o, d, pl_, z0 = (torch.tensor(a) for a in rays)
    cuda_lib.reset_launch_counts()
    x = torch.tensor(np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32))
    out = tcm.fused_sdf_value_feat_grad(tp, tc, x)
    ref = tcm.sdf_core_plain(tcm.materialize_sdf_weights_full(tp, tc), x, tc, "bfloat16")
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    z = tm.fused_importance_z(tp, tc, o, d, z0, mlp_dtype="bfloat16", split=True, sweep_impl="xla", rounds_impl="xla")
    w = tm.march_weights(tp, tc, "bfloat16")
    sdist = torch.full((N_RAYS, 1), 0.03)
    tm.shadow_final(z, o, d, sdist, 64.0, 1.0, w, tc)
    sdf0 = tm.march_sweep(z0, o, d, w, tc)
    assert torch.equal(sdf0, tm.march_sweep_plain(z0, o, d, w, tc))
    assert torch.equal(tm.march_rounds(z0, sdf0, o, d, w, tc), tm.march_rounds_plain(z0, sdf0, o, d, w, tc))
    assert torch.equal(tm.importance_march(z0, o, d, w, tc), tm.importance_march_plain(z0, o, d, w, tc))
    assert torch.equal(tm.shadow_march(z0, o, d, sdist, 64.0, 1.0, w, tc),
                       tm.shadow_march_plain(z0, o, d, sdist, 64.0, 1.0, w, tc))
    assert all(v == 0 for v in cuda_lib.launch_counts.values())


# ---------------------------------------------------------------------------
# Kernel B


def _schedule(tc, tp, o, d, z0, mlp_dtype, merge="bitonic"):
    """The inputs of the 5 machinery steps of one march (captured from the
    port's own run) as tuples of round_machinery arguments."""
    w = tm.march_weights(tp, tc, mlp_dtype)
    z = torch.cat([z0, torch.full((z0.shape[0], 64), tm.BIG_Z)], -1)
    sweep = tm._mlp_sdf_3d(o[:, None, :] + d[:, None, :] * z0[..., None], w, tc)
    sdf = torch.cat([sweep, torch.zeros_like(sweep)], -1)
    steps, new_z, new_sdf = [], None, None
    for i in range(4):
        vn = 64 + 16 * i
        args = (z, sdf, o, d, new_z, new_sdf, None if i == 0 else vn - 16, vn, 64.0 * 2**i)
        steps.append(args)
        new_z, z, sdf = tm.round_machinery_plain(*args, merge=merge)
        new_sdf = tm._mlp_sdf_3d(o[:, None, :] + d[:, None, :] * new_z[..., None], w, tc) if i < 3 else torch.zeros_like(new_z)
    steps.append((z, sdf, o, d, new_z, new_sdf, 112, None, None))
    return steps


def _pallas_machinery(z, sdf, o, d, nz, ns, merge_vn, next_vn, inv_s, merge="bitonic"):
    """One launch of the JAX ``_round_machinery_kernel``, interpret mode."""
    kernel = jm._round_machinery_kernel(16, merge, merge_vn, next_vn, inv_s)
    inputs = [z, sdf, o, d] + ([nz, ns] if merge_vn is not None else [])
    inputs = [jnp.asarray(a.numpy()) for a in inputs]
    widths = (16, 128, 128) if next_vn is not None else (128,)
    b = z.shape[0]

    def spec(w):
        return pl.BlockSpec((b, w), lambda i: (0, 0))

    return pl.pallas_call(
        kernel,
        grid=(1,),
        in_specs=[spec(a.shape[-1]) for a in inputs],
        out_specs=tuple(spec(w) for w in widths),
        out_shape=tuple(jax.ShapeDtypeStruct((b, w), jnp.float32) for w in widths),
        interpret=True,
    )(*inputs)


@pytest.mark.parametrize("step", range(5))
def test_round_machinery_step_matches_pallas(sdf, rays, step):
    jc, jp, tc, tp = sdf
    o, d, _, z0 = (torch.tensor(a) for a in rays)
    args = _schedule(tc, tp, o, d, z0, "float32")[step]
    new_z, z, sdf_out = tm.round_machinery_plain(*args)
    ref = [np.asarray(a) for a in _pallas_machinery(*args)]
    if new_z is None:
        np.testing.assert_array_equal(z.numpy(), ref[0])
        return
    np.testing.assert_array_equal(z.numpy(), ref[1])
    np.testing.assert_array_equal(sdf_out.numpy(), ref[2])
    np.testing.assert_allclose(new_z[:, 1:].numpy(), ref[0][:, 1:], rtol=1e-5, atol=1e-5)
    vn = args[7]
    lo, hi = z[:, vn - 2].numpy(), z[:, vn - 1].numpy()
    for u1 in (new_z[:, 0].numpy(), ref[0][:, 0]):
        assert np.all((u1 >= lo) & (u1 <= hi))


@pytest.mark.parametrize("step", [1, 2, 3, 4])
def test_round_machinery_rank_step_matches_pallas(sdf, rays, step):
    """The merging steps of B under merge="rank" against JAX's rank merge:
    the merged buffers are identical, the draw as above; the merged z
    equal the bitonic network's."""
    jc, jp, tc, tp = sdf
    o, d, _, z0 = (torch.tensor(a) for a in rays)
    args = _schedule(tc, tp, o, d, z0, "float32", merge="rank")[step]
    new_z, z, sdf_out = tm.round_machinery_plain(*args, merge="rank")
    ref = [np.asarray(a) for a in _pallas_machinery(*args, merge="rank")]
    assert torch.equal(z, tm.round_machinery_plain(*args)[1])
    if new_z is None:
        np.testing.assert_array_equal(z.numpy(), ref[0])
        return
    np.testing.assert_array_equal(z.numpy(), ref[1])
    np.testing.assert_array_equal(sdf_out.numpy(), ref[2])
    np.testing.assert_allclose(new_z[:, 1:].numpy(), ref[0][:, 1:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("merge", ["bitonic", "rank"])
def test_round_machinery_last_step_matches_pallas(sdf, rays, merge):
    """B's last-round mode (the round-3 draw, then those 16 samples merged in
    with a zero sdf, z alone returned) against JAX's round-3
    ``_round_machinery_kernel`` followed by its tail kernel, interpret mode:
    z equal to JAX's tail on JAX's round-3 buffers and the port's draws,
    which agree with JAX's draws as in the steps above."""
    jc, jp, tc, tp = sdf
    o, d, _, z0 = (torch.tensor(a) for a in rays)
    args = _schedule(tc, tp, o, d, z0, "float32", merge=merge)[3]
    new_z, z, sdf_out = tm.round_machinery_plain(*args, merge=merge, last=True)
    assert new_z is None and sdf_out is None
    j_new, j_z, j_sdf = (torch.tensor(np.asarray(a)) for a in _pallas_machinery(*args, merge=merge))
    draws = tm.round_machinery_plain(*args, merge=merge)[0]
    (tail,) = _pallas_machinery(j_z, j_sdf, o, d, draws, torch.zeros_like(draws), 112, None, None, merge=merge)
    np.testing.assert_array_equal(z.numpy(), np.asarray(tail))
    np.testing.assert_allclose(draws[:, 1:].numpy(), j_new[:, 1:].numpy(), rtol=1e-5, atol=1e-5)
    lo, hi = j_z[:, 110].numpy(), j_z[:, 111].numpy()
    for u1 in (draws[:, 0].numpy(), j_new[:, 0].numpy()):
        assert np.all((u1 >= lo) & (u1 <= hi))


@pytest.mark.parametrize("merge", ["bitonic", "rank"])
def test_rounds_take_four_machinery_steps(sdf, rays, merge):
    """A march's rounds take 4 machinery steps, the last in the last-round
    mode, and give the z of JAX's schedule of 5 (4 rounds and a merge-only
    tail step) bit for bit."""
    jc, jp, tc, tp = sdf
    o, d, _, z0 = (torch.tensor(a) for a in rays)
    w = tm.march_weights(tp, tc, "float32")
    sdf0 = tm.march_sweep_plain(z0, o, d, w, tc)
    calls = []

    def machinery(*args):
        calls.append((args[6], args[7], args[11]))
        return tm.round_machinery_plain(*args)

    z = tm._rounds(w, tc, o, d, z0, sdf0, 4, 16, 64.0, merge, machinery)
    assert calls == [(None, 64, False), (64, 80, False), (80, 96, False), (96, 112, True)]
    steps = _schedule(tc, tp, o, d, z0, "float32", merge=merge)
    assert torch.equal(z, tm.round_machinery_plain(*steps[4], merge=merge)[1])


def _assert_z_close(out, ref):
    """The refined-z metric: sorted, 90% of slots within 1e-4, every slot
    within one stratified interval (the u = 1 draw, see above)."""
    assert out.shape == (N_RAYS, 128)
    assert np.all(np.diff(out, axis=-1) >= 0)
    err = np.abs(out - ref)
    assert np.mean(err <= 1e-4) >= 0.9, np.mean(err <= 1e-4)
    assert err.max() <= 2.0 / 63 + 1e-5


@pytest.mark.parametrize("mlp_dtype", ["float32", "bfloat16"])
def test_importance_z_matches_jax(sdf, rays, mlp_dtype):
    jc, jp, tc, tp = sdf
    o, d, _, z0 = rays
    ref = np.asarray(
        jm.fused_importance_z(
            jp, jc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(z0), split=True, sweep_impl="xla",
            rounds_impl="xla", interpret=True, mlp_dtype=mlp_dtype,
        )
    )
    out = tm.fused_importance_z(
        tp, tc, torch.tensor(o), torch.tensor(d), torch.tensor(z0), mlp_dtype=mlp_dtype, split=True, sweep_impl="xla",
        rounds_impl="xla",
    ).numpy()
    _assert_z_close(out, ref)


# ---------------------------------------------------------------------------
# Kernel C


def _shadow_inputs(tc, tp, rays, mlp_dtype):
    o, d, pl_, _ = rays
    o_t, d_t = torch.tensor(o), torch.tensor(d)
    z = tm.fused_importance_z(
        tp, tc, o_t, d_t, torch.tensor(rays[3]), mlp_dtype=mlp_dtype, split=True, sweep_impl="xla", rounds_impl="xla"
    )
    sdist = torch.full((N_RAYS, 1), 2.0 / 64)
    return z, o_t, d_t, sdist


@pytest.mark.parametrize("mlp_dtype,atol", [("float32", 1e-6), ("bfloat16", 1e-4)])
def test_shadow_final_plain_matches_pallas(sdf, rays, mlp_dtype, atol):
    jc, jp, tc, tp = sdf
    z, o, d, sdist = _shadow_inputs(tc, tp, rays, mlp_dtype)
    weights, w_specs = jm._weights_and_specs(jp, jc, mlp_dtype)
    b = N_RAYS

    def spec(w):
        return pl.BlockSpec((b, w), lambda i: (0, 0))

    scalar = pl.BlockSpec((1, 1), lambda i: (0, 0), memory_space=pltpu.SMEM)
    ref = pl.pallas_call(
        jm._shadow_final_kernel(jc, len(weights)),
        grid=(1,),
        in_specs=[spec(128), spec(3), spec(3), spec(1), scalar, scalar, *w_specs],
        out_specs=spec(1),
        out_shape=jax.ShapeDtypeStruct((b, 1), jnp.float32),
        interpret=True,
    )(*[jnp.asarray(t.numpy()) for t in (z, o, d, sdist)], jnp.full((1, 1), 64.0), jnp.full((1, 1), 0.7), *weights)
    out = tm.shadow_final_plain(z, o, d, sdist, 64.0, 0.7, tm.march_weights(tp, tc, mlp_dtype), tc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=atol)
    assert np.asarray(ref).min() < 0.9  # some shadow rays cross the surface


@pytest.mark.parametrize("mlp_dtype,atol", [("float32", 1e-3), ("bfloat16", 1e-3)])
def test_shadow_tau_matches_jax(sdf, rays, mlp_dtype, atol):
    """The whole shadow march; tau within the roadmap's shadow-map 1e-3."""
    jc, jp, tc, tp = sdf
    o, d, _, z0 = rays
    sdist = np.full((N_RAYS, 1), 2.0 / 64, np.float32)
    ref = jm.fused_shadow_tau(
        jp, jc, *(jnp.asarray(a) for a in (o, d, z0, sdist)), jnp.asarray(64.0), jnp.asarray(0.7),
        split=True, sweep_impl="xla", rounds_impl="xla", final_impl="pallas", interpret=True,
        mlp_dtype=mlp_dtype,
    )
    out = tm.fused_shadow_tau(
        tp, tc, *(torch.tensor(a) for a in (o, d, z0, sdist)), torch.tensor(64.0), torch.tensor(0.7),
        mlp_dtype=mlp_dtype, split=True, sweep_impl="xla", rounds_impl="xla", final_impl="pallas",
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)


# ---------------------------------------------------------------------------
# Kernels K, L, M and N (the round-4 fused marches)


def _full_spec(b, w):
    return pl.BlockSpec((b, w), lambda i: (0, 0))


@pytest.mark.parametrize("mlp_dtype,atol", [("float32", 1e-6), ("bfloat16", 1e-4)])
def test_march_sweep_plain_matches_pallas(sdf, rays, mlp_dtype, atol):
    jc, jp, tc, tp = sdf
    o, d, _, z0 = rays
    weights, w_specs = jm._weights_and_specs(jp, jc, mlp_dtype)
    ref = pl.pallas_call(
        jm._sweep_kernel(jc, len(weights)),
        grid=(1,),
        in_specs=[_full_spec(N_RAYS, 64), _full_spec(N_RAYS, 3), _full_spec(N_RAYS, 3), *w_specs],
        out_specs=_full_spec(N_RAYS, 64),
        out_shape=jax.ShapeDtypeStruct((N_RAYS, 64), jnp.float32),
        interpret=True,
    )(jnp.asarray(z0), jnp.asarray(o), jnp.asarray(d), *weights)
    out = tm.march_sweep_plain(*(torch.tensor(a) for a in (z0, o, d)), tm.march_weights(tp, tc, mlp_dtype), tc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("merge", ["bitonic", "rank"])
def test_march_rounds_plain_matches_pallas(sdf, rays, merge):
    """L's plain version against ``_rounds_kernel`` on the same (z0, sdf0)."""
    jc, jp, tc, tp = sdf
    o, d, _, z0 = rays
    w = tm.march_weights(tp, tc, "float32")
    sdf0 = tm.march_sweep_plain(*(torch.tensor(a) for a in (z0, o, d)), w, tc).numpy()
    weights, w_specs = jm._weights_and_specs(jp, jc, "float32")
    ref = pl.pallas_call(
        jm._rounds_kernel(jc, 4, 16, 64.0, len(weights), merge),
        grid=(1,),
        in_specs=[_full_spec(N_RAYS, 64), _full_spec(N_RAYS, 64), _full_spec(N_RAYS, 3), _full_spec(N_RAYS, 3),
                  *w_specs],
        out_specs=_full_spec(N_RAYS, 128),
        out_shape=jax.ShapeDtypeStruct((N_RAYS, 128), jnp.float32),
        interpret=True,
    )(*(jnp.asarray(a) for a in (z0, sdf0, o, d)), *weights)
    out = tm.march_rounds_plain(*(torch.tensor(a) for a in (z0, sdf0, o, d)), w, tc, merge=merge)
    _assert_z_close(out.numpy(), np.asarray(ref))


MARCH_CASES = [("float32", "bitonic"), ("bfloat16", "bitonic"), ("float32", "rank")]


@pytest.mark.parametrize("mlp_dtype,merge", MARCH_CASES)
def test_importance_march_plain_matches_jax(sdf, rays, mlp_dtype, merge):
    """M's plain version against JAX's monolithic importance march."""
    jc, jp, tc, tp = sdf
    o, d, _, z0 = rays
    ref = jm.fused_importance_z(
        jp, jc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(z0), interpret=True, mlp_dtype=mlp_dtype, merge=merge
    )
    out = tm.importance_march_plain(
        *(torch.tensor(a) for a in (z0, o, d)), tm.march_weights(tp, tc, mlp_dtype), tc, merge=merge
    )
    _assert_z_close(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mlp_dtype,merge", MARCH_CASES)
def test_shadow_march_plain_matches_jax(sdf, rays, mlp_dtype, merge):
    """N's plain version against JAX's monolithic shadow march: tau 1e-3."""
    jc, jp, tc, tp = sdf
    o, d, _, z0 = rays
    sdist = np.full((N_RAYS, 1), 2.0 / 64, np.float32)
    ref = jm.fused_shadow_tau(
        jp, jc, *(jnp.asarray(a) for a in (o, d, z0, sdist)), jnp.asarray(64.0), jnp.asarray(0.7),
        interpret=True, mlp_dtype=mlp_dtype, merge=merge,
    )
    out = tm.shadow_march_plain(
        *(torch.tensor(a) for a in (z0, o, d, sdist)), 64.0, 0.7, tm.march_weights(tp, tc, mlp_dtype), tc, merge=merge
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3)
    assert np.asarray(ref).min() < 0.9


def test_rank_merge_requires_power_of_two_n_new(sdf, rays):
    _, _, tc, tp = sdf
    o, d, _, _ = (torch.tensor(a) for a in rays)
    z0 = torch.linspace(2.0, 4.0, 128 - 4 * 12).expand(N_RAYS, -1)
    with pytest.raises(ValueError, match="power-of-two"):
        tm.fused_importance_z(tp, tc, o, d, z0, n_new=12, merge="rank")


@pytest.mark.parametrize("kw", [{"merge": "odd_even"}, {"split": True, "sweep_impl": "mosaic"},
                                {"rounds_impl": "xla"}, {"split": True, "final_impl": "triton"}])
def test_march_dispatch_rejects_bad_knobs(sdf, rays, kw):
    """Values outside each knob's JAX set raise, as does an "xla" half
    without split=True."""
    _, _, tc, tp = sdf
    o, d, _, z0 = (torch.tensor(a) for a in rays)
    with pytest.raises(ValueError):
        tm.fused_shadow_tau(tp, tc, o, d, z0, torch.full((N_RAYS, 1), 0.03), 64.0, 1.0, **kw)


# ---------------------------------------------------------------------------
# Kernels D and E (the SDF stash op) and F and G (the trunk stash op)
#
# Tolerances, each as max |port - JAX| <= tol * max |JAX| per output (dW
# entries that nearly cancel over the points carry f32 reassociation noise,
# so the scale is the tensor's, not the entry's):
# * float32 compute and stash: 2e-3, the roadmap's gradient tolerance (the
#   measured gap is ~1e-6: same formulas, other summation order).
# * the shipping bf16 dot operands and bf16 stash: 2e-2.  Both sides round
#   the same operands, but an f32 value within an ulp of a bf16 rounding
#   boundary can round the other way on either side, which moves that
#   operand by 2^-8 relative, and the backward chains 2L such products.


def _close_scaled(port, ref, tol, what=""):
    ref = np.asarray(ref, dtype=np.float64)
    port = np.asarray(port, dtype=np.float64).reshape(ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(port - ref).max())
    assert err <= tol * scale, f"{what}: err {err:.3e} vs scale {scale:.3e}"


STASH_TOL = {"float32": 2e-3, "bfloat16": 2e-2}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, dtype=np.float32)


@pytest.fixture(scope="module")
def stash_case(sdf):
    """Points, weights on both sides and random cotangents of (sdf, feat, grad)."""
    jc, jp, tc, tp = sdf
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(77, 3)) * 0.4).astype(np.float32)
    cots = (rng.normal(size=(77,)).astype(np.float32), rng.normal(size=(77, tc.d_out_feat)).astype(np.float32),
            rng.normal(size=(77, 3)).astype(np.float32))
    jw = jcm.materialize_sdf_weights_full(jp, jc)
    tw = tcm.materialize_sdf_weights_full(tp, tc)
    return jc, tc, x, cots, jw, tw


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_sdf_fwd_hs_plain_matches_jax(stash_case, dt):
    """Kernel D's plain version against ``sdf_core_fwd_hs_ref`` and the
    Pallas stash forward (interpret mode)."""
    from nrhints_tpu.kernels import core_stash as jcs

    jc, tc, x, _, jw, tw = stash_case
    port = tcs.sdf_core_fwd_hs_plain(tw, torch.tensor(x), tc, dt, dt)
    ref = jcs.sdf_core_fwd_hs_ref(list(jw), jnp.asarray(x), jc, dt)
    (psdf, pfeat, pgx), phs = jcs._sdf_stash_fwd_pallas((jc, 32, 32, True, dt, dt, False), jw, jnp.asarray(x))
    for p, r, q in zip(port[:3], ref[:3], (psdf, pfeat, pgx)):
        _close_scaled(_np(p), np.asarray(r).reshape(p.shape), 1e-5 if dt == "float32" else 2e-3)
        _close_scaled(_np(p), np.asarray(q).reshape(p.shape), 1e-5 if dt == "float32" else 2e-3)
    assert len(port[3]) == tc.n_layers
    for h, r, q in zip(port[3], ref[3], phs):
        assert h.dtype == tcs._DTYPES[dt]
        _close_scaled(_np(h), np.asarray(q, np.float32), 1e-5 if dt == "float32" else 2e-2)
        _close_scaled(_np(h), np.asarray(r), 1e-5 if dt == "float32" else 2e-2)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_sdf_bwd_stash_plain_matches_jax(stash_case, dt):
    """Kernel E's plain version against ``sdf_core_bwd_stash_ref`` at the
    same stash, against the Pallas stash backward (interpret mode) and,
    in f32, against ``jax.vjp`` of ``sdf_core_ref``."""
    from nrhints_tpu.kernels import core_stash as jcs

    jc, tc, x, cots, jw, tw = stash_case
    _, _, _, jhs = jcs.sdf_core_fwd_hs_ref(list(jw), jnp.asarray(x), jc, dt)
    jhs = [h.astype(jnp.dtype(dt)) for h in jhs]
    jcots = (jnp.asarray(cots[0]).reshape(-1, 1), jnp.asarray(cots[1]), jnp.asarray(cots[2]))
    ref_dws, ref_dx = jcs.sdf_core_bwd_stash_ref(list(jw), jnp.asarray(x), [h.astype(jnp.float32) for h in jhs],
                                                 jcots, jc, dt)
    pal_dws, pal_dx = jcs._sdf_stash_bwd_pallas((jc, 32, 32, True, dt, dt, False), jw, jnp.asarray(x), jhs,
                                                (jnp.asarray(cots[0]), jcots[1], jcots[2]))
    ths = [torch.tensor(np.asarray(h.astype(jnp.float32))).to(tcs._DTYPES[dt]) for h in jhs]
    dws, dx = tcs.sdf_core_bwd_stash_plain(tw, torch.tensor(x), ths, tuple(torch.tensor(c) for c in cots), tc, dt)
    tol = STASH_TOL[dt]
    refs = [(ref_dws, ref_dx, "stash_ref"), (pal_dws, pal_dx, "pallas")]
    if dt == "float32":
        _, vjp = jax.vjp(lambda w, xx: jcm.sdf_core_ref(w, xx, jc, "float32"), list(jw), jnp.asarray(x))
        refs.append((*vjp(jcots), "vjp"))
    for r_dws, r_dx, name in refs:
        _close_scaled(_np(dx), r_dx, tol, f"{name} dx")
        assert len(dws) == len(r_dws)
        for k, (a, b) in enumerate(zip(dws, r_dws)):
            _close_scaled(_np(a), b, tol, f"{name} dw[{k}]")


def test_sdf_stash_backward_without_weight_gradients(stash_case):
    """Where no weight needs a gradient (registration), kernel E's plain
    version and ``SdfStashFn`` compute no weight cotangent, and dx is the
    full backward's bit for bit."""
    _, tc, x, cots, _, tw = stash_case
    xt = torch.tensor(x)
    _, _, _, hs = tcs.sdf_core_fwd_hs_plain(tw, xt, tc, "bfloat16", "bfloat16")
    tcots = tuple(torch.tensor(c) for c in cots)
    dws, dx = tcs.sdf_core_bwd_stash_plain(tw, xt, hs, tcots, tc, "bfloat16")
    none, dx_only = tcs.sdf_core_bwd_stash_plain(tw, xt, hs, tcots, tc, "bfloat16", need_dw=False)
    assert none is None and len(dws) == len(tw) and torch.equal(dx_only, dx)
    grads = []
    for weights_grad in (True, False):
        ws = [w.clone().requires_grad_(weights_grad) for w in tw]
        xx = xt.clone().requires_grad_(True)
        out = tcs.SdfStashFn.apply(tc, "bfloat16", "bfloat16", "kernel", False, xx, *ws)
        torch.autograd.backward(out, tcots)
        assert all((w.grad is not None) == weights_grad for w in ws)
        grads.append(xx.grad)
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0], dx)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_sdf_fwd_hs_plain_return_us_matches_jax(stash_case, dt):
    """Kernel D's stash_all variant's plain version (``return_us``) against
    ``sdf_core_fwd_hs_ref(return_us=True)`` and the Pallas stash forward
    with ``stash_us=True`` (interpret mode): the outputs, and every h_i,
    u_i and g_enc in the stash's dtype."""
    from nrhints_tpu.kernels import core_stash as jcs

    jc, tc, x, _, jw, tw = stash_case
    L = tc.n_layers
    port = tcs.sdf_core_fwd_hs_plain(tw, torch.tensor(x), tc, dt, dt, return_us=True)
    ref = jcs.sdf_core_fwd_hs_ref(list(jw), jnp.asarray(x), jc, dt, return_us=True)
    (psdf, pfeat, pgx), extras = jcs._sdf_stash_fwd_pallas((jc, 32, 32, True, dt, dt, True), jw, jnp.asarray(x))
    for p, r, q in zip(port[:3], ref[:3], (psdf, pfeat, pgx)):
        _close_scaled(_np(p), np.asarray(r).reshape(p.shape), 1e-5 if dt == "float32" else 2e-3)
        _close_scaled(_np(p), np.asarray(q).reshape(p.shape), 1e-5 if dt == "float32" else 2e-3)
    stash = [*port[3], *port[4], port[5]]
    assert len(stash) == len(extras) == 2 * L + 1
    for k, (s, r, q) in enumerate(zip(stash, [*ref[3], *ref[4], ref[5]], extras)):
        assert s.dtype == tcs._DTYPES[dt] and tuple(s.shape) == q.shape, k
        _close_scaled(_np(s), np.asarray(q, np.float32), 1e-5 if dt == "float32" else 2e-2, f"stash {k}")
        _close_scaled(_np(s), np.asarray(r), 1e-5 if dt == "float32" else 2e-2, f"stash {k}")
    u_last = (tw[2 * L].reshape(1, -1) / tc.scale).to(tcs._DTYPES[dt]).expand(x.shape[0], -1)
    assert torch.equal(port[4][L - 1], u_last)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_sdf_bwd_stash_all_plain_matches_jax(stash_case, dt):
    """Kernel E's stash_all variant's plain version against
    ``sdf_core_bwd_stash_all_ref`` and the Pallas stash backward with
    ``stash_us=True`` (interpret mode), at the same h_i, u_i and g_enc
    rounded to the stash's dtype."""
    from nrhints_tpu.kernels import core_stash as jcs

    jc, tc, x, cots, jw, tw = stash_case
    L = tc.n_layers
    _, _, _, jhs, jus, jge = jcs.sdf_core_fwd_hs_ref(list(jw), jnp.asarray(x), jc, dt, return_us=True)
    stash = [a.astype(jnp.dtype(dt)) for a in (*jhs, *jus, jge)]
    f32 = [a.astype(jnp.float32) for a in stash]
    jcots = (jnp.asarray(cots[0]).reshape(-1, 1), jnp.asarray(cots[1]), jnp.asarray(cots[2]))
    ref_dws, ref_dx = jcs.sdf_core_bwd_stash_all_ref(list(jw), jnp.asarray(x), f32[:L], f32[L : 2 * L], f32[2 * L],
                                                     jcots, jc, dt)
    pal_dws, pal_dx = jcs._sdf_stash_bwd_pallas((jc, 32, 32, True, dt, dt, True), jw, jnp.asarray(x), stash,
                                                (jnp.asarray(cots[0]), jcots[1], jcots[2]))
    ts = [torch.tensor(np.asarray(a)).to(tcs._DTYPES[dt]) for a in f32]
    dws, dx = tcs.sdf_core_bwd_stash_all_plain(tw, torch.tensor(x), ts[:L], ts[L : 2 * L], ts[2 * L],
                                               tuple(torch.tensor(c) for c in cots), tc, dt)
    tol = STASH_TOL[dt]
    for r_dws, r_dx, name in ((ref_dws, ref_dx, "stash_all_ref"), (pal_dws, pal_dx, "pallas")):
        _close_scaled(_np(dx), r_dx, tol, f"{name} dx")
        assert len(dws) == len(r_dws)
        for k, (a, b) in enumerate(zip(dws, r_dws)):
            _close_scaled(_np(a), b, tol, f"{name} dw[{k}]")


def test_stash_all_sdf_op_matches_jax_vjp(sdf, stash_case):
    """``fused_sdf_value_feat_grad(backward="stash_all")`` through autograd
    (``SdfStashFn`` with ``stash_us``, weight norm outside) against
    ``jax.vjp`` of JAX's ``fused_sdf_value_feat_grad_stash(stash_us=True)``
    in interpret mode, bf16 operands and stash: the outputs, and the
    cotangents of every weight-norm leaf and of x (2e-2 of each scale).
    With no weight needing a gradient, dx is the full backward's bit for
    bit."""
    from nrhints_tpu.kernels import core_stash as jcs
    from nrhints_torch.utils import tree_items

    jc, jp, tc, tp = sdf
    _, _, x, cots, _, _ = stash_case
    j_out, vjp = jax.vjp(lambda p, xx: jcs.fused_sdf_value_feat_grad_stash(
        p, jc, xx, block_pts=32, block_pts_bwd=32, interpret=True, stash_us=True),
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    j_dp, j_dx = vjp(tuple(jnp.asarray(c) for c in cots))
    leaves = {n: t.detach().clone().requires_grad_(True) for n, t in tree_items(tp)}
    params = {}
    for n, t in leaves.items():
        layer, key = n.strip("/").split("/")
        params.setdefault(layer, {})[key] = t
    xt = torch.tensor(x, requires_grad=True)
    tcots = tuple(torch.tensor(c) for c in cots)
    out = tcm.fused_sdf_value_feat_grad(params, tc, xt, backward="stash_all")
    assert type(out[0].grad_fn).__name__.startswith("SdfStashFn") and len(out[0].grad_fn.saved_tensors) > 0
    grads = torch.autograd.grad(out, [xt, *leaves.values()], tcots)
    for a, b in zip(out, j_out):
        _close_scaled(_np(a), b, 2e-3)
    _close_scaled(_np(grads[0]), j_dx, STASH_TOL["bfloat16"], "dx")
    j_named = dict(tree_items(j_dp))
    assert sorted(j_named) == sorted(leaves)
    for (name, _), g in zip(leaves.items(), grads[1:]):
        _close_scaled(_np(g), j_named[name], STASH_TOL["bfloat16"], name)
    frozen = {k: {kk: vv.detach() for kk, vv in v.items()} for k, v in params.items()}
    xt2 = torch.tensor(x, requires_grad=True)
    dx_only = torch.autograd.grad(tcm.fused_sdf_value_feat_grad(frozen, tc, xt2, backward="stash_all"), xt2, tcots)
    assert torch.equal(dx_only[0], grads[0])


def _trunk_params():
    """A 45 -> 2 x 32 -> 3 weight-norm trunk: (JAX params as numpy, port params)."""
    from nrhints_torch.convert import params_from_jax
    from nrhints_tpu.fields.mlp import torch_default_linear_init, weight_norm_params

    key = jax.random.PRNGKey(7)
    dims = [45, 32, 32, 3]
    params = {}
    for i in range(3):
        key, k = jax.random.split(key)
        params[f"lin{i}"] = weight_norm_params(*torch_default_linear_init(k, dims[i], dims[i + 1]))
    jp = jax.device_get(params)
    return jp, params_from_jax(jp, device="cpu")


@pytest.fixture(scope="module")
def trunk_case():
    jp, tp = _trunk_params()
    rng = np.random.default_rng(11)
    x = rng.normal(size=(61, 45)).astype(np.float32)
    g = rng.normal(size=(61, 3)).astype(np.float32)
    return 2, jcm.materialize_mlp_weights(jp, 2), tcm.materialize_mlp_weights(tp, 2), x, g


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_mlp_stash_plain_matches_jax(trunk_case, dt):
    """Kernels F and G's plain versions against ``mlp_relu_fwd_zs_ref`` /
    ``mlp_relu_bwd_stash_ref`` and the Pallas stash kernels (interpret)."""
    from nrhints_tpu.kernels import core_stash as jcs

    n_layers, jw, tw, x, g = trunk_case
    tol = STASH_TOL[dt]
    out, zs = tcs.mlp_relu_fwd_zs_plain(tw, torch.tensor(x), n_layers, dt, dt)
    r_out, r_zs = jcs.mlp_relu_fwd_zs_ref(list(jw), jnp.asarray(x), n_layers, dt)
    p_out, p_zs = jcs._mlp_stash_fwd_pallas((n_layers, 32, 32, True, dt, dt), jw, jnp.asarray(x))
    for ref_o, ref_z in ((r_out, r_zs), (p_out, p_zs)):
        _close_scaled(_np(out), ref_o, 1e-5 if dt == "float32" else 2e-3)
        for a, b in zip(zs, ref_z):
            _close_scaled(_np(a), np.asarray(b, np.float32), 1e-5 if dt == "float32" else 2e-2)
    jzs = [z.astype(jnp.dtype(dt)) for z in r_zs]
    r_dws, r_dx = jcs.mlp_relu_bwd_stash_ref(list(jw), jnp.asarray(x), [z.astype(jnp.float32) for z in jzs],
                                             jnp.asarray(g), n_layers, dt)
    p_dws, p_dx = jcs._mlp_stash_bwd_pallas((n_layers, 32, 32, True, dt, dt), jw, jnp.asarray(x), jzs,
                                            jnp.asarray(g))
    tzs = [torch.tensor(np.asarray(z.astype(jnp.float32))).to(tcs._DTYPES[dt]) for z in jzs]
    dws, dx = tcs.mlp_relu_bwd_stash_plain(tw, torch.tensor(x), tzs, torch.tensor(g), n_layers, dt)
    for ref_dws, ref_dx, name in ((r_dws, r_dx, "ref"), (p_dws, p_dx, "pallas")):
        _close_scaled(_np(dx), ref_dx, tol, f"{name} dx")
        for k, (a, b) in enumerate(zip(dws, ref_dws)):
            _close_scaled(_np(a), b, tol, f"{name} dw[{k}]")


def _stash_loss(sdf_v, feat, gx, coef):
    return (torch.sum(sdf_v * coef[0]) + torch.sum(feat * coef[1]) + torch.sum(gx * coef[2])
            + torch.sum((torch.linalg.norm(gx, dim=-1) - 1.0) ** 2))


def test_sdf_stash_fn_matches_double_backward(stash_case):
    """``SdfStashFn`` through autograd against an independent second-order
    reference: the gradient taken by ``torch.autograd.grad(create_graph=
    True)`` of the plain forward's sdf, then differentiated again.  f32
    compute and stash: 2e-3 of each leaf's scale."""
    jc, tc, x, cots, _, tw = stash_case
    coef = [torch.tensor(c) for c in cots]
    ws = [w.detach().clone().requires_grad_(True) for w in tw]
    xt = torch.tensor(x, requires_grad=True)
    s, f, gx = tcs.SdfStashFn.apply(tc, "float32", "float32", "kernel", False, xt, *ws)
    g_port = torch.autograd.grad(_stash_loss(s, f, gx, coef), [xt, *ws])

    ws2 = [w.detach().clone().requires_grad_(True) for w in tw]
    xt2 = torch.tensor(x, requires_grad=True)
    s2, f2, _ = tcm.sdf_core_plain(ws2, xt2, tc, "float32")
    gx2 = torch.autograd.grad(s2.sum(), xt2, create_graph=True)[0]
    g_ref = torch.autograd.grad(_stash_loss(s2, f2, gx2, coef), [xt2, *ws2])
    _close_scaled(_np(gx), _np(gx2), 1e-4, "grad")
    for k, (a, b) in enumerate(zip(g_port, g_ref)):
        _close_scaled(_np(a), _np(b), STASH_TOL["float32"], f"leaf {k}")


def test_mlp_stash_fn_matches_autograd(trunk_case):
    """``MlpStashFn`` against autograd of the plain forward, f32."""
    n_layers, _, tw, x, g = trunk_case
    ws = [w.detach().clone().requires_grad_(True) for w in tw]
    xt = torch.tensor(x, requires_grad=True)
    out = tcs.MlpStashFn.apply(n_layers, "float32", "float32", "kernel", xt, *ws)
    g_port = torch.autograd.grad(torch.sum(out * torch.tensor(g)), [xt, *ws])
    ws2 = [w.detach().clone().requires_grad_(True) for w in tw]
    xt2 = torch.tensor(x, requires_grad=True)
    out2, _ = tcs.mlp_relu_fwd_zs_plain(ws2, xt2, n_layers)
    g_ref = torch.autograd.grad(torch.sum(out2 * torch.tensor(g)), [xt2, *ws2])
    for k, (a, b) in enumerate(zip(g_port, g_ref)):
        _close_scaled(_np(a), _np(b), 1e-5, f"leaf {k}")


def test_stash_layouts():
    """The packed layouts the CUDA kernels read: stash columns on 16-column
    boundaries, dW products on 16-element boundaries, the shipping widths."""
    from nrhints_torch.fields.sdf import SDFNetConfig

    cols = tcs.sdf_stash_columns(SDFNetConfig())
    assert [w for _, w in cols] == [256, 256, 256, 217, 256, 256, 256, 256]
    assert all(off % 16 == 0 for off, _ in cols) and cols[-1][0] + 256 == 2016
    assert tcs.sdf_stash_width(SDFNetConfig()) == 2016
    jobs, n_scratch, n_dw = tcm.dw_jobs([(64, 48, 256), (64, 256, 224), (32, 256, 256)])
    assert (jobs[:, :2] % 16 == 0).all() and (jobs[:, 5] % 16 == 0).all()
    assert n_scratch == 64 * (48 + 256) + 64 * (256 + 224) + 32 * 512 and n_dw == 48 * 256 + 256 * 224 + 256 * 256
    with pytest.raises(ValueError):
        tcm.dw_jobs([(24, 16, 16)])
    assert tcm.dw_split(16) == 1 and tcm.dw_split(65536) == tcm.MAX_SPLIT
    w = [torch.zeros(361, 256), torch.zeros(256), torch.zeros(256, 256), torch.zeros(256), torch.zeros(256, 3),
         torch.zeros(3)]
    pk = tcm.pack_mlp(w, 2)
    assert list(pk["meta"][:4]) == [3, 361, 3, 512]
    assert tcs.mlp_stash_columns(pk) == [(0, 256), (256, 256)]


def test_stash_all_layout():
    """D's stash_all layout: the h_i, then every u_i at the same offsets
    plus GT, then g_enc at 2 GT, 16-padded (csrc/sdf_mlp.cuh::stash_row),
    and its launcher names: 535 MB at 65,536 points at full width."""
    from nrhints_torch.fields.sdf import SDFNetConfig

    cfg = SDFNetConfig()
    hs, cols = tcs.sdf_stash_columns(cfg), tcs.sdf_stash_columns(cfg, stash_us=True)
    assert cols[:8] == hs and cols[8:16] == [(off + 2016, w) for off, w in hs] and cols[16] == (4032, 39)
    assert tcs.sdf_stash_width(cfg, stash_us=True) == 4080 and 65536 * 4080 * 2 == 534_773_760
    small = tcs.sdf_stash_columns(SDFNetConfig(n_layers=4, d_hidden=32, skip_in=(2,), multi_res=4), stash_us=True)
    assert small[-1] == (2 * (32 + 16 + 32 + 32), 27) and all(off % 16 == 0 for off, _ in small)
    src = (cuda_lib.CSRC / "sdf_mlp.cuh").read_text()
    assert "return us ? 2 * m.gates_total + (m.d0 + 15) / 16 * 16 : m.gates_total;" in src
    assert {"sdf_stash_all_fwd", "sdf_stash_all_bwd"} <= set(cuda_lib.launch_counts)
    assert "sdf_stash_all_fwd" in cuda_lib._SIGNATURES["sdf_core"]
    assert "sdf_stash_all_bwd" in cuda_lib._SIGNATURES["sdf_stash"]


@pytest.mark.parametrize("n, nblk", [(1, 1), (63, 1), (64, 1), (65, 2), (4161, 66), (65536, 1024)])
def test_sdf_bwd_chain_layout(n, nblk):
    """The SDF backward chain's padding on 64-point blocks: padded points,
    per-block column-sum rows, and the f32 scratch of u_i (2,016 gate
    columns at full width) and four 64-wide encoding cotangents per padded
    point."""
    got_blk, npad, n_chain = tcm.chain_layout(n, 2016)
    assert (got_blk, npad) == (nblk, nblk * 64) and npad >= n > npad - 64
    assert n_chain == npad * (2016 + 4 * 64)
    assert tcm.dw_split(npad) == min(16, max(1, npad // 1024))


@pytest.mark.parametrize("n, nblk", [(1, 1), (63, 1), (64, 1), (65, 2), (65536, 1024), (65537, 1025)])
def test_sdf_fwd_gate_layout(n, nblk):
    """The SDF core's forward on 64-point blocks: padded points and the f32
    gate scratch of 2,016 columns per padded point (528 MB at 65,536)."""
    got_blk, npad, n_gates = tcm.gate_layout(n, 2016)
    assert (got_blk, npad) == (nblk, nblk * 64) and npad >= n > npad - 64
    assert n_gates == npad * 2016


@pytest.mark.parametrize("n, nblk", [(1, 1), (63, 1), (64, 1), (65, 2), (4161, 66), (65536, 1024), (65537, 1025)])
def test_trunk_layout(n, nblk):
    """The trunk kernels F, G, I, J on 64-point blocks: padded points, one
    row of bias sums per 16 padded points, J's transient bf16 z stash in
    F's layout (1,024 columns at full width, 134 MB at 65,536 points), and
    the dW row chunks: at one train step's 65,536 points the same as on
    16-point blocks, so the dW sums run in the same order."""
    got_blk, npad, rows, n_zs = tcm.trunk_layout(n, 1024)
    assert (got_blk, npad) == (nblk, nblk * 64) and npad >= n > npad - 64
    assert rows == 4 * nblk and rows * tcm.SUM_ROWS == npad
    assert n_zs == n * 1024
    assert tcm.dw_split(npad) == min(16, max(1, npad // 1024))
    if n == 65536:
        assert n_zs * 2 == 134_217_728 and tcm.dw_split(npad) == tcm.dw_split(-(-n // 16) * 16)


def test_chain_constants_match_the_headers():
    """CHAIN_TP, ENC_MAX, IN_MAX and SUM_ROWS in Python are the constants the
    CUDA kernels are compiled with; the SDF forward and the trunk kernels
    launch kChainTP-point blocks of kChainThreads threads, and no 16-point
    code (kTP, kThreads, gemm_rows16) is left in any source."""
    def const(header, name):
        m = re.search(rf"constexpr int {name} = (\d+);", (cuda_lib.CSRC / header).read_text())
        return int(m.group(1))

    assert const("staged_mma.cuh", "kChainTP") == tcm.CHAIN_TP == 64
    assert const("sdf_mlp.cuh", "kEncMax") == tcm.ENC_MAX
    assert const("mlp_stash.cu", "kInMax") == tcm.IN_MAX
    assert const("mlp_stash.cu", "kSumRows") == tcm.SUM_ROWS
    fwd = (cuda_lib.CSRC / "sdf_fwd.cuh").read_text()
    assert "<<<(n + kChainTP - 1) / kChainTP, kChainThreads, kFwdSmem" in fwd
    trunk = (cuda_lib.CSRC / "mlp_stash.cu").read_text()
    assert "<<<nblocks(n), kChainThreads, kMlpFwdSmem" in trunk
    assert "<<<nblk, kChainThreads, kMlpChainSmem" in trunk
    assert "return (n + kChainTP - 1) / kChainTP;" in trunk
    assert trunk.count("gemm_rows64<") == 3 and "wmma::" not in trunk  # every product through gemm_rows64
    for path in sorted(cuda_lib.CSRC.iterdir()):
        assert not re.search(r"\bkTP\b|\bkThreads\b|\bkWarps\b|gemm_rows16", path.read_text()), path.name
    assert not hasattr(tcm, "TP")


# The march template's instances by kernel: (source, SWEEP, ROUNDS, FINAL,
# C entry point).  Every instance that runs the rounds is launched under
# both merges, and each has an f32 instance (<entry point>_f32).
MARCH_INSTANCES = {
    "C": ("march.cu", "false", "false", "true", "shadow_final"),
    "K": ("march_fused.cu", "true", "false", "false", "march_sweep"),
    "L": ("march_fused.cu", "false", "true", "false", "march_rounds"),
    "M": ("march_fused.cu", "true", "true", "false", "importance_march"),
    "N": ("march_fused.cu", "true", "true", "true", "shadow_march"),
}


@pytest.mark.parametrize("kernel", sorted(MARCH_INSTANCES))
def test_march_kernels_run_the_row_engine(kernel):
    """Every march instance, C, K, L, M and N, runs the row engine: 4 rays on
    blocks of kRowsThreads = kChainThreads threads, every sweep through
    mma_rows.cuh::sdf_rows (ldmatrix + mma.sync on staged slabs), or in its
    f32 instance sdf_rows_f32 (fmaf on staged f32 slabs); no 2-ray path
    (sdf_tile, TileSmem, MTHREADS, the WIDE template flag) is left in
    csrc/."""
    def const(header, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", (cuda_lib.CSRC / header).read_text()).group(1))

    assert const("mma_rows.cuh", "kRowsThreads") == const("staged_mma.cuh", "kChainThreads") == 4 * tm.N_BUF
    rows = (cuda_lib.CSRC / "mma_rows.cuh").read_text()
    assert "wmma::" not in rows and "mma.sync.aligned.m16n8k16" in rows and "ldmatrix.sync.aligned" in rows
    f32 = rows[rows.index("void rows_product_f32("):rows.index("void rows_epilogue_f32(")]
    assert "fmaf(av, w.x, acc[i][0])" in f32 and "mma" not in f32
    common = (cuda_lib.CSRC / "march_common.cuh").read_text()
    assert "wmma::" not in common and "Engine::template values<64>(S.t," in common
    assert "sdf_rows<false, ROWS / 64>(S," in common and "sdf_rows_f32<true>(S, dir," in common
    assert "kernel<<<(b + kMarchRays - 1) / kMarchRays, kRowsThreads, smem," in common
    for path in sorted(cuda_lib.CSRC.iterdir()):
        assert not re.search(r"\bsdf_tile\b|\bTileSmem\b|\bMTHREADS\b|\bMWARPS\b|\bWIDE\b|march_rpb",
                             path.read_text()), path.name
    src, sweep, rounds, final, fn = MARCH_INSTANCES[kernel]
    text = (cuda_lib.CSRC / src).read_text()
    launches = re.findall(rf"launch_march<(?:F32|false|true), {sweep}, {rounds}, {final}, (true|false)>", text)
    assert sorted(set(launches)) == (["false", "true"] if rounds == "true" else ["false"])
    assert f'extern "C" int {fn}(' in text and f'extern "C" int {fn}_f32(' in text
    assert fn in cuda_lib.launch_counts and f"{fn}_f32" in cuda_lib.launch_counts


def test_round_machinery_runs_one_warp_a_ray():
    """Kernel B runs one warp a ray, 4 rays on a 128-thread block, and joins
    its lanes by shuffles, ballots and __syncwarp: no __syncthreads in
    round_machinery_kernel or in the machinery it runs (march_common.cuh's
    ray_step and the routines it calls); the march template runs the same
    ray_step, so L is B's steps between K's sweeps by construction."""
    src = (cuda_lib.CSRC / "march.cu").read_text()
    body = src[src.index("round_machinery_kernel(const float*"):src.index('extern "C" int round_machinery(')]
    assert "__syncthreads" not in body and "ray_step<RANK>(" in body
    assert "kernel<<<(b + kMachRays - 1) / kMachRays, kMachRays * 32, 0," in src
    common = (cuda_lib.CSRC / "march_common.cuh").read_text()
    machinery = common[common.index("// Machinery: one warp a ray"):common.index("// log(1 - alpha + 1e-7)")]
    assert "__syncthreads" not in machinery and "__syncwarp();" in machinery
    template = common[common.index("struct MarchSmem"):]
    assert template.count("ray_step<RANK>(") == 1 and "draw_new_z" not in template


# ---------------------------------------------------------------------------
# Kernels H (the SDF core's recompute backward), I and J (the trunk's
# forward and recompute backward)
#
# Tolerances, each as max |port - JAX| <= tol * max |JAX| per output: at
# float32 1e-4 (the same function; JAX's jax.vjp and the port's autograd or
# hand backward sum in other orders); at the shipping bf16 dot operands the
# stash tests' 2e-2 (both sides round the dot operands, and autodiff also
# rounds each dot's cotangent result to bf16, but at other places: JAX per
# 32-point block, the port over the whole batch).  N = 77 and 61 are not
# multiples of the Pallas blocks (32), so the padded rows are covered.

RECOMPUTE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_sdf_core_bwd_plain_matches_pallas(stash_case, dt):
    """Kernel H's plain version against ``_sdf_core_bwd_pallas`` (interpret
    mode), at random cotangents of (sdf, feat, grad)."""
    jc, tc, x, cots, jw, tw = stash_case
    j_dws, j_dx = jcm._sdf_core_bwd_pallas((jc, 32, 32, True, dt), jw, jnp.asarray(x),
                                          tuple(jnp.asarray(c) for c in cots))
    dws, dx = tcm.sdf_core_bwd_plain(tw, torch.tensor(x), tuple(torch.tensor(c) for c in cots), tc, dt)
    tol = RECOMPUTE_TOL[dt]
    _close_scaled(_np(dx), j_dx, tol, "dx")
    assert len(dws) == len(j_dws)
    for k, (a, b) in enumerate(zip(dws, j_dws)):
        assert tuple(a.shape) == tuple(np.shape(b)[-a.dim():]), k
        _close_scaled(_np(a), b, tol, f"dw[{k}]")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_recompute_sdf_op_matches_jax_vjp(sdf, stash_case, dt):
    """``fused_sdf_value_feat_grad(backward="recompute")`` through autograd
    (``SdfCoreFn``, weight norm outside) against ``jax.vjp`` of the JAX op
    in interpret mode: the outputs, and the cotangents of every weight-norm
    leaf and of x."""
    from nrhints_torch.utils import tree_items

    jc, jp, tc, tp = sdf
    _, _, x, cots, _, _ = stash_case
    kw = dict(block_pts=32, block_pts_bwd=32, interpret=True, compute_dtype=dt, backward="recompute")
    j_out, vjp = jax.vjp(lambda p, xx: jcm.fused_sdf_value_feat_grad(p, jc, xx, **kw),
                         jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    j_dp, j_dx = vjp(tuple(jnp.asarray(c) for c in cots))
    leaves = {n: t.detach().clone().requires_grad_(True) for n, t in tree_items(tp)}
    params = {}
    for n, t in leaves.items():
        layer, key = n.strip("/").split("/")
        params.setdefault(layer, {})[key] = t
    xt = torch.tensor(x, requires_grad=True)
    out = tcm.fused_sdf_value_feat_grad(params, tc, xt, compute_dtype=dt, backward="recompute")
    assert out[0].grad_fn is not None and type(out[0].grad_fn).__name__.startswith("SdfCoreFn")
    grads = torch.autograd.grad(out, [xt, *leaves.values()], tuple(torch.tensor(c) for c in cots))
    tol = RECOMPUTE_TOL[dt]
    for a, b in zip(out, j_out):
        _close_scaled(_np(a), b, 1e-5 if dt == "float32" else 2e-3)
    _close_scaled(_np(grads[0]), j_dx, tol, "dx")
    j_named = dict(tree_items(j_dp))
    assert sorted(j_named) == sorted(leaves)
    for (name, _), g in zip(leaves.items(), grads[1:]):
        _close_scaled(_np(g), j_named[name], tol, name)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_mlp_plain_matches_pallas(trunk_case, dt):
    """Kernels I and J's plain versions against ``_mlp_fwd_pallas`` and
    ``_mlp_bwd_pallas`` (interpret mode) and against ``mlp_relu_ref``."""
    n_layers, jw, tw, x, g = trunk_case
    tol = RECOMPUTE_TOL[dt]
    opts = (n_layers, 32, 32, True, dt)
    out = tcm.mlp_relu_plain(tw, torch.tensor(x), n_layers, dt)
    for ref in (jcm._mlp_fwd_pallas(opts, jw, jnp.asarray(x)), jcm.mlp_relu_ref(jw, jnp.asarray(x), n_layers, dt)):
        _close_scaled(_np(out), ref, 1e-5 if dt == "float32" else 2e-3)
    j_dws, j_dx = jcm._mlp_bwd_pallas(opts, jw, jnp.asarray(x), jnp.asarray(g))
    dws, dx = tcm.mlp_relu_bwd_plain(tw, torch.tensor(x), torch.tensor(g), n_layers, dt)
    _close_scaled(_np(dx), j_dx, tol, "dx")
    assert len(dws) == len(j_dws)
    for k, (a, b) in enumerate(zip(dws, j_dws)):
        _close_scaled(_np(a), b, tol, f"dw[{k}]")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_recompute_mlp_op_matches_jax_vjp(trunk_case, dt):
    """``fused_mlp_apply(backward="recompute")`` (``MlpFn``) against
    ``jax.vjp`` of the JAX ``fused_mlp_apply`` in interpret mode, at the
    weight-norm leaves and x.  The port's op is always bf16; the f32 case
    runs ``MlpFn`` at f32 on the materialized weights."""
    from nrhints_torch.utils import tree_items

    n_layers, _, _, x, g = trunk_case
    jp, tp = _trunk_params()
    leaves = {n: t.detach().clone().requires_grad_(True) for n, t in tree_items(tp)}
    params = {}
    for n, t in leaves.items():
        layer, key = n.strip("/").split("/")
        params.setdefault(layer, {})[key] = t
    xt = torch.tensor(x, requires_grad=True)
    if dt == "bfloat16":
        out = tcm.fused_mlp_apply(params, n_layers, xt, backward="recompute")
    else:
        out = tcm.MlpFn.apply(n_layers, dt, xt, *tcm.materialize_mlp_weights(params, n_layers))
    assert type(out.grad_fn).__name__.startswith("MlpFn")
    grads = torch.autograd.grad(out, [xt, *leaves.values()], torch.tensor(g))
    kw = dict(block_pts=32, block_pts_bwd=32, interpret=True, compute_dtype=dt, backward="recompute")
    j_out, vjp = jax.vjp(lambda p, xx: jcm.fused_mlp_apply(p, n_layers, xx, **kw),
                         jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    j_dp, j_dx = vjp(jnp.asarray(g))
    tol = RECOMPUTE_TOL[dt]
    _close_scaled(_np(out), j_out, 1e-5 if dt == "float32" else 2e-3, "out")
    _close_scaled(_np(grads[0]), j_dx, tol, "dx")
    j_named = dict(tree_items(j_dp))
    for (name, _), gr in zip(leaves.items(), grads[1:]):
        _close_scaled(_np(gr), j_named[name], tol, name)


def test_sdf_core_fn_matches_double_backward(stash_case):
    """``SdfCoreFn`` (the recompute op, f32) against ``torch.autograd.grad(
    create_graph=True)`` of ``sdf_core_plain``'s sdf, differentiated again:
    1e-4 of each leaf's scale."""
    jc, tc, x, cots, _, tw = stash_case
    coef = [torch.tensor(c) for c in cots]
    ws = [w.detach().clone().requires_grad_(True) for w in tw]
    xt = torch.tensor(x, requires_grad=True)
    s, f, gx = tcm.SdfCoreFn.apply(tc, "float32", xt, *ws)
    g_port = torch.autograd.grad(_stash_loss(s, f, gx, coef), [xt, *ws])

    ws2 = [w.detach().clone().requires_grad_(True) for w in tw]
    xt2 = torch.tensor(x, requires_grad=True)
    s2, f2, _ = tcm.sdf_core_plain(ws2, xt2, tc, "float32")
    gx2 = torch.autograd.grad(s2.sum(), xt2, create_graph=True)[0]
    g_ref = torch.autograd.grad(_stash_loss(s2, f2, gx2, coef), [xt2, *ws2])
    _close_scaled(_np(gx), _np(gx2), 1e-4, "grad")
    for k, (a, b) in enumerate(zip(g_port, g_ref)):
        _close_scaled(_np(a), _np(b), 1e-4, f"leaf {k}")


def test_mlp_fn_matches_autograd(trunk_case):
    """``MlpFn`` (the recompute op, f32) against autograd of
    ``mlp_relu_plain``: 1e-5 of each leaf's scale."""
    n_layers, _, tw, x, g = trunk_case
    ws = [w.detach().clone().requires_grad_(True) for w in tw]
    xt = torch.tensor(x, requires_grad=True)
    out = tcm.MlpFn.apply(n_layers, "float32", xt, *ws)
    g_port = torch.autograd.grad(torch.sum(out * torch.tensor(g)), [xt, *ws])
    ws2 = [w.detach().clone().requires_grad_(True) for w in tw]
    xt2 = torch.tensor(x, requires_grad=True)
    g_ref = torch.autograd.grad(torch.sum(tcm.mlp_relu_plain(ws2, xt2, n_layers) * torch.tensor(g)), [xt2, *ws2])
    for k, (a, b) in enumerate(zip(g_port, g_ref)):
        _close_scaled(_np(a), _np(b), 1e-5, f"leaf {k}")


@pytest.mark.parametrize("backward", ["stash", "recompute", "stash_xla", "stash_all"])
def test_undifferentiated_trunk_runs_forward_only(monkeypatch, backward):
    """Under ``torch.no_grad()`` the trunk takes its plain forward (kernel
    I on the card) for every schedule and never an autograd op (so never
    kernel F), as JAX's stash op dispatches its non-stash forward for the
    undifferentiated primal."""
    _, tp = _trunk_params()
    from nrhints_torch.utils import tree_leaves

    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)

    def refuse(*args, **kwargs):
        raise AssertionError("an autograd op ran without a gradient")

    monkeypatch.setattr(tcs.MlpStashFn, "apply", refuse)
    monkeypatch.setattr(tcm.MlpFn, "apply", refuse)
    x = torch.tensor(np.random.default_rng(2).normal(size=(9, 45)).astype(np.float32))
    with torch.no_grad():
        out = tcm.fused_mlp_apply(tp, 2, x, backward=backward)
    assert torch.equal(out, tcm.mlp_relu_plain(tcm.materialize_mlp_weights(tp, 2), x, 2, "bfloat16"))
