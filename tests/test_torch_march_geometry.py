"""The fused marches at geometries other than 64 + 4 x 16, on the CPU: JAX's
``fused_importance_z`` and ``fused_shadow_tau`` with their Pallas kernels in
interpret mode against the port's same calls on every route (the plain
versions of kernels B, K, L, M and N; the CUDA instances run on the card:
``chip_smoke.py --march-geometry``), at the tiny SDF of
tests/torch_port_utils.py, f32 march weights, and the range check that the
card's wrappers run before any launch.

The geometries (rounds x n_new, n0 = 128 - rounds * n_new): 2 x 32, 8 x 8,
3 x 16 (n0 = 80, a partial last sweep pass), 5 x 12 (n0 = 68, bitonic
only: JAX's rank merge needs a power-of-two n_new) and 1 x 64 (n_new > 32,
so a lane draws two samples).  Each JAX call runs once per module (one
``jax.jit`` a geometry and entry point, the bitonic monolith); every port
route under both merges is held to it (the merges give the same z row).
Tolerances are tests/test_torch_kernels.py's: the refined z sorted, 90% of
its slots within 1e-4 and every slot within one stratified interval, 2 /
(n0 - 1) here (the u = 1 draw moves a ray's low-weight tail); tau within
the shadow map's 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrhints_torch.kernels import cuda_lib, march as tm
from nrhints_tpu.kernels import march as jm
from tests.torch_port_utils import N_RAYS, camera_rays, jax_sdf_params

GEOMETRIES = [(2, 32), (8, 8), (3, 16), (5, 12), (1, 64)]
CASES = [(g, merge) for g in GEOMETRIES for merge in ("bitonic", "rank") if merge == "bitonic" or g != (5, 12)]
# fused_importance_z's routes: the monolith (M), the split march (K, L),
# and the "xla" halves (plain sweeps; kernel B's steps between plain sweeps).
Z_ROUTES = {
    "monolith": {},
    "split": dict(split=True),
    "xla_sweep": dict(split=True, sweep_impl="xla"),
    "xla_rounds": dict(split=True, rounds_impl="xla"),
    "shipping": dict(split=True, sweep_impl="xla", rounds_impl="xla"),
}
# fused_shadow_tau's: the monolith (N), and with split the refinement by
# either impl of each half and the final sweep by kernel C or plainly; the
# refinements that mix the impls are slow (tier-1 keeps M, and B between
# plain sweeps, each before C and before the plain final sweep).
TAU_ROUTES = {"monolith": {}, **{
    f"split_{s}_{r}_{f}": dict(split=True, sweep_impl=s, rounds_impl=r, final_impl=f)
    for s in ("pallas", "xla") for r in ("pallas", "xla") for f in ("pallas", "xla")}}
TAU_CASES = [pytest.param(r, marks=pytest.mark.slow) if r.startswith(("split_pallas_xla", "split_xla_pallas")) else r
             for r in sorted(TAU_ROUTES)]
SDIST, INV_S, ANNEAL = 2.0 / 64, 64.0, 0.7


def _z0(near, far, n0: int) -> np.ndarray:
    return (near + (far - near) * np.linspace(0.0, 1.0, n0, dtype=np.float32)[None, :]).astype(np.float32)


@pytest.fixture(scope="module")
def geo():
    """(port config, port params, (o, d, near, far), JAX references):
    references[(rounds, n_new)] = (refined z, tau) as numpy."""
    jc, jp, tc, tp = jax_sdf_params()
    o, d, _, near, far = camera_rays(0)
    p = jax.tree_util.tree_map(jnp.asarray, jp)
    refs = {}
    for rounds, n_new in GEOMETRIES:
        z0 = jnp.asarray(_z0(near, far, 128 - rounds * n_new))
        z = jax.jit(lambda p_, o_, d_, z_, r=rounds, n=n_new: jm.fused_importance_z(
            p_, jc, o_, d_, z_, rounds=r, n_new=n, interpret=True))(p, jnp.asarray(o), jnp.asarray(d), z0)
        tau = jax.jit(lambda p_, o_, d_, z_, r=rounds, n=n_new: jm.fused_shadow_tau(
            p_, jc, o_, d_, z_, jnp.full((N_RAYS, 1), SDIST), jnp.asarray(INV_S), jnp.asarray(ANNEAL), rounds=r,
            n_new=n, interpret=True))(p, jnp.asarray(o), jnp.asarray(d), z0)
        refs[rounds, n_new] = (np.asarray(z), np.asarray(tau))
    return tc, tp, (o, d, near, far), refs


def _inputs(geo, rounds, n_new):
    _, _, (o, d, near, far), _ = geo
    return torch.tensor(o), torch.tensor(d), torch.tensor(_z0(near, far, 128 - rounds * n_new))


@pytest.mark.parametrize("route", sorted(Z_ROUTES))
@pytest.mark.parametrize("geometry,merge", CASES)
def test_importance_z_matches_jax(geo, geometry, merge, route):
    tc, tp, _, refs = geo
    rounds, n_new = geometry
    o, d, z0 = _inputs(geo, rounds, n_new)
    out = tm.fused_importance_z(tp, tc, o, d, z0, rounds=rounds, n_new=n_new, merge=merge,
                                **Z_ROUTES[route]).numpy()
    ref = refs[geometry][0]
    assert out.shape == (N_RAYS, 128)
    assert np.all(np.diff(out, axis=-1) >= 0)
    assert np.isin(z0.numpy(), out).all()  # every stratified sample kept
    err = np.abs(out - ref)
    assert np.mean(err <= 1e-4) >= 0.9, np.mean(err <= 1e-4)
    assert err.max() <= 2.0 / (z0.shape[1] - 1) + 1e-5


@pytest.mark.parametrize("route", TAU_CASES)
@pytest.mark.parametrize("geometry,merge", CASES)
def test_shadow_tau_matches_jax(geo, geometry, merge, route):
    tc, tp, _, refs = geo
    rounds, n_new = geometry
    o, d, z0 = _inputs(geo, rounds, n_new)
    out = tm.fused_shadow_tau(tp, tc, o, d, z0, torch.full((N_RAYS, 1), SDIST), INV_S, ANNEAL, rounds=rounds,
                              n_new=n_new, merge=merge, **TAU_ROUTES[route]).numpy()
    np.testing.assert_allclose(out, refs[geometry][1], atol=1e-3)
    assert refs[geometry][1].min() < 0.9  # some shadow rays cross the surface


@pytest.mark.parametrize("rounds,n_new,merge", [
    (127, 1, "bitonic"), (10, 1, "rank"),  # n_new = 1: JAX's u = 1 - k / 0 is NaN
    (1, 127, "bitonic"), (2, 64, "rank"), (3, 50, "bitonic"),  # n0 < 2: no valid interval (NaN), or none at all
    (0, 16, "bitonic"), (-1, 16, "bitonic"),  # no round: JAX drops the stratified samples
    (5, 12, "rank"), (1, 126, "rank"),  # rank needs a power-of-two n_new
])
def test_geometry_range_raises(rounds, n_new, merge):
    with pytest.raises(NotImplementedError, match="rounds >= 1, n_new >= 2"):
        tm.check_geometry(rounds, n_new, merge)


def test_gate_geometries_in_range():
    for rounds, n_new in GEOMETRIES + [(4, 16), (1, 126), (63, 2)]:
        assert tm.check_geometry(rounds, n_new) == 128 - rounds * n_new
        if n_new & (n_new - 1) == 0:
            assert tm.check_geometry(rounds, n_new, "rank") == 128 - rounds * n_new


def test_card_wrappers_check_the_range_before_any_launch(geo):
    """The card's wrappers (any tensor off the CPU: here the meta device)
    raise NotImplementedError for a geometry out of the range before they
    touch a kernel, and pass a geometry in it on to the next check (the
    CUDA tensor check, ValueError on the meta device).  Nothing launches."""
    tc, tp, _, _ = geo
    w = tm.march_weights(tp, tc, "bfloat16")
    cuda_lib.reset_launch_counts()

    def t(*shape):
        return torch.zeros(shape, device="meta")

    b = N_RAYS
    for (rounds, n_new), exc in (((10, 1), NotImplementedError), ((0, 16), NotImplementedError),
                                 ((8, 8), ValueError), ((1, 126), ValueError)):
        n0 = 128 - rounds * n_new
        z0 = t(b, n0)
        z, s, o, d = t(b, 128), t(b, 128), t(b, 3), t(b, 3)
        with pytest.raises(exc):
            tm.fused_importance_z(tp, tc, o, d, z0, rounds=rounds, n_new=n_new)
        with pytest.raises(exc):
            tm.fused_shadow_tau(tp, tc, o, d, z0, t(b, 1), INV_S, ANNEAL, rounds=rounds, n_new=n_new, split=True)
        with pytest.raises(exc):
            tm.march_rounds(z0, z0, o, d, w, tc, rounds=rounds, n_new=n_new)
        with pytest.raises(exc):
            tm.importance_march(z0, o, d, w, tc, rounds=rounds, n_new=n_new)
        with pytest.raises(exc):
            tm.shadow_march(z0, o, d, t(b, 1), INV_S, ANNEAL, w, tc, rounds=rounds, n_new=n_new)
        with pytest.raises(ValueError if 2 <= n_new <= 126 else NotImplementedError):  # B draws n_new alone
            tm.round_machinery(z, s, o, d, None, None, None, n0, INV_S, n_new)
        if not 2 <= n0 <= 126:
            with pytest.raises(NotImplementedError, match="kernel K"):
                tm.march_sweep(z0, o, d, w, tc)
    with pytest.raises(NotImplementedError):  # rank at a geometry in range but for the merge
        tm.march_rounds(t(b, 68), t(b, 68), t(b, 3), t(b, 3), w, tc, rounds=5, n_new=12, merge="rank")
    assert all(v == 0 for v in cuda_lib.launch_counts.values())


def test_run_time_geometry_instances_are_counted():
    """Every K-N instance and kernel B have a run-time geometry instance
    (``*_geom``), a C entry point of csrc/march_geom.cu (f32 weights:
    march_geom_f32.cu; the huge class: march_fused_huge.cu, beside its
    64 + 4 x 16 instances; B: march.cu) with a launch counter of the same
    name; 64 + 4 x 16 keeps the compile-time ones."""
    assert tm.FIXED_GEOMETRY == (4, 16)
    for lib, suffixes in (("march_geom", ("", "_wide")), ("march_geom_f32", ("_f32", "_f32_wide")),
                          ("march_fused_huge", ("_huge",))):
        assert lib in cuda_lib.SOURCES
        assert all(("_f32" in k) == (lib == "march_geom_f32") for k in cuda_lib._SIGNATURES[lib])
        src = (cuda_lib.CSRC / f"{lib}.cu").read_text()
        assert [s for s in suffixes if f"NRH_GEOM_ENTRIES({s}," in src] == list(suffixes)
    huge_geom = {k: v for k, v in cuda_lib._SIGNATURES["march_fused_huge"].items() if k.endswith("_geom")}
    geom = {**cuda_lib._SIGNATURES["march_geom"], **cuda_lib._SIGNATURES["march_geom_f32"], **huge_geom}
    assert sorted(geom) == sorted(k for k in cuda_lib.MARCH_GEOM_INSTANCES if k != "round_machinery_geom")
    assert "round_machinery_geom" in cuda_lib._SIGNATURES["march"]
    for k in cuda_lib.MARCH_GEOM_INSTANCES:
        assert k in cuda_lib.launch_counts
