"""The SDF core above the presets' widths in the port, on the CPU: JAX's
``fused_sdf_value_feat_grad`` with its Pallas kernels in interpret mode
against the port's at padded widths above 256 and encodings above 64 (the
CUDA wide instances' class), and above 512 and 128 (the huge instances'
class: a 528-wide SDF, and a 160-wide one with a 144-wide padded encoding),
under the "recompute", "stash" and "stash_all" schedules; and what the wide
and huge instances read: the pack at 288, 512 and 528, the width-class
choice and its limits, the gate, chain and row layouts, and the renderer's
check before any launch.  (The CUDA instances against their plain versions
run on the card: tests/test_torch_gpu.py.)

Each JAX call runs once per module (a module-scoped fixture, one jitted
``jax.vjp`` a case), at exact f32 dot operands, on 41 points (two of JAX's
32-point blocks, the second ragged).  Tolerances: the outputs those of
tests/test_torch_kernels.py::test_sdf_core_plain_matches_pallas at f32
(rtol and atol 1e-5); the gradients as tests/test_torch_core_f32.py holds
them, each of its own scale: 1e-4 under "recompute" (exact f32 on both sides,
summed in other orders), 2e-2 under the stash schedules, whose bf16 stash
can round an f32 value within an ulp of a bf16 boundary the other way on
either side.  The comparison runs at f32 dot operands, and once more at the
shipping bf16 operands at 288 wide under "recompute"
(test_wide_bf16_entry_point_matches_jax).  There the two packages'
weight-norm materializations (g v / |v|, the norm summed in other orders)
differ by 1-6 f32 ulps, and three of the 140,000 weights lie within an ulp
of a bf16 rounding midpoint, so their bf16 operands differ by one bf16 ulp:
the feature head's w[109, 102] moves feat[:, 102] by up to 2.16e-4 (at
point 38, whose activation h[109] is largest), and w2[55, 110] moves layer
2's output; no activation operand rounds differently.  That case holds each
output to 1e-4 in at least 98% of its entries (measured: sdf 100%, feat
99.9%, grad 98.4%) and every entry to BF16_MAX_ERR, and the gradients to
the stash schedules' 2e-2 of scale (measured: dx 8.5e-4, worst leaf
/lin2/v 5.9e-3).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrhints_torch.convert import params_from_jax
from nrhints_torch.fields.sdf import SDFNetConfig
from nrhints_torch.kernels import core_mlp as tcm, cuda_lib
from nrhints_torch.utils import tree_items
from nrhints_tpu.fields.sdf import SDFNetConfig as JSDFNetConfig, sdf_init
from nrhints_tpu.kernels import core_mlp as jcm

N_PTS = 41
# Wide by every width (3 layers, a skip at 2, d0 = 69, a 272-wide feature
# head), and wide by its encoding alone (d0 = 69 above 64, layers 96 wide);
# huge by every width (528 wide, a 528-wide feature head), and huge by its
# encoding alone (multi_res 21: d0 = 129, padded 144; layers 160 wide, the
# narrowest even width whose skip layer takes that encoding: layer 1 keeps
# 160 - 129 = 31 units).
# Each case's seed is its place in this order.
CONFIGS = {
    "enc69": dict(n_layers=3, d_hidden=96, skip_in=(2,), multi_res=11, d_out_feat=32),
    "w288": dict(n_layers=3, d_hidden=288, skip_in=(2,), multi_res=11, d_out_feat=272),
    "enc144": dict(n_layers=3, d_hidden=160, skip_in=(2,), multi_res=21, d_out_feat=32),
    "w528": dict(n_layers=3, d_hidden=528, skip_in=(2,), multi_res=6, d_out_feat=528),
}
BACKWARDS = ("recompute", "stash", "stash_all")
# The bf16 case's bound on any output entry: 2.3x the measured 2.16e-4, one
# bf16 ulp of a feature-head weight (|w| 2^-8, |w| about 0.11) times an
# activation of about 0.44 (see above).
BF16_MAX_ERR = 5e-4


def _close_scaled(port, ref, tol, what=""):
    ref = np.asarray(ref, dtype=np.float64)
    port = np.asarray(port.detach(), dtype=np.float64).reshape(ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(port - ref).max())
    assert err <= tol * scale, f"{what}: err {err:.3e} vs scale {scale:.3e}"


@pytest.fixture(scope="module")
def cases():
    """name -> (JAX config, JAX params as numpy, the port's config, port
    params, x, cotangents)."""
    out = {}
    for i, (name, kw) in enumerate(CONFIGS.items()):
        jc = JSDFNetConfig(**kw)
        jp = jax.device_get(jax.jit(sdf_init, static_argnums=1)(jax.random.PRNGKey(i), jc))
        rng = np.random.default_rng(10 + i)
        x = (rng.normal(size=(N_PTS, 3)) * 0.4).astype(np.float32)
        cots = (rng.normal(size=(N_PTS,)).astype(np.float32),
                rng.normal(size=(N_PTS, kw["d_out_feat"])).astype(np.float32),
                rng.normal(size=(N_PTS, 3)).astype(np.float32))
        out[name] = (jc, jp, SDFNetConfig(**kw), params_from_jax(jp, device="cpu"), x, cots)
    return out


@pytest.fixture(scope="module")
def jax_runs(cases):
    """(config, backward) -> (outputs, named parameter cotangents, x's
    cotangent) of JAX's fused_sdf_value_feat_grad in interpret mode."""
    out = {}
    runs = [(name, backward, "float32") for name in cases for backward in BACKWARDS]
    for name, backward, cdt in runs + [("w288", "recompute", "bfloat16")]:
        jc, jp, _, _, x, cots = cases[name]
        params = jax.tree_util.tree_map(jnp.asarray, jp)

        @jax.jit
        def run(p, xx, c, backward=backward, jc=jc, cdt=cdt):
            call = lambda p_, x_: jcm.fused_sdf_value_feat_grad(  # noqa: E731
                p_, jc, x_, block_pts=32, block_pts_bwd=32, interpret=True, compute_dtype=cdt,
                backward=backward)
            o, vjp = jax.vjp(call, p, xx)
            return o, vjp(c)

        o, (dp, dx) = run(params, jnp.asarray(x), tuple(jnp.asarray(c) for c in cots))
        key = (name, backward) if cdt == "float32" else (name, backward, cdt)
        out[key] = ([np.asarray(a) for a in o], {n: np.asarray(g) for n, g in tree_items(dp)}, np.asarray(dx))
    return out


def _port_run(case, backward, compute_dtype):
    """The port's fused_sdf_value_feat_grad on the CPU (the plain versions
    through ``SdfCoreFn`` or ``SdfStashFn``) -> (leaves, outputs, the
    cotangents of x and of every weight-norm leaf)."""
    _, _, tc, tp, x, cots = case
    leaves = {n: t.detach().clone().requires_grad_(True) for n, t in tree_items(tp)}
    params = {}
    for n, t in leaves.items():
        layer, key = n.strip("/").split("/")
        params.setdefault(layer, {})[key] = t
    xt = torch.tensor(x, requires_grad=True)
    out = tcm.fused_sdf_value_feat_grad(params, tc, xt, compute_dtype=compute_dtype, backward=backward)
    assert type(out[0].grad_fn).__name__.startswith("SdfCoreFn" if backward == "recompute" else "SdfStashFn")
    return leaves, out, torch.autograd.grad(out, [xt, *leaves.values()], tuple(torch.tensor(c) for c in cots))


@pytest.mark.parametrize("backward", BACKWARDS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_wide_entry_point_matches_jax(cases, jax_runs, name, backward):
    """The port's fused_sdf_value_feat_grad against JAX's same call in
    interpret mode at f32 dot operands: the three outputs and the
    cotangents of x and of every weight-norm leaf."""
    leaves, out, grads = _port_run(cases[name], backward, "float32")
    j_out, j_dp, j_dx = jax_runs[name, backward]
    for a, b in zip(out, j_out):
        np.testing.assert_allclose(a.detach().numpy(), b.reshape(a.shape), rtol=1e-5, atol=1e-5)
    grad_tol = 1e-4 if backward == "recompute" else 2e-2
    _close_scaled(grads[0], j_dx, grad_tol, "dx")
    assert sorted(j_dp) == sorted(leaves)
    for (n, _), g in zip(leaves.items(), grads[1:]):
        _close_scaled(g, j_dp[n], grad_tol, n)


def test_wide_bf16_entry_point_matches_jax(cases, jax_runs):
    """The same at the shipping bf16 dot operands, 288 wide, "recompute":
    each output within 1e-4 in at least 98% of its entries and within
    BF16_MAX_ERR everywhere, the gradients within 2e-2 of their scale (the
    bf16 weight flips of the module docstring)."""
    leaves, out, grads = _port_run(cases["w288"], "recompute", "bfloat16")
    j_out, j_dp, j_dx = jax_runs["w288", "recompute", "bfloat16"]
    for name, a, b in zip(("sdf", "feat", "grad"), out, j_out):
        err = np.abs(a.detach().numpy() - b.reshape(a.shape))
        assert np.mean(err <= 1e-4) >= 0.98 and err.max() <= BF16_MAX_ERR, (name, np.mean(err <= 1e-4), err.max())
    _close_scaled(grads[0], j_dx, 2e-2, "dx")
    assert sorted(j_dp) == sorted(leaves)
    for (n, _), g in zip(leaves.items(), grads[1:]):
        _close_scaled(g, j_dp[n], 2e-2, n)


def _blocks(pk):
    """(weight offset, kp, np, in, out) of every layer, then the feature
    head's, from the pack's meta."""
    meta = pk["meta"]
    out = [tuple(int(meta[10 + 7 * i + k]) for k in (5, 2, 3, 0, 1)) for i in range(int(meta[0]))]
    return out + [(int(meta[7]), int(meta[5]), int(meta[6]), int(meta[4]), int(meta[3]))]


@pytest.mark.parametrize("d_hidden", [288, 512])
def test_wide_pack_unpacks(d_hidden):
    """pack_sdf_mlp at padded widths 288 and 512: every block unpacks to its
    bf16 weight with zero padding, every bias to its bias, the meta's
    widths, offsets, skip flags and gates_total are the config's, and the
    pack's class is WIDE."""
    cfg = SDFNetConfig(d_hidden=d_hidden, multi_res=12, d_out_feat=d_hidden)
    gen = torch.Generator().manual_seed(d_hidden)
    from nrhints_torch.fields.sdf import _layer_dims, sdf_init as t_sdf_init

    w = tcm.materialize_sdf_weights_full(t_sdf_init(gen, cfg, "cpu"), cfg)
    pk = tcm.pack_sdf_mlp(w, cfg, with_feat=True)
    assert pk["cls"] is tcm.WIDE and pk["wpack"].dtype == torch.bfloat16
    io, dims = _layer_dims(cfg)
    meta = pk["meta"]
    L = cfg.n_layers
    assert list(meta[:5]) == [L, 12, 75, d_hidden, dims[-2]]
    assert int(meta[9]) == sum(-(-o // 16) * 16 for _, o in io)
    blocks = _blocks(pk)
    weights = [w[2 * i] for i in range(L)] + [w[2 * L + 2]]
    biases = [w[2 * i + 1] for i in range(L)] + [w[2 * L + 3]]
    b_offs = [int(meta[10 + 7 * i + 6]) for i in range(L)] + [int(meta[8])]
    off = 0
    for i, ((wo, kp, np_, din, dout), wt, b, bo) in enumerate(zip(blocks, weights, biases, b_offs)):
        assert wo == off and kp == -(-din // 16) * 16 and np_ == -(-dout // 16) * 16 and kp <= 512 and np_ <= 512
        if i < L:
            assert (din, dout) == io[i] and int(meta[10 + 7 * i + 4]) == int(i in cfg.skip_in)
        blk = pk["wpack"][wo : wo + kp * np_].view(kp, np_)
        assert torch.equal(blk[:din, :dout], wt.to(torch.bfloat16))
        assert not blk[din:].any() and not blk[:, dout:].any()
        assert torch.equal(pk["bpack"][bo : bo + dout], b.float())
        off += kp * np_
    assert pk["bpack"][-1] == w[2 * L + 1].reshape(())
    assert torch.equal(pk["w_sdf"], w[2 * L].reshape(-1).float())


@pytest.mark.parametrize("kw,cls", [
    ({}, "NARROW"), (dict(d_hidden=256, multi_res=10), "NARROW"), (dict(d_hidden=272), "WIDE"),
    (dict(multi_res=11), "WIDE"), (dict(d_out_feat=512, multi_res=12), "WIDE"), (dict(d_hidden=512), "WIDE"),
    (dict(d_hidden=512, multi_res=20, n_layers=16, skip_in=(8,)), "WIDE"),
])
def test_width_class_and_instance_names(kw, cls):
    """The presets' widths (padded widths up to 256, encodings up to 64)
    take the 64-point instances under today's counters; anything above
    them, up to 512 and 128, the wide instances (``*_wide``, the kWideClass
    bit), at every (compute, stash) dtype pair: A and H at each compute
    dtype, D, E and the variants at each pair, the dtype bits ORed with the
    class's; every instance has a counter."""
    from nrhints_torch.configs.config import nr_hints, nr_hints_cam_opt, pl_naive

    for preset in (nr_hints, nr_hints_cam_opt, pl_naive):
        assert tcm.core_class(preset().model.sdf_network) is tcm.NARROW
    cfg = SDFNetConfig(**kw)
    want = getattr(tcm, cls)
    assert tcm.core_class(cfg) is want
    pk = {"cls": want}
    for kernel in ("sdf_core_fwd", "sdf_core_bwd"):
        name, bits = tcm.core_instance(kernel, pk, "bfloat16")
        assert (name, bits) == (kernel + want.suffix, want.bit) and name in cuda_lib.launch_counts
    for kernel in ("sdf_stash_fwd", "sdf_stash_bwd", "sdf_stash_all_fwd", "sdf_stash_all_bwd"):
        name, bits = tcm.core_instance(kernel, pk, "bfloat16", "bfloat16")
        assert (name, bits) == (kernel + want.suffix, want.bit) and name in cuda_lib.launch_counts
    if want is tcm.NARROW:
        assert tcm.core_instance("sdf_stash_fwd", pk, "float32", "bfloat16") == ("sdf_stash_fwd_f32_bf16stash", 1)
    for kernel in ("sdf_core_fwd", "sdf_core_bwd"):
        name, bits = tcm.core_instance(kernel, pk, "float32")
        assert (name, bits) == (f"{kernel}_f32{want.suffix}", 1 | want.bit) and name in cuda_lib.launch_counts
    pairs = {("float32", "float32"): ("_f32", 3), ("float32", "bfloat16"): ("_f32_bf16stash", 1),
             ("bfloat16", "float32"): ("_f32stash", 2)}
    for kernel in ("sdf_stash_fwd", "sdf_stash_bwd", "sdf_stash_all_fwd", "sdf_stash_all_bwd"):
        for (compute, stash), (suffix, dbits) in pairs.items():
            name, bits = tcm.core_instance(kernel, pk, compute, stash)
            assert (name, bits) == (kernel + suffix + want.suffix, dbits | want.bit) and name in cuda_lib.launch_counts


@pytest.mark.parametrize("n, nblk", [(1, 1), (31, 1), (32, 1), (33, 2), (4161, 131), (65536, 2048)])
def test_wide_layouts(n, nblk):
    """The wide instances' gate scratch and chain scratch on 32-point
    blocks: padded points, the f32 gates (4,064 columns at d_hidden 512:
    1.07 GB at 65,536 points) and the chain's u_i and four 128-wide encoding
    cotangents a padded point; the dW row chunks over the padded rows."""
    blk, npad, n_gates = tcm.gate_layout(n, 4064, tcm.WIDE.pts)
    assert (blk, npad) == (nblk, nblk * 32) and npad >= n > npad - 32 and n_gates == npad * 4064
    blk2, npad2, n_chain = tcm.chain_layout(n, 4064, tcm.WIDE)
    assert (blk2, npad2) == (blk, npad) and n_chain == npad * (4064 + 4 * 128)
    assert tcm.dw_split(npad) == min(16, max(1, npad // 1024))
    if n == 65536:
        assert n_gates * 4 == 1_065_353_216
    assert tcm.chain_layout(n, 2016) == tcm.chain_layout(n, 2016, tcm.NARROW)


def test_wide_constants_match_the_headers():
    """WIDE's block, widths and bit are the constants the CUDA wide
    instances are compiled with, and the wide kernels launch 32-point
    blocks of kChainThreads threads."""
    def const(header, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", (cuda_lib.CSRC / header).read_text()).group(1))

    assert const("staged_mma.cuh", "kWidePts") == tcm.WIDE.pts == 32
    assert const("mma_rows.cuh", "kWideClass") == tcm.WIDE.bit == 4
    mlp = (cuda_lib.CSRC / "sdf_mlp.cuh").read_text()
    assert "constexpr int kWideWMax = 2 * kWMax;" in mlp and "constexpr int kWideEncMax = 2 * kEncMax;" in mlp
    assert 2 * const("sdf_mlp.cuh", "kWMax") == tcm.WIDE.width and 2 * const("sdf_mlp.cuh", "kEncMax") == tcm.WIDE.enc
    assert const("sdf_mlp.cuh", "kMaxLayers") == tcm.MAX_LAYERS
    fwd = (cuda_lib.CSRC / "sdf_fwd.cuh").read_text()
    bwd = (cuda_lib.CSRC / "sdf_bwd.cuh").read_text()
    assert "<<<(n + Cls::kPts - 1) / Cls::kPts, kChainThreads, kFwdSmem" in fwd
    assert "const int nblk = (n + Cls::kPts - 1) / Cls::kPts;" in bwd
    assert "fwd_smem<CoreWide, bf16>() == 226304" in fwd and "chain_smem<CoreWide, bf16>() == 226432" in bwd
    # The f32 instances: activations and carry [32][516] f32, the 128-wide
    # encoding, the f32 ring of two 16-row by 512-column stages (+ d sdf a
    # point in the chain), under a block's 232,448 bytes.
    ring_f32 = 2 * 16 * 512 * 4
    assert 32 * 516 * 4 * 2 + 32 * 128 * 4 + ring_f32 == 214016 and 214016 + 32 * 4 == 214144
    assert "fwd_smem<CoreWide, float>() == 214016" in fwd and "chain_smem<CoreWide, float>() == 214144" in bwd
    rows = (cuda_lib.CSRC / "mma_rows.cuh").read_text()
    assert "std::conditional<Cls::kPts == kChainTP, RowsNarrow, RowsWide>" in rows


@pytest.mark.parametrize("kw,what", [
    (dict(d_hidden=528), "padded widths up to 512"),
    (dict(d_out_feat=520), "padded widths up to 512"),
    (dict(multi_res=21), "encodings up to 128"),
    (dict(n_layers=17, skip_in=(4,)), None),
    (dict(skip_in=(0,)), "no skip at"),
])
def test_core_limits_raise(kw, what):
    """Beyond the wide instances' limits (``what``: 528 wide, a 520-wide
    feature head, a 144-wide padded encoding) the SDF core takes the huge
    class and the pack packs every block at its padded widths; so do the
    march kernels (the row engine's ROWS_HUGE, bf16 march weights) where
    their widths are beyond them (528 wide, the 144-wide encoding; the
    feature head is not theirs), while f32 march weights there raise
    naming the march kernels and item 15, from core_class and the f32 pack;
    a skip at layer 0, which JAX's fused core does not run either, raises
    naming that record, not item 15.  Depth is no limit (what=None): 17
    layers take the 64-point class, and the pack carries its meta vector's
    device copy (on the CPU, a CPU copy) for the kernels to read."""
    from nrhints_torch.fields.sdf import sdf_init as t_sdf_init

    cfg = SDFNetConfig(**kw)
    w = tcm.materialize_sdf_weights_full(t_sdf_init(torch.Generator().manual_seed(0), cfg, "cpu"), cfg)
    if what is None:
        assert tcm.core_class(cfg) is tcm.NARROW
        pk = tcm.pack_sdf_mlp(w, cfg, with_feat=True)
        assert int(pk["meta"][0]) == 17 and np.array_equal(pk["meta_dev"].numpy(), pk["meta"])
        return
    if what in ("padded widths up to 512", "encodings up to 128"):
        assert tcm.core_class(cfg) is tcm.CORE_HUGE
        pk = tcm.pack_sdf_mlp(w, cfg, with_feat=True)
        assert pk["cls"] is tcm.CORE_HUGE and pk["wpack"].dtype == torch.bfloat16
        L = cfg.n_layers
        weights = [w[2 * i] for i in range(L)] + [w[2 * L + 2]]
        for (wo, kp, np_, din, dout), wt in zip(_blocks(pk), weights):
            assert kp == -(-din // 16) * 16 and np_ == -(-dout // 16) * 16
            blk = pk["wpack"][wo : wo + kp * np_].view(kp, np_)
            assert torch.equal(blk[:din, :dout], wt.to(torch.bfloat16))
            assert not blk[din:].any() and not blk[:, dout:].any()
        mw = w[: 2 * L + 2]
        if "d_out_feat" in kw:
            assert tcm.core_class(cfg, with_feat=False, compute_dtype="float32") is tcm.NARROW
            return
        assert tcm.core_class(cfg, with_feat=False) is tcm.ROWS_HUGE
        rows = tcm.pack_sdf_mlp(mw, cfg, with_feat=False)
        assert rows["cls"] is tcm.ROWS_HUGE and torch.equal(rows["wpack"], pk["wpack"][: pk["meta"][7]])
        with pytest.raises(NotImplementedError, match="march kernels .*bf16 march weights only.* item 15"):
            tcm.core_class(cfg, with_feat=False, compute_dtype="float32")
        with pytest.raises(NotImplementedError, match="march kernels .* item 15"):
            tcm.pack_sdf_mlp(mw, cfg, with_feat=False, dtype=torch.float32)
        return
    with pytest.raises(NotImplementedError, match=what) as e:
        tcm.core_class(cfg)
    if kw.get("skip_in"):
        assert "item 15" not in str(e.value) and "JAX's fused core" in str(e.value)
        return
    assert "ROADMAP.md Queue 2 item 15" in str(e.value)
    with pytest.raises(NotImplementedError, match=what):
        tcm.pack_sdf_mlp(w, cfg, with_feat=True)


def test_wide_dtype_and_row_engine_limits_raise():
    """The SDF core's wide class takes f32 operands and an f32 stash: the
    f32 pack at 512 wide is WIDE, its wtpack every block transposed at the
    same offset, and the f32-stash instance is the wide one of its pair;
    the march kernels' row engine takes the same widths at bf16 and f32
    march weights: its pack (with_feat=False) at 512 wide is ROWS_WIDE at
    either dtype, its blocks laid out as the core's, and above 512 / 128 it
    is ROWS_HUGE at bf16 march weights and raises at f32 ones, naming the
    march kernels and item 15."""
    from nrhints_torch.fields.sdf import sdf_init as t_sdf_init

    cfg = SDFNetConfig(d_hidden=512)
    w = tcm.materialize_sdf_weights_full(t_sdf_init(torch.Generator().manual_seed(0), cfg, "cpu"), cfg)
    assert tcm.core_class(cfg) is tcm.core_class(cfg, compute_dtype="float32") is tcm.WIDE
    f32 = tcm.pack_sdf_mlp(w, cfg, with_feat=True, dtype=torch.float32)
    assert f32["cls"] is tcm.WIDE and f32["wpack"].dtype == f32["wtpack"].dtype == torch.float32
    for wo, kp, np_, _, _ in _blocks(f32):
        block = f32["wpack"][wo : wo + kp * np_].view(kp, np_)
        assert torch.equal(f32["wtpack"][wo : wo + kp * np_].view(np_, kp), block.t())
    pk = tcm.pack_sdf_mlp(w, cfg, with_feat=True)
    assert tcm.core_instance("sdf_stash_fwd", pk, "bfloat16", "float32") == ("sdf_stash_fwd_f32stash_wide", 6)
    mw = w[: 2 * cfg.n_layers + 2]
    for compute, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        assert tcm.core_class(cfg, with_feat=False) is tcm.ROWS_WIDE
        rows = tcm.pack_sdf_mlp(mw, cfg, with_feat=False, dtype=dt)
        assert rows["cls"] is tcm.ROWS_WIDE and rows["wpack"].dtype == dt
        # The core's pack holds the same hidden blocks, then the feature head at wf_off.
        assert torch.equal(rows["wpack"].to(torch.bfloat16), pk["wpack"][: pk["meta"][7]])
        assert list(rows["meta"][10:]) == list(pk["meta"][10:]) and int(rows["meta"][3]) == 0
    for kw, what in ((dict(d_hidden=528), "padded width 528 and encoding 48"),
                     (dict(multi_res=21), "padded width 256 and encoding 144")):
        assert tcm.core_class(SDFNetConfig(**kw), with_feat=False) is tcm.ROWS_HUGE
        with pytest.raises(NotImplementedError, match=what) as e:
            tcm.core_class(SDFNetConfig(**kw), with_feat=False, compute_dtype="float32")
        assert "march kernels" in str(e.value) and "ROADMAP.md Queue 2 item 15" in str(e.value)
    assert tcm.core_class(SDFNetConfig(), with_feat=False) is tcm.NARROW


@pytest.mark.parametrize("renderer_kw,fused", [
    (dict(shadow_final_impl="xla"), True),
    ({}, True),  # the shipping routes: kernel C's final shadow sweep
    (dict(shadow_final_impl="xla", march_sweep_impl="pallas", march_rounds_impl="pallas", shadow_split=False),
     True),
    (dict(shadow_final_impl="xla", importance_split=True, march_sweep_impl="pallas"), True),
    (dict(fused_kernels="off"), False),
])
def test_renderer_checks_widths_before_launch(renderer_kw, fused):
    """``render/renderer.py::check_kernel_widths`` (called by render_rays
    for CUDA rays before any launch): a 512-wide SDF passes on every route,
    the march kernels' wide instances among them; a 528-wide SDF (the SDF
    core's and the march kernels' huge classes) passes on every route at
    the default bf16 march weights, and at march_dtype="float32" passes
    where every march is "xla" (shadow_final_impl="xla" beside the default
    "xla" sweeps and rounds) and raises on every fused march route, naming
    the march kernels and item 15; a trunk in the CUDA trunk kernels' wide class (272 hidden)
    passes on every trunk route; a trunk wider than that class (528 hidden)
    raises where the fused trunk runs (training at
    reflectance_impl="pallas", eval at eval_reflectance_impl="pallas"),
    naming item 15, and passes where the "xla" trunk runs; the presets
    pass."""
    import dataclasses

    from nrhints_torch.configs.config import nr_hints_cam_opt
    from nrhints_torch.render import renderer as tr

    base = nr_hints_cam_opt().model
    tr.check_kernel_widths(base)
    wide = dataclasses.replace(base, sdf_network=dataclasses.replace(base.sdf_network, d_hidden=512),
                               renderer=dataclasses.replace(base.renderer, **renderer_kw))
    for is_training in (True, False):
        tr.check_kernel_widths(wide, is_training)
    too_wide = dataclasses.replace(wide, sdf_network=dataclasses.replace(base.sdf_network, d_hidden=528))
    for is_training in (True, False):
        tr.check_kernel_widths(too_wide, is_training)
    r = too_wide.renderer
    xla_marches = r.march_sweep_impl == r.march_rounds_impl == r.shadow_final_impl == "xla" and not r.importance_split
    f32 = dataclasses.replace(too_wide, renderer=dataclasses.replace(r, march_dtype="float32"))
    if not fused or xla_marches:
        for is_training in (True, False):
            tr.check_kernel_widths(f32, is_training)
    else:
        with pytest.raises(NotImplementedError, match="march kernels .* item 15"):
            tr.check_kernel_widths(f32)
    for d_hidden, takes in ((272, True), (528, False)):
        trunk = dataclasses.replace(wide, reflectance_network=dataclasses.replace(base.reflectance_network,
                                                                              d_hidden=d_hidden))
        for impl in ("pallas", "xla"):
            cfg = dataclasses.replace(trunk, renderer=dataclasses.replace(
                trunk.renderer, reflectance_impl=impl, eval_reflectance_impl=impl))
            for is_training in (True, False):
                if fused and impl == "pallas" and not takes:
                    with pytest.raises(NotImplementedError, match="trunk kernels .* item 15"):
                        tr.check_kernel_widths(cfg, is_training)
                else:
                    tr.check_kernel_widths(cfg, is_training)
        tr.check_kernel_widths(trunk, is_training=False)  # eval's default trunk is "xla"


def test_huge_class_instances_and_layouts():
    """Above 512 / 128 the SDF core takes CORE_HUGE (64-point blocks, the
    kHugeClass bit alone, counted as *_huge) at bf16 operands and a bf16
    stash; its pack's tile widths are the widest padded layer and feature
    head and the padded encoding, its rows in device memory (``row_layout``)
    1.5 widths and an encoding of f32 a padded point (0 for the other
    classes), and the chain's encoding cotangents take the padded encoding;
    the march kernels take the same SDFs in their own huge class
    (ROWS_HUGE, counted as *_huge)."""
    from nrhints_torch.fields.sdf import sdf_init as t_sdf_init

    for kw, tiles in ((dict(d_hidden=1024), (1024, 48)), (dict(d_hidden=528), (528, 48)),
                      (dict(d_out_feat=520), (528, 48)), (dict(d_hidden=256, multi_res=24), (256, 160)),
                      (dict(multi_res=21), (256, 144))):
        cfg = SDFNetConfig(**kw)
        assert tcm.core_class(cfg) is tcm.CORE_HUGE
        w = tcm.materialize_sdf_weights_full(t_sdf_init(torch.Generator().manual_seed(0), cfg, "cpu"), cfg)
        pk = tcm.pack_sdf_mlp(w, cfg, with_feat=True)
        assert tcm.huge_tiles(pk["meta"]) == tiles
        width, enc = tiles
        for n, nblk in ((1, 1), (64, 1), (65, 2), (65536, 1024)):
            assert tcm.row_layout(n, pk) == (nblk, 64 * nblk, 64 * nblk * (width // 2 + width + enc))
            gt = int(pk["meta"][9])
            assert tcm.chain_layout(n, gt, tcm.CORE_HUGE, enc) == (nblk, 64 * nblk, 64 * nblk * (gt + 4 * enc))
        for kernel in cuda_lib.SDF_CORE_KERNELS:
            name, bits = tcm.core_instance(kernel, pk, "bfloat16", "bfloat16")
            assert (name, bits) == (kernel + "_huge", 8) and name in cuda_lib.launch_counts
        if "d_out_feat" not in kw:
            assert tcm.core_class(cfg, with_feat=False) is tcm.ROWS_HUGE
            for k in ("shadow_final", *cuda_lib.MARCH_FUSED):
                assert k + tcm.ROWS_HUGE.suffix in cuda_lib.launch_counts
    big = SDFNetConfig(d_hidden=1024)
    w = tcm.materialize_sdf_weights_full(t_sdf_init(torch.Generator().manual_seed(0), big, "cpu"), big)
    pk = tcm.pack_sdf_mlp(w, big, with_feat=True)
    assert int(pk["meta"][9]) == 8160 and tcm.row_layout(65536, pk)[2] * 4 == 415_236_096
    for cls in (tcm.NARROW, tcm.WIDE):
        assert tcm.row_layout(1000, dict(pk, cls=cls))[2] == 0
    assert cuda_lib.SDF_CORE_INSTANCES[-6:] == [f"{k}_huge" for k in cuda_lib.SDF_CORE_KERNELS]


@pytest.mark.parametrize("kw", [dict(d_hidden=528), dict(multi_res=21)])
def test_huge_f32_raises(kw):
    """The huge class is bf16 only: an f32 operand or stash dtype there
    raises NotImplementedError naming item 15, from core_class, the f32
    pack and core_instance (which every card wrapper calls before any
    allocation or launch); the CPU's plain versions take them."""
    from nrhints_torch.fields.sdf import sdf_init as t_sdf_init

    cfg = SDFNetConfig(**kw)
    w = tcm.materialize_sdf_weights_full(t_sdf_init(torch.Generator().manual_seed(0), cfg, "cpu"), cfg)
    for compute, stash in (("float32", "bfloat16"), ("bfloat16", "float32"), ("float32", "float32")):
        with pytest.raises(NotImplementedError, match="bf16 operands and a bf16 stash only.*item 15"):
            tcm.core_class(cfg, compute_dtype=compute, stash_dtype=stash)
    with pytest.raises(NotImplementedError, match="item 15"):
        tcm.pack_sdf_mlp(w, cfg, with_feat=True, dtype=torch.float32)
    pk = tcm.pack_sdf_mlp(w, cfg, with_feat=True)
    for compute, stash in (("float32", None), ("bfloat16", "float32"), ("float32", "bfloat16")):
        with pytest.raises(NotImplementedError, match="item 15"):
            tcm.core_instance("sdf_stash_fwd", pk, compute, stash)
    x = torch.tensor(np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32))
    sdf, feat, gx = tcm.sdf_core_primal(w, x, cfg, "float32")
    assert sdf.shape == (5,) and feat.shape == (5, cfg.d_out_feat) and torch.isfinite(gx).all()


def test_params_from_jax_at_528(cases):
    """``convert.params_from_jax`` carries a 528-wide SDF's weight-norm
    leaves over exactly (every leaf, its shape and its floats)."""
    _, jp, _, tp, _, _ = cases["w528"]
    flat = {n: np.asarray(v) for n, v in tree_items(jp)}
    ported = dict(tree_items(tp))
    assert sorted(flat) == sorted(ported)
    for n, v in flat.items():
        assert ported[n].shape == v.shape and np.array_equal(ported[n].numpy(), v), n
    assert max(v.shape[-1] for v in flat.values()) == 528


def test_huge_constants_match_the_headers():
    """CORE_HUGE's block and bit are the constants the CUDA huge instances
    are compiled with; their shared memory holds only the weight ring and
    the row ring (138,240 B forward, + d sdf a point in the chain), and
    their rows' layout is row_layout's."""
    def const(header, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", (cuda_lib.CSRC / header).read_text()).group(1))

    assert const("mma_rows.cuh", "kHugeClass") == tcm.CORE_HUGE.bit == 8
    assert const("staged_mma.cuh", "kChainTP") == tcm.CORE_HUGE.pts == 64
    staged = (cuda_lib.CSRC / "staged_mma.cuh").read_text()
    assert "static constexpr int kPts = kChainTP, kW = 0, kEnc = 0, kLdC = 0;" in staged
    ring = 3 * max(64 * (256 + 8), 256 * (64 + 8)) * 2
    assert ring + 3 * 64 * (64 + 8) * 2 == 138240
    fwd = (cuda_lib.CSRC / "sdf_fwd.cuh").read_text()
    bwd = (cuda_lib.CSRC / "sdf_bwd.cuh").read_text()
    assert "fwd_smem<CoreHuge, bf16>() == 138240" in fwd and "chain_smem<CoreHuge, bf16>() == 138496" in bwd
    rows = (cuda_lib.CSRC / "mma_rows.cuh").read_text()
    assert "return w / 2 + w + huge_enc(m);" in rows and "const int w = huge_width(m);" in rows
    assert "return (m.d0 + 15) / 16 * 16;" in rows
    assert "return m.gates_total + 4 * (Cls::kHuge ? huge_enc(m) : Cls::kEnc);" in bwd
    # The march kernels' huge class: 64-row passes on the same rings and the
    # same rows, 4 rays a block, the block's rows at blockIdx.x 64 rows.
    assert "static constexpr int kRows = kChainTP;" in rows and tcm.ROWS_HUGE.pts == 64
    assert "static_assert(sizeof(RowsHugeTile::ring) == huge_smem(0)" in rows
    assert "core_tiles<CoreHuge, bf16>(reinterpret_cast<unsigned char*>(S.ring), S.rows, m)" in rows
    assert rows.count("gemm_rows_huge<false>(") == 1 and "wmma::" not in rows
    common = (cuda_lib.CSRC / "march_common.cuh").read_text()
    assert "constexpr int kMarchRays = kRowsThreads / NBUF;" in common and tcm.MARCH_RAYS == 512 // 128
    assert "rows + (size_t)blockIdx.x * RowsHuge::kRows * huge_row(m);" in common
    assert "parse_meta(meta, meta_dev, &m, kIsWide, kIsHuge)" in common


def test_march_huge_rows_layout():
    """``core_mlp.march_layout``: the march kernels' huge class keeps 64
    rows a 4-ray block in device memory, each the bf16 activations and the
    f32 product output at the widest padded layer and the f32 padded
    encoding.  At d_hidden 1024 and multi_res 6 (encoding 39, padded 48)
    that is 1024 / 2 + 1024 + 48 = 1,584 floats a row by hand, 405,504
    bytes a block, 51.9 MB at 512 rays (128 blocks); the other classes keep
    none."""
    from nrhints_torch.fields.sdf import sdf_init as t_sdf_init

    cfg = SDFNetConfig(d_hidden=1024)
    w = tcm.materialize_sdf_weights_full(t_sdf_init(torch.Generator().manual_seed(0), cfg, "cpu"), cfg)
    pk = tcm.pack_sdf_mlp(w[: 2 * cfg.n_layers + 2], cfg, with_feat=False)
    assert pk["cls"] is tcm.ROWS_HUGE and tcm.huge_tiles(pk["meta"]) == (1024, 48)
    row = 512 + 1024 + 48
    assert row == 1584 and 64 * row * 4 == 405_504
    for b, nblk in ((1, 1), (4, 1), (5, 2), (512, 128), (2048, 512)):
        assert tcm.march_layout(b, pk) == (nblk, nblk * 64 * row)
    assert tcm.march_layout(512, pk)[1] * 4 == 51_904_512
    assert tcm.march_layout(2048, pk)[1] * 4 == 207_618_048
    for cls in (tcm.NARROW, tcm.ROWS_WIDE):
        assert tcm.march_layout(512, dict(pk, cls=cls)) == (128, 0)
