"""Each CUDA kernel of nrhints_torch against its plain PyTorch version, on a
CUDA card (marked ``gpu``; without a card every test here skips).  This file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: kernel A and C round their dot operands to bf16 like the plain
versions but sum in another order, so an activation on a bf16 rounding
boundary can round the other way: 1e-2 relative to the output's scale.
Kernel B's merge is exact (identical z and sdf); its draws sum in the plain
version's order: 1e-5; its last-round step (draw, then merge the draws in)
gives the z of its draw step followed by its merge-only step bit for bit.  Kernels D, F and I: outputs and stash 1e-2, as A.
Kernels E, G, H and J: 2e-2 of each gradient's scale: the backward chains
twice as many bf16-operand products as the forward, and the dW sums over
the points run in another order (H's plain version is autograd, which
rounds each dot's result to bf16 where the kernel rounds its operands).
Kernel D's outputs are kernel A's bit for bit (and D's stash_all
variant's, with the h_i of its stash, plain D's), I's are F's, J's gradients
are G's at F's stash (the ReLU backward reads only what a bf16 z keeps),
A gives the same outputs and E, G, H and J the same gradients bit for bit
on every run (no atomics).  J's plain version recomputes the z_i in
another summation order, so a z_i within rounding of 0 can take the other
side of the ReLU there and
move one point's dx by a whole unit's share: J is held entry by entry
against the plain backward at the forward's own z_i, and against the wholly
plain backward by the relative norm of the error (2e-2).
Kernels K, L, M and N (the round-4 marches): K's sdf0 1e-2 as A; N's tau
1e-2 as C, also at ray counts that fill C's and N's 4-ray blocks in part;
L's z equal bit for bit to its schedule run as kernel B steps
between kernel K sweeps, M's z to L(K(.)) and N's tau to C(M(.)), K, L and
M also at ray counts that fill their 4-ray blocks in part; against
the wholly plain marches, L's and M's z as chip_smoke.py holds them (sorted,
every stratified sample kept, Z_NN_SHARE of the samples within 1e-4 of a
plain sample: near-ties of the cdf and the u grid send a draw to the next
interval when a sweep rounds otherwise).  Kernel B's rank merge gives the
bitonic network's z bit for bit.
The SDF core's f32 instances (compute_dtype="float32": A, D, E, H and D's
and E's stash_all variants) against their plain f32 versions: 1e-5 of
max(1, scale) for the outputs, 1e-4 of each gradient's scale (exact f32
dots on both sides, summed in other orders; the dW sums run over every
point); f32 matmuls run without TF32.  An f32 stash holds the kernel's
h_i, u_i and g_enc to 1e-5; a bf16 stash to 1e-2 (a value within an f32
ulp of a bf16 rounding boundary rounds the other way), and E reads the
kernel's own stash on both sides.  The mixed instance with bf16 operands
and an f32 stash keeps the bf16 tolerances above.
The SDF core's wide instances (A, D, E, H and D's and E's stash_all
variants above the presets' widths: bf16, 32-point blocks) at the bf16
instances' tolerances above, with the same identities (D = A, the variant
= D where they share outputs, E and H repeat, E without its dW passes gives
E's dx, all bit for bit).
The trunk's f32 instances (F and G at each (compute, stash) pair, I and J
at compute_dtype="float32") against their plain versions at the same
tolerances; I equals F's output and J's gradients G's at F's f32 stash bit
for bit, G and J repeat bit for bit, and J is held the two ways above (1e-4
entry by entry at F's z_i, 1e-4 by the relative norm against the wholly
plain backward).  bf16 operands with an f32 stash give the (bf16, bf16)
pair's output and gradients bit for bit, and the stash rounds to its stash:
bf16(relu(z)) = relu(bf16(z)), and the ReLU mask reads only z's sign.
The trunk's wide instances (F, G, I and J above the presets' widths:
32-point blocks, bf16 and f32, every dtype pair) at the tolerances above for
their dtypes, with the same identities (I = F, J = G at F's stash, G and J
repeat, bit for bit; J by the norm against the wholly plain backward).
"""
import numpy as np
import pytest
import torch

from nrhints_torch.fields.sdf import SDFNetConfig, sdf_init
from nrhints_torch.kernels import core_mlp, core_stash, cuda_lib, march

SMALL = SDFNetConfig(n_layers=4, d_hidden=32, d_out_feat=16, skip_in=(2,), multi_res=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    from nrhints_torch.utils import resolve_device

    return resolve_device("cuda")


def _rays(dev, n=37):
    rng = np.random.default_rng(0)
    o = np.tile(np.array([[0.3, 0.4, -2.7]], np.float32), (n, 1))
    tgt = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    tgt[:, 2] = 0.0
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mid = -np.sum(o * d, -1, keepdims=True)
    z0 = mid - 1.0 + 2.0 * np.linspace(0.0, 1.0, 64, dtype=np.float32)[None, :]
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in (o, d, z0)]


def _close(k, p, tol):
    scale = max(1.0, p.abs().max().item())
    assert (k - p).abs().max().item() <= tol * scale


def _close_rel(k, p, tol):
    """Within tol of the plain gradient's own scale (gradients can be far
    below 1)."""
    err, scale = (k - p).abs().max().item(), p.abs().max().item()
    assert err <= tol * scale + 1e-7, f"err {err:.3e} vs scale {scale:.3e}"


# Point counts of the SDF core's tests: kernels A, D, E and H run on 64-point
# blocks (core_mlp.CHAIN_TP), so 63, 64 and 65 sit on the edges of one and
# two blocks, and 4,161 = 65 x 64 + 1 has a ragged last block past 4,096
# points (several dW row chunks of E and H).
SDF_BWD_N = [1, 63, 64, 65, 100, 1000, 4161]
# The SDF core's wide instances run on 32-point blocks (core_mlp.WIDE): 31,
# 32 and 33 sit on the edges of one and two blocks.
WIDE_N = [1, 31, 33, 1000, 4161]
# A config wide by every width (the 512-wide nr-hints SDF), one whose
# feature head and encoding alone are (d0 = 75, a 512-wide head), and a
# small one at 288 (3 layers, d0 = 69).
WIDE_CFGS = {
    "d512": SDFNetConfig(d_hidden=512),
    "feat512": SDFNetConfig(d_out_feat=512, multi_res=12),
    "w288": SDFNetConfig(n_layers=3, d_hidden=288, skip_in=(2,), multi_res=11, d_out_feat=272),
}
# The trunk kernels F, G, I and J run on the same 64-point blocks: 64 is one
# block exactly, 65 one block and a ragged row.
TRUNK_N = [1, 64, 65, 100, 1000]


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [SMALL, SDFNetConfig()], ids=["small", "full"])
@pytest.mark.parametrize("n", SDF_BWD_N)
def test_sdf_core_fwd_matches_plain(cuda, cfg, n):
    """Kernel A against its plain version, and bit for bit on a rerun."""
    w = core_mlp.materialize_sdf_weights_full(sdf_init(torch.Generator().manual_seed(0), cfg, cuda), cfg)
    x = torch.tensor(np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32) * 0.5, device=cuda)
    before = cuda_lib.launch_counts["sdf_core_fwd"]
    out = core_mlp.sdf_core_fwd(w, x, cfg)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["sdf_core_fwd"] == before + 1
    for k, p in zip(out, core_mlp.sdf_core_plain(w, x, cfg, "bfloat16")):
        _close(k, p, 1e-2)
    assert all(torch.equal(a, b) for a, b in zip(out, core_mlp.sdf_core_fwd(w, x, cfg)))


# Ray counts of kernel B, 4 rays a 128-thread block (one warp each): one
# ray, 5 (a second block with one), 127 (a ragged last block) and one
# 512-ray chunk.
MACHINERY_B = [1, 5, 127, 512]


@pytest.mark.gpu
@pytest.mark.parametrize("merge", ["bitonic", "rank"])
@pytest.mark.parametrize("n", MACHINERY_B)
def test_round_machinery_matches_plain(cuda, merge, n):
    """Kernel B against its plain version on every step of a march, each
    from the kernel's own previous outputs: the 4 round steps, JAX's
    merge-only tail step after the last, and the last round's step that
    merges its draws in itself (``last``), whose z equals the round step
    followed by the tail step bit for bit; one launch a step."""
    p = sdf_init(torch.Generator().manual_seed(0), SMALL, cuda)
    o, d, z0 = _rays(cuda, n)
    w = march.march_weights(p, SMALL, "bfloat16")
    z = torch.cat([z0, torch.full_like(z0, march.BIG_Z)], -1)
    sdf = torch.cat([march._mlp_sdf_3d(o[:, None] + d[:, None] * z0[..., None], w, SMALL), torch.zeros_like(z0)], -1)
    new_z = new_sdf = None
    before = cuda_lib.launch_counts["round_machinery"]
    for i in range(4):
        vn = 64 + 16 * i
        args = (z, sdf, o, d, new_z, new_sdf, None if i == 0 else vn - 16, vn, 64.0 * 2**i)
        k, pl_ = march.round_machinery(*args, merge=merge), march.round_machinery_plain(*args, merge=merge)
        assert torch.equal(k[1], pl_[1]) and torch.equal(k[2], pl_[2])
        _close(k[0], pl_[0], 1e-5)
        new_z, z, sdf = k
        new_sdf = march._mlp_sdf_3d(o[:, None] + d[:, None] * new_z[..., None], w, SMALL)
    tail = (z, sdf, o, d, new_z, torch.zeros_like(new_z), 112, None, None)
    kt, pt = march.round_machinery(*tail, merge=merge), march.round_machinery_plain(*tail, merge=merge)
    assert kt[0] is None and kt[2] is None and torch.equal(kt[1], pt[1])
    kl = march.round_machinery(*args, merge=merge, last=True)
    pl_l = march.round_machinery_plain(*args, merge=merge, last=True)
    torch.cuda.synchronize()
    assert kl[0] is None and kl[2] is None and pl_l[0] is None and torch.equal(kl[1], kt[1])
    assert kl[1].shape == (n, 128) and bool((kl[1][:, 1:] >= kl[1][:, :-1]).all())
    _close(kl[1], pl_l[1], 1e-4)
    assert cuda_lib.launch_counts["round_machinery"] == before + 6


# Ray counts of the shadow kernels C and N, which run 4 rays per block: one
# ray, and 3, 4 and 5 (a block with spare rays, one full block, a second block
# with 3 spare rays), 130 (a ragged last block) and one 512-ray chunk.
SHADOW_B = [1, 3, 4, 5, 130, 512]


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [SMALL, SDFNetConfig()], ids=["small", "full"])
@pytest.mark.parametrize("n", SHADOW_B)
def test_shadow_final_matches_plain(cuda, cfg, n):
    p = sdf_init(torch.Generator().manual_seed(0), cfg, cuda)
    o, d, z0 = _rays(cuda, n)
    z = march.fused_importance_z(p, cfg, o, d, z0, mlp_dtype="bfloat16", split=True, sweep_impl="xla",
                                 rounds_impl="xla")
    sdist = torch.full((o.shape[0], 1), 2.0 / 64, device=cuda)
    w = march.march_weights(p, cfg, "bfloat16")
    k = march.shadow_final(z, o, d, sdist, 64.0, 0.7, w, cfg)
    _close(k, march.shadow_final_plain(z, o, d, sdist, 64.0, 0.7, w, cfg), 1e-2)


@pytest.mark.gpu
def test_render_rays_card_matches_cpu(cuda):
    """The eval render on the card (all three kernels) against the same
    render on the CPU (plain versions), at the shipping bf16 march: 2e-2, as
    chip_smoke.py's CPU re-render (bf16 rounding flips move a few samples;
    the composite absorbs them)."""
    from nrhints_torch.core.structs import RayBundle
    from nrhints_torch.fields.reflectance import ReflectanceNetConfig
    from nrhints_torch.render.renderer import ModelConfig, init_model_params, render_rays

    cfg = ModelConfig(sdf_network=SMALL, reflectance_network=ReflectanceNetConfig(n_layers=2, d_hidden=32))
    params = init_model_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    o, d, z0 = _rays("cpu")
    pl_ = torch.tensor([[1.5, 2.5, -1.0]]).expand_as(o).contiguous()
    rays = RayBundle(o, d, pl_, z0[:, :1], z0[:, -1:])

    def to_card(t):
        return {k: to_card(v) for k, v in t.items()} if isinstance(t, dict) else t.to(cuda)

    cpu = render_rays(params, cfg, rays)
    before = dict(cuda_lib.launch_counts)
    card = render_rays(to_card(params), cfg, RayBundle(*(to_card(t) for t in (o, d, pl_, z0[:, :1], z0[:, -1:]))))
    torch.cuda.synchronize()
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in before} == dict(
        {k: 0 for k in before}, sdf_core_fwd=1, round_machinery=8, shadow_final=1)
    for k in ("rgb", "depth", "visibilities"):
        assert (getattr(card, k).cpu() - getattr(cpu, k)).abs().max().item() <= 2e-2, k


@pytest.mark.gpu
def test_wrappers_raise_on_bad_inputs(exact_f32):
    cuda = exact_f32
    p = sdf_init(torch.Generator().manual_seed(0), SMALL, cuda)
    w = core_mlp.materialize_sdf_weights_full(p, SMALL)
    with pytest.raises(ValueError):
        core_mlp.sdf_core_fwd(w, torch.zeros((4, 3), dtype=torch.float64, device=cuda), SMALL)
    with pytest.raises(ValueError):
        core_mlp.sdf_core_fwd(w, torch.zeros((3, 4), device=cuda).t(), SMALL)
    # compute_dtype="float32" runs A's f32 instance, and an f32 MlpFn I's and
    # J's (each raised before its f32 instance existed).
    x = torch.tensor(np.random.default_rng(3).normal(size=(37, 3)).astype(np.float32) * 0.5, device=cuda)
    before = cuda_lib.launch_counts["sdf_core_fwd_f32"]
    out = core_mlp.fused_sdf_value_feat_grad(p, SMALL, x, compute_dtype="float32")
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["sdf_core_fwd_f32"] == before + 1
    for k, ref in zip(out, core_mlp.sdf_core_plain(w, x, SMALL, "float32")):
        _close(k, ref, 1e-5)
    with pytest.raises(ValueError):
        core_mlp.fused_sdf_value_feat_grad(p, SMALL, x, compute_dtype="float16")
    tw, _, xt, gt = _gpu_trunk_case(cuda, (45, 32, 3), 37)
    tw = [w.requires_grad_(True) for w in tw]
    xt.requires_grad_(True)
    before = dict(cuda_lib.launch_counts)
    out = core_mlp.MlpFn.apply(1, "float32", xt, *tw)
    grads = torch.autograd.grad(out, [xt, *tw], gt)
    torch.cuda.synchronize()
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in before if cuda_lib.launch_counts[k] != before[k]} == {
        "mlp_fwd_f32": 1, "mlp_bwd_f32": 1}
    ref_out = core_mlp.mlp_relu_plain(tw, xt, 1, "float32")
    _close(out, ref_out, 1e-5)
    for k, ref in zip(grads, torch.autograd.grad(ref_out, [xt, *tw], gt)):
        _close_rel(k, ref, 1e-4)


def _gpu_trunk_case(dev, dims, n):
    """(weights, n_layers, x, g): the trunk dims[0] -> ... -> dims[-1] with
    torch.nn.Linear's default init from seed 1, and n random inputs and
    output cotangents (seed n)."""
    from nrhints_torch.fields.mlp import torch_default_linear_init

    gen = torch.Generator().manual_seed(1)
    w = []
    for i in range(len(dims) - 1):
        w += list(torch_default_linear_init(gen, dims[i], dims[i + 1], dev))
    rng = np.random.default_rng(n)
    x = torch.tensor(rng.normal(size=(n, dims[0])).astype(np.float32), device=dev)
    g = torch.tensor(rng.normal(size=(n, dims[-1])).astype(np.float32), device=dev)
    return w, len(dims) - 2, x, g


def _gpu_sdf_case(cuda, cfg, n):
    w = core_mlp.materialize_sdf_weights_full(sdf_init(torch.Generator().manual_seed(0), cfg, cuda), cfg)
    rng = np.random.default_rng(n)
    x = torch.tensor(rng.normal(size=(n, 3)).astype(np.float32) * 0.5, device=cuda)
    cots = tuple(torch.tensor(a.astype(np.float32), device=cuda) for a in (
        rng.normal(size=(n,)), rng.normal(size=(n, cfg.d_out_feat)), rng.normal(size=(n, 3))))
    return w, x, cots


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [SMALL, SDFNetConfig()], ids=["small", "full"])
@pytest.mark.parametrize("n", SDF_BWD_N)
def test_sdf_stash_kernels_match_plain(cuda, cfg, n):
    """Kernel D against kernel A and the plain forward; kernel E against the
    plain backward at D's stash."""
    w, x, cots = _gpu_sdf_case(cuda, cfg, n)
    before = dict(cuda_lib.launch_counts)
    sdf, feat, gx, stash = core_stash.sdf_stash_fwd(w, x, cfg)
    for k, a in zip((sdf, feat, gx), core_mlp.sdf_core_fwd(w, x, cfg)):
        assert torch.equal(k, a)
    _, _, _, hs = core_stash.sdf_core_fwd_hs_plain(w, x, cfg, "bfloat16", "bfloat16")
    for k, p in zip(core_stash.split_stash(stash, core_stash.sdf_stash_columns(cfg)), hs):
        _close(k.float(), p.float(), 1e-2)
    dws, dx = core_stash.sdf_stash_bwd(w, x, stash, cots, cfg)
    torch.cuda.synchronize()
    p_dws, p_dx = core_stash.sdf_core_bwd_stash_plain(
        w, x, core_stash.split_stash(stash, core_stash.sdf_stash_columns(cfg)), cots, cfg, "bfloat16")
    _close_rel(dx, p_dx, 2e-2)
    assert len(dws) == len(p_dws)
    for k, p in zip(dws, p_dws):
        assert k.shape == p.shape
        _close_rel(k, p, 2e-2)
    dws2, dx2 = core_stash.sdf_stash_bwd(w, x, stash, cots, cfg)
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in ("sdf_stash_fwd", "sdf_stash_bwd")} == {
        "sdf_stash_fwd": 1, "sdf_stash_bwd": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [SMALL, SDFNetConfig()], ids=["small", "full"])
@pytest.mark.parametrize("n", SDF_BWD_N)
def test_sdf_stash_all_kernels_match_plain(cuda, cfg, n):
    """D's stash_all variant against plain D (sdf, feat, grad and the h_i
    bit for bit) and its plain version (h_i, u_i and g_enc); E's variant
    against its plain version at the variant's stash, twice bit for bit,
    and without its dW passes (dx bit for bit)."""
    w, x, cots = _gpu_sdf_case(cuda, cfg, n)
    L, gt = cfg.n_layers, core_stash.sdf_stash_width(cfg)
    cols = core_stash.sdf_stash_columns(cfg, stash_us=True)
    before = dict(cuda_lib.launch_counts)
    sdf, feat, gx, stash = core_stash.sdf_stash_fwd(w, x, cfg, stash_us=True)
    ref = core_stash.sdf_stash_fwd(w, x, cfg)
    assert stash.shape == (n, core_stash.sdf_stash_width(cfg, stash_us=True))
    assert all(torch.equal(k, a) for k, a in zip((sdf, feat, gx), ref[:3])) and torch.equal(stash[:, :gt], ref[3])
    _, _, _, hs, us, g_enc = core_stash.sdf_core_fwd_hs_plain(w, x, cfg, "bfloat16", "bfloat16", return_us=True)
    parts = core_stash.split_stash(stash, cols)
    for k, p in zip(parts, [*hs, *us, g_enc]):
        _close(k.float(), p.float(), 1e-2)
    dws, dx = core_stash.sdf_stash_bwd(w, x, stash, cots, cfg, stash_us=True)
    torch.cuda.synchronize()
    p_dws, p_dx = core_stash.sdf_core_bwd_stash_all_plain(w, x, parts[:L], parts[L : 2 * L], parts[2 * L], cots, cfg,
                                                          "bfloat16")
    _close_rel(dx, p_dx, 2e-2)
    assert len(dws) == len(p_dws)
    for k, p in zip(dws, p_dws):
        assert k.shape == p.shape
        _close_rel(k, p, 2e-2)
    dws2, dx2 = core_stash.sdf_stash_bwd(w, x, stash, cots, cfg, stash_us=True)
    none, dx_only = core_stash.sdf_stash_bwd(w, x, stash, cots, cfg, need_dw=False, stash_us=True)
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))
    assert none is None and torch.equal(dx_only, dx)
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in before if cuda_lib.launch_counts[k] != before[k]} == {
        "sdf_stash_all_fwd": 1, "sdf_stash_fwd": 1, "sdf_stash_all_bwd": 3}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(WIDE_CFGS))
@pytest.mark.parametrize("n", WIDE_N)
def test_sdf_core_wide_forward_matches_plain(cuda, name, n):
    """The wide instances of A, D and D's stash_all variant against their
    plain versions; D's outputs A's, the variant's outputs and h_i D's,
    and A on a rerun, bit for bit; each counted under its _wide name."""
    cfg = WIDE_CFGS[name]
    w, x, _ = _gpu_sdf_case(cuda, cfg, n)
    assert core_mlp.core_class(cfg) is core_mlp.WIDE
    before = dict(cuda_lib.launch_counts)
    a = core_mlp.sdf_core_fwd(w, x, cfg)
    torch.cuda.synchronize()
    for k, p in zip(a, core_mlp.sdf_core_plain(w, x, cfg, "bfloat16")):
        _close(k, p, 1e-2)
    assert all(torch.equal(u, v) for u, v in zip(a, core_mlp.sdf_core_fwd(w, x, cfg)))
    d = core_stash.sdf_stash_fwd(w, x, cfg)
    assert all(torch.equal(u, v) for u, v in zip(d[:3], a))
    _, _, _, hs, us, g_enc = core_stash.sdf_core_fwd_hs_plain(w, x, cfg, "bfloat16", "bfloat16", return_us=True)
    for k, p in zip(core_stash.split_stash(d[3], core_stash.sdf_stash_columns(cfg)), hs):
        _close(k.float(), p.float(), 1e-2)
    v = core_stash.sdf_stash_fwd(w, x, cfg, stash_us=True)
    gt = core_stash.sdf_stash_width(cfg)
    assert all(torch.equal(u, t) for u, t in zip(v[:3], a)) and torch.equal(v[3][:, :gt], d[3])
    for k, p in zip(core_stash.split_stash(v[3], core_stash.sdf_stash_columns(cfg, stash_us=True)), [*hs, *us, g_enc]):
        _close(k.float(), p.float(), 1e-2)
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in before if cuda_lib.launch_counts[k] != before[k]} == {
        "sdf_core_fwd_wide": 2, "sdf_stash_fwd_wide": 1, "sdf_stash_all_fwd_wide": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(WIDE_CFGS))
@pytest.mark.parametrize("n", WIDE_N)
def test_sdf_core_wide_backward_matches_plain(cuda, name, n):
    """The wide instances of E, E's stash_all variant and H against their
    plain versions, each twice bit for bit, and E and the variant without
    their dW passes (dx bit for bit)."""
    cfg = WIDE_CFGS[name]
    w, x, cots = _gpu_sdf_case(cuda, cfg, n)
    L = cfg.n_layers
    before = dict(cuda_lib.launch_counts)
    for us in (False, True):
        stash = core_stash.sdf_stash_fwd(w, x, cfg, stash_us=us)[3]
        parts = core_stash.split_stash(stash, core_stash.sdf_stash_columns(cfg, stash_us=us))
        dws, dx = core_stash.sdf_stash_bwd(w, x, stash, cots, cfg, stash_us=us)
        torch.cuda.synchronize()
        if us:
            p_dws, p_dx = core_stash.sdf_core_bwd_stash_all_plain(w, x, parts[:L], parts[L : 2 * L], parts[2 * L],
                                                                  cots, cfg, "bfloat16")
        else:
            p_dws, p_dx = core_stash.sdf_core_bwd_stash_plain(w, x, parts, cots, cfg, "bfloat16")
        _close_rel(dx, p_dx, 2e-2)
        assert len(dws) == len(p_dws)
        for k, p in zip(dws, p_dws):
            assert k.shape == p.shape
            _close_rel(k, p, 2e-2)
        dws2, dx2 = core_stash.sdf_stash_bwd(w, x, stash, cots, cfg, stash_us=us)
        none, dx_only = core_stash.sdf_stash_bwd(w, x, stash, cots, cfg, need_dw=False, stash_us=us)
        assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))
        assert none is None and torch.equal(dx_only, dx)
    dws, dx = core_mlp.sdf_core_bwd(w, x, cots, cfg)
    torch.cuda.synchronize()
    p_dws, p_dx = core_mlp.sdf_core_bwd_plain(w, x, cots, cfg, "bfloat16")
    _close_rel(dx, p_dx, 2e-2)
    for k, p in zip(dws, p_dws):
        assert k.shape == p.shape
        _close_rel(k, p, 2e-2)
    dws2, dx2 = core_mlp.sdf_core_bwd(w, x, cots, cfg)
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in before if cuda_lib.launch_counts[k] != before[k]} == {
        "sdf_stash_fwd_wide": 1, "sdf_stash_all_fwd_wide": 1, "sdf_stash_bwd_wide": 3, "sdf_stash_all_bwd_wide": 3,
        "sdf_core_bwd_wide": 2}


@pytest.mark.gpu
def test_sdf_core_wide_limits_raise_before_launch(cuda):
    """Beyond the wide instances (d_hidden 528, the SDF core's and the march
    kernels'), and at f32 operands or an f32 stash of the core above the
    presets' widths, the wrappers raise NotImplementedError and launch
    nothing."""
    cfg, wide = SDFNetConfig(d_hidden=528), SDFNetConfig(d_hidden=512)
    w, x, cots = _gpu_sdf_case(cuda, cfg, 40)
    ww, _, wcots = _gpu_sdf_case(cuda, wide, 40)
    before = dict(cuda_lib.launch_counts)
    with pytest.raises(NotImplementedError, match="item 15"):
        core_mlp.sdf_core_fwd(w, x, cfg)
    with pytest.raises(NotImplementedError, match="item 15"):
        core_mlp.sdf_core_bwd(w, x, cots, cfg)
    with pytest.raises(NotImplementedError, match="item 15"):
        core_mlp.sdf_core_fwd(ww, x, wide, compute_dtype="float32")
    with pytest.raises(NotImplementedError, match="item 15"):
        core_stash.sdf_stash_fwd(ww, x, wide, stash_dtype="float32")
    o, d, z0 = _rays(cuda, 4)
    for dt in ("bfloat16", "float32"):
        mw = march.march_weights(sdf_init(torch.Generator().manual_seed(0), cfg, cuda), cfg, dt)
        with pytest.raises(NotImplementedError, match="item 15"):
            march.march_sweep(z0, o, d, mw, cfg)
    assert dict(cuda_lib.launch_counts) == before


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(45, 32, 32, 3), (361, 256, 256, 256, 256, 3)], ids=["small", "full"])
@pytest.mark.parametrize("n", TRUNK_N)
def test_mlp_stash_kernels_match_plain(cuda, dims, n):
    """Kernels F and G against the plain trunk forward and backward."""
    w, n_layers, x, g = _gpu_trunk_case(cuda, dims, n)
    out, zs = core_stash.mlp_stash_fwd(w, x, n_layers)
    p_out, p_zs = core_stash.mlp_relu_fwd_zs_plain(w, x, n_layers, "bfloat16", "bfloat16")
    _close(out, p_out, 1e-2)
    cols = core_stash.mlp_stash_columns(core_mlp.pack_mlp(w, n_layers))
    for k, p in zip(core_stash.split_stash(zs, cols), p_zs):
        _close(k.float(), p.float(), 1e-2)
    dws, dx = core_stash.mlp_stash_bwd(w, x, zs, g, n_layers)
    torch.cuda.synchronize()
    p_dws, p_dx = core_stash.mlp_relu_bwd_stash_plain(w, x, core_stash.split_stash(zs, cols), g, n_layers, "bfloat16")
    _close_rel(dx, p_dx, 2e-2)
    for k, p in zip(dws, p_dws):
        assert k.shape == p.shape
        _close_rel(k, p, 2e-2)
    dws2, _ = core_stash.mlp_stash_bwd(w, x, zs, g, n_layers)
    assert all(torch.equal(a, b) for a, b in zip(dws, dws2))


STEP_LAUNCHES = {
    "stash": {"sdf_stash_fwd": 1, "sdf_stash_bwd": 1, "mlp_stash_fwd": 1, "mlp_stash_bwd": 1},
    "recompute": {"sdf_core_fwd": 1, "sdf_core_bwd": 1, "mlp_fwd": 1, "mlp_bwd": 1},
    "stash_xla": {"sdf_stash_fwd": 1, "mlp_stash_fwd": 1},
    "stash_all": {"sdf_stash_all_fwd": 1, "sdf_stash_all_bwd": 1, "mlp_stash_fwd": 1, "mlp_stash_bwd": 1},
}


@pytest.mark.gpu
@pytest.mark.parametrize("core_backward", ["stash", "recompute", "stash_xla", "stash_all"])
def test_train_step_card_matches_cpu(cuda, core_backward):
    """One train step's gradients on the card (kernels B, C and the
    schedule's core kernels) against the same step on the CPU (plain
    versions), same uniforms, at the small configs: 5e-2 of each leaf's
    scale (bf16 rounding flips in the kernels and the bf16 march move a few
    samples), and the launches of one step."""
    from nrhints_torch.camera.model import CameraModel
    from nrhints_torch.camera.rays import ray_generator_init
    from nrhints_torch.configs.config import nr_hints_cam_opt
    from nrhints_torch.core.structs import PixelBundle
    from nrhints_torch.data.synthetic import scene_views
    from nrhints_torch.fields.reflectance import ReflectanceNetConfig
    from nrhints_torch.render.renderer import init_model_params
    from nrhints_torch.train.step import init_train_state, loss_and_grads, make_optimizer
    import dataclasses

    cfg = nr_hints_cam_opt()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, sdf_network=SMALL, reflectance_network=ReflectanceNetConfig(n_layers=2, d_hidden=32),
        renderer=dataclasses.replace(cfg.model.renderer, core_backward=core_backward)))
    sc = scene_views(2, 32, 32)
    cam = CameraModel(32, 32, 16.0, 16.0, sc["focal"], sc["focal"], 0.1, 6.0)
    rng = np.random.default_rng(0)
    img, hh, ww = rng.integers(0, 2, 64), rng.integers(0, 32, 64), rng.integers(0, 32, 64)
    pix = dict(h_indices=hh.astype(np.float32), w_indices=ww.astype(np.float32), poses=sc["poses"][img],
               pls=sc["pls"][img], img_indices=img, rgb_gt=sc["images"][img, hh, ww])
    u = {"strat": rng.random((64, 1), dtype=np.float32), "shadow": rng.random((64, 64), dtype=np.float32)}
    gen = torch.Generator().manual_seed(0)
    renderer = init_model_params(cfg.model, gen, device="cpu")
    raygen, _ = ray_generator_init(gen, cfg.ray_generator, 2, device="cpu")
    grads = {}
    for dev in ("cpu", cuda):
        params = {"renderer": _tree_to(renderer, dev), "raygen": _tree_to(raygen, dev)}
        state = init_train_state(params, make_optimizer(cfg, params))
        batch = PixelBundle(**{k: torch.as_tensor(v).to(dev) for k, v in pix.items()})
        before = dict(cuda_lib.launch_counts)
        loss_and_grads(state, cfg, cam, {}, batch, uniforms={k: torch.as_tensor(v).to(dev) for k, v in u.items()})
        delta = {k: cuda_lib.launch_counts[k] - before[k] for k in before}
        grads[str(dev)] = {name: t.grad.detach().cpu() for name, t in _named(params)}
    torch.cuda.synchronize()
    expected = {k: 0 for k in cuda_lib.launch_counts}
    expected.update(round_machinery=8, shadow_final=1, **STEP_LAUNCHES[core_backward])
    assert delta == expected
    card = grads[str(cuda)]
    for name, g in grads["cpu"].items():
        _close_rel(card[name], g, 5e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [SMALL, SDFNetConfig()], ids=["small", "full"])
@pytest.mark.parametrize("n", SDF_BWD_N)
def test_sdf_core_bwd_matches_plain(cuda, cfg, n):
    """Kernel H against its plain version (autograd over sdf_core_plain),
    twice, bit for bit."""
    w, x, cots = _gpu_sdf_case(cuda, cfg, n)
    before = cuda_lib.launch_counts["sdf_core_bwd"]
    dws, dx = core_mlp.sdf_core_bwd(w, x, cots, cfg)
    torch.cuda.synchronize()
    p_dws, p_dx = core_mlp.sdf_core_bwd_plain(w, x, cots, cfg, "bfloat16")
    _close_rel(dx, p_dx, 2e-2)
    assert len(dws) == len(p_dws)
    for k, p in zip(dws, p_dws):
        assert k.shape == p.shape
        _close_rel(k, p, 2e-2)
    dws2, dx2 = core_mlp.sdf_core_bwd(w, x, cots, cfg)
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))
    assert cuda_lib.launch_counts["sdf_core_bwd"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(45, 32, 32, 3), (361, 256, 256, 256, 256, 3)], ids=["small", "full"])
@pytest.mark.parametrize("n", TRUNK_N)
def test_mlp_recompute_kernels_match_plain(cuda, dims, n):
    """Kernels I and J against the plain trunk and its backward; I equals
    F's output and J equals G at F's stash, bit for bit; J repeats."""
    w, n_layers, x, g = _gpu_trunk_case(cuda, dims, n)
    before = dict(cuda_lib.launch_counts)
    out = core_mlp.mlp_fwd(w, x, n_layers)
    _close(out, core_mlp.mlp_relu_plain(w, x, n_layers, "bfloat16"), 1e-2)
    f_out, zs = core_stash.mlp_stash_fwd(w, x, n_layers)
    assert torch.equal(out, f_out)
    dws, dx = core_mlp.mlp_bwd(w, x, g, n_layers)
    torch.cuda.synchronize()
    cols = core_stash.mlp_stash_columns(core_mlp.pack_mlp(w, n_layers))
    z_dws, z_dx = core_mlp.mlp_relu_bwd_plain(w, x, g, n_layers, "bfloat16",
                                              zs=[z.float() for z in core_stash.split_stash(zs, cols)])
    p_dws, p_dx = core_mlp.mlp_relu_bwd_plain(w, x, g, n_layers, "bfloat16")
    for k, z, p in zip((dx, *dws), (z_dx, *z_dws), (p_dx, *p_dws)):
        assert k.shape == p.shape
        _close_rel(k, z, 2e-2)
        assert (k - p).norm().item() <= 2e-2 * p.norm().item() + 1e-7
    g_dws, g_dx = core_stash.mlp_stash_bwd(w, x, zs, g, n_layers)
    assert torch.equal(dx, g_dx) and all(torch.equal(a, b) for a, b in zip(dws, g_dws))
    dws2, dx2 = core_mlp.mlp_bwd(w, x, g, n_layers)
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in ("mlp_fwd", "mlp_bwd")} == {"mlp_fwd": 1, "mlp_bwd": 2}


@pytest.mark.gpu
def test_backward_kernels_repeat_at_full_width(cuda):
    """At one train step's 65,536 points and full width: kernels E, G, H and
    J give the same gradients bit for bit on a second run (fixed-order sums,
    no atomics), and J equals G at F's stash."""
    from nrhints_torch.fields.mlp import torch_default_linear_init

    cfg = SDFNetConfig()
    w, x, cots = _gpu_sdf_case(cuda, cfg, 65536)
    stash = core_stash.sdf_stash_fwd(w, x, cfg)[3]
    for run in (lambda: core_stash.sdf_stash_bwd(w, x, stash, cots, cfg),
                lambda: core_mlp.sdf_core_bwd(w, x, cots, cfg)):
        (dws, dx), (dws2, dx2) = run(), run()
        assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))
    dims = (361, 256, 256, 256, 256, 3)
    gen = torch.Generator().manual_seed(1)
    tw = []
    for i in range(len(dims) - 1):
        tw += list(torch_default_linear_init(gen, dims[i], dims[i + 1], cuda))
    rng = np.random.default_rng(6)
    xt = torch.tensor(rng.normal(size=(65536, dims[0])).astype(np.float32), device=cuda)
    g = torch.tensor(rng.normal(size=(65536, 3)).astype(np.float32), device=cuda)
    _, zs = core_stash.mlp_stash_fwd(tw, xt, 4)
    g_dws, g_dx = core_stash.mlp_stash_bwd(tw, xt, zs, g, 4)
    g2_dws, g2_dx = core_stash.mlp_stash_bwd(tw, xt, zs, g, 4)
    j_dws, j_dx = core_mlp.mlp_bwd(tw, xt, g, 4)
    j2_dws, j2_dx = core_mlp.mlp_bwd(tw, xt, g, 4)
    for a_dws, a_dx, b_dws, b_dx in ((g_dws, g_dx, g2_dws, g2_dx), (j_dws, j_dx, j2_dws, j2_dx),
                                     (j_dws, j_dx, g_dws, g_dx)):
        assert torch.equal(a_dx, b_dx) and all(torch.equal(a, b) for a, b in zip(a_dws, b_dws))


@pytest.mark.gpu
def test_eval_trunk_pallas_card_matches_cpu(cuda):
    """The eval render under eval_reflectance_impl="pallas" (kernel I for
    the trunk, never F) on the card against the CPU, at 2e-2 as the f32
    trunk's render above."""
    from nrhints_torch.core.structs import RayBundle
    from nrhints_torch.fields.reflectance import ReflectanceNetConfig
    from nrhints_torch.render.renderer import ModelConfig, RendererConfig, init_model_params, render_rays

    cfg = ModelConfig(sdf_network=SMALL, reflectance_network=ReflectanceNetConfig(n_layers=2, d_hidden=32),
                      renderer=RendererConfig(eval_reflectance_impl="pallas"))
    params = init_model_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    o, d, z0 = _rays("cpu")
    pl_ = torch.tensor([[1.5, 2.5, -1.0]]).expand_as(o).contiguous()
    host = (o, d, pl_, z0[:, :1], z0[:, -1:])
    with torch.no_grad():
        cpu = render_rays(params, cfg, RayBundle(*host))
        before = dict(cuda_lib.launch_counts)
        card = render_rays(_tree_to(params, cuda), cfg, RayBundle(*(t.to(cuda) for t in host)))
    torch.cuda.synchronize()
    delta = {k: cuda_lib.launch_counts[k] - before[k] for k in before}
    assert delta["mlp_fwd"] == 1 and delta["mlp_stash_fwd"] == 0 and delta["sdf_core_fwd"] == 1
    for k in ("rgb", "depth", "visibilities"):
        assert (getattr(card, k).cpu() - getattr(cpu, k)).abs().max().item() <= 2e-2, k


def _assert_z_close(k, p, z0):
    from chip_smoke import Z_NN_SHARE, z_err

    _, _, share, ok = z_err(k, p, z0)
    assert ok and share >= Z_NN_SHARE, (ok, share)


@pytest.mark.gpu
@pytest.mark.parametrize("merge", ["bitonic", "rank"])
@pytest.mark.parametrize("cfg", [SMALL, SDFNetConfig()], ids=["small", "full"])
def test_march_kernels_match_plain(cuda, cfg, merge):
    """Kernels K, L, M and N against their plain versions; M = L(K(.)) and
    N = C(M(.)) bit for bit; one launch each."""
    p = sdf_init(torch.Generator().manual_seed(0), cfg, cuda)
    o, d, z0 = _rays(cuda)
    w = march.march_weights(p, cfg, "bfloat16")
    sdist = torch.full((o.shape[0], 1), 2.0 / 64, device=cuda)
    inv_s, anneal = torch.tensor(64.0, device=cuda), torch.tensor(0.7, device=cuda)
    before = dict(cuda_lib.launch_counts)
    sdf0 = march.march_sweep(z0, o, d, w, cfg)
    z_l = march.march_rounds(z0, sdf0, o, d, w, cfg, merge=merge)
    z_m = march.importance_march(z0, o, d, w, cfg, merge=merge)
    tau = march.shadow_march(z0, o, d, sdist, inv_s, anneal, w, cfg, merge=merge)
    tau_c = march.shadow_final(z_m, o, d, sdist, inv_s, anneal, w, cfg)
    torch.cuda.synchronize()
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in ("march_sweep", "march_rounds", "importance_march",
                                                              "shadow_march", "shadow_final")} == dict.fromkeys(
        ("march_sweep", "march_rounds", "importance_march", "shadow_march", "shadow_final"), 1)
    _close(sdf0, march.march_sweep_plain(z0, o, d, w, cfg), 1e-2)
    from chip_smoke import sweep16

    assert torch.equal(z_l, march._rounds(w, cfg, o, d, z0, sdf0, 4, 16, 64.0, merge, march.round_machinery,
                                          sweep16(o, d, w, cfg)))
    _assert_z_close(z_l, march.march_rounds_plain(z0, sdf0, o, d, w, cfg, merge=merge), z0)
    _assert_z_close(z_m, march.importance_march_plain(z0, o, d, w, cfg, merge=merge), z0)
    _close(tau, march.shadow_march_plain(z0, o, d, sdist, inv_s, anneal, w, cfg, merge=merge), 1e-2)
    assert torch.equal(z_m, z_l)
    assert torch.equal(tau, tau_c)


@pytest.mark.gpu
@pytest.mark.parametrize("merge", ["bitonic", "rank"])
@pytest.mark.parametrize("cfg", [SMALL, SDFNetConfig()], ids=["small", "full"])
@pytest.mark.parametrize("n", SHADOW_B)
def test_shadow_march_on_4ray_blocks(cuda, cfg, merge, n):
    """Kernel N against its plain version and, bit for bit, against kernel C
    after kernel M, at ray counts that fill 4-ray blocks in part; one launch
    of each."""
    p = sdf_init(torch.Generator().manual_seed(0), cfg, cuda)
    o, d, z0 = _rays(cuda, n)
    w = march.march_weights(p, cfg, "bfloat16")
    sdist = torch.full((n, 1), 2.0 / 64, device=cuda)
    inv_s, anneal = torch.tensor(64.0, device=cuda), torch.tensor(0.7, device=cuda)
    before = dict(cuda_lib.launch_counts)
    tau = march.shadow_march(z0, o, d, sdist, inv_s, anneal, w, cfg, merge=merge)
    tau_c = march.shadow_final(march.importance_march(z0, o, d, w, cfg, merge=merge), o, d, sdist, inv_s, anneal, w,
                               cfg)
    torch.cuda.synchronize()
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in ("importance_march", "shadow_march", "shadow_final")} == \
        dict.fromkeys(("importance_march", "shadow_march", "shadow_final"), 1)
    assert tau.shape == (n, 1) and torch.equal(tau, tau_c)
    _close(tau, march.shadow_march_plain(z0, o, d, sdist, inv_s, anneal, w, cfg, merge=merge), 1e-2)


# Ray counts of kernels K, L and M, which run 4 rays per block: one ray (3
# spare rays), 5 (a second block with 3), 510 (a last block with 2) and one
# 512-ray chunk.
FUSED_B = [1, 5, 510, 512]


@pytest.mark.gpu
@pytest.mark.parametrize("merge", ["bitonic", "rank"])
@pytest.mark.parametrize("cfg", [SMALL, SDFNetConfig()], ids=["small", "full"])
@pytest.mark.parametrize("n", FUSED_B)
def test_sweep_and_importance_march_on_4ray_blocks(cuda, cfg, merge, n):
    """Kernels K, L and M on the row engine's 4-ray blocks against their
    plain versions (K's sdf0 at 1e-2, L's and M's z by order-free shares, as
    in test_march_kernels_match_plain), L = B's steps between K's sweeps, M
    = L(K(.)) and N = C(M(.)) bit for bit, at ray counts that fill 4-ray
    blocks in part; one launch of each."""
    p = sdf_init(torch.Generator().manual_seed(0), cfg, cuda)
    o, d, z0 = _rays(cuda, n)
    w = march.march_weights(p, cfg, "bfloat16")
    sdist = torch.full((n, 1), 2.0 / 64, device=cuda)
    inv_s, anneal = torch.tensor(64.0, device=cuda), torch.tensor(0.7, device=cuda)
    names = ("march_sweep", "march_rounds", "importance_march", "shadow_march", "shadow_final")
    before = dict(cuda_lib.launch_counts)
    sdf0 = march.march_sweep(z0, o, d, w, cfg)
    z_l = march.march_rounds(z0, sdf0, o, d, w, cfg, merge=merge)
    z_m = march.importance_march(z0, o, d, w, cfg, merge=merge)
    tau = march.shadow_march(z0, o, d, sdist, inv_s, anneal, w, cfg, merge=merge)
    tau_c = march.shadow_final(z_m, o, d, sdist, inv_s, anneal, w, cfg)
    torch.cuda.synchronize()
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in names} == dict.fromkeys(names, 1)
    assert sdf0.shape == (n, 64) and z_l.shape == z_m.shape == (n, 128)
    _close(sdf0, march.march_sweep_plain(z0, o, d, w, cfg), 1e-2)
    from chip_smoke import sweep16

    assert torch.equal(z_l, march._rounds(w, cfg, o, d, z0, sdf0, 4, 16, 64.0, merge, march.round_machinery,
                                          sweep16(o, d, w, cfg)))
    _assert_z_close(z_l, march.march_rounds_plain(z0, sdf0, o, d, w, cfg, merge=merge), z0)
    _assert_z_close(z_m, march.importance_march_plain(z0, o, d, w, cfg, merge=merge), z0)
    assert torch.equal(z_m, z_l)
    assert torch.equal(tau, tau_c)


@pytest.mark.gpu
def test_round_machinery_rank_matches_bitonic(cuda):
    """Kernel B under merge="rank": z equal to the bitonic network's and to
    the plain rank merge's, the payload to the plain rank merge's."""
    p = sdf_init(torch.Generator().manual_seed(0), SMALL, cuda)
    o, d, z0 = _rays(cuda)
    w = march.march_weights(p, SMALL, "bfloat16")
    z = torch.cat([z0, torch.full_like(z0, march.BIG_Z)], -1)
    sdf = torch.cat([march._mlp_sdf_3d(o[:, None] + d[:, None] * z0[..., None], w, SMALL), torch.zeros_like(z0)], -1)
    new_z = new_sdf = None
    for i in range(5):
        vn = 64 + 16 * i
        args = (z, sdf, o, d, new_z, new_sdf, None if i == 0 else vn - 16, vn if i < 4 else None,
                64.0 * 2**i if i < 4 else None)
        kr = march.round_machinery(*args, merge="rank")
        kb = march.round_machinery(*args)
        pr = march.round_machinery_plain(*args, merge="rank")
        assert torch.equal(kr[1], kb[1]) and torch.equal(kr[1], pr[1])
        if i < 4:
            assert torch.equal(kr[2], pr[2])
            _close(kr[0], pr[0], 1e-5)
            new_z, z, sdf = kr
            new_sdf = march._mlp_sdf_3d(o[:, None] + d[:, None] * new_z[..., None], w, SMALL)


ROUND4 = {
    "monolith": ({"march_sweep_impl": "pallas", "march_rounds_impl": "pallas", "shadow_split": False},
                 {"importance_march": 1, "shadow_march": 1}),
    "split": ({"importance_split": True, "march_sweep_impl": "pallas", "march_rounds_impl": "pallas",
               "march_merge": "rank"}, {"march_sweep": 1, "march_rounds": 1, "importance_march": 1,
                                        "shadow_final": 1}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["monolith", "split"])
def test_render_rays_round4_card_matches_cpu(cuda, route):
    """The eval render under the round-4 march configurations on the card
    against the CPU, at 2e-2 as the shipping render above, with the exact
    launches of one chunk."""
    from nrhints_torch.core.structs import RayBundle
    from nrhints_torch.fields.reflectance import ReflectanceNetConfig
    from nrhints_torch.render.renderer import ModelConfig, RendererConfig, init_model_params, render_rays

    renderer_kw, launches = ROUND4[route]
    cfg = ModelConfig(sdf_network=SMALL, reflectance_network=ReflectanceNetConfig(n_layers=2, d_hidden=32),
                      renderer=RendererConfig(**renderer_kw))
    params = init_model_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    o, d, z0 = _rays("cpu")
    pl_ = torch.tensor([[1.5, 2.5, -1.0]]).expand_as(o).contiguous()
    host = (o, d, pl_, z0[:, :1], z0[:, -1:])
    with torch.no_grad():
        cpu = render_rays(params, cfg, RayBundle(*host))
        before = dict(cuda_lib.launch_counts)
        card = render_rays(_tree_to(params, cuda), cfg, RayBundle(*(t.to(cuda) for t in host)))
    torch.cuda.synchronize()
    expected = {k: 0 for k in cuda_lib.launch_counts}
    expected.update(sdf_core_fwd=1, **launches)
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in before} == expected
    for k in ("rgb", "depth", "visibilities"):
        assert (getattr(card, k).cpu() - getattr(cpu, k)).abs().max().item() <= 2e-2, k


@pytest.mark.gpu
def test_march_wrappers_raise_on_bad_inputs(cuda):
    """Bad inputs raise; f32 march weights reach the f32 instances (values
    against the plain f32 versions, at F32_TOL), weights of another dtype
    raise."""
    p = sdf_init(torch.Generator().manual_seed(0), SMALL, cuda)
    o, d, z0 = _rays(cuda)
    w32, w16 = march.march_weights(p, SMALL, "float32"), march.march_weights(p, SMALL, "bfloat16")
    sdist = torch.full((o.shape[0], 1), 2.0 / 64, device=cuda)
    _close(march.march_sweep(z0, o, d, w32, SMALL), march.march_sweep_plain(z0, o, d, w32, SMALL), F32_TOL["sdf0"])
    _assert_z_close(march.importance_march(z0, o, d, w32, SMALL), march.importance_march_plain(z0, o, d, w32, SMALL),
                    z0)
    _close(march.shadow_march(z0, o, d, sdist, 64.0, 1.0, w32, SMALL),
           march.shadow_march_plain(z0, o, d, sdist, 64.0, 1.0, w32, SMALL), F32_TOL["tau"])
    with pytest.raises(ValueError, match="bf16 or f32"):
        march.march_sweep(z0, o, d, [w.double() for w in w32], SMALL)
    with pytest.raises(NotImplementedError):  # K sweeps 2 to 126 samples a ray
        march.march_sweep(z0[:, :1].contiguous(), o, d, w16, SMALL)
    with pytest.raises(ValueError):  # z0 of 32 samples at 4 rounds of 16
        march.march_rounds(z0[:, :32].contiguous(), z0[:, :32].contiguous(), o, d, w16, SMALL)
    with pytest.raises(ValueError):
        march.march_rounds(z0, z0.double(), o, d, w16, SMALL)
    with pytest.raises(ValueError):
        march.importance_march(z0.t().contiguous().t(), o, d, w16, SMALL)
    with pytest.raises(ValueError):
        march.shadow_march(z0, o, d, sdist[:3], 64.0, 1.0, w16, SMALL)


# The f32 instances of C, K, L, M and N against their plain f32 versions:
# the same f32 products in another summation order (sequential FMAs against
# the card's f32 matmul), so sdf0 differs by a few f32 ulps of the sweep's
# sums; tau passes each sdf through sigmoid(inv_s x) and 127 log factors,
# which multiply such differences by up to inv_s (64 here) and sum them.
F32_TOL = {"sdf0": 1e-5, "tau": 1e-4}


@pytest.mark.gpu
@pytest.mark.parametrize("merge", ["bitonic", "rank"])
@pytest.mark.parametrize("cfg", [SMALL, SDFNetConfig()], ids=["small", "full"])
@pytest.mark.parametrize("n", [1, 5, 130])
def test_march_kernels_f32_match_plain(cuda, cfg, merge, n):
    """The f32 instances (march_dtype="float32") of K, L, M, N and C against
    their plain f32 versions, at ray counts that fill 4-ray blocks in part;
    L = B's steps between K's sweeps, M = L(K(.)) and N = C(M(.)) bit for
    bit, as in bf16; one launch each, counted under the *_f32 names."""
    p = sdf_init(torch.Generator().manual_seed(0), cfg, cuda)
    o, d, z0 = _rays(cuda, n)
    w = march.march_weights(p, cfg, "float32")
    sdist = torch.full((n, 1), 2.0 / 64, device=cuda)
    inv_s, anneal = torch.tensor(64.0, device=cuda), torch.tensor(0.7, device=cuda)
    names = ("march_sweep_f32", "march_rounds_f32", "importance_march_f32", "shadow_march_f32", "shadow_final_f32")
    before = dict(cuda_lib.launch_counts)
    sdf0 = march.march_sweep(z0, o, d, w, cfg)
    z_l = march.march_rounds(z0, sdf0, o, d, w, cfg, merge=merge)
    z_m = march.importance_march(z0, o, d, w, cfg, merge=merge)
    tau = march.shadow_march(z0, o, d, sdist, inv_s, anneal, w, cfg, merge=merge)
    tau_c = march.shadow_final(z_m, o, d, sdist, inv_s, anneal, w, cfg)
    torch.cuda.synchronize()
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in before} == {
        k: int(k in names) for k in before}
    assert sdf0.shape == (n, 64) and z_l.shape == z_m.shape == (n, 128) and tau.shape == (n, 1)
    _close(sdf0, march.march_sweep_plain(z0, o, d, w, cfg), F32_TOL["sdf0"])
    from chip_smoke import sweep16

    assert torch.equal(z_l, march._rounds(w, cfg, o, d, z0, sdf0, 4, 16, 64.0, merge, march.round_machinery,
                                          sweep16(o, d, w, cfg)))
    _assert_z_close(z_m, march.importance_march_plain(z0, o, d, w, cfg, merge=merge), z0)
    assert torch.equal(z_m, z_l)
    assert torch.equal(tau, tau_c)
    _close(tau, march.shadow_march_plain(z0, o, d, sdist, inv_s, anneal, w, cfg, merge=merge), F32_TOL["tau"])
    _close(tau_c, march.shadow_final_plain(z_m, o, d, sdist, inv_s, anneal, w, cfg), F32_TOL["tau"])


# The march kernels' wide instances (C, K, L, M and N above the presets'
# widths, bf16 and f32): the 512-wide nr-hints SDF and the small 288-wide one
# with a 69-wide encoding, at ray counts that fill 4-ray blocks in part.
WIDE_MARCH_CFGS = {"d512": WIDE_CFGS["d512"], "w288": WIDE_CFGS["w288"]}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("merge", ["bitonic", "rank"])
@pytest.mark.parametrize("name", sorted(WIDE_MARCH_CFGS))
@pytest.mark.parametrize("n", [1, 5, 130])
def test_march_kernels_wide_match_plain(cuda, exact_f32, dtype, merge, name, n):
    """The wide instances of K, L, M, N and C at each march dtype against
    their plain versions, at the narrow instances' tolerances (bf16 1e-2,
    f32 F32_TOL; L's and M's z by order-free shares); L = B's steps between
    K's sweeps, M = L(K(.)) and N = C(M(.)) bit for bit; one launch each,
    counted under the *_wide (*_f32_wide) names."""
    cfg = WIDE_MARCH_CFGS[name]
    assert core_mlp.core_class(cfg, with_feat=False) is core_mlp.ROWS_WIDE
    p = sdf_init(torch.Generator().manual_seed(0), cfg, cuda)
    o, d, z0 = _rays(cuda, n)
    w = march.march_weights(p, cfg, dtype)
    sdist = torch.full((n, 1), 2.0 / 64, device=cuda)
    inv_s, anneal = torch.tensor(64.0, device=cuda), torch.tensor(0.7, device=cuda)
    suffix = ("_f32" if dtype == "float32" else "") + "_wide"
    names = tuple(k + suffix for k in ("march_sweep", "march_rounds", "importance_march", "shadow_march",
                                       "shadow_final"))
    tol = F32_TOL if dtype == "float32" else {"sdf0": 1e-2, "tau": 1e-2}
    before = dict(cuda_lib.launch_counts)
    sdf0 = march.march_sweep(z0, o, d, w, cfg)
    z_l = march.march_rounds(z0, sdf0, o, d, w, cfg, merge=merge)
    z_m = march.importance_march(z0, o, d, w, cfg, merge=merge)
    tau = march.shadow_march(z0, o, d, sdist, inv_s, anneal, w, cfg, merge=merge)
    tau_c = march.shadow_final(z_m, o, d, sdist, inv_s, anneal, w, cfg)
    torch.cuda.synchronize()
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in before} == {k: int(k in names) for k in before}
    assert sdf0.shape == (n, 64) and z_l.shape == z_m.shape == (n, 128) and tau.shape == (n, 1)
    _close(sdf0, march.march_sweep_plain(z0, o, d, w, cfg), tol["sdf0"])
    from chip_smoke import sweep16

    assert torch.equal(z_l, march._rounds(w, cfg, o, d, z0, sdf0, 4, 16, 64.0, merge, march.round_machinery,
                                          sweep16(o, d, w, cfg)))
    _assert_z_close(z_l, march.march_rounds_plain(z0, sdf0, o, d, w, cfg, merge=merge), z0)
    _assert_z_close(z_m, march.importance_march_plain(z0, o, d, w, cfg, merge=merge), z0)
    assert torch.equal(z_m, z_l)
    assert torch.equal(tau, tau_c)
    _close(tau, march.shadow_march_plain(z0, o, d, sdist, inv_s, anneal, w, cfg, merge=merge), tol["tau"])
    _close(tau_c, march.shadow_final_plain(z_m, o, d, sdist, inv_s, anneal, w, cfg), tol["tau"])


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) for k, v in tree.items()} if isinstance(tree, dict) else tree.detach().clone().to(dev)


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _small_train(cuda, n_batches=2, **renderer_kw):
    """(config, camera, device batches, a fresh train state on the card) of
    nr-hints-cam-opt at the small widths on a 32 x 32 two-view scene."""
    import dataclasses

    from nrhints_torch.camera.model import CameraModel
    from nrhints_torch.camera.rays import ray_generator_init
    from nrhints_torch.configs.config import nr_hints_cam_opt
    from nrhints_torch.core.structs import PixelBundle
    from nrhints_torch.data.synthetic import scene_views
    from nrhints_torch.fields.reflectance import ReflectanceNetConfig
    from nrhints_torch.render.renderer import init_model_params
    from nrhints_torch.train.step import init_train_state, make_optimizer

    cfg = nr_hints_cam_opt()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, sdf_network=SMALL, reflectance_network=ReflectanceNetConfig(n_layers=2, d_hidden=32),
        batch_size=64, warm_up_end=1, anneal_end=4,
        renderer=dataclasses.replace(cfg.model.renderer, **renderer_kw)))
    sc = scene_views(2, 32, 32)
    cam = CameraModel(32, 32, 16.0, 16.0, sc["focal"], sc["focal"], 0.1, 6.0)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(n_batches):
        img, hh, ww = rng.integers(0, 2, 64), rng.integers(0, 32, 64), rng.integers(0, 32, 64)
        pix = dict(h_indices=hh.astype(np.float32), w_indices=ww.astype(np.float32), poses=sc["poses"][img],
                   pls=sc["pls"][img], img_indices=img, rgb_gt=sc["images"][img, hh, ww])
        batches.append(PixelBundle(**{k: torch.as_tensor(v).to(cuda) for k, v in pix.items()}))
    gen = torch.Generator().manual_seed(0)
    params = {"renderer": init_model_params(cfg.model, gen, device=cuda)}
    params["raygen"], _ = ray_generator_init(gen, cfg.ray_generator, 2, device=cuda)
    params["raygen"]["cam_pose_adjustment"].normal_(0.0, 0.02)
    return cfg, cam, batches, init_train_state(params, make_optimizer(cfg, params))


@pytest.mark.gpu
@pytest.mark.parametrize("renderer_kw", [{}, {"core_backward": "recompute"},
                                         {"march_sweep_impl": "pallas", "march_rounds_impl": "pallas",
                                          "shadow_split": False}],
                         ids=["stash", "recompute", "round4-monolith"])
def test_scan_graph_matches_eager_steps(cuda, renderer_kw):
    """``make_train_step_scan`` at K = 2 on the card: its first call (eager,
    then the capture) and a replay from the same state, batches and
    generators give the params, Adam's state and the last metrics of two
    eager ``make_train_step`` steps bit for bit (cos_anneal_ratio and the
    learning rate change between the steps), and the replay adds the two
    steps' launches to the counts."""
    from chip_smoke import snapshot_err, train_restore, train_snapshot
    from nrhints_torch.train.step import make_train_step, make_train_step_scan, stack_bundles

    cfg, cam, batches, state = _small_train(cuda, **renderer_kw)
    state.step = 2  # inside warm-up (factor 2 / warm_up_end) and anneal, past step 0's zero rate
    start = train_snapshot(state)

    def gens():
        return [torch.Generator(device=cuda).manual_seed(10 + i) for i in range(2)]

    step = make_train_step(cfg, cam, {}, state.optimizer)
    before = dict(cuda_lib.launch_counts)
    for b, g in zip(batches, gens()):
        state, m_eager = step(state, b, g)
    torch.cuda.synchronize()
    per_two = {k: cuda_lib.launch_counts[k] - before[k] for k in before}
    eager = train_snapshot(state)
    scan = make_train_step_scan(cfg, cam, {}, state.optimizer, n_steps=2)
    runs = []
    for _ in range(3):  # the warm-up and capture, then two replays
        train_restore(state, start)
        before = dict(cuda_lib.launch_counts)
        state, m = scan(state, stack_bundles(batches), gens())
        torch.cuda.synchronize()
        runs.append((train_snapshot(state), m, {k: cuda_lib.launch_counts[k] - before[k] for k in before}))
    assert sum(per_two.values()) > 0
    for snap, m, delta in runs:
        assert snapshot_err(snap, eager) == (0.0, "")
        assert snap["step"] == 4 and all(torch.equal(m[k], m_eager[k]) for k in m_eager)
        assert delta == per_two


def _small_view_setup(cuda, **renderer_kw):
    import dataclasses

    from nrhints_torch.camera.model import CameraModel
    from nrhints_torch.configs.config import nr_hints_cam_opt
    from nrhints_torch.core.structs import PixelBundle
    from nrhints_torch.data.synthetic import scene_views
    from nrhints_torch.eval.evaluator import Evaluator
    from nrhints_torch.fields.reflectance import ReflectanceNetConfig
    from nrhints_torch.render.renderer import init_model_params

    cfg = nr_hints_cam_opt()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, sdf_network=SMALL, reflectance_network=ReflectanceNetConfig(n_layers=2, d_hidden=32),
        batch_size=64, inference_chunk_size=100, renderer=dataclasses.replace(cfg.model.renderer, **renderer_kw)))
    sc = scene_views(3, 12, 16)
    cam = CameraModel(12, 16, 8.0, 6.0, sc["focal"], sc["focal"], 0.1, 6.0)
    hh, ww = np.meshgrid(np.arange(12), np.arange(16), indexing="ij")

    def view(i, img_idx=True):
        return PixelBundle(h_indices=torch.tensor(hh, dtype=torch.float32),
                           w_indices=torch.tensor(ww, dtype=torch.float32),
                           poses=torch.tensor(np.broadcast_to(sc["poses"][i], (12, 16, 4, 4)).copy()),
                           pls=torch.tensor(np.broadcast_to(sc["pls"][i], (12, 16, 3)).copy()),
                           img_indices=torch.full((12, 16), i) if img_idx else None,
                           rgb_gt=torch.tensor(sc["images"][i]))

    params = {"renderer": init_model_params(cfg.model, torch.Generator().manual_seed(0), device=cuda),
              "raygen": {"cam_pose_adjustment": torch.randn(3, 6, device=cuda) * 0.02}}
    return Evaluator(cfg, cam, {}, device=cuda), params, view


@pytest.mark.gpu
def test_view_graph_matches_eager_sweep(cuda):
    """``render_image`` on the card (the first view of a key eager, then
    captured; later views replayed on new poses, lights and image indices)
    gives the eager sweep's images bit for bit, on the device-built grid
    with and without an image index and on a shuffled bundle, and counts
    one view's launches per view."""
    ev, params, view = _small_view_setup(cuda)
    perm = torch.randperm(12 * 16, generator=torch.Generator().manual_seed(0))

    def shuffle(v):
        return type(v)(**{k: None if t is None else t.reshape(12 * 16, *t.shape[2:])[perm].reshape(t.shape)
                          for k, t in vars(v).items()})

    for make in (view, lambda i: view(i, img_idx=False), lambda i: shuffle(view(i))):
        counts = []
        for i in (0, 1, 2, 1):
            pixels = make(i)
            ref = ev._render_eager(params, pixels)
            before = dict(cuda_lib.launch_counts)
            out = ev._render_graph(params, pixels)
            torch.cuda.synchronize()
            counts.append({k: cuda_lib.launch_counts[k] - before[k] for k in before})
            assert sorted(out) == sorted(ref) and all(torch.equal(out[k], ref[k]) for k in ref), i
        assert all(c == counts[0] for c in counts) and counts[0]["sdf_core_fwd"] == 2
        img = ev.render_image(params, make(0))
        assert img["rgb"].shape == (12, 16, 3) and np.isfinite(img["rgb"]).all()


@pytest.mark.gpu
def test_registration_graph_matches_eager(cuda):
    """``register_view`` on the card (one captured step replayed) against
    ``_register_view_eager`` (the same step and capturable Adam, eagerly),
    from the same generator: the registered pose deltas bit for bit, for a
    first view (eager step, capture, replays) and a second (replays only,
    on new parameters), with ``pixel_draws`` too; D and E once a step."""
    ev, params, view = _small_view_setup(cuda)
    for i, shift in ((1, 0.0), (2, 0.01)):
        p = {"renderer": params["renderer"],
             "raygen": {"cam_pose_adjustment": params["raygen"]["cam_pose_adjustment"] + shift}}
        ref = ev._register_view_eager(p, view(i), steps=4)
        before = dict(cuda_lib.launch_counts)
        out = ev.register_view(p, view(i), steps=4)
        delta = {k: cuda_lib.launch_counts[k] - before[k] for k in before}
        assert torch.equal(out["raygen"]["cam_pose_adjustment"], ref["raygen"]["cam_pose_adjustment"])
        assert not torch.equal(out["raygen"]["cam_pose_adjustment"], p["raygen"]["cam_pose_adjustment"])
        assert delta["sdf_stash_fwd"] == delta["sdf_stash_bwd"] == 4 and delta["mlp_stash_fwd"] == 0
    draws = [(torch.randint(0, 12, (64,)), torch.randint(0, 16, (64,))) for _ in range(3)]
    a = ev.register_view(params, view(0), steps=3, pixel_draws=draws)["raygen"]["cam_pose_adjustment"]
    b = ev._register_view_eager(params, view(0), steps=3, pixel_draws=draws)["raygen"]["cam_pose_adjustment"]
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [SMALL, SDFNetConfig()], ids=["small", "full"])
def test_sdf_stash_bwd_without_weight_gradients(cuda, cfg):
    """Kernel E with ``need_dw=False`` (registration) gives the full
    backward's dx bit for bit and launches no dW pass."""
    sp = sdf_init(torch.Generator().manual_seed(0), cfg, cuda)
    w = core_mlp.materialize_sdf_weights_full(sp, cfg)
    x = torch.randn((1000, 3), generator=torch.Generator().manual_seed(1)).to(cuda) * 0.4
    _, _, _, stash = core_stash.sdf_stash_fwd(w, x, cfg)
    g = torch.Generator().manual_seed(2)
    cots = tuple(torch.randn(s, generator=g).to(cuda) for s in ((1000,), (1000, cfg.d_out_feat), (1000, 3)))
    dws, dx = core_stash.sdf_stash_bwd(w, x, stash, cots, cfg)
    none, dx_only = core_stash.sdf_stash_bwd(w, x, stash, cots, cfg, need_dw=False)
    torch.cuda.synchronize()
    assert none is None and dws is not None and torch.equal(dx_only, dx)


# The SDF core's f32 instances.  (compute, stash) of D and E: both f32, f32
# operands with the shipping bf16 stash (JAX's fused_sdf_value_feat_grad at
# compute_dtype="float32"), and bf16 operands with an f32 stash.
F32_COMBOS = [("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "float32")]
# Point counts: one point, a ragged 64-point block, and several dW row
# chunks with a ragged last block.
F32_N = [1, 65, 4161]


def _tols(compute, stash):
    """(output tol, stash tol, gradient tol) of an instance against its
    plain version (see the module's docstring)."""
    if compute == "bfloat16":
        return 1e-2, 1e-2, 2e-2
    return 1e-5, 1e-5 if stash == "float32" else 1e-2, 1e-4


@pytest.fixture
def exact_f32(cuda):
    """f32 matmuls in full f32 on the card for the plain versions."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [SMALL, SDFNetConfig()], ids=["small", "full"])
@pytest.mark.parametrize("n", F32_N)
def test_sdf_core_f32_kernels_match_plain(exact_f32, cfg, n):
    """A's and H's f32 instances against sdf_core_plain and
    sdf_core_bwd_plain at "float32"; H repeats bit for bit; one launch
    each, counted under sdf_core_fwd_f32 and sdf_core_bwd_f32."""
    w, x, cots = _gpu_sdf_case(exact_f32, cfg, n)
    before = dict(cuda_lib.launch_counts)
    out = core_mlp.sdf_core_fwd(w, x, cfg, compute_dtype="float32")
    for k, p in zip(out, core_mlp.sdf_core_plain(w, x, cfg, "float32")):
        _close(k, p, 1e-5)
    dws, dx = core_mlp.sdf_core_bwd(w, x, cots, cfg, compute_dtype="float32")
    torch.cuda.synchronize()
    p_dws, p_dx = core_mlp.sdf_core_bwd_plain(w, x, cots, cfg, "float32")
    _close_rel(dx, p_dx, 1e-4)
    for k, p in zip(dws, p_dws):
        assert k.shape == p.shape
        _close_rel(k, p, 1e-4)
    dws2, dx2 = core_mlp.sdf_core_bwd(w, x, cots, cfg, compute_dtype="float32")
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in before if cuda_lib.launch_counts[k] != before[k]} == {
        "sdf_core_fwd_f32": 1, "sdf_core_bwd_f32": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("stash_us", [False, True], ids=["stash", "stash_all"])
@pytest.mark.parametrize("compute,stash_dt", F32_COMBOS)
@pytest.mark.parametrize("cfg", [SMALL, SDFNetConfig()], ids=["small", "full"])
@pytest.mark.parametrize("n", F32_N)
def test_sdf_stash_f32_kernels_match_plain(exact_f32, cfg, n, compute, stash_dt, stash_us):
    """D's instance (or its stash_all variant's) at (compute, stash):
    outputs equal A's at the same compute dtype bit for bit, the stash
    against sdf_core_fwd_hs_plain; E's instance against its plain version
    at D's stash, twice bit for bit, and without its dW passes (dx bit for
    bit); each launch counted under its instance's name."""
    w, x, cots = _gpu_sdf_case(exact_f32, cfg, n)
    out_tol, stash_tol, grad_tol = _tols(compute, stash_dt)
    L = cfg.n_layers
    cols = core_stash.sdf_stash_columns(cfg, stash_us)
    kw = dict(compute_dtype=compute, stash_dtype=stash_dt)
    before = dict(cuda_lib.launch_counts)
    sdf, feat, gx, stash = core_stash.sdf_stash_fwd(w, x, cfg, stash_us=stash_us, **kw)
    assert stash.dtype == core_stash._DTYPES[stash_dt] and stash.shape == (n, core_stash.sdf_stash_width(cfg, stash_us))
    for k, a in zip((sdf, feat, gx), core_mlp.sdf_core_fwd(w, x, cfg, compute_dtype=compute)):
        assert torch.equal(k, a)
    plain = core_stash.sdf_core_fwd_hs_plain(w, x, cfg, compute, stash_dt, return_us=stash_us)
    for k, p in zip((sdf, feat, gx), plain[:3]):
        _close(k, p, out_tol)
    parts = core_stash.split_stash(stash, cols)
    for k, p in zip(parts, [*plain[3], *plain[4], plain[5]] if stash_us else plain[3]):
        _close(k.float(), p.float(), stash_tol)
    dws, dx = core_stash.sdf_stash_bwd(w, x, stash, cots, cfg, stash_us=stash_us, **kw)
    torch.cuda.synchronize()
    if stash_us:
        p_dws, p_dx = core_stash.sdf_core_bwd_stash_all_plain(w, x, parts[:L], parts[L : 2 * L], parts[2 * L], cots,
                                                              cfg, compute)
    else:
        p_dws, p_dx = core_stash.sdf_core_bwd_stash_plain(w, x, parts, cots, cfg, compute)
    _close_rel(dx, p_dx, grad_tol)
    assert len(dws) == len(p_dws)
    for k, p in zip(dws, p_dws):
        assert k.shape == p.shape
        _close_rel(k, p, grad_tol)
    dws2, dx2 = core_stash.sdf_stash_bwd(w, x, stash, cots, cfg, stash_us=stash_us, **kw)
    none, dx_only = core_stash.sdf_stash_bwd(w, x, stash, cots, cfg, need_dw=False, stash_us=stash_us, **kw)
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))
    assert none is None and torch.equal(dx_only, dx)
    fwd, bwd = ("sdf_stash_all_fwd", "sdf_stash_all_bwd") if stash_us else ("sdf_stash_fwd", "sdf_stash_bwd")
    a_name = core_mlp.instance_name("sdf_core_fwd", compute)
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in before if cuda_lib.launch_counts[k] != before[k]} == {
        core_mlp.instance_name(fwd, compute, stash_dt): 1, a_name: 1,
        core_mlp.instance_name(bwd, compute, stash_dt): 3}


def _sdf_leaves(cfg, dev):
    from nrhints_torch.utils import tree_items

    p = sdf_init(torch.Generator().manual_seed(0), cfg, dev)
    leaves = {n: t.detach().clone().requires_grad_(True) for n, t in tree_items(p)}
    params = {}
    for name, t in leaves.items():
        layer, key = name.strip("/").split("/")
        params.setdefault(layer, {})[key] = t
    return params, leaves


# The f32 entry points and the instances each schedule launches.
F32_ENTRY = {
    "recompute": (None, {"sdf_core_fwd_f32": 1, "sdf_core_bwd_f32": 1}),
    "stash": (None, {"sdf_stash_fwd_f32_bf16stash": 1, "sdf_stash_bwd_f32_bf16stash": 1}),
    "stash_all": (None, {"sdf_stash_all_fwd_f32_bf16stash": 1, "sdf_stash_all_bwd_f32_bf16stash": 1}),
    "stash_xla": (None, {"sdf_stash_fwd_f32_bf16stash": 1}),
    "stash f32": (dict(stash_dtype="float32"), {"sdf_stash_fwd_f32": 1, "sdf_stash_bwd_f32": 1}),
    "stash_all f32": (dict(stash_dtype="float32", stash_us=True), {"sdf_stash_all_fwd_f32": 1,
                                                                     "sdf_stash_all_bwd_f32": 1}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(F32_ENTRY))
def test_f32_entry_points_match_autograd(exact_f32, route):
    """fused_sdf_value_feat_grad(compute_dtype="float32") under each
    backward schedule, and fused_sdf_value_feat_grad_stash at an f32 stash,
    against torch.autograd over sdf_core_plain(..., "float32") (the eikonal
    term's second order included): outputs 1e-5, the weight-norm leaves'
    and x's gradients 1e-4 of scale (2e-2, the bf16 stash's tolerance,
    where the stash is bf16: the backward reads the h_i rounded to bf16);
    the f32 instances' launches, and no other kernel's."""
    cfg = SMALL
    stash_kw, want = F32_ENTRY[route]
    params, leaves = _sdf_leaves(cfg, exact_f32)
    rng = np.random.default_rng(9)
    x = torch.tensor(rng.normal(size=(300, 3)).astype(np.float32) * 0.5, device=exact_f32, requires_grad=True)
    cots = [torch.tensor(rng.normal(size=s).astype(np.float32), device=exact_f32)
            for s in ((300,), (300, cfg.d_out_feat), (300, 3))]
    before = dict(cuda_lib.launch_counts)
    if stash_kw is None:
        out = core_mlp.fused_sdf_value_feat_grad(params, cfg, x, compute_dtype="float32", backward=route)
    else:
        out = core_stash.fused_sdf_value_feat_grad_stash(params, cfg, x, compute_dtype="float32", **stash_kw)
    grads = torch.autograd.grad(out, [x, *leaves.values()], cots)
    torch.cuda.synchronize()
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in before if cuda_lib.launch_counts[k] != before[k]} == want
    ref_out = core_mlp.sdf_core_plain(core_mlp.materialize_sdf_weights_full(params, cfg), x, cfg, "float32")
    ref = torch.autograd.grad(ref_out, [x, *leaves.values()], cots)
    for k, p in zip(out, ref_out):
        _close(k, p, 1e-5)
    tol = 1e-4 if stash_kw is not None or route == "recompute" else 2e-2
    for k, p in zip(grads, ref):
        _close_rel(k, p, tol)


# The trunk's f32 instances: F and G at each F32_COMBOS pair, I and J at f32.
TRUNK_DIMS = [(45, 32, 32, 3), (361, 256, 256, 256, 256, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("compute,stash_dt", F32_COMBOS)
@pytest.mark.parametrize("dims", TRUNK_DIMS, ids=["small", "full"])
@pytest.mark.parametrize("n", [1, 65, 1000])
def test_mlp_stash_f32_kernels_match_plain(exact_f32, dims, n, compute, stash_dt):
    """F's instance at (compute, stash) against mlp_relu_fwd_zs_plain, G's
    against mlp_relu_bwd_stash_plain at F's stash, twice bit for bit; bf16
    operands with an f32 stash give the (bf16, bf16) pair's output and
    gradients bit for bit, and a stash that rounds to its stash; each
    launch counted under its instance's name."""
    w, n_layers, x, g = _gpu_trunk_case(exact_f32, dims, n)
    out_tol, stash_tol, grad_tol = _tols(compute, stash_dt)
    kw = dict(compute_dtype=compute, stash_dtype=stash_dt)
    cols = core_stash.mlp_stash_columns(core_mlp.pack_mlp(w, n_layers))
    before = dict(cuda_lib.launch_counts)
    out, zs = core_stash.mlp_stash_fwd(w, x, n_layers, **kw)
    assert zs.dtype == core_stash._DTYPES[stash_dt]
    p_out, p_zs = core_stash.mlp_relu_fwd_zs_plain(w, x, n_layers, compute, stash_dt)
    _close(out, p_out, out_tol)
    for k, p in zip(core_stash.split_stash(zs, cols), p_zs):
        _close(k.float(), p.float(), stash_tol)
    dws, dx = core_stash.mlp_stash_bwd(w, x, zs, g, n_layers, **kw)
    torch.cuda.synchronize()
    p_dws, p_dx = core_stash.mlp_relu_bwd_stash_plain(w, x, core_stash.split_stash(zs, cols), g, n_layers, compute)
    _close_rel(dx, p_dx, grad_tol)
    for k, p in zip(dws, p_dws):
        assert k.shape == p.shape
        _close_rel(k, p, grad_tol)
    dws2, dx2 = core_stash.mlp_stash_bwd(w, x, zs, g, n_layers, **kw)
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))
    want = {core_mlp.instance_name("mlp_stash_fwd", compute, stash_dt): 1,
            core_mlp.instance_name("mlp_stash_bwd", compute, stash_dt): 2}
    if compute == "bfloat16":
        b_out, b_zs = core_stash.mlp_stash_fwd(w, x, n_layers)
        b_dws, b_dx = core_stash.mlp_stash_bwd(w, x, b_zs, g, n_layers)
        assert torch.equal(out, b_out) and torch.equal(zs.to(torch.bfloat16), b_zs)
        assert torch.equal(dx, b_dx) and all(torch.equal(a, b) for a, b in zip(dws, b_dws))
        want.update(mlp_stash_fwd=1, mlp_stash_bwd=1)
    torch.cuda.synchronize()
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in before if cuda_lib.launch_counts[k] != before[k]} == want


@pytest.mark.gpu
@pytest.mark.parametrize("dims", TRUNK_DIMS, ids=["small", "full"])
@pytest.mark.parametrize("n", [1, 65, 1000])
def test_mlp_recompute_f32_kernels_match_plain(exact_f32, dims, n):
    """I's and J's f32 instances against mlp_relu_plain and
    mlp_relu_bwd_plain at "float32": I equals F's (f32, f32) output, J's
    gradients G's at F's f32 stash, bit for bit; J repeats; J entry by
    entry against the plain backward at F's z_i and by the relative norm
    against the wholly plain backward."""
    w, n_layers, x, g = _gpu_trunk_case(exact_f32, dims, n)
    kw = dict(compute_dtype="float32", stash_dtype="float32")
    before = dict(cuda_lib.launch_counts)
    out = core_mlp.mlp_fwd(w, x, n_layers, compute_dtype="float32")
    _close(out, core_mlp.mlp_relu_plain(w, x, n_layers, "float32"), 1e-5)
    f_out, zs = core_stash.mlp_stash_fwd(w, x, n_layers, **kw)
    assert torch.equal(out, f_out)
    dws, dx = core_mlp.mlp_bwd(w, x, g, n_layers, compute_dtype="float32")
    torch.cuda.synchronize()
    cols = core_stash.mlp_stash_columns(core_mlp.pack_mlp(w, n_layers))
    z_dws, z_dx = core_mlp.mlp_relu_bwd_plain(w, x, g, n_layers, "float32", zs=core_stash.split_stash(zs, cols))
    p_dws, p_dx = core_mlp.mlp_relu_bwd_plain(w, x, g, n_layers, "float32")
    for k, z, p in zip((dx, *dws), (z_dx, *z_dws), (p_dx, *p_dws)):
        assert k.shape == p.shape
        _close_rel(k, z, 1e-4)
        assert (k - p).norm().item() <= 1e-4 * p.norm().item() + 1e-7
    g_dws, g_dx = core_stash.mlp_stash_bwd(w, x, zs, g, n_layers, **kw)
    assert torch.equal(dx, g_dx) and all(torch.equal(a, b) for a, b in zip(dws, g_dws))
    dws2, dx2 = core_mlp.mlp_bwd(w, x, g, n_layers, compute_dtype="float32")
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))
    torch.cuda.synchronize()
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in before if cuda_lib.launch_counts[k] != before[k]} == {
        "mlp_fwd_f32": 1, "mlp_stash_fwd_f32": 1, "mlp_bwd_f32": 2, "mlp_stash_bwd_f32": 1}


# The trunk's f32 entry points and the instances each launches.
TRUNK_F32_ENTRY = {
    "recompute": (None, {"mlp_fwd_f32": 1, "mlp_bwd_f32": 1}),
    "stash": (None, {"mlp_stash_fwd_f32_bf16stash": 1, "mlp_stash_bwd_f32_bf16stash": 1}),
    "stash_all": (None, {"mlp_stash_fwd_f32_bf16stash": 1, "mlp_stash_bwd_f32_bf16stash": 1}),
    "stash_xla": (None, {"mlp_stash_fwd_f32_bf16stash": 1}),
    "stash f32": (dict(stash_dtype="float32"), {"mlp_stash_fwd_f32": 1, "mlp_stash_bwd_f32": 1}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(TRUNK_F32_ENTRY))
def test_trunk_f32_entry_points_match_autograd(exact_f32, route):
    """fused_mlp_apply(compute_dtype="float32") under each backward schedule
    and fused_mlp_apply_stash at an f32 stash against torch.autograd over
    mlp_relu_plain(..., "float32"): output 1e-5, the weight-norm leaves' and
    x's gradients 1e-4 of scale (2e-2 where the stash is bf16); the f32
    instances' launches, and no other kernel's."""
    from nrhints_torch.fields.mlp import torch_default_linear_init, weight_norm_params
    from nrhints_torch.utils import tree_items

    gen = torch.Generator().manual_seed(2)
    dims = (45, 32, 32, 3)
    params = {f"lin{i}": weight_norm_params(*torch_default_linear_init(gen, dims[i], dims[i + 1], exact_f32))
              for i in range(3)}
    leaves = {n: t.detach().clone().requires_grad_(True) for n, t in tree_items(params)}
    params = {}
    for name, t in leaves.items():
        layer, key = name.strip("/").split("/")
        params.setdefault(layer, {})[key] = t
    stash_kw, want = TRUNK_F32_ENTRY[route]
    rng = np.random.default_rng(9)
    x = torch.tensor(rng.normal(size=(300, 45)).astype(np.float32), device=exact_f32, requires_grad=True)
    cot = torch.tensor(rng.normal(size=(300, 3)).astype(np.float32), device=exact_f32)
    before = dict(cuda_lib.launch_counts)
    if stash_kw is None:
        out = core_mlp.fused_mlp_apply(params, 2, x, compute_dtype="float32", backward=route)
    else:
        out = core_stash.fused_mlp_apply_stash(params, 2, x, compute_dtype="float32", **stash_kw)
    grads = torch.autograd.grad(out, [x, *leaves.values()], cot)
    torch.cuda.synchronize()
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in before if cuda_lib.launch_counts[k] != before[k]} == want
    ref_out = core_mlp.mlp_relu_plain(core_mlp.materialize_mlp_weights(params, 2), x, 2, "float32")
    ref = torch.autograd.grad(ref_out, [x, *leaves.values()], cot)
    _close(out, ref_out, 1e-5)
    tol = 1e-4 if stash_kw is not None or route == "recompute" else 2e-2
    for k, p in zip(grads, ref):
        _close_rel(k, p, tol)


# The trunk's wide instances: (kernel pair, compute dtype, stash dtype), F
# and G at every pair, I and J at each operand dtype; at the 512-wide
# model's trunk (617 -> 4 x 512 -> 3) and a small one whose padded input
# alone is wide (400 -> 2 x 32 -> 3); 31 and 33 points sit on the edges of
# one and two 32-point blocks.
WIDE_TRUNK_CASES = [("stash", c, s) for c, s in [("bfloat16", "bfloat16")] + F32_COMBOS] + [
    ("recompute", "bfloat16", "bfloat16"), ("recompute", "float32", "float32")]
WIDE_TRUNK_DIMS = {"d512": (617, 512, 512, 512, 512, 3), "in400": (400, 32, 32, 3)}


@pytest.mark.gpu
@pytest.mark.parametrize("kernels,compute,stash_dt", WIDE_TRUNK_CASES)
@pytest.mark.parametrize("dims", sorted(WIDE_TRUNK_DIMS))
@pytest.mark.parametrize("n", [1, 31, 33, 1000])
def test_trunk_kernels_wide_match_plain(exact_f32, kernels, compute, stash_dt, dims, n):
    """The trunk's wide instances against their plain versions: F's at
    (compute, stash) against mlp_relu_fwd_zs_plain and G's against
    mlp_relu_bwd_stash_plain at F's stash, G twice bit for bit; or I's
    against mlp_relu_plain (I = F bit for bit) and J's entry by entry at F's
    z_i and by the norm against the wholly plain backward (J = G at F's
    stash, J repeats, bit for bit); each launch counted under its wide
    instance's name.  The wholly plain backward recomputes the z_i in its
    own summation order, and a z_i within rounding of 0 takes the other side
    of the ReLU there, which moves that point's dx by a whole unit's share:
    at 2,048 z_i a point, one such flipped point moved dx's norm by 2.5e-2
    among 33 points (bf16) and by 1.6e-3 among 1,000 (f32), the other
    points' dx by 2.0e-6 and 6.7e-7.  So dx is held to it by the
    norm over the points whose masks agree with F's, and the weight
    gradients, sums over every point, entry by entry at F's z_i only."""
    w, n_layers, x, g = _gpu_trunk_case(exact_f32, WIDE_TRUNK_DIMS[dims], n)
    out_tol, stash_tol, grad_tol = _tols(compute, stash_dt)
    kw = dict(compute_dtype=compute, stash_dtype=stash_dt)
    pk = core_mlp.pack_mlp(w, n_layers)
    assert pk["cls"] is core_mlp.TRUNK_WIDE
    cols = core_stash.mlp_stash_columns(pk)
    before = dict(cuda_lib.launch_counts)
    out, zs = core_stash.mlp_stash_fwd(w, x, n_layers, **kw)
    if kernels == "stash":
        p_out, p_zs = core_stash.mlp_relu_fwd_zs_plain(w, x, n_layers, compute, stash_dt)
        _close(out, p_out, out_tol)
        for k, p in zip(core_stash.split_stash(zs, cols), p_zs):
            _close(k.float(), p.float(), stash_tol)
        dws, dx = core_stash.mlp_stash_bwd(w, x, zs, g, n_layers, **kw)
        torch.cuda.synchronize()
        p_dws, p_dx = core_stash.mlp_relu_bwd_stash_plain(w, x, core_stash.split_stash(zs, cols), g, n_layers,
                                                          compute)
        for k, p in zip((dx, *dws), (p_dx, *p_dws)):
            assert k.shape == p.shape
            _close_rel(k, p, grad_tol)
        dws2, dx2 = core_stash.mlp_stash_bwd(w, x, zs, g, n_layers, **kw)
        assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))
        want = {core_mlp.instance_name("mlp_stash_fwd", compute, stash_dt) + "_wide": 1,
                core_mlp.instance_name("mlp_stash_bwd", compute, stash_dt) + "_wide": 2}
    else:
        i_out = core_mlp.mlp_fwd(w, x, n_layers, compute_dtype=compute)
        assert torch.equal(i_out, out)
        _close(i_out, core_mlp.mlp_relu_plain(w, x, n_layers, compute), out_tol)
        dws, dx = core_mlp.mlp_bwd(w, x, g, n_layers, compute_dtype=compute)
        torch.cuda.synchronize()
        f_z = [z.float() for z in core_stash.split_stash(zs, cols)]
        z_dws, z_dx = core_mlp.mlp_relu_bwd_plain(w, x, g, n_layers, compute, zs=f_z)
        for k, z in zip((dx, *dws), (z_dx, *z_dws)):
            assert k.shape == z.shape
            _close_rel(k, z, grad_tol)
        _, p_zs = core_mlp.mlp_relu_plain(w, x, n_layers, compute, return_zs=True)
        agree = torch.stack([((a > 0) == (b > 0)).all(1) for a, b in zip(f_z, p_zs)]).all(0)
        p_dx = core_mlp.mlp_relu_bwd_plain(w, x, g, n_layers, compute)[1][agree]
        assert (dx[agree] - p_dx).norm().item() <= grad_tol * p_dx.norm().item() + 1e-7
        g_dws, g_dx = core_stash.mlp_stash_bwd(w, x, zs, g, n_layers, **kw)
        assert torch.equal(dx, g_dx) and all(torch.equal(a, b) for a, b in zip(dws, g_dws))
        dws2, dx2 = core_mlp.mlp_bwd(w, x, g, n_layers, compute_dtype=compute)
        assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))
        sfx = "_f32" if compute == "float32" else ""
        want = {f"mlp_stash_fwd{sfx}_wide": 1, f"mlp_stash_bwd{sfx}_wide": 1, f"mlp_fwd{sfx}_wide": 1,
                f"mlp_bwd{sfx}_wide": 2}
    torch.cuda.synchronize()
    assert {k: cuda_lib.launch_counts[k] - before[k] for k in before if cuda_lib.launch_counts[k] != before[k]} == want


@pytest.mark.gpu
def test_trunk_wide_limits_raise_before_launch(cuda):
    """Beyond the trunk's wide instances (hidden 528, or a padded input
    above 640) every trunk wrapper raises NotImplementedError naming item
    15 and launches nothing."""
    before = dict(cuda_lib.launch_counts)
    for dims in ((45, 528, 3), (641, 32, 3)):
        w, n_layers, x, g = _gpu_trunk_case(cuda, dims, 40)
        for call in (lambda: core_mlp.mlp_fwd(w, x, n_layers), lambda: core_mlp.mlp_bwd(w, x, g, n_layers),
                     lambda: core_stash.mlp_stash_fwd(w, x, n_layers)):
            with pytest.raises(NotImplementedError, match="item 15"):
                call()
    torch.cuda.synchronize()
    assert dict(cuda_lib.launch_counts) == before


# March geometries other than 64 + 4 x 16 (rounds, n_new): the run-time
# geometry instances of B, K, L, M and N (B keeps its n_new = 16 instance at
# 3 x 16, K its n0 = 64 one at 2 x 32, 8 x 8 and 1 x 64), at ray counts
# that fill 4-ray blocks in part.
GEOMETRIES = [(2, 32), (8, 8), (3, 16), (5, 12), (1, 64), (1, 126)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("n", [5, 512])
def test_march_geometry_kernels_match_plain(cuda, dtype, geometry, n):
    """Kernels K, L, M and N at another geometry against their plain
    versions (as test_march_kernels_match_plain holds them), L = B's steps
    between K's sweeps, M = L(K(.)) and N = C(M(.)) bit for bit under both
    merges (5 x 12 and 1 x 126: bitonic alone), B's merges equal to the plain
    ones; one launch of each run-time geometry instance."""
    rounds, n_new = geometry
    n0 = 128 - rounds * n_new
    cfg = SDFNetConfig()
    p = sdf_init(torch.Generator().manual_seed(0), cfg, cuda)
    o, d, z64 = _rays(cuda, n)
    z0 = (z64[:, :1] + (z64[:, -1:] - z64[:, :1]) * torch.linspace(0, 1, n0, device=cuda)[None]).contiguous()
    w = march.march_weights(p, cfg, dtype)
    sdist = torch.full((n, 1), 2.0 / 64, device=cuda)
    inv_s, anneal = torch.tensor(64.0, device=cuda), torch.tensor(0.7, device=cuda)
    sfx = "_f32" if dtype == "float32" else ""
    tol = 1e-5 if dtype == "float32" else 1e-2
    sweep = lambda new_z, *_: march.march_sweep(new_z.contiguous(), o, d, w, cfg)  # noqa: E731
    for merge in ("bitonic", "rank") if n_new & (n_new - 1) == 0 else ("bitonic",):
        kw = dict(rounds=rounds, n_new=n_new, merge=merge)
        before = dict(cuda_lib.launch_counts)
        sdf0 = march.march_sweep(z0, o, d, w, cfg)
        z_l = march.march_rounds(z0, sdf0, o, d, w, cfg, **kw)
        z_m = march.importance_march(z0, o, d, w, cfg, **kw)
        tau = march.shadow_march(z0, o, d, sdist, inv_s, anneal, w, cfg, **kw)
        torch.cuda.synchronize()
        names = [f"{k}{sfx}_geom" for k in ("march_rounds", "importance_march", "shadow_march")]
        names.append(f"march_sweep{sfx}" + ("" if n0 == 64 else "_geom"))  # K's compile-time instance takes n0 = 64
        assert {k: cuda_lib.launch_counts[k] - before[k] for k in names} == dict.fromkeys(names, 1)
        assert sdf0.shape == (n, n0) and z_l.shape == z_m.shape == (n, 128) and tau.shape == (n, 1)
        _close(sdf0, march.march_sweep_plain(z0, o, d, w, cfg), tol)
        z_bk = march._rounds(w, cfg, o, d, z0, sdf0, rounds, n_new, 64.0, merge, march.round_machinery, sweep)
        assert torch.equal(z_l, z_bk)
        _assert_z_close(z_l, march.march_rounds_plain(z0, sdf0, o, d, w, cfg, **kw), z0)
        _assert_z_close(z_m, march.importance_march_plain(z0, o, d, w, cfg, **kw), z0)
        assert torch.equal(z_m, z_l)
        assert torch.equal(tau, march.shadow_final(z_m, o, d, sdist, inv_s, anneal, w, cfg))
        _close(tau, march.shadow_march_plain(z0, o, d, sdist, inv_s, anneal, w, cfg, **kw), 1e-4 if sfx else 1e-2)
        # B's first step: merge-free draw; its merges, step by step, as the plain ones.
        z = torch.cat([z0, torch.full((n, 128 - n0), march.BIG_Z, device=cuda)], -1)
        s = torch.cat([sdf0, torch.zeros((n, 128 - n0), device=cuda)], -1)
        new_z = new_s = None
        for i in range(rounds - 1):
            args = (z, s, o, d, new_z, new_s, None if i == 0 else n0 + (i - 1) * n_new, n0 + i * n_new, 64.0 * 2**i,
                    n_new, merge)
            k_out, p_out = march.round_machinery(*args), march.round_machinery_plain(*args)
            assert torch.equal(k_out[1], p_out[1]) and torch.equal(k_out[2], p_out[2])
            _close(k_out[0], p_out[0], 1e-4)
            new_z, z, s = k_out
            new_s = sweep(new_z)


@pytest.mark.gpu
def test_march_geometry_out_of_range_raises_before_launch(cuda):
    """Geometries out of the range (n_new = 1, n0 < 2, no round, a rank
    merge of a non-power-of-two n_new) raise NotImplementedError in every
    card wrapper (the entry points: ValueError for the rank merge, as JAX)
    and launch nothing."""
    cfg = SDFNetConfig()
    p = sdf_init(torch.Generator().manual_seed(0), cfg, cuda)
    o, d, _ = _rays(cuda, 8)
    w = march.march_weights(p, cfg, "bfloat16")
    sdist = torch.full((8, 1), 2.0 / 64, device=cuda)
    before = dict(cuda_lib.launch_counts)
    for rounds, n_new, merge in ((10, 1, "bitonic"), (1, 127, "bitonic"), (0, 16, "bitonic"), (5, 12, "rank")):
        z0 = torch.zeros((8, 128 - rounds * n_new), device=cuda)
        with pytest.raises(ValueError if merge == "rank" else NotImplementedError):
            march.fused_importance_z(p, cfg, o, d, z0, rounds=rounds, n_new=n_new, merge=merge)
        with pytest.raises(ValueError if merge == "rank" else NotImplementedError):
            march.fused_shadow_tau(p, cfg, o, d, z0, sdist, 64.0, 0.7, rounds=rounds, n_new=n_new, merge=merge)
        for call in (lambda: march.march_rounds(z0, z0, o, d, w, cfg, rounds=rounds, n_new=n_new, merge=merge),
                     lambda: march.importance_march(z0, o, d, w, cfg, rounds=rounds, n_new=n_new, merge=merge),
                     lambda: march.shadow_march(z0, o, d, sdist, 64.0, 0.7, w, cfg, rounds=rounds, n_new=n_new,
                                                merge=merge)):
            with pytest.raises(NotImplementedError, match="rounds >= 1, n_new >= 2"):
                call()
    torch.cuda.synchronize()
    assert dict(cuda_lib.launch_counts) == before
