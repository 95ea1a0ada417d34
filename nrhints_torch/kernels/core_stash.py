"""The activation-stashing core ops of the train path: kernels D, E, F and
G, their plain versions and their ``torch.autograd.Function``s (port of
``nrhints_tpu/kernels/core_stash.py``).

The SDF op's forward (kernel D, ``csrc/sdf_core.cu``) is kernel A plus a
bf16 stash of every layer's activation h_i.  Its backward (kernel E,
``csrc/sdf_stash.cu``) reads the stash instead of recomputing the forward
chain, and assembles the VJP of (sdf, feat, grad_x sdf) by hand:

    f(ws, x) = Tail(g_enc, x)   with   hs    = Fwd(ws, x)
                                       g_enc = RevSweep(ws, hs)
                                       sdf, feat = Heads(ws, h_L)

The reverse sweep's values u_i and g_enc are recomputed from the stashed h
(the gates are 1 - exp(-100 h)); the VJP of the sweep runs in ascending
layer order and carries the eikonal loss's second-order terms; the heads
and the forward z-chain follow (``sdf_core_bwd_stash_all_ref``'s formulas).
The weight cotangent of layer i is inp_i^T Gz_i + v_i^T t_i, one product
with K = 2N rows that the kernel sums in a second, deterministic pass.

Under ``core_backward="stash_all"`` D's variant also stashes u_i and g_enc
(bf16, as JAX's ``stash_us``), and E's variant reads them where E
recomputes them: its chain runs 2L per-layer products instead of 3L.

The trunk op (kernels F and G, ``csrc/mlp_stash.cu``) stashes the ReLU
pre-activations z_i and back-propagates at them.

Under ``core_backward="stash_xla"`` the ops keep kernels D and F but run
their backward as the plain versions over the whole batch (the JAX package
runs the same program through XLA there).

``fused_sdf_value_feat_grad_stash`` and ``fused_mlp_apply_stash`` are the
two ops' entry points, with JAX's signatures: ``compute_dtype`` (bf16 or
exact f32 dot operands) and ``stash_dtype`` (a bf16 or f32 stash) pick D's
and E's, or F's and G's, instances on the card, each counted under
``core_mlp.instance_name``.

On CPU tensors every wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises.  The layouts and backward launchers shared
with the recompute kernels live in ``core_mlp.py``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from nrhints_torch.fields.sdf import SDFNetConfig, _layer_dims
from nrhints_torch.kernels import cuda_lib
from nrhints_torch.kernels.common import DTYPES as _DTYPES, INV_SQRT2, dot, gate_from_h, torch_dtype
from nrhints_torch.kernels.core_mlp import (
    _launch,
    _round16,
    _wt,
    core_fwd_scratch,
    core_instance,
    core_pack,
    cotangent,
    encode_points,
    materialize_sdf_weights_full,
    materialize_mlp_weights,
    meta_args,
    mlp_bwd_launch,
    mlp_primal,
    mlp_relu_bwd_plain,
    mlp_relu_plain,
    needs_grad,
    per_dim_sum,
    require_cuda,
    reverse_sweep,
    sdf_bwd_launch,
    sdf_core_plain,
    sdf_core_primal,
    trunk_pack,
)
from nrhints_torch.utils import tree_leaves


# ---------------------------------------------------------------------------
# Plain versions


def sdf_core_fwd_hs_plain(weights, x, cfg: SDFNetConfig, compute_dtype="float32", stash_dtype="float32",
                          return_us: bool = False):
    """-> (sdf [N], feat, grad, hs): ``sdf_core_plain``'s outputs and every
    layer's activation h_i [N, out_i] in ``stash_dtype`` (port of
    ``sdf_core_fwd_hs_ref``).  ``return_us`` also returns the reverse
    sweep's values, in ``stash_dtype`` too: every layer's u_i [N, out_i]
    (the g that reaches layer i's gate; u_{L-1} is w_sdf / scale at every
    point) and g_enc [N, d0] -> (sdf, feat, grad, hs, us, g_enc)."""
    sdf, feat, gx, hs, us, g_enc = sdf_core_plain(weights, x, cfg, compute_dtype, return_hs=True)
    dt = _DTYPES[stash_dtype]
    hs = [h.to(dt) for h in hs]
    if return_us:
        return sdf, feat, gx, hs, [u.to(dt) for u in us], g_enc.to(dt)
    return sdf, feat, gx, hs


def sdf_core_bwd_stash_plain(weights, x, hs, cots, cfg: SDFNetConfig, compute_dtype="float32", need_dw=True):
    """Backward at the stashed hs -> (dws, dx), in kernel E's order: the
    reverse sweep's u_i and g_enc recomputed from hs in f32, then
    ``sdf_core_bwd_stash_all_plain`` at them.  ``cots`` = (d sdf [N],
    d feat [N, F], d grad [N, 3]); ``dws`` has the shapes of ``weights``.
    ``need_dw=False`` computes no weight cotangent -> (None, dx), dx the
    same bit for bit (kernel E's chain without its dW passes)."""
    enc, _, _ = encode_points(x, cfg)
    gates = [gate_from_h(h.float()) for h in hs]
    g_enc, us = reverse_sweep(weights, gates, cfg, enc, compute_dtype)
    return sdf_core_bwd_stash_all_plain(weights, x, hs, us, g_enc, cots, cfg, compute_dtype, need_dw)


def sdf_core_bwd_stash_all_plain(weights, x, hs, us, g_enc, cots, cfg: SDFNetConfig, compute_dtype="float32",
                                 need_dw=True):
    """Backward at the stashed hs, u_i and g_enc -> (dws, dx) (port of
    ``sdf_core_bwd_stash_all_ref``): the Tail VJP at g_enc, the VJP of the
    reverse sweep in ascending order at the u_i, the heads, the forward
    z-chain in descending order, the encoding.  Every stash is read as f32;
    the gates are 1 - exp(-100 h).  ``cots`` and ``need_dw`` as
    ``sdf_core_bwd_stash_plain``'s."""
    cd = compute_dtype
    ds, df, dgx = cots
    L, F, d_in, scale = cfg.n_layers, cfg.multi_res, cfg.d_in, cfg.scale
    io, _ = _layer_dims(cfg)
    enc, sin_b, cos_b = encode_points(x, cfg)
    d0 = enc.shape[-1]
    hs = [h.float() for h in hs]
    us = [u.float() for u in us]
    g_enc = g_enc.float()
    gates = [gate_from_h(h) for h in hs]
    L2 = 2 * L

    # 1) Tail VJP: gx = (g_enc[:, :3] + sum_f dS_f 2^f) * scale.
    c = dgx * scale
    cdS = torch.cat([c[:, d : d + 1] * (2.0**f) for d in range(d_in) for f in range(F)], dim=-1)
    g_sin = g_enc[:, d_in : d_in + d_in * F]
    g_cos = g_enc[:, d_in + d_in * F :]
    d_genc = torch.cat([c, cdS * cos_b, -cdS * sin_b], dim=-1)
    d_sin_t = -cdS * g_cos
    d_cos_t = cdS * g_sin

    # 2) VJP of the reverse sweep, ascending.
    dw_rev, dhs_r = [None] * L, [None] * L
    carry = d_genc
    for i in range(L):
        v_r = torch.cat([carry, d_genc], dim=-1) * INV_SQRT2 if i in cfg.skip_in else carry
        if need_dw:
            dw_rev[i] = dot(v_r.t(), us[i] * gates[i], cd)
        dt = dot(v_r, weights[2 * i], cd)
        dhs_r[i] = dt * us[i] * (100.0 * (1.0 - gates[i]))
        carry = dt * gates[i]

    # 3) Heads.
    h_L = hs[L - 1]
    ds_s = ds.reshape(-1, 1) / scale
    dws = [None] * len(weights)
    if need_dw:
        dws[L2] = (torch.sum(carry, dim=0) / scale)[:, None] + dot(h_L.t(), ds_s, cd)
        dws[L2 + 1] = torch.sum(ds_s, dim=0)
        dws[L2 + 2] = dot(h_L.t(), df, cd)
        dws[L2 + 3] = torch.sum(df, dim=0)
    G = dot(ds_s, weights[L2].t(), cd) + dot(df, weights[L2 + 2].t(), cd) + dhs_r[L - 1]

    # 4) The forward z-chain, descending.
    d_enc = torch.zeros_like(enc)
    gprev = None
    for i in reversed(range(L)):
        Gz = G * gates[i]
        if need_dw:
            if i in cfg.skip_in:
                inp = torch.cat([hs[i - 1], enc], dim=-1) * INV_SQRT2
            else:
                inp = enc if i == 0 else hs[i - 1]
            dws[2 * i] = dw_rev[i] + dot(inp.t(), Gz, cd)
            dws[2 * i + 1] = torch.sum(Gz, dim=0)
        gprev = dot(Gz, weights[2 * i].t(), cd)
        if i in cfg.skip_in:
            gprev = gprev * INV_SQRT2
            split = io[i][0] - d0
            d_enc = d_enc + gprev[:, split:]
            gprev = gprev[:, :split]
        if i > 0:
            G = gprev + dhs_r[i - 1]
    d_enc = d_enc + gprev

    # 5) The encoding chain -> dx.
    e_sin = d_enc[:, d_in : d_in + d_in * F] + d_sin_t
    e_cos = d_enc[:, d_in + d_in * F :] + d_cos_t
    dS = e_sin * cos_b - e_cos * sin_b
    dx = (d_enc[:, :d_in] + per_dim_sum(dS, d_in, F)) * scale
    return (tuple(dws) if need_dw else None), dx


def mlp_relu_fwd_zs_plain(weights, x, n_layers: int, compute_dtype="float32", stash_dtype="float32"):
    """-> (out [N, d_out], zs): the ReLU MLP with a linear last layer, and
    its hidden pre-activations z_i in ``stash_dtype`` (port of
    ``mlp_relu_fwd_zs_ref``)."""
    out, zs = mlp_relu_plain(weights, x, n_layers, compute_dtype, return_zs=True)
    return out, [z.to(_DTYPES[stash_dtype]) for z in zs]


def mlp_relu_bwd_stash_plain(weights, x, zs, g, n_layers: int, compute_dtype="float32"):
    """The hand backward of the ReLU MLP at the stashed z_i -> (dws, dx)
    (port of ``mlp_relu_bwd_stash_ref``)."""
    return mlp_relu_bwd_plain(weights, x, g, n_layers, compute_dtype, zs=[z.float() for z in zs])


# ---------------------------------------------------------------------------
# Layouts shared with the kernels


def sdf_stash_columns(cfg: SDFNetConfig, stash_us: bool = False) -> list[tuple[int, int]]:
    """(column offset, width) of each part of kernel D's packed stash [N,
    ``sdf_stash_width``], in columns of the stash's dtype, the same for a
    bf16 and an f32 stash: every layer's h_i at 16-column boundaries (GT
    columns in all, ``gates_total`` of ``pack_sdf_mlp``'s meta); with
    ``stash_us`` (``core_backward="stash_all"``) then every layer's u_i at
    the same offsets plus GT, and g_enc [N, d0] at 2 GT."""
    io, _ = _layer_dims(cfg)
    cols, off = [], 0
    for _, out in io:
        cols.append((off, out))
        off += _round16(out)
    if stash_us:
        cols += [(off + o, w) for o, w in cols] + [(2 * off, cfg.d_encoded)]
    return cols


def sdf_stash_width(cfg: SDFNetConfig, stash_us: bool = False) -> int:
    """Columns of kernel D's packed stash (``csrc/sdf_mlp.cuh::stash_row``)."""
    off, w = sdf_stash_columns(cfg, stash_us)[-1]
    return off + _round16(w)


def split_stash(stash: torch.Tensor, cols) -> list[torch.Tensor]:
    """The packed stash as per-layer views [N, width]."""
    return [stash[:, off : off + w] for off, w in cols]


# ---------------------------------------------------------------------------
# Kernels D and E


def sdf_stash_fwd(weights: Sequence[torch.Tensor], x: torch.Tensor, cfg: SDFNetConfig, pk: dict | None = None,
                  stash_us: bool = False, compute_dtype: str = "bfloat16", stash_dtype: str = "bfloat16"):
    """Kernel D on the card -> (sdf [N], feat [N, F], grad [N, 3], stash
    [N, ``sdf_stash_width``] of ``stash_dtype``): kernel A's outputs at the
    same ``compute_dtype``, bit for bit, and every h_i at its
    ``sdf_stash_columns`` offset; with ``stash_us`` (D's stash_all variant)
    also every u_i and g_enc, rounded to ``stash_dtype``, where the h_i
    columns and the outputs stay plain D's bit for bit; the pack's width
    class picks the block (``core_mlp.core_class``).  Its f32 gates (and
    the huge class's rows) go to a scratch of ``core_mlp.gate_layout``'s
    (and ``row_layout``'s) size, freed when this returns."""
    require_cuda(x, (None, 3), "x")
    n, dev = x.shape[0], x.device
    pk = core_pack(weights, cfg, compute_dtype, pk)
    fn = "sdf_stash_all_fwd" if stash_us else "sdf_stash_fwd"
    name, bits = core_instance(fn, pk, compute_dtype, stash_dtype)
    sdf = torch.empty(n, device=dev)
    feat = torch.empty((n, cfg.d_out_feat), device=dev)
    gx = torch.empty((n, 3), device=dev)
    stash = torch.empty((n, sdf_stash_width(cfg, stash_us)), dtype=torch_dtype(stash_dtype), device=dev)
    if n == 0:
        return sdf, feat, gx, stash
    gates = core_fwd_scratch(n, pk, dev, name)
    _launch(
        cuda_lib.load("sdf_core"), fn, name,
        x.data_ptr(), pk["wpack"].data_ptr(), _wt(pk), pk["bpack"].data_ptr(), pk["w_sdf"].data_ptr(),
        sdf.data_ptr(), feat.data_ptr(), gx.data_ptr(), stash.data_ptr(), gates.data_ptr(), n,
        *meta_args(pk), float(cfg.scale), bits, cuda_lib.stream_ptr(dev),
    )
    return sdf, feat, gx, stash


def sdf_stash_bwd(weights, x, stash, cots, cfg: SDFNetConfig, pk: dict | None = None, need_dw: bool = True,
                  stash_us: bool = False, compute_dtype: str = "bfloat16", stash_dtype: str = "bfloat16"):
    """Kernel E on the card -> (dws, dx) with the shapes of
    ``sdf_core_bwd_stash_plain``'s, at kernel D's stash of ``stash_dtype``
    with dot operands of ``compute_dtype`` (``core_mlp.sdf_bwd_launch``);
    ``need_dw=False`` -> (None, dx) without the dW passes.  ``stash_us``:
    E's stash_all variant, at the u_i and g_enc of D's stash_all variant
    (``sdf_core_bwd_stash_all_plain``'s function)."""
    return sdf_bwd_launch(weights, x, cots, cfg, pk, stash=stash, need_dw=need_dw, stash_us=stash_us,
                          compute_dtype=compute_dtype, stash_dtype=stash_dtype)


# ---------------------------------------------------------------------------
# Kernels F and G


def mlp_stash_columns(pk: dict) -> list[tuple[int, int]]:
    """(column offset, width) of each hidden z_i in kernel F's packed stash."""
    meta = pk["meta"]
    return [(int(meta[4 + 7 * i + 6]), int(meta[4 + 7 * i + 1])) for i in range(int(meta[0]) - 1)]


def mlp_stash_fwd(weights, x: torch.Tensor, n_layers: int, pk: dict | None = None, compute_dtype: str = "bfloat16",
                  stash_dtype: str = "bfloat16"):
    """Kernel F on the card -> (out [N, d_out] f32, zs stash [N, ZT] of
    ``stash_dtype``), on ``core_mlp.trunk_layout``'s blocks of the pack's
    width class, with dot operands of ``compute_dtype`` (bf16, or exact
    f32)."""
    pk = trunk_pack(weights, n_layers, compute_dtype, pk)
    name, bits = core_instance("mlp_stash_fwd", pk, compute_dtype, stash_dtype)
    meta = pk["meta"]
    n, dev = x.shape[0], x.device
    require_cuda(x, (None, int(meta[1])), "x")
    out = torch.empty((n, int(meta[2])), device=dev)
    zs = torch.empty((n, int(meta[3])), dtype=torch_dtype(stash_dtype), device=dev)
    if n > 0:
        _launch(
            cuda_lib.load("mlp_stash"), "mlp_stash_fwd", name,
            x.data_ptr(), pk["wpack"].data_ptr(), pk["bpack"].data_ptr(), out.data_ptr(), zs.data_ptr(), n,
            *meta_args(pk), bits, cuda_lib.stream_ptr(dev),
        )
    return out, zs


def mlp_stash_bwd(weights, x: torch.Tensor, zs: torch.Tensor, g: torch.Tensor, n_layers: int, pk: dict | None = None,
                  compute_dtype: str = "bfloat16", stash_dtype: str = "bfloat16"):
    """Kernel G on the card -> (dws, dx) at kernel F's stash of
    ``stash_dtype``, with dot operands of ``compute_dtype``
    (``core_mlp.mlp_bwd_launch``)."""
    return mlp_bwd_launch(weights, x, g, n_layers, pk, zs=zs, compute_dtype=compute_dtype, stash_dtype=stash_dtype)


# ---------------------------------------------------------------------------
# The autograd ops


class SdfStashFn(torch.autograd.Function):
    """(sdf [N], feat [N, F], grad [N, 3]) with the stash backward: forward
    kernel D and backward kernel E on CUDA tensors, their instances at
    ``compute_dtype`` and ``stash_dtype`` (with ``bwd_impl="xla"``, E's
    plain version on the card's tensors), the plain versions on CPU
    tensors.  ``stash_us`` (``core_backward="stash_all"``) also stashes the
    reverse sweep's u_i and g_enc, and the backward reads them instead of
    recomputing the sweep: D's and E's stash_all variants.  The backward is
    the full first-order VJP of all three outputs; the eikonal loss's
    second-order terms are inside it, so nothing differentiates through it
    again.  Where no weight needs a gradient (registration differentiates
    the rays alone, as JAX's does), it computes dx only: kernel E without
    its dW passes."""

    @staticmethod
    def forward(ctx, cfg, compute_dtype, stash_dtype, bwd_impl, stash_us, x, *weights):
        ctx.cfg, ctx.compute_dtype, ctx.bwd_impl, ctx.stash_us = cfg, compute_dtype, bwd_impl, stash_us
        ctx.stash_dtype = stash_dtype
        if x.device.type == "cpu":
            out = sdf_core_fwd_hs_plain(weights, x, cfg, compute_dtype, stash_dtype, return_us=stash_us)
            sdf, feat, gx, hs = out[:4]
            stash = [*hs, *out[4], out[5]] if stash_us else hs
            ctx.pk = None
        else:
            ctx.pk = core_pack([w.detach() for w in weights], cfg, compute_dtype)
            sdf, feat, gx, packed = sdf_stash_fwd(weights, x, cfg, ctx.pk, stash_us, compute_dtype, stash_dtype)
            stash = [packed]
        ctx.save_for_backward(x, *weights, *stash)
        ctx.n_w = len(weights)
        return sdf, feat, gx

    @staticmethod
    @once_differentiable
    def backward(ctx, d_sdf, d_feat, d_gx):
        saved = ctx.saved_tensors
        x, weights, stash = saved[0], saved[1 : 1 + ctx.n_w], saved[1 + ctx.n_w :]
        cfg, n = ctx.cfg, x.shape[0]
        cots = (
            cotangent(d_sdf, (n,), x.device),
            cotangent(d_feat, (n, cfg.d_out_feat), x.device),
            cotangent(d_gx, (n, 3), x.device),
        )
        need_dw = any(ctx.needs_input_grad[6:])
        if x.device.type == "cuda" and ctx.bwd_impl != "xla":
            dws, dx = sdf_stash_bwd(weights, x, stash[0], cots, cfg, ctx.pk, need_dw, ctx.stash_us, ctx.compute_dtype,
                                    ctx.stash_dtype)
        else:
            if x.device.type == "cuda":
                stash = split_stash(stash[0], sdf_stash_columns(cfg, ctx.stash_us))
            L = cfg.n_layers
            if ctx.stash_us:
                dws, dx = sdf_core_bwd_stash_all_plain(weights, x, stash[:L], stash[L : 2 * L], stash[2 * L], cots,
                                                       cfg, ctx.compute_dtype, need_dw)
            else:
                dws, dx = sdf_core_bwd_stash_plain(weights, x, stash, cots, cfg, ctx.compute_dtype, need_dw)
        return (None, None, None, None, None, dx, *(dws or [None] * ctx.n_w))


class MlpStashFn(torch.autograd.Function):
    """The ReLU trunk with the stash backward: kernels F and G on CUDA
    tensors, their instances at ``compute_dtype`` and ``stash_dtype`` (with
    ``bwd_impl="xla"``, G's plain version on the card's tensors), the plain
    versions on CPU tensors."""

    @staticmethod
    def forward(ctx, n_layers, compute_dtype, stash_dtype, bwd_impl, x, *weights):
        ctx.n_layers, ctx.compute_dtype, ctx.stash_dtype, ctx.bwd_impl = n_layers, compute_dtype, stash_dtype, bwd_impl
        if x.device.type == "cpu":
            out, zs = mlp_relu_fwd_zs_plain(weights, x, n_layers, compute_dtype, stash_dtype)
            ctx.pk = None
        else:
            ctx.pk = trunk_pack([w.detach() for w in weights], n_layers, compute_dtype)
            out, stash = mlp_stash_fwd(weights, x, n_layers, ctx.pk, compute_dtype, stash_dtype)
            zs = [stash]
        ctx.save_for_backward(x, *weights, *zs)
        ctx.n_w = len(weights)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        saved = ctx.saved_tensors
        x, weights, zs = saved[0], saved[1 : 1 + ctx.n_w], saved[1 + ctx.n_w :]
        g = g.contiguous()
        if x.device.type == "cpu":
            dws, dx = mlp_relu_bwd_stash_plain(weights, x, zs, g, ctx.n_layers, ctx.compute_dtype)
        elif ctx.bwd_impl == "xla":
            zs = split_stash(zs[0], mlp_stash_columns(ctx.pk))
            dws, dx = mlp_relu_bwd_stash_plain(weights, x, zs, g, ctx.n_layers, ctx.compute_dtype)
        else:
            dws, dx = mlp_stash_bwd(weights, x, zs[0], g, ctx.n_layers, ctx.pk, ctx.compute_dtype, ctx.stash_dtype)
        return (None, None, None, None, dx, *dws)


# ---------------------------------------------------------------------------
# Entry points


def fused_sdf_value_feat_grad_stash(
    params: dict,
    cfg: SDFNetConfig,
    x: torch.Tensor,
    *,
    compute_dtype: str = "bfloat16",
    stash_dtype: str = "bfloat16",
    stash_us: bool = False,
    bwd_impl: str = "pallas",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sdf [N], feat [N, F], grad [N, 3]) of the SDF field at ``x`` with
    the stash backward (port of ``core_stash.py::fused_sdf_value_feat_grad_stash``):
    the outputs and forward numerics of ``core_mlp.fused_sdf_value_feat_grad``.
    With no gradient wanted it runs the undifferentiated core (kernel A, or
    ``sdf_core_plain`` on a CPU tensor), as JAX's op does; with one,
    ``SdfStashFn``: D's and E's instances at ``compute_dtype`` ("bfloat16"
    or exact-f32 "float32" dot operands) and ``stash_dtype`` (the stash's
    dtype); ``stash_us`` their stash_all variants; ``bwd_impl="xla"`` E's
    plain version over the whole batch ("pallas", JAX's name, is the CUDA
    kernel)."""
    if bwd_impl not in ("pallas", "xla"):
        raise ValueError(f"bwd_impl must be 'pallas' or 'xla', got {bwd_impl!r}")
    torch_dtype(compute_dtype), torch_dtype(stash_dtype)
    weights = materialize_sdf_weights_full(params, cfg)
    if not needs_grad(x, *tree_leaves(params)):
        return sdf_core_primal(weights, x, cfg, compute_dtype)
    return SdfStashFn.apply(cfg, compute_dtype, stash_dtype, "xla" if bwd_impl == "xla" else "kernel", stash_us,
                            x.contiguous(), *weights)


def fused_mlp_apply_stash(
    params: dict,
    n_layers: int,
    x: torch.Tensor,
    *,
    compute_dtype: str = "bfloat16",
    stash_dtype: str = "bfloat16",
    bwd_impl: str = "pallas",
) -> torch.Tensor:
    """The weight-norm ReLU trunk on pre-encoded inputs -> [N, d_out]
    logits with the stash backward (port of
    ``core_stash.py::fused_mlp_apply_stash``, the stash twin of
    ``core_mlp.fused_mlp_apply``).  With no gradient wanted it runs the
    undifferentiated trunk (kernel I at ``compute_dtype``, or
    ``mlp_relu_plain`` on a CPU tensor), as JAX's op does; with one,
    ``MlpStashFn``: F's and G's instances at ``compute_dtype`` ("bfloat16"
    or exact-f32 "float32" dot operands) and ``stash_dtype`` (the stash's
    dtype); ``bwd_impl="xla"`` G's plain version over the whole batch
    ("pallas", JAX's name, is the CUDA kernel)."""
    if bwd_impl not in ("pallas", "xla"):
        raise ValueError(f"bwd_impl must be 'pallas' or 'xla', got {bwd_impl!r}")
    torch_dtype(compute_dtype), torch_dtype(stash_dtype)
    x = x.contiguous()
    weights = materialize_mlp_weights(params, n_layers)
    if not needs_grad(x, *tree_leaves(params)):
        return mlp_primal(weights, x, n_layers, compute_dtype)
    return MlpStashFn.apply(n_layers, compute_dtype, stash_dtype, "xla" if bwd_impl == "xla" else "kernel", x,
                            *weights)
