"""The fused SDF core and reflectance trunk with the recompute backward
(port of ``nrhints_tpu/kernels/core_mlp.py``): kernels A, H, I and J, their
plain versions, the layouts the CUDA kernels read, and the entry points of
both ops.

``fused_sdf_value_feat_grad`` returns (sdf [N], feat [N, F], grad_x sdf
[N, 3]) for N points.  Without a gradient it launches kernel A
(``csrc/sdf_core.cu``) on a CUDA tensor and runs ``sdf_core_plain``, the
port of ``sdf_core_ref``, on a CPU tensor.  With one, ``backward`` picks the
schedule: "recompute" runs ``SdfCoreFn`` (A forward, H backward,
``csrc/sdf_core_bwd.cu``; only x and the weights are kept between them),
"stash", "stash_all" and "stash_xla" the stash op of ``core_stash.py``.
``fused_mlp_apply`` runs the reflectance trunk the same way: kernel I
(``csrc/mlp_stash.cu``) without a gradient, ``MlpFn`` (I forward, J
backward) under "recompute", the stash op (F, G) otherwise.

On CPU tensors every wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from nrhints_torch.fields.mlp import effective_weight
from nrhints_torch.fields.sdf import SDFNetConfig, _layer_dims
from nrhints_torch.kernels import cuda_lib
from nrhints_torch.kernels.common import INV_SQRT2, dot, softplus100_gate
from nrhints_torch.utils import tree_leaves


def encode_points(x: torch.Tensor, cfg: SDFNetConfig):
    """(enc [M, d0], sin_b, cos_b) of raw points: enc = [xs, sin(S), cos(S)]
    with xs = x * scale and S_{d,f} = xs_d 2^f dim-major."""
    F, d_in = cfg.multi_res, cfg.d_in
    xs = x * cfg.scale
    scaled = torch.cat([xs[:, d : d + 1] * (2.0**f) for d in range(d_in) for f in range(F)], dim=-1)
    sin_b = torch.sin(scaled)
    cos_b = torch.sin(scaled + math.pi / 2.0)
    return torch.cat([xs, sin_b, cos_b], dim=-1), sin_b, cos_b


def reverse_sweep(weights: Sequence[torch.Tensor], gates: Sequence[torch.Tensor], cfg: SDFNetConfig,
                  enc: torch.Tensor, compute_dtype: str = "float32"):
    """-> (g_enc [M, d0], us): d sdf / d enc by the manual reverse sweep from
    the sdf head down through the gates, and each layer's u_i (the g that
    reaches layer i's gate)."""
    io, _ = _layer_dims(cfg)
    d0, n_layers = enc.shape[-1], cfg.n_layers
    g = weights[2 * n_layers].reshape(1, -1).expand(enc.shape[0], -1) / cfg.scale
    g_enc = torch.zeros_like(enc)
    us = [None] * n_layers
    for i in reversed(range(n_layers)):
        us[i] = g
        g = dot(g * gates[i], weights[2 * i].t(), compute_dtype)
        if i in cfg.skip_in:
            g = g * INV_SQRT2
            split = io[i][0] - d0
            g_enc = g_enc + g[:, split:]
            g = g[:, :split]
    return g_enc + g, us


def per_dim_sum(dS: torch.Tensor, d_in: int, F: int) -> torch.Tensor:
    """sum_f dS[:, d F + f] 2^f per input dimension, in the JAX order."""
    per_dim = []
    for d in range(d_in):
        acc = dS[:, d * F : d * F + 1]
        for f in range(1, F):
            acc = acc + dS[:, d * F + f : d * F + f + 1] * (2.0**f)
        per_dim.append(acc)
    return torch.cat(per_dim, dim=-1)


def sdf_core_plain(
    weights: Sequence[torch.Tensor],
    x: torch.Tensor,  # [M, 3] raw points
    cfg: SDFNetConfig,
    compute_dtype: str = "float32",
    return_hs: bool = False,
):
    """-> (sdf [M], feat [M, F], grad_x sdf [M, 3]); the port of
    ``sdf_core_ref``.  ``weights`` = (w0, b0, ..., w_sdf, b_sdf, w_feat,
    b_feat), w [in, out].  ``compute_dtype="bfloat16"`` rounds only the
    dot operands; the gradient is a manual reverse sweep with the gates
    sigmoid(100 z).  ``return_hs`` appends the lists of every layer's f32
    activation h_i and reverse-sweep value u_i (the g that reaches layer
    i's gate), and g_enc (the stashes of ``core_stash.py``)."""
    L, F, d_in = cfg.n_layers, cfg.multi_res, cfg.d_in
    enc, sin_b, cos_b = encode_points(x, cfg)

    h = enc
    gates, hs = [], []
    for i in range(L):
        if i in cfg.skip_in:
            h = torch.cat([h, enc], dim=-1) * INV_SQRT2
        h, gate = softplus100_gate(dot(h, weights[2 * i], compute_dtype) + weights[2 * i + 1])
        gates.append(gate)
        hs.append(h)
    w_sdf, b_sdf = weights[2 * L], weights[2 * L + 1]
    w_feat, b_feat = weights[2 * L + 2], weights[2 * L + 3]
    sdf = (dot(h, w_sdf, compute_dtype) + b_sdf) / cfg.scale
    feat = dot(h, w_feat, compute_dtype) + b_feat

    g_enc, us = reverse_sweep(weights, gates, cfg, enc, compute_dtype)
    g_sin = g_enc[:, d_in : d_in + d_in * F]
    g_cos = g_enc[:, d_in + d_in * F :]
    dS = g_sin * cos_b - g_cos * sin_b
    gx = (g_enc[:, :d_in] + per_dim_sum(dS, d_in, F)) * cfg.scale
    if return_hs:
        return sdf[:, 0], feat, gx, hs, us, g_enc
    return sdf[:, 0], feat, gx


def sdf_core_bwd_plain(weights, x, cots, cfg: SDFNetConfig, compute_dtype: str = "float32"):
    """-> (dws, dx): the VJP of ``sdf_core_plain`` with respect to (weights,
    x) at ``cots`` = (d sdf [N], d feat [N, F], d grad [N, 3]), by autograd
    through the whole forward and its reverse sweep, so the eikonal loss's
    second-order terms come with it (the port of ``jax.vjp`` over
    ``sdf_core_ref``, which ``_sdf_core_bwd_pallas`` runs per block).
    ``dws`` has the shapes of ``weights``."""
    with torch.enable_grad():
        ws = [w.detach().requires_grad_(True) for w in weights]
        xx = x.detach().requires_grad_(True)
        grads = torch.autograd.grad(sdf_core_plain(ws, xx, cfg, compute_dtype), [*ws, xx], cots, allow_unused=True)
    dws = tuple(torch.zeros_like(w) if d is None else d for w, d in zip(ws, grads[:-1]))
    return dws, grads[-1]


def mlp_relu_plain(weights, x, n_layers: int, compute_dtype: str = "float32", return_zs: bool = False):
    """-> out [N, d_out]: the ReLU MLP with a linear last layer (port of
    ``mlp_relu_ref``), ``weights`` = (w0, b0, ..., w_n, b_n), w [in, out].
    ``return_zs`` also returns the list of its f32 hidden pre-activations."""
    h, zs = x, []
    for i in range(n_layers + 1):
        h = dot(h, weights[2 * i], compute_dtype) + weights[2 * i + 1]
        if i < n_layers:
            zs.append(h)
            h = torch.relu(h)
    return (h, zs) if return_zs else h


def mlp_relu_bwd_plain(weights, x, g, n_layers: int, compute_dtype: str = "float32", zs=None):
    """-> (dws, dx): the VJP of ``mlp_relu_plain`` at the cotangent ``g``
    [N, d_out], by the hand backward G <- (G [z_i > 0]) W_i^T at the hidden
    pre-activations z_i: recomputed in f32 from x, or the given ``zs``
    (the stash of ``core_stash.py``)."""
    if zs is None:
        _, zs = mlp_relu_plain(weights, x, n_layers, compute_dtype, return_zs=True)
    dws = [None] * (2 * (n_layers + 1))
    G = g
    for i in reversed(range(n_layers + 1)):
        inp = x if i == 0 else torch.relu(zs[i - 1])
        if i < n_layers:
            G = G * (zs[i] > 0.0).to(G.dtype)
        dws[2 * i + 1] = torch.sum(G, dim=0)
        dws[2 * i] = dot(inp.t(), G, compute_dtype)
        G = dot(G, weights[2 * i].t(), compute_dtype)
    return tuple(dws), G


def materialize_sdf_weights_full(params: dict, cfg: SDFNetConfig) -> tuple:
    """Weight-norm SDF params -> (w0, b0, ..., w_sdf, b_sdf, w_feat, b_feat)
    with w [in, out] and b [out]."""
    out = []
    for i in range(cfg.n_layers):
        out += list(effective_weight(params[f"lin{i}"]))
    for head in ("out_sdf", "out_feat"):
        out += list(effective_weight(params[head]))
    return tuple(out)


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def pack_sdf_mlp(weights: Sequence[torch.Tensor], cfg: SDFNetConfig, with_feat: bool,
                 dtype: torch.dtype = torch.bfloat16) -> dict:
    """Lay the SDF MLP out as ``csrc/sdf_mlp.cuh`` reads it: weights in
    ``dtype`` zero-padded to 16-multiples, f32 biases, the f32 sdf head
    column and the int meta vector.  ``weights`` ends with the sdf head,
    then (when ``with_feat``) the feature head.  ``dtype`` is bf16 for every
    kernel but the f32 march instances (``march_dtype="float32"``), which
    read f32 weights in the same layout (``csrc/mma_rows.cuh::sdf_rows_f32``)."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the packed SDF weights are bf16 or f32, got {dtype}")
    if cfg.encoding != "frequency":
        raise ValueError("the CUDA SDF kernels take the frequency encoding; the renderer runs the hash "
                         "encoding on the unfused path, as the JAX package does")
    if cfg.d_in != 3 or 0 in cfg.skip_in:
        raise NotImplementedError("the CUDA SDF kernels take 3-D points and no skip at layer 0")
    io, dims = _layer_dims(cfg)
    L, d0, d_last = cfg.n_layers, cfg.d_encoded, dims[-2]
    d_feat = cfg.d_out_feat if with_feat else 0
    kpf, npf = _round16(d_last), _round16(d_feat)
    if max([_round16(v) for pair in io for v in pair] + [kpf, npf]) > 256 or d0 > 64:
        raise NotImplementedError("the CUDA SDF kernels take widths up to 256 and encodings up to 64")
    dev = weights[0].device
    layers = []
    w_off = b_off = 0
    for i, (din, dout) in enumerate(io):
        kp, np_ = _round16(din), _round16(dout)
        layers.append((din, dout, kp, np_, int(i in cfg.skip_in), w_off, b_off))
        w_off += kp * np_
        b_off += np_
    wf_off, bf_off = w_off, b_off
    wpack = torch.zeros(w_off + kpf * npf, dtype=dtype, device=dev)
    bpack = torch.zeros(b_off + npf + 1, dtype=torch.float32, device=dev)
    blocks = [(weights[2 * i], weights[2 * i + 1], lay[5], lay[6], lay[2], lay[3]) for i, lay in enumerate(layers)]
    if with_feat:
        blocks.append((weights[2 * L + 2], weights[2 * L + 3], wf_off, bf_off, kpf, npf))
    for w, b, wo, bo, kp, np_ in blocks:
        wp = torch.zeros(kp, np_, dtype=dtype, device=dev)
        wp[: w.shape[0], : w.shape[1]] = w.to(dtype)
        wpack[wo : wo + kp * np_] = wp.reshape(-1)
        bpack[bo : bo + b.numel()] = b.reshape(-1).float()
    bpack[bf_off + npf] = weights[2 * L + 1].reshape(())
    meta = [L, cfg.multi_res, d0, d_feat, d_last, kpf, npf, wf_off, bf_off, sum(l[3] for l in layers)]
    for lay in layers:
        meta += list(lay)
    return {
        "wpack": wpack,
        "bpack": bpack,
        "w_sdf": weights[2 * L].reshape(-1).float().contiguous(),
        "meta": np.asarray(meta, dtype=np.int32),
    }


def require_cuda(t: torch.Tensor, shape: tuple, name: str, dtype=torch.float32) -> None:
    """Kernel-input checks: CUDA device, dtype, shape (None = any) and
    contiguity."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != a for s, a in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


CHAIN_TP = 64  # points per block of kernels A, D, E, H and F, G, I, J (csrc/staged_mma.cuh::kChainTP)
IN_MAX = 384  # widest padded trunk input (csrc/mlp_stash.cu::kInMax)
SUM_ROWS = 16  # points per row of the trunk's bias sums (csrc/mlp_stash.cu::kSumRows)
ENC_MAX = 64  # widest padded frequency encoding (csrc/sdf_mlp.cuh::kEncMax)
MAX_SPLIT = 16  # row chunks of the weight-cotangent products


def gate_layout(n: int, gates_total: int) -> tuple[int, int, int]:
    """-> (blocks, padded points, f32 elements of the gate scratch) of the
    SDF core's forward (``csrc/sdf_fwd.cuh``: kernels A, D and H's first
    pass) at n points: every layer's gate sigmoid(100 z_i) per padded point,
    ``gates_total`` columns in the stash's layout."""
    nblk = -(-n // CHAIN_TP)
    npad = nblk * CHAIN_TP
    return nblk, npad, npad * gates_total


def chain_layout(n: int, gates_total: int) -> tuple[int, int, int]:
    """-> (blocks, padded points, f32 elements of the device-memory scratch)
    of the SDF backward chain at n points: per point u_i then dL/dh_i of
    every layer (``gates_total``), and four f32 encoding cotangents of
    ``ENC_MAX`` each.  The per-block column sums have one row per block."""
    nblk, npad, _ = gate_layout(n, gates_total)
    return nblk, npad, npad * (gates_total + 4 * ENC_MAX)


def trunk_layout(n: int, zt: int) -> tuple[int, int, int, int]:
    """-> (blocks, padded points, rows of the bias sums, bf16 elements of
    kernel J's transient z stash) of the trunk's kernels (``csrc/mlp_stash.cu``)
    at n points and ZT stash columns: 64-point blocks; one row of f32 column
    sums of every G_i per ``SUM_ROWS`` padded points; J's stash has kernel
    F's layout [n, ZT]."""
    nblk, npad, _ = gate_layout(n, 0)
    return nblk, npad, npad // SUM_ROWS, n * zt


def materialize_mlp_weights(params: dict, n_layers: int) -> tuple:
    """Reflectance weight-norm params -> (w0, b0, ..., w_n, b_n), w [in, out]
    and b [out]."""
    out = []
    for i in range(n_layers + 1):
        out += list(effective_weight(params[f"lin{i}"]))
    return tuple(out)


def pack_mlp(weights: Sequence[torch.Tensor], n_layers: int) -> dict:
    """Lay the trunk out as ``csrc/mlp_stash.cu`` reads it: per layer a
    zero-padded bf16 [kp, np] block (w [in, out]) and a padded f32 bias,
    and the int meta vector [n_lin, d0, d_out, ZT, then per layer in, out,
    kp, np, w_off, b_off, z_off]; ZT is the width of the packed z_i."""
    dev = weights[0].device
    dims = [(weights[2 * i].shape[0], weights[2 * i].shape[1]) for i in range(n_layers + 1)]
    if max(_round16(o) for _, o in dims) > 256 or _round16(dims[0][0]) > IN_MAX or any(
        _round16(i) > 256 for i, _ in dims[1:]
    ):
        raise NotImplementedError(f"the CUDA trunk kernels take hidden widths up to 256 and inputs up to {IN_MAX}")
    meta, w_off, b_off, z_off = [], 0, 0, 0
    for din, dout in dims:
        kp, np_ = _round16(din), _round16(dout)
        meta += [din, dout, kp, np_, w_off, b_off, z_off]
        w_off, b_off = w_off + kp * np_, b_off + np_
        z_off += np_
    zt = sum(_round16(o) for _, o in dims[:-1])
    wpack = torch.zeros(w_off, dtype=torch.bfloat16, device=dev)
    bpack = torch.zeros(b_off, dtype=torch.float32, device=dev)
    for i, (din, dout) in enumerate(dims):
        _, _, kp, np_, wo, bo, _ = meta[7 * i : 7 * i + 7]
        wp = torch.zeros(kp, np_, dtype=torch.bfloat16, device=dev)
        wp[:din, :dout] = weights[2 * i].to(torch.bfloat16)
        wpack[wo : wo + kp * np_] = wp.reshape(-1)
        bpack[bo : bo + dout] = weights[2 * i + 1].reshape(-1).float()
    meta = [n_layers + 1, dims[0][0], dims[-1][1], zt] + meta
    return {"wpack": wpack, "bpack": bpack, "meta": np.asarray(meta, dtype=np.int32)}


def dw_jobs(shapes) -> tuple[np.ndarray, int, int]:
    """Layout of the weight-cotangent products C_j = A_j^T B_j: ``shapes``
    lists (rows, ka, nb) per product.  -> (int64 [J, 6] table of (a_off,
    b_off, rows, ka, nb, c_off), bf16 scratch elements, f32 dW elements).
    Every offset is a multiple of 16 elements (32-byte aligned tiles)."""
    table, off, c_off = [], 0, 0
    for rows, ka, nb in shapes:
        if rows % 16 or ka % 16 or nb % 16:
            raise ValueError(f"dW product shapes must be multiples of 16, got {(rows, ka, nb)}")
        a_off, off = off, off + rows * ka
        b_off, off = off, off + rows * nb
        table.append((a_off, b_off, rows, ka, nb, c_off))
        c_off += ka * nb
    return np.asarray(table, dtype=np.int64), off, c_off


def dw_split(npad: int) -> int:
    """Row chunks of the dW products: about 1,024 rows each, at most 16."""
    return max(1, min(MAX_SPLIT, npad // 1024))


def _launch(lib, fn: str, kernel: str, *args) -> None:
    rc = getattr(lib, fn)(*args)
    cuda_lib.check(lib, rc, kernel)
    cuda_lib.launch_counts[kernel] += 1


# ---------------------------------------------------------------------------
# Kernels A and H, and the backward plumbing they share with kernel E


def sdf_core_fwd(
    weights: Sequence[torch.Tensor], x: torch.Tensor, cfg: SDFNetConfig, pk: dict | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel A on the card: (sdf [N], feat [N, F], grad [N, 3]) with bf16
    dot operands, f32 everything else.  Its f32 gates go to a scratch of
    ``gate_layout``'s size, freed when this returns."""
    require_cuda(x, (None, 3), "x")
    n = x.shape[0]
    sdf = torch.empty(n, device=x.device)
    feat = torch.empty((n, cfg.d_out_feat), device=x.device)
    gx = torch.empty((n, 3), device=x.device)
    if n == 0:
        return sdf, feat, gx
    pk = pack_sdf_mlp(weights, cfg, with_feat=True) if pk is None else pk
    gates = torch.empty(gate_layout(n, int(pk["meta"][9]))[2], device=x.device)
    _launch(
        cuda_lib.load("sdf_core"), "sdf_core_fwd", "sdf_core_fwd",
        x.data_ptr(), pk["wpack"].data_ptr(), pk["bpack"].data_ptr(), pk["w_sdf"].data_ptr(),
        sdf.data_ptr(), feat.data_ptr(), gx.data_ptr(), gates.data_ptr(), n, pk["meta"].ctypes.data,
        float(cfg.scale), cuda_lib.stream_ptr(x.device),
    )
    return sdf, feat, gx


def sdf_bwd_launch(weights, x, cots, cfg: SDFNetConfig, pk: dict | None = None, stash: torch.Tensor | None = None,
                   need_dw: bool = True, stash_us: bool = False):
    """The SDF core's backward on the card -> (dws, dx) with the shapes of
    ``sdf_core_bwd_plain``'s: kernel E at the bf16 ``stash`` of kernel D
    (with ``stash_us``, E's stash_all variant at D's stash_all stash, which
    also holds u_i and g_enc), or, with ``stash=None``, kernel H, which
    first recomputes the layers into a scratch of its own (bf16 h_i and f32
    gates, freed when this returns).
    Both run the per-point chain on 64-point blocks (dx, the dW operands in
    bf16 scratch, per-block f32 column sums of the bias cotangents, and u_i
    and the encoding cotangents in an f32 scratch of ``chain_layout``'s
    size, freed when this returns), the split-K dW products and the
    in-order sums of the partials (no atomics: the gradients repeat bit for
    bit).  ``need_dw=False`` launches the chain alone -> (None, dx): no dW
    pass runs, and dx is the same bit for bit."""
    ds, df, dgx = cots
    n, dev = x.shape[0], x.device
    pk = pack_sdf_mlp(weights, cfg, with_feat=True) if pk is None else pk
    meta = pk["meta"]
    L, d_feat, d_last, kpf, npf, gt = (int(meta[k]) for k in (0, 3, 4, 5, 6, 9))
    require_cuda(x, (None, 3), "x")
    if stash is not None:
        from nrhints_torch.kernels.core_stash import sdf_stash_width

        require_cuda(stash, (n, sdf_stash_width(cfg, stash_us)), "stash", torch.bfloat16)
    require_cuda(ds, (n,), "d_sdf")
    require_cuda(df, (n, d_feat), "d_feat")
    require_cuda(dgx, (n, 3), "d_grad")
    nblk, npad, n_chain = chain_layout(n, gt)
    layers = [tuple(int(v) for v in meta[10 + 7 * i : 17 + 7 * i]) for i in range(L)]
    jobs, n_scratch, n_dw = dw_jobs([(2 * npad, lay[2], lay[3]) for lay in layers] + [(npad, kpf, npf)])
    split = dw_split(npad) if need_dw else 0
    pw = gt + npf + 1 + 2 * kpf
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((n, 3), **f32)
    scratch = torch.empty(n_scratch, dtype=torch.bfloat16, device=dev)
    chain = torch.empty(n_chain, **f32)
    partial = torch.empty((nblk, pw), **f32)
    colsum, part_dw, dw = (torch.empty(pw, **f32), torch.empty((split, n_dw), **f32),
                           torch.empty(n_dw, **f32)) if need_dw else (None, None, None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    tail = (dx.data_ptr(), scratch.data_ptr(), chain.data_ptr(), partial.data_ptr(), ptr(colsum),
            ptr(part_dw), ptr(dw), jobs.ctypes.data, len(jobs), split, n, meta.ctypes.data,
            float(cfg.scale), cuda_lib.stream_ptr(dev))
    if n > 0 and stash is None:
        hs = torch.empty((n, gt), dtype=torch.bfloat16, device=dev)
        gates = torch.empty(gate_layout(n, gt)[2], **f32)
        _launch(
            cuda_lib.load("sdf_core_bwd"), "sdf_core_bwd", "sdf_core_bwd",
            x.data_ptr(), ds.data_ptr(), df.data_ptr(), dgx.data_ptr(), pk["wpack"].data_ptr(),
            pk["bpack"].data_ptr(), pk["w_sdf"].data_ptr(), hs.data_ptr(), gates.data_ptr(), *tail,
        )
    elif n > 0:
        name = "sdf_stash_all_bwd" if stash_us else "sdf_stash_bwd"
        _launch(
            cuda_lib.load("sdf_stash"), name, name,
            x.data_ptr(), stash.data_ptr(), ds.data_ptr(), df.data_ptr(), dgx.data_ptr(), pk["wpack"].data_ptr(),
            pk["w_sdf"].data_ptr(), *tail,
        )
    elif need_dw:
        colsum.zero_()
        dw.zero_()
    if not need_dw:
        return None, dx
    dws = []
    for i, (din, dout, kp, np_, _skip, _w, b_off) in enumerate(layers):
        c_off = int(jobs[i, 5])
        dws.append(dw[c_off : c_off + kp * np_].view(kp, np_)[:din, :dout])
        dws.append(colsum[b_off : b_off + dout])
    o = gt
    b_feat, o = colsum[o : o + d_feat], o + npf
    b_sdf, o = colsum[o : o + 1], o + 1
    hds, carry = colsum[o : o + d_last], colsum[o + kpf : o + kpf + d_last]
    c_off = int(jobs[L, 5])
    dws += [(carry / cfg.scale + hds)[:, None], b_sdf, dw[c_off : c_off + kpf * npf].view(kpf, npf)[:d_last, :d_feat],
            b_feat]
    return tuple(dws), dx


def sdf_core_bwd(weights, x, cots, cfg: SDFNetConfig, pk: dict | None = None):
    """Kernel H on the card -> (dws, dx): the recompute VJP of kernel A's
    function from x and the cotangents alone, with A's gates sigmoid(100 z)
    in f32 (``sdf_bwd_launch``)."""
    return sdf_bwd_launch(weights, x, cots, cfg, pk)


# ---------------------------------------------------------------------------
# Kernels I and J, and the backward plumbing they share with kernel G


def mlp_fwd(weights, x: torch.Tensor, n_layers: int, pk: dict | None = None) -> torch.Tensor:
    """Kernel I on the card -> out [N, d_out] f32 (kernel F without its
    stash; ``trunk_layout``'s 64-point blocks)."""
    pk = pack_mlp(weights, n_layers) if pk is None else pk
    meta = pk["meta"]
    n, dev = x.shape[0], x.device
    require_cuda(x, (None, int(meta[1])), "x")
    out = torch.empty((n, int(meta[2])), device=dev)
    if n > 0:
        _launch(
            cuda_lib.load("mlp_stash"), "mlp_fwd", "mlp_fwd",
            x.data_ptr(), pk["wpack"].data_ptr(), pk["bpack"].data_ptr(), out.data_ptr(), n, meta.ctypes.data,
            cuda_lib.stream_ptr(dev),
        )
    return out


def mlp_bwd_launch(weights, x: torch.Tensor, g: torch.Tensor, n_layers: int, pk: dict | None = None,
                   zs: torch.Tensor | None = None):
    """The trunk's backward on the card -> (dws, dx): kernel G at the bf16
    ``zs`` stash of kernel F, or, with ``zs=None``, kernel J, which first
    recomputes the z_i into a transient stash of F's layout (freed when this
    returns).  Both run the per-point chain on 64-point blocks, then the same
    split-K dW products and in-order sums as kernel E (``trunk_layout``)."""
    pk = pack_mlp(weights, n_layers) if pk is None else pk
    meta = pk["meta"]
    n_lin, d0, d_out, zt = (int(v) for v in meta[:4])
    n, dev = x.shape[0], x.device
    require_cuda(x, (n, d0), "x")
    if zs is not None:
        require_cuda(zs, (n, zt), "zs", torch.bfloat16)
    require_cuda(g, (n, d_out), "g")
    layers = [tuple(int(v) for v in meta[4 + 7 * i : 11 + 7 * i]) for i in range(n_lin)]
    _, npad, sum_rows, n_zs = trunk_layout(n, zt)
    jobs, n_scratch, n_dw = dw_jobs([(npad, lay[2], lay[3]) for lay in layers])
    split = dw_split(npad)
    bt = sum(lay[3] for lay in layers)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((n, d0), **f32)
    scratch = torch.empty(n_scratch, dtype=torch.bfloat16, device=dev)
    partial = torch.empty((sum_rows, bt), **f32)
    colsum = torch.empty(bt, **f32)
    part_dw = torch.empty((split, n_dw), **f32)
    dw = torch.empty(n_dw, **f32)
    tail = (dx.data_ptr(), scratch.data_ptr(), partial.data_ptr(), colsum.data_ptr(), part_dw.data_ptr(),
            dw.data_ptr(), jobs.ctypes.data, len(jobs), split, n, meta.ctypes.data, cuda_lib.stream_ptr(dev))
    if n > 0 and zs is None:
        zsc = torch.empty(n_zs, dtype=torch.bfloat16, device=dev)
        _launch(cuda_lib.load("mlp_stash"), "mlp_bwd", "mlp_bwd", x.data_ptr(), g.data_ptr(), pk["wpack"].data_ptr(),
                pk["bpack"].data_ptr(), zsc.data_ptr(), *tail)
    elif n > 0:
        _launch(cuda_lib.load("mlp_stash"), "mlp_stash_bwd", "mlp_stash_bwd", x.data_ptr(), zs.data_ptr(),
                g.data_ptr(), pk["wpack"].data_ptr(), *tail)
    else:
        colsum.zero_()
        dw.zero_()
    dws = []
    for i, (din, dout, kp, np_, _w, b_off, _z) in enumerate(layers):
        c_off = int(jobs[i, 5])
        dws += [dw[c_off : c_off + kp * np_].view(kp, np_)[:din, :dout], colsum[b_off : b_off + dout]]
    return tuple(dws), dx


def mlp_bwd(weights, x: torch.Tensor, g: torch.Tensor, n_layers: int, pk: dict | None = None):
    """Kernel J on the card -> (dws, dx) (``mlp_bwd_launch``)."""
    return mlp_bwd_launch(weights, x, g, n_layers, pk)


# ---------------------------------------------------------------------------
# The autograd ops of the recompute schedule


def check_kernel_dtype(compute_dtype: str) -> None:
    if compute_dtype != "bfloat16":
        raise NotImplementedError("the CUDA core kernels compute with bf16 dot operands only")


def cotangent(g, shape, device) -> torch.Tensor:
    """A contiguous cotangent; autograd passes None for an unused output."""
    return torch.zeros(shape, device=device) if g is None else g.contiguous()


class SdfCoreFn(torch.autograd.Function):
    """(sdf [N], feat [N, F], grad [N, 3]) with the recompute backward:
    kernel A forward and kernel H backward on CUDA tensors, ``sdf_core_plain``
    and ``sdf_core_bwd_plain`` on CPU tensors.  It saves only x and the
    weights, as the JAX op's residuals: no activation is kept from the
    forward to the backward.  The backward is the full first-order VJP of
    all three outputs, the eikonal loss's second-order terms inside it."""

    @staticmethod
    def forward(ctx, cfg, compute_dtype, x, *weights):
        ctx.cfg, ctx.compute_dtype = cfg, compute_dtype
        if x.device.type == "cpu":
            out = sdf_core_plain(weights, x, cfg, compute_dtype)
            ctx.pk = None
        else:
            check_kernel_dtype(compute_dtype)
            ctx.pk = pack_sdf_mlp([w.detach() for w in weights], cfg, with_feat=True)
            out = sdf_core_fwd(weights, x, cfg, ctx.pk)
        ctx.save_for_backward(x, *weights)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, d_sdf, d_feat, d_gx):
        x, *weights = ctx.saved_tensors
        n = x.shape[0]
        cots = (cotangent(d_sdf, (n,), x.device), cotangent(d_feat, (n, ctx.cfg.d_out_feat), x.device),
                cotangent(d_gx, (n, 3), x.device))
        if x.device.type == "cpu":
            dws, dx = sdf_core_bwd_plain(weights, x, cots, ctx.cfg, ctx.compute_dtype)
        else:
            dws, dx = sdf_core_bwd(weights, x, cots, ctx.cfg, ctx.pk)
        return (None, None, dx, *dws)


class MlpFn(torch.autograd.Function):
    """The ReLU trunk with the recompute backward: kernels I and J on CUDA
    tensors, ``mlp_relu_plain`` and ``mlp_relu_bwd_plain`` on CPU tensors;
    it saves only x and the weights."""

    @staticmethod
    def forward(ctx, n_layers, compute_dtype, x, *weights):
        ctx.n_layers, ctx.compute_dtype = n_layers, compute_dtype
        if x.device.type == "cpu":
            out = mlp_relu_plain(weights, x, n_layers, compute_dtype)
            ctx.pk = None
        else:
            check_kernel_dtype(compute_dtype)
            ctx.pk = pack_mlp([w.detach() for w in weights], n_layers)
            out = mlp_fwd(weights, x, n_layers, ctx.pk)
        ctx.save_for_backward(x, *weights)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        g = g.contiguous()
        if x.device.type == "cpu":
            dws, dx = mlp_relu_bwd_plain(weights, x, g, ctx.n_layers, ctx.compute_dtype)
        else:
            dws, dx = mlp_bwd(weights, x, g, ctx.n_layers, ctx.pk)
        return (None, None, dx, *dws)


# ---------------------------------------------------------------------------
# Entry points


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd will want a gradient of an op on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _stash_bwd_impl(backward: str) -> str:
    """The stash op's backward for a ``core_backward`` value: its kernel,
    or full-batch PyTorch for "stash_xla" (where JAX runs XLA)."""
    return "xla" if backward == "stash_xla" else "kernel"


def fused_sdf_value_feat_grad(
    params: dict,
    cfg: SDFNetConfig,
    x: torch.Tensor,
    *,
    compute_dtype: str = "bfloat16",
    backward: str = "stash",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sdf [N], feat [N, F], grad [N, 3]) of the SDF field at ``x``.

    With no gradient wanted, CUDA tensors go through kernel A (bf16
    operands only; it raises for any other ``compute_dtype``) and CPU
    tensors through ``sdf_core_plain``, whatever ``backward`` says.  When
    autograd needs the op's gradient, ``backward`` is the schedule:
    "recompute" (``SdfCoreFn``: A, then H), "stash" (``core_stash.SdfStashFn``:
    D, then E), "stash_all" (D's and E's variants that also stash and read
    the reverse sweep's u_i and g_enc) or "stash_xla" (D, then E's plain
    version over the whole batch)."""
    grad = needs_grad(x, *tree_leaves(params))
    weights = materialize_sdf_weights_full(params, cfg)
    if grad:
        if backward == "recompute":
            return SdfCoreFn.apply(cfg, compute_dtype, x.contiguous(), *weights)
        if backward in ("stash", "stash_all", "stash_xla"):
            from nrhints_torch.kernels.core_stash import SdfStashFn

            return SdfStashFn.apply(cfg, compute_dtype, "bfloat16", _stash_bwd_impl(backward), backward == "stash_all",
                                    x.contiguous(), *weights)
        raise NotImplementedError(f"core_backward={backward!r}: the port's fused core has the 'recompute', 'stash', "
                                  "'stash_all' and 'stash_xla' schedules")
    if x.device.type == "cpu":
        return sdf_core_plain(weights, x, cfg, compute_dtype)
    check_kernel_dtype(compute_dtype)
    return sdf_core_fwd(weights, x.contiguous(), cfg)


def fused_mlp_apply(params: dict, n_layers: int, x: torch.Tensor, *, backward: str = "stash") -> torch.Tensor:
    """The weight-norm ReLU trunk on pre-encoded inputs -> [N, d_out]
    logits, with bf16 dot operands.  Without a gradient: kernel I (or
    ``mlp_relu_plain`` on the CPU) for every ``backward``, as JAX's stash op
    dispatches its non-stash forward for the undifferentiated primal.  With
    one: ``MlpFn`` (I, J) for "recompute", ``core_stash.MlpStashFn`` (F, then
    G, or G's plain version for "stash_xla") for the stash schedules ("stash_all"
    maps to the stash backward, as in JAX)."""
    x = x.contiguous()
    grad = needs_grad(x, *tree_leaves(params))
    weights = materialize_mlp_weights(params, n_layers)
    if not grad:
        return mlp_relu_plain(weights, x, n_layers, "bfloat16") if x.device.type == "cpu" else mlp_fwd(weights, x, n_layers)
    if backward == "recompute":
        return MlpFn.apply(n_layers, "bfloat16", x, *weights)
    if backward in ("stash", "stash_all", "stash_xla"):
        from nrhints_torch.kernels.core_stash import MlpStashFn

        return MlpStashFn.apply(n_layers, "bfloat16", "bfloat16", _stash_bwd_impl(backward), x, *weights)
    raise NotImplementedError(f"core_backward={backward!r}: the port's fused trunk has the 'recompute', 'stash', "
                              "'stash_all' and 'stash_xla' schedules")


def fused_reflectance_forward(
    params: dict,
    cfg,
    points: torch.Tensor,
    normals: torch.Tensor,
    view_dirs: torch.Tensor,
    feature_vectors: torch.Tensor,
    point_lights: torch.Tensor,
    visibilities: torch.Tensor | None = None,
    specular_cue: torch.Tensor | None = None,
    *,
    backward: str = "stash",
) -> torch.Tensor:
    """The reflectance field on the fused path: the frequency encodings and
    the concat in PyTorch, the trunk through ``fused_mlp_apply`` under the
    ``backward`` schedule, then the sigmoid
    (``core_mlp.py::fused_reflectance_forward`` of the JAX package)."""
    from nrhints_torch.core.encodings import nerf_encoding

    parts = [points, nerf_encoding(view_dirs, cfg.multi_res), normals, nerf_encoding(point_lights, cfg.multi_res),
             feature_vectors]
    if visibilities is not None:
        parts.append(nerf_encoding(visibilities, cfg.multi_res))
    if specular_cue is not None:
        parts.append(nerf_encoding(specular_cue, cfg.multi_res))
    out = fused_mlp_apply(params, cfg.n_layers, torch.cat(parts, dim=-1), backward=backward)
    return torch.sigmoid(out) if cfg.squeeze_out else out
