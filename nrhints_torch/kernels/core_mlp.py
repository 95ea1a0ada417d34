"""The fused SDF core and reflectance trunk (port of
``nrhints_tpu/kernels/core_mlp.py``): kernel A, its plain version, the
weight packing of the CUDA SDF kernels, and the entry points of both ops.

``fused_sdf_value_feat_grad`` returns (sdf [N], feat [N, F], grad_x sdf
[N, 3]) for N points.  Without a gradient it launches kernel A
(``csrc/sdf_core.cu``) on a CUDA tensor and runs ``sdf_core_plain``, the
port of ``sdf_core_ref``, on a CPU tensor; with one it goes through the
stash op of ``core_stash.py`` (kernels D and E).  ``fused_reflectance_forward``
runs the trunk through the stash op of kernels F and G.  The recompute
backward and the non-stash trunk kernels are later slices.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from nrhints_torch.fields.mlp import effective_weight
from nrhints_torch.fields.sdf import SDFNetConfig, _layer_dims, check_ported
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
    sigmoid(100 z).  ``return_hs`` appends the list of every layer's f32
    activation h_i (the stash of ``core_stash.py``)."""
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

    g_enc, _ = reverse_sweep(weights, gates, cfg, enc, compute_dtype)
    g_sin = g_enc[:, d_in : d_in + d_in * F]
    g_cos = g_enc[:, d_in + d_in * F :]
    dS = g_sin * cos_b - g_cos * sin_b
    gx = (g_enc[:, :d_in] + per_dim_sum(dS, d_in, F)) * cfg.scale
    if return_hs:
        return sdf[:, 0], feat, gx, hs
    return sdf[:, 0], feat, gx


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


def pack_sdf_mlp(weights: Sequence[torch.Tensor], cfg: SDFNetConfig, with_feat: bool) -> dict:
    """Lay the SDF MLP out as ``csrc/sdf_mlp.cuh`` reads it: bf16 weights
    zero-padded to 16-multiples, f32 biases, the f32 sdf head column and
    the int meta vector.  ``weights`` ends with the sdf head, then (when
    ``with_feat``) the feature head."""
    check_ported(cfg)
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
    wpack = torch.zeros(w_off + kpf * npf, dtype=torch.bfloat16, device=dev)
    bpack = torch.zeros(b_off + npf + 1, dtype=torch.float32, device=dev)
    blocks = [(weights[2 * i], weights[2 * i + 1], lay[5], lay[6], lay[2], lay[3]) for i, lay in enumerate(layers)]
    if with_feat:
        blocks.append((weights[2 * L + 2], weights[2 * L + 3], wf_off, bf_off, kpf, npf))
    for w, b, wo, bo, kp, np_ in blocks:
        wp = torch.zeros(kp, np_, dtype=torch.bfloat16, device=dev)
        wp[: w.shape[0], : w.shape[1]] = w.to(torch.bfloat16)
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


def sdf_core_fwd(
    weights: Sequence[torch.Tensor], x: torch.Tensor, cfg: SDFNetConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel A on the card: (sdf [N], feat [N, F], grad [N, 3]) with bf16
    dot operands, f32 everything else."""
    require_cuda(x, (None, 3), "x")
    n = x.shape[0]
    sdf = torch.empty(n, device=x.device)
    feat = torch.empty((n, cfg.d_out_feat), device=x.device)
    gx = torch.empty((n, 3), device=x.device)
    if n == 0:
        return sdf, feat, gx
    pk = pack_sdf_mlp(weights, cfg, with_feat=True)
    lib = cuda_lib.load("sdf_core")
    rc = lib.sdf_core_fwd(
        x.data_ptr(), pk["wpack"].data_ptr(), pk["bpack"].data_ptr(), pk["w_sdf"].data_ptr(),
        sdf.data_ptr(), feat.data_ptr(), gx.data_ptr(), n, pk["meta"].ctypes.data,
        float(cfg.scale), cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(lib, rc, "sdf_core_fwd")
    cuda_lib.launch_counts["sdf_core_fwd"] += 1
    return sdf, feat, gx


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd will want a gradient of an op on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
    tensors through ``sdf_core_plain``.  When autograd needs the op's
    gradient, ``backward="stash"`` (the only backward ported) runs
    ``core_stash.SdfStashFn``: kernels D and E, or their plain versions."""
    if needs_grad(x, *tree_leaves(params)):
        if backward != "stash":
            raise NotImplementedError(
                f"core_backward={backward!r}: only the 'stash' backward is ported (the others are later slices)"
            )
        from nrhints_torch.kernels.core_stash import fused_sdf_value_feat_grad_stash

        return fused_sdf_value_feat_grad_stash(params, cfg, x, compute_dtype=compute_dtype)
    weights = materialize_sdf_weights_full(params, cfg)
    if x.device.type == "cpu":
        return sdf_core_plain(weights, x, cfg, compute_dtype)
    if compute_dtype != "bfloat16":
        raise NotImplementedError("kernel A computes with bf16 dot operands only")
    return sdf_core_fwd(weights, x.contiguous(), cfg)


# ---------------------------------------------------------------------------
# The reflectance trunk on the train path


def materialize_mlp_weights(params: dict, n_layers: int) -> tuple:
    """Reflectance weight-norm params -> (w0, b0, ..., w_n, b_n), w [in, out]
    and b [out]."""
    out = []
    for i in range(n_layers + 1):
        out += list(effective_weight(params[f"lin{i}"]))
    return tuple(out)


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
) -> torch.Tensor:
    """The reflectance field on the train path: the frequency encodings and
    the concat in PyTorch, the trunk through ``core_stash.MlpStashFn``
    (kernels F and G, bf16 dot operands), then the sigmoid
    (``core_mlp.py::fused_reflectance_forward`` of the JAX package)."""
    from nrhints_torch.core.encodings import nerf_encoding
    from nrhints_torch.kernels.core_stash import fused_mlp_apply_stash

    parts = [points, nerf_encoding(view_dirs, cfg.multi_res), normals, nerf_encoding(point_lights, cfg.multi_res),
             feature_vectors]
    if visibilities is not None:
        parts.append(nerf_encoding(visibilities, cfg.multi_res))
    if specular_cue is not None:
        parts.append(nerf_encoding(specular_cue, cfg.multi_res))
    out = fused_mlp_apply_stash(params, cfg.n_layers, torch.cat(parts, dim=-1))
    return torch.sigmoid(out) if cfg.squeeze_out else out
