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
backward) under "recompute", ``core_stash.fused_mlp_apply_stash`` (F, G)
otherwise.

``compute_dtype`` picks each kernel's instance on the card: "bfloat16"
(the shipping bf16 dot operands) or "float32" (exact f32 dots: the f32
instances of A, H, I and J, counted as ``sdf_core_fwd_f32``,
``sdf_core_bwd_f32``, ``mlp_fwd_f32`` and ``mlp_bwd_f32``).  The SDF
core's width class picks A's, D's, E's and H's block (``core_class``): the
64-point instances at the presets' widths (padded widths up to 256,
encodings up to 64), the wide ones above them (up to 512 and 128, at every
dtype pair, counted as ``*_wide``), and above those the huge ones (any
width, bf16 operands and stash only, counted as ``*_huge``: 64-point blocks
whose activation rows lie in device memory, ``row_layout``).  The march kernels C, K, L, M and N
(``kernels/march.py``) have their own classes above the presets' widths:
``ROWS_WIDE`` up to 512 and 128, at bf16 and f32 march weights, and above
it ``ROWS_HUGE``, any width at bf16 march weights (counted as ``*_huge``:
64 rows a pass in device memory, ``march_layout``); and the trunk's F, G, I and J
theirs (``trunk_class``): the 64-point instances at padded hidden widths up
to 256 and inputs up to 384, the wide ones (32-point blocks, bf16 and f32,
counted as ``*_wide``) up to 512 and 640.  Every kernel takes any depth: up
to ``MAX_LAYERS`` layers the per-layer tables ride in the kernel's
parameters, a deeper network's are read from its meta vector's copy on the
card (the pack's "meta_dev"), and its dW job table's likewise.

On CPU tensors every wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from nrhints_torch.fields.mlp import effective_weight
from nrhints_torch.fields.sdf import SDFNetConfig, _layer_dims
from nrhints_torch.kernels import cuda_lib
from nrhints_torch.kernels.common import INV_SQRT2, dot, softplus100_gate, torch_dtype
from nrhints_torch.utils import device_constant, tree_leaves


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


CHAIN_TP = 64  # points per block of kernels A, D, E, H and F, G, I, J (csrc/staged_mma.cuh::kChainTP)
IN_MAX = 384  # widest padded trunk input (csrc/mlp_stash.cu::kInMax)
IN_WIDE = 640  # widest padded trunk input of the trunk's wide class (csrc/mlp_stash.cu::kInWide)
SUM_ROWS = 16  # points per row of the trunk's bias sums (csrc/mlp_stash.cu::kSumRows)
ENC_MAX = 64  # widest padded frequency encoding (csrc/sdf_mlp.cuh::kEncMax)
MAX_SPLIT = 16  # row chunks of the weight-cotangent products
# Layers whose tables ride in the CUDA kernels' parameters (csrc/sdf_mlp.cuh::
# kMaxLayers): SDF layers, or the trunk's linears; a deeper network's meta
# vector goes to the card too.  The dW passes take MAX_JOBS products a launch
# (csrc/dw_sum.cuh::kMaxJobs); a longer job table goes to the card too.
MAX_LAYERS = 16
MAX_JOBS = MAX_LAYERS + 1


@dataclass(frozen=True)
class CoreClass:
    """A width class of the SDF kernels: the SDF core's A, D, E and H
    (``csrc/staged_mma.cuh``'s CoreNarrow, CoreWide and CoreHuge) or the
    march kernels' row engine (``csrc/mma_rows.cuh``'s RowsNarrow, RowsWide
    and RowsHuge).  Points (rows) a block pass, the widest padded layer (and
    feature head) and encoding it takes (None: any multiple of 16, device
    memory the only limit), the suffix of its instances' launch counters
    and C entry points, and its bit in the SDF core's dtypes int
    (``csrc/mma_rows.cuh::kWideClass``, ``kHugeClass``; 0 for the row
    engine, whose class picks the entry point by name)."""

    pts: int
    width: int | None
    enc: int | None
    suffix: str
    bit: int


NARROW = CoreClass(CHAIN_TP, 256, ENC_MAX, "", 0)
WIDE = CoreClass(32, 512, 2 * ENC_MAX, "_wide", 4)  # bf16 and f32
# Above WIDE: any width, bf16 operands and a bf16 stash only (csrc/
# staged_mma.cuh::CoreHuge: a block's activations, carry and encoding are
# rows of device memory, ``row_layout``).
CORE_HUGE = CoreClass(CHAIN_TP, None, None, "_huge", 8)
# The row engine above the presets' widths (march kernels C, K, L, M, N):
# 64 bf16 rows a pass (32 f32), bf16 and f32 march weights.
ROWS_WIDE = CoreClass(64, 512, 2 * ENC_MAX, "_wide", 0)
# Above ROWS_WIDE: any width, bf16 march weights only (csrc/mma_rows.cuh::
# RowsHuge: 64 rows a pass whose activations, product output and encoding
# lie in device memory, ``march_layout``).
ROWS_HUGE = CoreClass(CHAIN_TP, None, None, "_huge", 0)
MARCH_RAYS = 4  # rays of a march block (csrc/march_common.cuh::kMarchRays)


@dataclass(frozen=True)
class TrunkClass:
    """A width class of the trunk kernels F, G, I and J (``csrc/mlp_stash.cu``'s
    TrunkNarrow and TrunkWide): points a block, the widest padded hidden
    layer and input it takes, the suffix of its instances' launch counters,
    and its bit in the dtypes int (kWideClass)."""

    pts: int
    width: int
    in_max: int
    suffix: str
    bit: int


TRUNK_NARROW = TrunkClass(CHAIN_TP, 256, IN_MAX, "", 0)
TRUNK_WIDE = TrunkClass(32, 512, IN_WIDE, "_wide", 4)  # bf16 and f32


def core_class(cfg: SDFNetConfig, with_feat: bool = True, compute_dtype: str = "bfloat16",
               stash_dtype: str = "bfloat16") -> CoreClass:
    """The width class whose CUDA instances take ``cfg``'s SDF: NARROW at
    padded widths up to 256 and encodings up to 64 (the presets' and every
    published width), else up to 512 and 128 WIDE, the SDF core's
    (``with_feat``) instances, or ROWS_WIDE, the march kernels C, K, L, M
    and N (``with_feat=False``); above those, at any width, the SDF core's
    CORE_HUGE or the march kernels' ROWS_HUGE.  NARROW and WIDE take every
    ``compute_dtype`` and ``stash_dtype`` (checked, "bfloat16" or
    "float32"; for the march kernels ``compute_dtype`` is the march
    weights' dtype), the huge classes bf16 only; every class takes any
    depth.  Raises ``NotImplementedError`` naming ROADMAP.md Queue 2 item
    15 for an f32 dtype above 512 / 128, and for what JAX's fused core does
    not run either: points other than 3-D, or a skip at layer 0 (its
    forward then fails in ``nrhints_tpu/kernels/core_mlp.py`` and
    ``fields/mlp.py``)."""
    torch_dtype(compute_dtype), torch_dtype(stash_dtype)
    if cfg.d_in != 3 or 0 in cfg.skip_in:
        raise NotImplementedError("the CUDA SDF kernels take 3-D points and no skip at layer 0; JAX's fused core runs "
                                  "neither (ROADMAP.md Queue 3, recorded differences)")
    io, _ = _layer_dims(cfg)
    width = max([_round16(v) for pair in io for v in pair] + [_round16(cfg.d_out_feat) if with_feat else 0])
    enc = _round16(cfg.d_encoded)
    if width <= NARROW.width and enc <= NARROW.enc:
        return NARROW
    if width <= WIDE.width and enc <= WIDE.enc:
        return WIDE if with_feat else ROWS_WIDE
    if not with_feat:
        if compute_dtype == "float32":
            raise NotImplementedError(f"the CUDA march kernels (C, K, L, M, N) take padded widths above {WIDE.width} "
                                      f"or encodings above {WIDE.enc} at bf16 march weights only, got padded width "
                                      f"{width} and encoding {enc} at march_dtype='float32' (ROADMAP.md Queue 2 item "
                                      "15)")
        return ROWS_HUGE
    huge_dtypes(compute_dtype, stash_dtype, f"padded width {width} and encoding {enc}")
    return CORE_HUGE


def huge_dtypes(compute_dtype: str, stash_dtype: str | None, what: str) -> None:
    """Raise ``NotImplementedError`` naming item 15 where a dtype of the SDF
    core above the wide class is f32: its huge instances are bf16 only."""
    if "float32" in (compute_dtype, stash_dtype):
        raise NotImplementedError(f"the CUDA SDF core (kernels A, D, E, H) takes padded widths above {WIDE.width} "
                                  f"or encodings above {WIDE.enc} at bf16 operands and a bf16 stash only, got {what} "
                                  f"at compute_dtype={compute_dtype!r}, stash_dtype={stash_dtype!r} (ROADMAP.md "
                                  "Queue 2 item 15)")


def device_meta(meta: np.ndarray, n_layers: int, dev) -> dict:
    """{"meta_dev": the meta vector on ``dev``} for a network of more than
    ``MAX_LAYERS`` layers (the kernels read its per-layer rows there), else
    {}.  The copy is made at first use and kept (``utils.device_constant``),
    so a CUDA graph's capture, which the eager warm-up precedes, finds it."""
    return {"meta_dev": device_constant(meta.tolist(), torch.int32, dev)} if n_layers > MAX_LAYERS else {}


def meta_args(pk: dict) -> tuple:
    """The meta vector's two arguments of a C entry point: its host copy,
    and its copy on the card (None up to ``MAX_LAYERS`` layers)."""
    return pk["meta"].ctypes.data, pk["meta_dev"].data_ptr() if "meta_dev" in pk else None


def jobs_args(jobs: np.ndarray, dev) -> tuple:
    """The dW job table's three arguments of a backward's C entry point:
    its host copy, its copy on the card (None up to ``MAX_JOBS`` jobs: the
    chain then reads the offsets from its parameters) and its length.  The
    table holds no point count (``dw_jobs``), so the copy, made at first use
    and kept (``utils.device_constant``), serves every n, and a CUDA graph's
    capture, which the eager warm-up precedes, finds it."""
    on_card = device_constant(jobs.reshape(-1).tolist(), torch.int64, dev).data_ptr() if len(jobs) > MAX_JOBS else None
    return jobs.ctypes.data, on_card, len(jobs)


def pack_sdf_mlp(weights: Sequence[torch.Tensor], cfg: SDFNetConfig, with_feat: bool,
                 dtype: torch.dtype = torch.bfloat16) -> dict:
    """Lay the SDF MLP out as ``csrc/sdf_mlp.cuh`` reads it: weights in
    ``dtype`` zero-padded to 16-multiples, f32 biases, the f32 sdf head
    column and the int meta vector.  ``weights`` ends with the sdf head,
    then (when ``with_feat``) the feature head.  ``dtype`` is bf16 for every
    bf16 instance; the f32 march instances (``march_dtype="float32"``,
    ``csrc/mma_rows.cuh::sdf_rows_f32``) and the SDF core's f32 instances
    (``compute_dtype="float32"``) read f32 weights in the same layout.  The
    f32 core layout (``with_feat``) also holds "wtpack": every block
    transposed at the same offset, the B operand of the reverse products
    (``mma_rows.cuh``'s f32 ``gemm_rows64`` reads B row-major).  "cls" is
    the width class of the instances that read it (``core_class``, which
    raises for a config no instance takes); "meta_dev" the meta vector on
    the card, for an SDF deeper than ``MAX_LAYERS`` (``device_meta``); the
    march kernels' huge class takes bf16 weights only, so their f32 pack
    above the wide class raises (``core_class``)."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the packed SDF weights are bf16 or f32, got {dtype}")
    if cfg.encoding != "frequency":
        raise ValueError("the CUDA SDF kernels take the frequency encoding; the renderer runs the hash "
                         "encoding on the unfused path, as the JAX package does")
    cls = core_class(cfg, with_feat, "float32" if dtype == torch.float32 else "bfloat16")
    io, dims = _layer_dims(cfg)
    L, d0, d_last = cfg.n_layers, cfg.d_encoded, dims[-2]
    d_feat = cfg.d_out_feat if with_feat else 0
    kpf, npf = _round16(d_last), _round16(d_feat)
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
    meta = np.asarray(meta, dtype=np.int32)
    pk = {
        "wpack": wpack,
        "bpack": bpack,
        "w_sdf": weights[2 * L].reshape(-1).float().contiguous(),
        "meta": meta,
        "cls": cls,
        **device_meta(meta, L, dev),
    }
    if dtype == torch.float32 and with_feat:
        pk["wtpack"] = torch.zeros_like(wpack)
        for _, _, wo, _, kp, np_ in blocks:
            pk["wtpack"][wo : wo + kp * np_] = wpack[wo : wo + kp * np_].view(kp, np_).t().reshape(-1)
    return pk


def core_pack(weights: Sequence[torch.Tensor], cfg: SDFNetConfig, compute_dtype: str, pk: dict | None = None) -> dict:
    """The SDF core's pack for ``compute_dtype`` (``pk`` when given, checked
    against it)."""
    dt = torch_dtype(compute_dtype)
    pk = pack_sdf_mlp(weights, cfg, with_feat=True, dtype=dt) if pk is None else pk
    if pk["wpack"].dtype != dt:
        raise ValueError(f"the pack holds {pk['wpack'].dtype} weights where compute_dtype is {compute_dtype!r}")
    return pk


def dtype_bits(compute_dtype: str, stash_dtype: str = "bfloat16") -> int:
    """The dtypes int of the SDF core's and the trunk's C entry points: 1
    for f32 dot operands, 2 for an f32 stash (``csrc/mma_rows.cuh``:
    kF32Compute, kF32Stash)."""
    torch_dtype(compute_dtype), torch_dtype(stash_dtype)
    return int(compute_dtype == "float32") | int(stash_dtype == "float32") << 1


def instance_name(kernel: str, compute_dtype: str, stash_dtype: str | None = None) -> str:
    """The launch counter of an SDF core or trunk kernel's instance: the kernel's name
    for bf16 operands, + "_f32" for f32 operands, + "_f32stash" or
    "_bf16stash" for a stash dtype other than the operands'."""
    name = kernel + ("_f32" if compute_dtype == "float32" else "")
    if stash_dtype is not None and stash_dtype != compute_dtype:
        name += "_f32stash" if stash_dtype == "float32" else "_bf16stash"
    return name


def core_instance(kernel: str, pk: dict, compute_dtype: str, stash_dtype: str | None = None) -> tuple[str, int]:
    """(launch counter, dtypes int) of an SDF core or trunk kernel's
    instance for the pack's width class: ``instance_name`` and
    ``dtype_bits``, with "_wide" and the kWideClass bit for a wide class
    (every dtype pair), "_huge" and the kHugeClass bit for the SDF core's
    huge class (bf16 only: an f32 dtype raises ``NotImplementedError``
    naming item 15, before any launch)."""
    cls = pk["cls"]
    if cls is CORE_HUGE:
        huge_dtypes(compute_dtype, stash_dtype, "the huge class")
    bits = dtype_bits(compute_dtype, stash_dtype or "bfloat16") | cls.bit
    return instance_name(kernel, compute_dtype, stash_dtype) + cls.suffix, bits


def _wt(pk: dict):
    """The f32 pack's transposed blocks, or None (the bf16 instances read
    the transposes of wpack's blocks); the SDF core's and the trunk's."""
    return pk["wtpack"].data_ptr() if "wtpack" in pk else None


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


def gate_layout(n: int, gates_total: int, pts: int = CHAIN_TP) -> tuple[int, int, int]:
    """-> (blocks, padded points, f32 elements of the gate scratch) of the
    SDF core's forward (``csrc/sdf_fwd.cuh``: kernels A, D and H's first
    pass) at n points on blocks of ``pts`` (a ``CoreClass``'s): every
    layer's gate sigmoid(100 z_i) per padded point, ``gates_total`` columns
    in the stash's layout."""
    nblk = -(-n // pts)
    npad = nblk * pts
    return nblk, npad, npad * gates_total


def chain_layout(n: int, gates_total: int, cls: CoreClass = NARROW, enc: int | None = None) -> tuple[int, int, int]:
    """-> (blocks, padded points, f32 elements of the device-memory scratch)
    of the SDF backward chain at n points in width class ``cls``: per point
    u_i then dL/dh_i of every layer (``gates_total``), and four f32
    encoding cotangents of ``cls.enc`` each (the huge class's: ``enc``, the
    padded encoding).  The per-block column sums have one row per block."""
    nblk, npad, _ = gate_layout(n, gates_total, cls.pts)
    return nblk, npad, npad * (gates_total + 4 * (enc if cls.enc is None else cls.enc))


def huge_tiles(meta: np.ndarray) -> tuple[int, int]:
    """(width, encoding) of the huge class's tiles from an SDF core pack's
    meta vector: the widest padded layer input or output and feature head,
    and the padded encoding (``csrc/mma_rows.cuh::huge_width`` and
    ``huge_enc``)."""
    L = int(meta[0])
    width = max([int(meta[5]), int(meta[6])] + [int(meta[10 + 7 * i + k]) for i in range(L) for k in (2, 3)])
    return width, _round16(int(meta[2]))


def row_layout(n: int, pk: dict) -> tuple[int, int, int]:
    """-> (blocks, padded points, f32 elements) of the per-block rows that
    the SDF core's huge class keeps in device memory at n points (0
    elements in the other classes, whose tiles fit shared memory): per
    padded point the bf16 activations and the f32 carry at ``huge_tiles``'s
    width and the f32 encoding, 4 bytes an element.  The forward's rows
    follow its gate scratch in one allocation, the chain's its chain
    scratch (``csrc/mma_rows.cuh::huge_row``): at d_hidden 1024 and 65,536
    points, 1,584 floats a point, 415 MB."""
    cls = pk["cls"]
    nblk, npad, _ = gate_layout(n, 0, cls.pts)
    if cls is not CORE_HUGE:
        return nblk, npad, 0
    width, enc = huge_tiles(pk["meta"])
    return nblk, npad, npad * (width // 2 + width + enc)


def march_layout(b: int, pk: dict) -> tuple[int, int]:
    """-> (blocks, f32 elements) of the rows that the march kernels' huge
    class (``ROWS_HUGE``) keeps in device memory at b rays: ``MARCH_RAYS``
    rays a block, ``ROWS_HUGE.pts`` rows a block, each the bf16
    activations and the f32 product output at ``huge_tiles``'s width and
    the f32 encoding (``row_layout``'s row, ``csrc/mma_rows.cuh::huge_row``);
    0 elements in the other classes, whose tiles fit shared memory.  At
    d_hidden 1024 and multi_res 6, 1,584 floats a row, 405,504 bytes a
    block: 51.9 MB at 512 rays."""
    nblk = -(-b // MARCH_RAYS)
    if pk["cls"] is not ROWS_HUGE:
        return nblk, 0
    width, enc = huge_tiles(pk["meta"])
    return nblk, nblk * ROWS_HUGE.pts * (width // 2 + width + enc)


def check_scratch(n_bytes: int, dev, kernel: str) -> None:
    """Raise ``MemoryError`` before any launch where a huge-class call's
    device scratch (``n_bytes``) exceeds the card's free memory and what
    the caching allocator holds unused; outside a CUDA graph's capture (the
    eager warm-up before it checks the same sizes)."""
    if torch.cuda.is_current_stream_capturing():
        return
    free, _ = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    if n_bytes > free + cached:
        raise MemoryError(f"{kernel}: {n_bytes / 1e9:.2f} GB of device scratch at this width and point count, "
                          f"{(free + cached) / 1e9:.2f} GB free on the card: pass fewer points a call")


def trunk_layout(n: int, zt: int, cls: TrunkClass = TRUNK_NARROW) -> tuple[int, int, int, int]:
    """-> (blocks, padded points, rows of the bias sums, elements of kernel
    J's transient z stash) of the trunk's kernels (``csrc/mlp_stash.cu``)
    at n points and ZT stash columns in width class ``cls``: blocks of
    ``cls.pts`` points; one row of f32 column sums of every G_i per
    ``SUM_ROWS`` padded points; J's stash has kernel F's layout [n, ZT], in
    J's operand dtype."""
    nblk, npad, _ = gate_layout(n, 0, cls.pts)
    return nblk, npad, npad // SUM_ROWS, n * zt


def materialize_mlp_weights(params: dict, n_layers: int) -> tuple:
    """Reflectance weight-norm params -> (w0, b0, ..., w_n, b_n), w [in, out]
    and b [out]."""
    out = []
    for i in range(n_layers + 1):
        out += list(effective_weight(params[f"lin{i}"]))
    return tuple(out)


def trunk_class(dims: Sequence[tuple[int, int]]) -> TrunkClass:
    """The width class whose CUDA instances take a trunk of (in, out) layer
    widths ``dims``: TRUNK_NARROW at padded hidden widths up to 256 and a
    padded input up to 384 (the presets'), else TRUNK_WIDE up to 512 and
    640 (``sdf_network.d_out_feat`` = 512 under both hints), at bf16 and
    f32, at any depth.  Raises ``NotImplementedError`` for what no instance
    takes: wider layers or inputs."""
    hidden = max([_round16(o) for _, o in dims] + [_round16(i) for i, _ in dims[1:]])
    d0 = _round16(dims[0][0])
    for cls in (TRUNK_NARROW, TRUNK_WIDE):
        if hidden <= cls.width and d0 <= cls.in_max:
            return cls
    raise NotImplementedError(f"the CUDA trunk kernels (F, G, I, J) take padded hidden widths up to "
                              f"{TRUNK_WIDE.width} and a padded input up to {TRUNK_WIDE.in_max}, got padded hidden "
                              f"{hidden} and input {d0} (ROADMAP.md Queue 2 item 15)")


def check_trunk_widths(dims: Sequence[tuple[int, int]]) -> None:
    """Raise ``NotImplementedError`` where no instance of the CUDA trunk
    kernels takes the trunk's (in, out) layer widths (``trunk_class``)."""
    trunk_class(dims)


def pack_mlp(weights: Sequence[torch.Tensor], n_layers: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Lay the trunk out as ``csrc/mlp_stash.cu`` reads it: per layer a
    zero-padded [kp, np] block (w [in, out]) in ``dtype`` and a padded f32
    bias, and the int meta vector [n_lin, d0, d_out, ZT, then per layer in,
    out, kp, np, w_off, b_off, z_off]; ZT is the width of the packed z_i.
    ``dtype`` is bf16 for the bf16 instances; the f32 instances
    (``compute_dtype="float32"``) read f32 blocks in the same layout and
    "wtpack": every block transposed at the same offset, the B operand of
    the chain's products G_i W_i^T (``mma_rows.cuh``'s f32 products read B
    row-major).  "cls" is the width class of the instances that read it
    (``trunk_class``, which raises for a trunk no instance takes); the
    layout is the same in both classes.  "meta_dev" is the meta vector on
    the card, for more than ``MAX_LAYERS`` linears (``device_meta``)."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the packed trunk weights are bf16 or f32, got {dtype}")
    dev = weights[0].device
    dims = [(weights[2 * i].shape[0], weights[2 * i].shape[1]) for i in range(n_layers + 1)]
    cls = trunk_class(dims)
    meta, w_off, b_off, z_off = [], 0, 0, 0
    for din, dout in dims:
        kp, np_ = _round16(din), _round16(dout)
        meta += [din, dout, kp, np_, w_off, b_off, z_off]
        w_off, b_off = w_off + kp * np_, b_off + np_
        z_off += np_
    zt = sum(_round16(o) for _, o in dims[:-1])
    wpack = torch.zeros(w_off, dtype=dtype, device=dev)
    bpack = torch.zeros(b_off, dtype=torch.float32, device=dev)
    wtpack = torch.zeros(w_off, dtype=dtype, device=dev) if dtype == torch.float32 else None
    for i, (din, dout) in enumerate(dims):
        _, _, kp, np_, wo, bo, _ = meta[7 * i : 7 * i + 7]
        wp = torch.zeros(kp, np_, dtype=dtype, device=dev)
        wp[:din, :dout] = weights[2 * i].to(dtype)
        wpack[wo : wo + kp * np_] = wp.reshape(-1)
        if wtpack is not None:
            wtpack[wo : wo + kp * np_] = wp.t().reshape(-1)
        bpack[bo : bo + dout] = weights[2 * i + 1].reshape(-1).float()
    meta = np.asarray([n_layers + 1, dims[0][0], dims[-1][1], zt] + meta, dtype=np.int32)
    pk = {"wpack": wpack, "bpack": bpack, "meta": meta, "cls": cls, **device_meta(meta, n_layers + 1, dev)}
    if wtpack is not None:
        pk["wtpack"] = wtpack
    return pk


def trunk_pack(weights: Sequence[torch.Tensor], n_layers: int, compute_dtype: str, pk: dict | None = None) -> dict:
    """The trunk's pack for ``compute_dtype`` (``pk`` when given, checked
    against it)."""
    dt = torch_dtype(compute_dtype)
    pk = pack_mlp(weights, n_layers, dt) if pk is None else pk
    if pk["wpack"].dtype != dt:
        raise ValueError(f"the pack holds {pk['wpack'].dtype} weights where compute_dtype is {compute_dtype!r}")
    return pk


def dw_jobs(shapes, npad: int) -> tuple[np.ndarray, int, int]:
    """Layout of the weight-cotangent products C_j = A_j^T B_j at ``npad``
    padded points: ``shapes`` lists (m, ka, nb) per product, whose operands
    have m npad rows.  -> (int64 [J, 6] table of (a, b, m, ka, nb, c_off),
    scratch elements, f32 dW elements): A_j starts at a npad elements of the
    scratch, B_j at b npad (``csrc/dw_sum.cuh::DwJobs``), so the table does
    not depend on npad.  Every offset is a multiple of 16 elements (32-byte
    aligned tiles)."""
    if npad % 16:
        raise ValueError(f"the dW products' padded points must be a multiple of 16, got {npad}")
    table, off, c_off = [], 0, 0
    for m, ka, nb in shapes:
        if ka % 16 or nb % 16:
            raise ValueError(f"dW product widths must be multiples of 16, got {(ka, nb)}")
        a, off = off, off + m * ka
        b, off = off, off + m * nb
        table.append((a, b, m, ka, nb, c_off))
        c_off += ka * nb
    return np.asarray(table, dtype=np.int64), off * npad, c_off


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
    weights: Sequence[torch.Tensor], x: torch.Tensor, cfg: SDFNetConfig, pk: dict | None = None,
    compute_dtype: str = "bfloat16",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel A on the card: (sdf [N], feat [N, F], grad [N, 3]) with dot
    operands of ``compute_dtype`` (bf16, or exact f32: A's f32 instance), f32
    everything else, at the pack's width class.  Its f32 gates go to a
    scratch of ``gate_layout``'s size, freed when this returns."""
    require_cuda(x, (None, 3), "x")
    n = x.shape[0]
    sdf = torch.empty(n, device=x.device)
    feat = torch.empty((n, cfg.d_out_feat), device=x.device)
    gx = torch.empty((n, 3), device=x.device)
    pk = core_pack(weights, cfg, compute_dtype, pk)
    name, bits = core_instance("sdf_core_fwd", pk, compute_dtype)
    if n == 0:
        return sdf, feat, gx
    gates = core_fwd_scratch(n, pk, x.device, name)
    _launch(
        cuda_lib.load("sdf_core"), "sdf_core_fwd", name,
        x.data_ptr(), pk["wpack"].data_ptr(), _wt(pk), pk["bpack"].data_ptr(), pk["w_sdf"].data_ptr(),
        sdf.data_ptr(), feat.data_ptr(), gx.data_ptr(), gates.data_ptr(), n, *meta_args(pk),
        float(cfg.scale), bits, cuda_lib.stream_ptr(x.device),
    )
    return sdf, feat, gx


def core_fwd_scratch(n: int, pk: dict, dev, kernel: str, extra_bytes: int = 0) -> torch.Tensor:
    """The f32 scratch of the SDF core's forward (A, D, H's first pass) at
    n points: the gate scratch (``gate_layout``) and, in the huge class,
    its rows after it (``row_layout``), checked against the card's memory
    with ``extra_bytes`` of the call's other scratch (``check_scratch``)."""
    size = gate_layout(n, int(pk["meta"][9]), pk["cls"].pts)[2] + row_layout(n, pk)[2]
    if pk["cls"] is CORE_HUGE:
        check_scratch(4 * size + extra_bytes, dev, kernel)
    return torch.empty(size, dtype=torch.float32, device=dev)


def sdf_bwd_launch(weights, x, cots, cfg: SDFNetConfig, pk: dict | None = None, stash: torch.Tensor | None = None,
                   need_dw: bool = True, stash_us: bool = False, compute_dtype: str = "bfloat16",
                   stash_dtype: str = "bfloat16"):
    """The SDF core's backward on the card -> (dws, dx) with the shapes of
    ``sdf_core_bwd_plain``'s: kernel E at the ``stash`` (of ``stash_dtype``)
    of kernel D (with ``stash_us``, E's stash_all variant at D's stash_all
    stash, which also holds u_i and g_enc), or, with ``stash=None``, kernel
    H, which first recomputes the layers into a scratch of its own (h_i in
    the operands' dtype and f32 gates, freed when this returns).
    Both run the per-point chain on the class's blocks (dx, the dW operands
    in a scratch of the operands' dtype, per-block f32 column sums of the
    bias cotangents, and u_i and the encoding cotangents in an f32 scratch
    of ``chain_layout``'s size, in the huge class followed by its rows,
    ``row_layout``, freed when this returns), the split-K dW
    products and the in-order sums of the partials (no atomics: the
    gradients repeat bit for bit).  ``compute_dtype`` picks bf16 or exact
    f32 dot operands (the f32 instances); the pack's width class the
    block (``core_class``).  ``need_dw=False`` launches the chain alone ->
    (None, dx): no dW pass runs, and dx is the same bit for bit."""
    ds, df, dgx = cots
    n, dev = x.shape[0], x.device
    pk = core_pack(weights, cfg, compute_dtype, pk)
    if stash is None:
        name, bits = core_instance("sdf_core_bwd", pk, compute_dtype)
    else:
        name, bits = core_instance("sdf_stash_all_bwd" if stash_us else "sdf_stash_bwd", pk, compute_dtype,
                                   stash_dtype)
    cdt, cls = torch_dtype(compute_dtype), pk["cls"]
    meta = pk["meta"]
    L, d_feat, d_last, kpf, npf, gt = (int(meta[k]) for k in (0, 3, 4, 5, 6, 9))
    require_cuda(x, (None, 3), "x")
    if stash is not None:
        from nrhints_torch.kernels.core_stash import sdf_stash_width

        require_cuda(stash, (n, sdf_stash_width(cfg, stash_us)), "stash", torch_dtype(stash_dtype))
    require_cuda(ds, (n,), "d_sdf")
    require_cuda(df, (n, d_feat), "d_feat")
    require_cuda(dgx, (n, 3), "d_grad")
    nblk, npad, n_chain = chain_layout(n, gt, cls, huge_tiles(meta)[1])
    n_chain += row_layout(n, pk)[2]
    layers = [tuple(int(v) for v in meta[10 + 7 * i : 17 + 7 * i]) for i in range(L)]
    jobs, n_scratch, n_dw = dw_jobs([(2, lay[2], lay[3]) for lay in layers] + [(1, kpf, npf)], npad)
    split = dw_split(npad) if need_dw else 0
    pw = gt + npf + 1 + 2 * kpf
    f32 = dict(dtype=torch.float32, device=dev)
    n_gates = gate_layout(n, gt, cls.pts)[2] + row_layout(n, pk)[2]  # H's first pass
    if cls is CORE_HUGE and n > 0:
        hs_bytes = 0 if stash is not None else 2 * n * gt + 4 * n_gates
        check_scratch(2 * n_scratch + 4 * (n_chain + nblk * pw + (split + 1) * n_dw) + hs_bytes, dev, name)
    dx = torch.empty((n, 3), **f32)
    scratch = torch.empty(n_scratch, dtype=cdt, device=dev)
    chain = torch.empty(n_chain, **f32)
    partial = torch.empty((nblk, pw), **f32)
    colsum, part_dw, dw = (torch.empty(pw, **f32), torch.empty((split, n_dw), **f32),
                           torch.empty(n_dw, **f32)) if need_dw else (None, None, None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    tail = (dx.data_ptr(), scratch.data_ptr(), chain.data_ptr(), partial.data_ptr(), ptr(colsum),
            ptr(part_dw), ptr(dw), *jobs_args(jobs, dev), split, n, *meta_args(pk), float(cfg.scale))
    if n > 0 and stash is None:
        hs = torch.empty((n, gt), dtype=cdt, device=dev)
        gates = torch.empty(n_gates, **f32)
        _launch(
            cuda_lib.load("sdf_core_bwd"), "sdf_core_bwd", name,
            x.data_ptr(), ds.data_ptr(), df.data_ptr(), dgx.data_ptr(), pk["wpack"].data_ptr(), _wt(pk),
            pk["bpack"].data_ptr(), pk["w_sdf"].data_ptr(), hs.data_ptr(), gates.data_ptr(), *tail,
            bits, cuda_lib.stream_ptr(dev),
        )
    elif n > 0:
        _launch(
            cuda_lib.load("sdf_stash"), "sdf_stash_all_bwd" if stash_us else "sdf_stash_bwd", name,
            x.data_ptr(), stash.data_ptr(), ds.data_ptr(), df.data_ptr(), dgx.data_ptr(), pk["wpack"].data_ptr(),
            _wt(pk), pk["w_sdf"].data_ptr(), *tail, bits, cuda_lib.stream_ptr(dev),
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


def sdf_core_bwd(weights, x, cots, cfg: SDFNetConfig, pk: dict | None = None, compute_dtype: str = "bfloat16"):
    """Kernel H on the card -> (dws, dx): the recompute VJP of kernel A's
    function from x and the cotangents alone, with A's gates sigmoid(100 z)
    in f32, at dot operands of ``compute_dtype`` (``sdf_bwd_launch``)."""
    return sdf_bwd_launch(weights, x, cots, cfg, pk, compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# Kernels I and J, and the backward plumbing they share with kernel G


def mlp_fwd(weights, x: torch.Tensor, n_layers: int, pk: dict | None = None,
            compute_dtype: str = "bfloat16") -> torch.Tensor:
    """Kernel I on the card -> out [N, d_out] f32 (kernel F without its
    stash; ``trunk_layout``'s blocks of the pack's class), with dot operands
    of ``compute_dtype`` (bf16, or exact f32: I's f32 instance)."""
    pk = trunk_pack(weights, n_layers, compute_dtype, pk)
    name, bits = core_instance("mlp_fwd", pk, compute_dtype)
    meta = pk["meta"]
    n, dev = x.shape[0], x.device
    require_cuda(x, (None, int(meta[1])), "x")
    out = torch.empty((n, int(meta[2])), device=dev)
    if n > 0:
        _launch(
            cuda_lib.load("mlp_stash"), "mlp_fwd", name,
            x.data_ptr(), pk["wpack"].data_ptr(), pk["bpack"].data_ptr(), out.data_ptr(), n, *meta_args(pk),
            bits, cuda_lib.stream_ptr(dev),
        )
    return out


def mlp_bwd_launch(weights, x: torch.Tensor, g: torch.Tensor, n_layers: int, pk: dict | None = None,
                   zs: torch.Tensor | None = None, compute_dtype: str = "bfloat16", stash_dtype: str = "bfloat16"):
    """The trunk's backward on the card -> (dws, dx): kernel G at the ``zs``
    stash (of ``stash_dtype``) of kernel F, or, with ``zs=None``, kernel J,
    which first recomputes the z_i into a transient stash of F's layout in
    the operands' dtype (freed when this returns).  Both run the per-point
    chain on the blocks of the pack's class, then the same split-K dW
    products and in-order sums as kernel E (``trunk_layout``; the dW
    operands in a scratch of the operands' dtype), at dot operands of
    ``compute_dtype`` (bf16, or exact f32: the f32 instances)."""
    pk = trunk_pack(weights, n_layers, compute_dtype, pk)
    if zs is None:
        name, bits = core_instance("mlp_bwd", pk, compute_dtype)
    else:
        name, bits = core_instance("mlp_stash_bwd", pk, compute_dtype, stash_dtype)
    cdt = torch_dtype(compute_dtype)
    meta = pk["meta"]
    n_lin, d0, d_out, zt = (int(v) for v in meta[:4])
    n, dev = x.shape[0], x.device
    require_cuda(x, (n, d0), "x")
    if zs is not None:
        require_cuda(zs, (n, zt), "zs", torch_dtype(stash_dtype))
    require_cuda(g, (n, d_out), "g")
    layers = [tuple(int(v) for v in meta[4 + 7 * i : 11 + 7 * i]) for i in range(n_lin)]
    _, npad, sum_rows, n_zs = trunk_layout(n, zt, pk["cls"])
    jobs, n_scratch, n_dw = dw_jobs([(1, lay[2], lay[3]) for lay in layers], npad)
    split = dw_split(npad)
    bt = sum(lay[3] for lay in layers)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((n, d0), **f32)
    scratch = torch.empty(n_scratch, dtype=cdt, device=dev)
    partial = torch.empty((sum_rows, bt), **f32)
    colsum = torch.empty(bt, **f32)
    part_dw = torch.empty((split, n_dw), **f32)
    dw = torch.empty(n_dw, **f32)
    tail = (dx.data_ptr(), scratch.data_ptr(), partial.data_ptr(), colsum.data_ptr(), part_dw.data_ptr(),
            dw.data_ptr(), *jobs_args(jobs, dev), split, n, *meta_args(pk))
    if n > 0 and zs is None:
        zsc = torch.empty(n_zs, dtype=cdt, device=dev)
        _launch(cuda_lib.load("mlp_stash"), "mlp_bwd", name, x.data_ptr(), g.data_ptr(), pk["wpack"].data_ptr(),
                _wt(pk), pk["bpack"].data_ptr(), zsc.data_ptr(), *tail, bits, cuda_lib.stream_ptr(dev))
    elif n > 0:
        _launch(cuda_lib.load("mlp_stash"), "mlp_stash_bwd", name, x.data_ptr(), zs.data_ptr(), g.data_ptr(),
                pk["wpack"].data_ptr(), _wt(pk), *tail, bits, cuda_lib.stream_ptr(dev))
    else:
        colsum.zero_()
        dw.zero_()
    dws = []
    for i, (din, dout, kp, np_, _w, b_off, _z) in enumerate(layers):
        c_off = int(jobs[i, 5])
        dws += [dw[c_off : c_off + kp * np_].view(kp, np_)[:din, :dout], colsum[b_off : b_off + dout]]
    return tuple(dws), dx


def mlp_bwd(weights, x: torch.Tensor, g: torch.Tensor, n_layers: int, pk: dict | None = None,
            compute_dtype: str = "bfloat16"):
    """Kernel J on the card -> (dws, dx) at dot operands of
    ``compute_dtype`` (``mlp_bwd_launch``)."""
    return mlp_bwd_launch(weights, x, g, n_layers, pk, compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# The autograd ops of the recompute schedule


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
            ctx.pk = core_pack([w.detach() for w in weights], cfg, compute_dtype)
            out = sdf_core_fwd(weights, x, cfg, ctx.pk, compute_dtype)
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
            dws, dx = sdf_core_bwd(weights, x, cots, ctx.cfg, ctx.pk, ctx.compute_dtype)
        return (None, None, dx, *dws)


class MlpFn(torch.autograd.Function):
    """The ReLU trunk with the recompute backward: kernels I and J on CUDA
    tensors, their instances at ``compute_dtype``, ``mlp_relu_plain`` and
    ``mlp_relu_bwd_plain`` on CPU tensors; it saves only x and the
    weights."""

    @staticmethod
    def forward(ctx, n_layers, compute_dtype, x, *weights):
        ctx.n_layers, ctx.compute_dtype = n_layers, compute_dtype
        if x.device.type == "cpu":
            out = mlp_relu_plain(weights, x, n_layers, compute_dtype)
            ctx.pk = None
        else:
            ctx.pk = trunk_pack([w.detach() for w in weights], n_layers, compute_dtype)
            out = mlp_fwd(weights, x, n_layers, ctx.pk, compute_dtype)
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
            dws, dx = mlp_bwd(weights, x, g, ctx.n_layers, ctx.pk, ctx.compute_dtype)
        return (None, None, dx, *dws)


# ---------------------------------------------------------------------------
# Entry points


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
    """(sdf [N], feat [N, F], grad [N, 3]) of the SDF field at ``x``, with
    dot operands of ``compute_dtype`` ("bfloat16", or "float32": exact f32
    dots, the kernels' f32 instances).

    With no gradient wanted, CUDA tensors go through kernel A and CPU
    tensors through ``sdf_core_plain``, whatever ``backward`` says.  When
    autograd needs the op's gradient, ``backward`` is the schedule:
    "recompute" (``SdfCoreFn``: A, then H), "stash", "stash_all" and
    "stash_xla" ``core_stash.fused_sdf_value_feat_grad_stash`` with a bf16
    stash, as JAX's op: "stash" D, then E; "stash_all" D's and E's variants
    that also stash and read the reverse sweep's u_i and g_enc; "stash_xla"
    D, then E's plain version over the whole batch."""
    grad = needs_grad(x, *tree_leaves(params))
    if grad and backward in ("stash", "stash_all", "stash_xla"):
        from nrhints_torch.kernels.core_stash import fused_sdf_value_feat_grad_stash

        return fused_sdf_value_feat_grad_stash(params, cfg, x, compute_dtype=compute_dtype,
                                               stash_us=backward == "stash_all",
                                               bwd_impl="xla" if backward == "stash_xla" else "pallas")
    if grad and backward != "recompute":
        raise NotImplementedError(f"core_backward={backward!r}: the port's fused core has the 'recompute', 'stash', "
                                  "'stash_all' and 'stash_xla' schedules")
    weights = materialize_sdf_weights_full(params, cfg)
    if grad:
        return SdfCoreFn.apply(cfg, compute_dtype, x.contiguous(), *weights)
    return sdf_core_primal(weights, x, cfg, compute_dtype)


def sdf_core_primal(weights, x: torch.Tensor, cfg: SDFNetConfig, compute_dtype: str):
    """The undifferentiated core: kernel A on a CUDA tensor,
    ``sdf_core_plain`` on a CPU tensor (as JAX's ops dispatch their
    non-stash forward for the undifferentiated primal)."""
    if x.device.type == "cpu":
        return sdf_core_plain(weights, x, cfg, compute_dtype)
    return sdf_core_fwd(weights, x.contiguous(), cfg, compute_dtype=compute_dtype)


def mlp_primal(weights, x: torch.Tensor, n_layers: int, compute_dtype: str) -> torch.Tensor:
    """The undifferentiated trunk: kernel I on a CUDA tensor,
    ``mlp_relu_plain`` on a CPU tensor (as JAX's ops dispatch their
    non-stash forward for the undifferentiated primal)."""
    if x.device.type == "cpu":
        return mlp_relu_plain(weights, x, n_layers, compute_dtype)
    return mlp_fwd(weights, x.contiguous(), n_layers, compute_dtype=compute_dtype)


def fused_mlp_apply(params: dict, n_layers: int, x: torch.Tensor, *, compute_dtype: str = "bfloat16",
                    backward: str = "recompute") -> torch.Tensor:
    """The weight-norm ReLU trunk on pre-encoded inputs -> [N, d_out]
    logits, with dot operands of ``compute_dtype`` ("bfloat16", or
    "float32": exact f32 dots, the kernels' f32 instances).  Without a
    gradient: kernel I (or ``mlp_relu_plain`` on the CPU) for every
    ``backward``, as JAX's ops dispatch their non-stash forward for the
    undifferentiated primal.  With one: ``MlpFn`` (I, J) for "recompute";
    the stash schedules go to ``core_stash.fused_mlp_apply_stash`` with a
    bf16 stash, as JAX's routing does: F, then G, or G's plain version for
    "stash_xla" ("stash_all" maps to the stash backward, as in JAX)."""
    torch_dtype(compute_dtype)
    if backward in ("stash", "stash_all", "stash_xla"):
        from nrhints_torch.kernels.core_stash import fused_mlp_apply_stash

        return fused_mlp_apply_stash(params, n_layers, x, compute_dtype=compute_dtype,
                                     bwd_impl="xla" if backward == "stash_xla" else "pallas")
    x = x.contiguous()
    weights = materialize_mlp_weights(params, n_layers)
    if not needs_grad(x, *tree_leaves(params)):
        return mlp_primal(weights, x, n_layers, compute_dtype)
    if backward == "recompute":
        return MlpFn.apply(n_layers, compute_dtype, x, *weights)
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
    compute_dtype: str = "bfloat16",
    backward: str = "recompute",
) -> torch.Tensor:
    """The reflectance field on the fused path: the frequency encodings and
    the concat in PyTorch, the trunk through ``fused_mlp_apply`` at
    ``compute_dtype`` under the ``backward`` schedule, then the sigmoid
    (``core_mlp.py::fused_reflectance_forward`` of the JAX package)."""
    from nrhints_torch.core.encodings import nerf_encoding

    parts = [points, nerf_encoding(view_dirs, cfg.multi_res), normals, nerf_encoding(point_lights, cfg.multi_res),
             feature_vectors]
    if visibilities is not None:
        parts.append(nerf_encoding(visibilities, cfg.multi_res))
    if specular_cue is not None:
        parts.append(nerf_encoding(specular_cue, cfg.multi_res))
    out = fused_mlp_apply(params, cfg.n_layers, torch.cat(parts, dim=-1), compute_dtype=compute_dtype,
                          backward=backward)
    return torch.sigmoid(out) if cfg.squeeze_out else out
