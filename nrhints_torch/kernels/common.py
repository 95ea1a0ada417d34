"""Building blocks shared by the kernel modules (port of
``nrhints_tpu/kernels/common.py``)."""
from __future__ import annotations

import math

import torch

from nrhints_torch.fields.mlp import effective_weight
from nrhints_torch.fields.sdf import SDFNetConfig

INV_SQRT2 = 1.0 / math.sqrt(2.0)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``compute_dtype`` or ``stash_dtype`` name."""
    if name not in DTYPES:
        raise ValueError(f"expected 'float32' or 'bfloat16', got {name!r}")
    return DTYPES[name]


def materialize_sdf_weights(params: dict, cfg: SDFNetConfig) -> tuple:
    """Weight-norm SDF params -> (w0, b0, ..., w{L-1}, b{L-1}, w_sdf, b_sdf),
    w [in, out] and b [out], computed once per call outside the kernels."""
    out = []
    for i in range(cfg.n_layers):
        out += list(effective_weight(params[f"lin{i}"]))
    out += list(effective_weight(params["out_sdf"]))
    return tuple(out)


def softplus100_gate(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(softplus(100 z) * 0.01, sigmoid(100 z)) from ONE exponential:
    e = exp(-|t|) feeds softplus in its logaddexp form and the sigmoid as
    1/(1+e) or e/(1+e) by sign.  The CUDA kernels use the same form."""
    t = 100.0 * z
    e = torch.exp(-torch.abs(t))
    inv = 1.0 / (1.0 + e)
    gate = torch.where(t >= 0.0, inv, e * inv)
    sp = (torch.clamp(t, min=0.0) + torch.log1p(e)) * 0.01
    return sp, gate


def gate_from_h(h: torch.Tensor) -> torch.Tensor:
    """sigmoid(100 z) recovered from h = softplus(100 z)/100, elementwise:
    1 - exp(-100 h) (``core_stash.py::_gate_from_h``)."""
    return 1.0 - torch.exp(-100.0 * h)


def dot(x: torch.Tensor, w: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """``x @ w`` with f32 accumulation; ``compute_dtype="bfloat16"`` rounds
    both operands to bf16 first (the products of two bf16 values are exact
    in f32, so an f32 matmul of the rounded values is a bf16-operand dot)."""
    if compute_dtype == "bfloat16":
        x = x.to(torch.bfloat16).float()
        w = w.to(torch.bfloat16).float()
    elif compute_dtype != "float32":
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {compute_dtype!r}")
    return x.float() @ w.float()
