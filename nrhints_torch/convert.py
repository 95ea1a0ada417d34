"""Carry a JAX parameter tree across to the port.

``params_from_jax`` takes the tree of ``nrhints_tpu`` parameters as nested
dicts of numpy arrays (``jax.device_get`` of the JAX tree gives exactly
that) and returns the same keys with torch tensors:
``renderer/sdf/lin{i}/{v,g,b}``, ``out_sdf``, ``out_feat``, ``variance``,
``color/lin{i}``, ``raygen/...``.  Weights keep their [in, out] layout, so
nothing is transposed.
"""
from __future__ import annotations

import numpy as np
import torch

from nrhints_torch.utils import resolve_device


def params_from_jax(tree, device="cuda"):
    """Nested dict of arrays -> the same nesting of torch tensors, on the
    card unless ``device="cpu"`` (without CUDA the default raises)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if not np.issubdtype(arr.dtype, np.number):
        raise TypeError(f"params_from_jax: unexpected leaf of dtype {arr.dtype}")
    return torch.as_tensor(np.array(arr), device=device)
