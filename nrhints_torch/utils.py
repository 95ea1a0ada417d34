"""Device resolution and parameter-tree walks shared by the port's entry
points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises instead of falling back to the CPU when CUDA is
    missing.  Pins float32 matmuls and convolutions to full float32 (no
    TF32): the plain tensor code around the kernels must stay f32."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "nrhints_torch: CUDA is not available; pass device='cpu' to "
                "run the plain PyTorch path on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"nrhints_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev


def tree_items(tree, prefix: str = ""):
    """(path, leaf) of a nested dict of tensors in sorted key order; paths
    read "/renderer/sdf/lin0/v"."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def tree_map(tree, fn):
    """A nested dict of tensors with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list[torch.Tensor]:
    """The leaves of a nested dict of tensors, in ``tree_items``'s order."""
    return [leaf for _, leaf in tree_items(tree)]


_CONSTANTS: dict = {}


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A 1-d tensor of host constants on ``device``, made at first use and
    kept for the process (callers only read it, so sharing is harmless).  A
    CUDA graph capture cannot copy from the host, and the eager warm-up
    before every capture makes the tensor first."""
    key = (tuple(values), dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(key[0], dtype=dtype, device=device)
    return t
