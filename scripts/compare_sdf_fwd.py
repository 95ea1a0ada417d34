#!/usr/bin/env python3
"""Kernel A of two checkouts of the PyTorch/CUDA port, compared bit for bit.

    python3 scripts/compare_sdf_fwd.py TREE_A TREE_B

Each tree's ``nrhints_torch`` runs ``core_mlp.sdf_core_fwd`` on a CUDA card,
in a process of its own, on the same 65,536 points (seed 0, one train
step's core call) and the full-width SDF weights made from seed 0; the
script prints each output's largest absolute difference and whether all
three are equal.  It needs one card.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path


def run(tree: str, out: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch
    from nrhints_torch.fields.sdf import SDFNetConfig, sdf_init
    from nrhints_torch.kernels import core_mlp

    cfg = SDFNetConfig()
    w = core_mlp.materialize_sdf_weights_full(sdf_init(torch.Generator().manual_seed(0), cfg, "cuda"), cfg)
    x = torch.tensor(np.random.default_rng(0).normal(size=(65536, 3)).astype(np.float32) * 0.5, device="cuda")
    torch.save([t.cpu() for t in core_mlp.sdf_core_fwd(w, x, cfg)], out)


def main() -> int:
    if sys.argv[1] == "--run":
        run(sys.argv[2], sys.argv[3])
        return 0
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        outs = []
        for i, tree in enumerate(sys.argv[1:3]):
            path = str(Path(tmp) / f"{i}.pt")
            subprocess.run([sys.executable, __file__, "--run", tree, path], check=True)
            outs.append(torch.load(path))
    diffs = {name: (a - b).abs().max().item() for name, a, b in zip(("sdf", "feat", "grad"), *outs)}
    equal = all(torch.equal(a, b) for a, b in zip(*outs))
    print(f"kernel A, {sys.argv[1]} against {sys.argv[2]}: max abs difference {diffs}; equal bit for bit: {equal}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
