#!/usr/bin/env python3
"""The SDF core's kernels of two checkouts of the PyTorch/CUDA port,
compared bit for bit.

    python3 scripts/compare_sdf_fwd.py TREE_A TREE_B

Each tree's ``nrhints_torch`` runs, on a CUDA card, in a process of its own,
on the same 65,536 points (seed 0, one train step's core call), the
full-width SDF weights made from seed 0 and the same cotangents (seed 1):
kernel A (``core_mlp.sdf_core_fwd``), D and D's stash_all variant
(``core_stash.sdf_stash_fwd``: outputs and stash), E and E's variant at
their own tree's D stash (``core_stash.sdf_stash_bwd``) and H
(``core_mlp.sdf_core_bwd``), each with its default (bf16) dtypes, which
both trees take; then the same kernels' f32 instances (A and H at
compute_dtype="float32", D, E and the variants at each (compute, stash)
dtype pair with an f32 in it), where both trees have them (a tree
without them reports none).  The script prints each kernel's largest
absolute difference and whether all its outputs are equal.  It needs one
card.
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
    from nrhints_torch.kernels import core_mlp, core_stash

    cfg = SDFNetConfig()
    n = 65536
    w = core_mlp.materialize_sdf_weights_full(sdf_init(torch.Generator().manual_seed(0), cfg, "cuda"), cfg)
    x = torch.tensor(np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32) * 0.5, device="cuda")
    rng = np.random.default_rng(1)
    cots = tuple(torch.tensor(rng.normal(size=s).astype(np.float32), device="cuda")
                 for s in ((n,), (n, cfg.d_out_feat), (n, 3)))
    res = {"A": list(core_mlp.sdf_core_fwd(w, x, cfg))}
    for name, us in (("D", False), ("D stash_all", True)):
        res[name] = list(core_stash.sdf_stash_fwd(w, x, cfg, stash_us=us))
        e_dws, e_dx = core_stash.sdf_stash_bwd(w, x, res[name][3], cots, cfg, stash_us=us)
        res[name.replace("D", "E")] = [e_dx, *e_dws]
    h_dws, h_dx = core_mlp.sdf_core_bwd(w, x, cots, cfg)
    res["H"] = [h_dx, *h_dws]
    if hasattr(core_mlp, "dtype_bits"):  # the f32 instances
        res["A f32"] = list(core_mlp.sdf_core_fwd(w, x, cfg, compute_dtype="float32"))
        h_dws, h_dx = core_mlp.sdf_core_bwd(w, x, cots, cfg, compute_dtype="float32")
        res["H f32"] = [h_dx, *h_dws]
        for compute, stash in (("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "float32")):
            kw = dict(compute_dtype=compute, stash_dtype=stash)
            for name, us in (("D", False), ("D stash_all", True)):
                key = f"{name} {compute}/{stash}"
                res[key] = list(core_stash.sdf_stash_fwd(w, x, cfg, stash_us=us, **kw))
                e_dws, e_dx = core_stash.sdf_stash_bwd(w, x, res[key][3], cots, cfg, stash_us=us, **kw)
                res[key.replace("D", "E", 1)] = [e_dx, *e_dws]
    torch.save({k: [t.cpu() for t in v] for k, v in res.items()}, out)


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
    for name in outs[0]:
        if name not in outs[1]:
            continue
        a, b = outs[0][name], outs[1][name]
        diff = max((u.float() - v.float()).abs().max().item() for u, v in zip(a, b))
        equal = len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))
        print(f"kernel {name}, {sys.argv[1]} against {sys.argv[2]}: max abs difference {diff:.3e}; equal bit for "
              f"bit: {equal}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
