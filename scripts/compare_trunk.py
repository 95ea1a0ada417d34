#!/usr/bin/env python3
"""The reflectance trunk's kernels F, I, G and J of two checkouts of the
PyTorch/CUDA port, compared bit for bit.

    python3 scripts/compare_trunk.py TREE_A TREE_B

Each tree's ``nrhints_torch`` runs, in a process of its own on a CUDA card,
kernel F (``core_stash.mlp_stash_fwd``: output and bf16 stash), kernel I
(``core_mlp.mlp_fwd``), kernel G at F's stash (``core_stash.mlp_stash_bwd``)
and kernel J (``core_mlp.mlp_bwd``) on the same 65,536 points (one train
step's trunk call) of random 361-wide inputs (seed 6), a random cotangent of
the 3 outputs, and the full-width trunk 361 -> 4 x 256 -> 3 with
torch.nn.Linear's default init from seed 1.  The script prints, per output,
the largest absolute difference (for the bias cotangents also against the
largest |db_i|) and whether all are equal.  It needs one card.

The trees run in turns, A, B, B, A, each in a process of its own; each run
also prints the device time of F, I, G (its chain and dW passes) and J (J1,
its chain and dW passes) on those inputs, the median of 5 profiled calls
(chip_smoke.py's kernel_device_ms), so each time is read twice; the outputs
compared are each tree's first run's.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

DIMS = (361, 256, 256, 256, 256, 3)
N_POINTS = 65536


def run(tree: str, out: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch
    from nrhints_torch.fields.mlp import torch_default_linear_init
    from nrhints_torch.kernels import core_mlp, core_stash

    gen = torch.Generator().manual_seed(1)
    w = []
    for i in range(len(DIMS) - 1):
        w += list(torch_default_linear_init(gen, DIMS[i], DIMS[i + 1], "cuda"))
    n_layers = len(DIMS) - 2
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.normal(size=(N_POINTS, DIMS[0])).astype(np.float32), device="cuda")
    g = torch.tensor(rng.normal(size=(N_POINTS, DIMS[-1])).astype(np.float32), device="cuda")
    f_out, f_zs = core_stash.mlp_stash_fwd(w, x, n_layers)
    outs = {"F out": f_out, "F stash": f_zs, "I out": core_mlp.mlp_fwd(w, x, n_layers)}
    for name, (dws, dx) in (("G", core_stash.mlp_stash_bwd(w, x, f_zs, g, n_layers)),
                            ("J", core_mlp.mlp_bwd(w, x, g, n_layers))):
        outs[f"{name} dx"] = dx
        for i in range(n_layers + 1):
            outs[f"{name} dW{i}"], outs[f"{name} db{i}"] = dws[2 * i], dws[2 * i + 1]
    from chip_smoke import kernel_device_ms

    chain, dw = "trunk chain: G1, or J2 after J1", "dW passes of E/G/H/J (dw_sum.cuh)"
    calls = {
        "F": (lambda: core_stash.mlp_stash_fwd(w, x, n_layers), "kernel F mlp_stash_fwd"),
        "I": (lambda: core_mlp.mlp_fwd(w, x, n_layers), "kernel I mlp_fwd"),
        "G": (lambda: core_stash.mlp_stash_bwd(w, x, f_zs, g, n_layers), (chain, dw)),
        "J": (lambda: core_mlp.mlp_bwd(w, x, g, n_layers), ("kernel J, recompute pass (J1)", chain, dw)),
    }
    times = {k: kernel_device_ms(fn, group, tries=5) for k, (fn, group) in calls.items()}
    torch.save({"outs": {k: v.cpu() for k, v in outs.items()}, "times": times}, out)


def main() -> int:
    if sys.argv[1] == "--run":
        run(sys.argv[2], sys.argv[3])
        return 0
    import torch

    trees = sys.argv[1:3]
    with tempfile.TemporaryDirectory() as tmp:
        runs = []  # (tree index, result) in the order A, B, B, A
        for i in (0, 1, 1, 0):
            path = str(Path(tmp) / f"{len(runs)}.pt")
            subprocess.run([sys.executable, __file__, "--run", trees[i], path], check=True)
            runs.append((i, torch.load(path)))
    for k in runs[0][1]["times"]:
        per_tree = [[res["times"][k] for i, res in runs if i == t] for t in (0, 1)]
        mean = [sum(v) / len(v) for v in per_tree]
        seq = ", ".join(f"{res['times'][k]:.5f}" for _, res in runs)
        print(f"kernel {k} device time (ms; runs A, B, B, A): {seq}; {trees[1]} / {trees[0]} = "
              f"{mean[1] / mean[0]:.4f}")
    a, b = runs[0][1]["outs"], runs[1][1]["outs"]
    equal = True
    for name in a:
        same = torch.equal(a[name], b[name])
        equal &= same
        diff = (a[name].float() - b[name].float()).abs().max().item()
        scale = f" (largest |value| {a[name].abs().max().item():.3e})" if " db" in name else ""
        print(f"trunk {name}: max abs difference {diff:.3e}{scale}; equal bit for bit: {same}")
    print(f"trunk kernels F, I, G, J, {sys.argv[1]} against {sys.argv[2]}: all outputs equal bit for bit: {equal}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
