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
without them reports none); then the wide class's instances ("... wide":
A, D, E, H and the variants in bf16, A and H in f32) at d_hidden 512 on
the same points, where both trees have them.  The script prints each
kernel's largest absolute difference and whether all its outputs are
equal.  It needs one card.

The trees run in turns, A, B, B, A, each in a process of its own; each run
also prints the device time of each bf16 kernel (A, D, E1 and its dW
passes, H1, H2 and H's dW passes, and the stash_all variants) and of A's and
H's f32 instances on those inputs, the median of 5 profiled calls
(chip_smoke.py's kernel_device_ms), so each time is read twice; the outputs
compared are each tree's first run's.
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
    wide_cfg = SDFNetConfig(d_hidden=512)
    wide = hasattr(core_mlp, "WIDE") and core_mlp.core_class(wide_cfg) is core_mlp.WIDE
    if wide:  # trees with the wide class
        ww = core_mlp.materialize_sdf_weights_full(sdf_init(torch.Generator().manual_seed(0), wide_cfg, "cuda"),
                                                   wide_cfg)
        res["A wide"] = list(core_mlp.sdf_core_fwd(ww, x, wide_cfg))
        for name, us in (("D wide", False), ("D stash_all wide", True)):
            res[name] = list(core_stash.sdf_stash_fwd(ww, x, wide_cfg, stash_us=us))
            e_dws, e_dx = core_stash.sdf_stash_bwd(ww, x, res[name][3], cots, wide_cfg, stash_us=us)
            res[name.replace("D", "E", 1)] = [e_dx, *e_dws]
        h_dws, h_dx = core_mlp.sdf_core_bwd(ww, x, cots, wide_cfg)
        res["H wide"] = [h_dx, *h_dws]
        res["A f32 wide"] = list(core_mlp.sdf_core_fwd(ww, x, wide_cfg, compute_dtype="float32"))
        h_dws, h_dx = core_mlp.sdf_core_bwd(ww, x, cots, wide_cfg, compute_dtype="float32")
        res["H f32 wide"] = [h_dx, *h_dws]
    from chip_smoke import kernel_device_ms

    dw = "dW passes of E/G/H/J (dw_sum.cuh)"
    stash, stash_all = res["D"][3], res["D stash_all"][3]
    calls = {
        "A": (lambda: core_mlp.sdf_core_fwd(w, x, cfg), "kernel A sdf_core_fwd"),
        "D": (lambda: core_stash.sdf_stash_fwd(w, x, cfg), "kernel D sdf_stash_fwd"),
        "E": (lambda: core_stash.sdf_stash_bwd(w, x, stash, cots, cfg), ("kernel E sdf_stash_bwd (E1)", dw)),
        "H": (lambda: core_mlp.sdf_core_bwd(w, x, cots, cfg),
              ("kernel H, forward pass (H1)", "kernel H chain (H2)", dw)),
        "D stash_all": (lambda: core_stash.sdf_stash_fwd(w, x, cfg, stash_us=True),
                        "kernel D stash_all variant sdf_stash_all_fwd"),
        "E stash_all": (lambda: core_stash.sdf_stash_bwd(w, x, stash_all, cots, cfg, stash_us=True),
                        ("kernel E stash_all variant sdf_stash_all_bwd (E1)", dw)),
        "A f32": (lambda: core_mlp.sdf_core_fwd(w, x, cfg, compute_dtype="float32"), "kernel A float32/float32"),
        "H f32": (lambda: core_mlp.sdf_core_bwd(w, x, cots, cfg, compute_dtype="float32"),
                  ("kernel H1 float32/float32", "kernel H2 float32/float32", dw)),
    }
    if wide:
        ws, ws_all = res["D wide"][3], res["D stash_all wide"][3]
        calls.update({
            "A wide": (lambda: core_mlp.sdf_core_fwd(ww, x, wide_cfg), "kernel A sdf_core_fwd_wide"),
            "D wide": (lambda: core_stash.sdf_stash_fwd(ww, x, wide_cfg), "kernel D sdf_stash_fwd_wide"),
            "E wide": (lambda: core_stash.sdf_stash_bwd(ww, x, ws, cots, wide_cfg),
                       ("kernel E sdf_stash_bwd_wide (E1)", dw)),
            "H wide": (lambda: core_mlp.sdf_core_bwd(ww, x, cots, wide_cfg),
                       ("kernel H wide, forward pass (H1)", "kernel H wide chain (H2)", dw)),
            "D stash_all wide": (lambda: core_stash.sdf_stash_fwd(ww, x, wide_cfg, stash_us=True),
                                 "kernel D' sdf_stash_all_fwd_wide"),
            "E stash_all wide": (lambda: core_stash.sdf_stash_bwd(ww, x, ws_all, cots, wide_cfg, stash_us=True),
                                 ("kernel E' sdf_stash_all_bwd_wide (E1)", dw)),
            "A f32 wide": (lambda: core_mlp.sdf_core_fwd(ww, x, wide_cfg, compute_dtype="float32"),
                           "kernel A wide float32/float32"),
            "H f32 wide": (lambda: core_mlp.sdf_core_bwd(ww, x, cots, wide_cfg, compute_dtype="float32"),
                           ("kernel H1 wide float32/float32", "kernel H2 wide float32/float32", dw)),
        })
    times = {k: kernel_device_ms(fn, group, tries=5) for k, (fn, group) in calls.items()}
    torch.save({"outs": {k: [t.cpu() for t in v] for k, v in res.items()}, "times": times}, out)


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
        if name not in b:
            continue
        diff = max((u.float() - v.float()).abs().max().item() for u, v in zip(a[name], b[name]))
        same = len(a[name]) == len(b[name]) and all(torch.equal(u, v) for u, v in zip(a[name], b[name]))
        equal &= same
        print(f"kernel {name}, {trees[0]} against {trees[1]}: max abs difference {diff:.3e}; equal bit for "
              f"bit: {same}")
    print(f"SDF core kernels A, D, E, H (bf16 and f32, 64-point and wide), {trees[0]} against {trees[1]}: all "
          f"outputs equal bit for bit: {equal}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
