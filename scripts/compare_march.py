#!/usr/bin/env python3
"""The march kernels B, C, K, L, M and N of two checkouts of the PyTorch/CUDA
port, compared bit for bit.

    python3 scripts/compare_march.py TREE_A TREE_B

The inputs are those of ``chip_smoke.py``'s phase 3 (``march_chunk``, from
the checkout that holds this script): the full-width ``nr-hints`` SDF with
random weights from seed 0, one 512-ray chunk of the 128x128 view and its
512 shadow rays.  Each tree's ``nrhints_torch`` then runs, in a process of
its own on a CUDA card, kernel K on the camera rays' z0, L on K's sdf0 and
M on z0 under both merges, C on the shadow rays' refined z, N on their
z0 under both merges, each with the bf16 march weights and again with the
f32 ones (the f32 instances); the same at a 512-wide SDF (random weights
from seed 0: the wide instances); the geometry twins of K, L, M and N (the
run-time instances, at 5 x 12, bitonic) of each of those four; and the
shipping route under both merges:
``fused_importance_z`` on the camera rays and ``fused_shadow_tau`` on the
shadow rays with ``split=True`` and the "xla" sweeps and rounds (plain
16-sample sweeps between kernel B's steps; C for the shadow rays' final
sweep).  The script prints, per output, the largest absolute difference and
whether the two trees' outputs are equal bit for bit, and each tree's device
time of kernels B (a launch of the shipping route's camera march), C, K, L,
M and N (bitonic) of every instance above on those inputs, the median of 3
profiled calls (chip_smoke.py's kernel_device_ms), and whether each of
those times is within 2% of the other tree's.  The trees run in turns, A,
B, B, A, each in a process of its own, so each time is read twice; the
outputs compared are each tree's first run's.  It needs one card.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
INPUTS = ("o", "d", "z0", "sl", "sdir", "sdist", "z0s", "sz", "inv_s", "anneal")
FNS = {"C": "shadow_final", "K": "march_sweep", "L": "march_rounds", "M": "importance_march", "N": "shadow_march"}
GEOMETRY = (5, 12)  # the geometry twins' (rounds, n_new)
WITHIN = 0.02  # the device-time band of "within 2%"


def group(k: str, label: str) -> str:
    """chip_smoke.py's device-time group of kernel ``k`` of an instance
    ``label`` ("", " f32", " wide", " f32 wide"; a geometry twin is in its
    compile-time instance's group)."""
    if k == "B":
        return "kernel B round_machinery"
    dt, wide = ("_f32" if "f32" in label else ""), ("_wide" if "wide" in label else "")
    return f"kernel {k}{label} {FNS[k]}{dt}{wide}"


def make_inputs(path: str) -> None:
    import torch

    sys.path.insert(0, str(REPO))
    from chip_smoke import march_chunk, tree_to

    mc = march_chunk("cuda")
    torch.save({"mw": [w.cpu() for w in mc["mw"]], "sdf_params": tree_to(mc["renderer_params"]["sdf"], "cpu"),
                **{k: torch.as_tensor(mc[k]).cpu() for k in INPUTS}}, path)


def run(tree: str, inputs: str, out: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from chip_smoke import kernel_device_ms, tree_to
    from nrhints_torch.configs.config import nr_hints
    from nrhints_torch.kernels import cuda_lib, march

    import dataclasses

    from nrhints_torch.fields.sdf import sdf_init

    mcfg = nr_hints().model
    cfg = mcfg.sdf_network
    wcfg = dataclasses.replace(cfg, d_hidden=512)
    t = torch.load(inputs)
    mw = [w.cuda() for w in t["mw"]]
    sdf_params = tree_to(t["sdf_params"], "cuda")
    wparams = sdf_init(torch.Generator().manual_seed(0), wcfg, "cuda")
    o, d, z0, sl, sdir, sdist, z0s, sz, inv_s, anneal = (t[k].cuda() for k in INPUTS)
    rounds, n_new = GEOMETRY
    n0 = 128 - rounds * n_new
    lin = torch.linspace(0.0, 1.0, n0, device="cuda")[None, :]
    z0g = (z0[:, :1] + (z0[:, -1:] - z0[:, :1]) * lin).contiguous()
    z0sg = (lin * z0s[:, -1:]).contiguous()
    outs, calls = {}, {}
    classes = (("", mw, cfg), (" f32", march.march_weights(sdf_params, cfg, "float32"), cfg),
               (" wide", march.march_weights(wparams, wcfg, "bfloat16"), wcfg),
               (" f32 wide", march.march_weights(wparams, wcfg, "float32"), wcfg))
    for label, w, c in classes:
        sdf0 = outs[f"K{label} sdf0"] = march.march_sweep(z0, o, d, w, c)
        for merge in ("bitonic", "rank"):
            outs[f"L{label} z ({merge})"] = march.march_rounds(z0, sdf0, o, d, w, c, merge=merge)
            outs[f"M{label} z ({merge})"] = march.importance_march(z0, o, d, w, c, merge=merge)
        outs[f"C{label} tau"] = march.shadow_final(sz, sl, sdir, sdist, inv_s, anneal, w, c)
        for merge in ("bitonic", "rank"):
            outs[f"N{label} tau ({merge})"] = march.shadow_march(z0s, sl, sdir, sdist, inv_s, anneal, w, c,
                                                                 merge=merge)
        geo = dict(rounds=rounds, n_new=n_new)
        sdf0g = outs[f"K{label} geom sdf0"] = march.march_sweep(z0g, o, d, w, c)
        outs[f"L{label} geom z"] = march.march_rounds(z0g, sdf0g, o, d, w, c, **geo)
        outs[f"M{label} geom z"] = march.importance_march(z0g, o, d, w, c, **geo)
        outs[f"N{label} geom tau"] = march.shadow_march(z0sg, sl, sdir, sdist, inv_s, anneal, w, c, **geo)
        calls.update({
            (f"C{label}", "C"): lambda w=w, c=c: march.shadow_final(sz, sl, sdir, sdist, inv_s, anneal, w, c),
            (f"K{label}", "K"): lambda w=w, c=c: march.march_sweep(z0, o, d, w, c),
            (f"L{label}", "L"): lambda w=w, c=c, s0=sdf0: march.march_rounds(z0, s0, o, d, w, c),
            (f"M{label}", "M"): lambda w=w, c=c: march.importance_march(z0, o, d, w, c),
            (f"N{label}", "N"): lambda w=w, c=c: march.shadow_march(z0s, sl, sdir, sdist, inv_s, anneal, w, c),
            (f"K{label} geom", "K"): lambda w=w, c=c: march.march_sweep(z0g, o, d, w, c),
            (f"L{label} geom", "L"): lambda w=w, c=c, s0=sdf0g: march.march_rounds(z0g, s0, o, d, w, c, **geo),
            (f"M{label} geom", "M"): lambda w=w, c=c: march.importance_march(z0g, o, d, w, c, **geo),
            (f"N{label} geom", "N"): lambda w=w, c=c: march.shadow_march(z0sg, sl, sdir, sdist, inv_s, anneal, w, c,
                                                                         **geo),
        })
    ship = dict(mlp_dtype=mcfg.renderer.march_dtype, split=True, sweep_impl="xla", rounds_impl="xla")

    def shipping_z(merge="bitonic"):
        return march.fused_importance_z(sdf_params, cfg, o, d, z0, merge=merge, **ship)

    for merge in ("bitonic", "rank"):
        outs[f"shipping z ({merge})"] = shipping_z(merge)
        outs[f"shipping tau ({merge})"] = march.fused_shadow_tau(sdf_params, cfg, sl, sdir, z0s, sdist, inv_s, anneal,
                                                                 merge=merge, final_impl="pallas", **ship)

    calls[("B", "B")] = shipping_z
    before = cuda_lib.launch_counts["round_machinery"]
    shipping_z()
    b_launches = cuda_lib.launch_counts["round_machinery"] - before
    times = {name: kernel_device_ms(fn, group(k, name[1:].replace(" geom", "")), tries=3)
             / (b_launches if k == "B" else 1) for (name, k), fn in calls.items()}
    torch.save({"outs": {k: v.cpu() for k, v in outs.items()}, "times": times, "b_launches": b_launches}, out)


def main() -> int:
    if sys.argv[1] == "--inputs":
        make_inputs(sys.argv[2])
        return 0
    if sys.argv[1] == "--run":
        run(sys.argv[2], sys.argv[3], sys.argv[4])
        return 0
    import torch

    trees = sys.argv[1:3]
    with tempfile.TemporaryDirectory() as tmp:
        inputs = str(Path(tmp) / "inputs.pt")
        subprocess.run([sys.executable, __file__, "--inputs", inputs], check=True)
        runs = []  # (tree index, result) in the order A, B, B, A
        for i in (0, 1, 1, 0):
            path = str(Path(tmp) / f"{len(runs)}.pt")
            subprocess.run([sys.executable, __file__, "--run", trees[i], inputs, path], check=True)
            runs.append((i, torch.load(path)))
    within = True
    for k in runs[0][1]["times"]:
        per_tree = [[res["times"][k] for i, res in runs if i == t] for t in (0, 1)]
        mean = [sum(v) / len(v) for v in per_tree]
        seq = ", ".join(f"{res['times'][k]:.5f}" for _, res in runs)
        ratio = mean[1] / mean[0]
        within &= abs(ratio - 1.0) <= WITHIN
        print(f"kernel {k} device time{' a launch' if k == 'B' else ''} (ms; runs A, B, B, A): {seq}; "
              f"{trees[1]} / {trees[0]} = {ratio:.4f}")
    print(f"every kernel's device time of {trees[1]} within {WITHIN:.0%} of {trees[0]}'s: {within}")
    print(f"kernel B: {runs[0][1]['b_launches']} launches a shipping camera march")
    a, b = runs[0][1]["outs"], runs[1][1]["outs"]
    equal = True
    for name in a:
        same = torch.equal(a[name], b[name])
        equal &= same
        print(f"march {name}: max abs difference {(a[name] - b[name]).abs().max().item():.3e}; "
              f"equal bit for bit: {same}")
    print(f"march kernels K, L, M, C, N (bf16 and f32, narrow and wide, and K-N's geometry twins) and the shipping "
          f"route (B), {trees[0]} against {trees[1]}: all outputs equal bit for bit: {equal}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
