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
f32 ones (the f32 instances), and the shipping route under both merges:
``fused_importance_z`` on the camera rays and ``fused_shadow_tau`` on the
shadow rays with ``split=True`` and the "xla" sweeps and rounds (plain
16-sample sweeps between kernel B's steps; C for the shadow rays' final
sweep).  The script prints, per output, the largest absolute difference and
whether the two trees' outputs are equal bit for bit, and each tree's device
time of kernels B (a launch of the shipping route's camera march), C, K, L,
M and N (bf16, bitonic) on those inputs, the median of 5 profiled calls
(chip_smoke.py's kernel_device_ms).  The trees run in turns, A, B, B, A,
each in a process of its own, so each time is read twice; the outputs
compared are each tree's first run's.  It needs one card.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
INPUTS = ("o", "d", "z0", "sl", "sdir", "sdist", "z0s", "sz", "inv_s", "anneal")
# chip_smoke.py's device-time group of each timed kernel
TIMED = {"B": "kernel B round_machinery", "C": "kernel C shadow_final", "K": "kernel K march_sweep",
         "L": "kernel L march_rounds", "M": "kernel M importance_march", "N": "kernel N shadow_march"}


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

    mcfg = nr_hints().model
    cfg = mcfg.sdf_network
    t = torch.load(inputs)
    mw = [w.cuda() for w in t["mw"]]
    sdf_params = tree_to(t["sdf_params"], "cuda")
    o, d, z0, sl, sdir, sdist, z0s, sz, inv_s, anneal = (t[k].cuda() for k in INPUTS)
    outs = {}
    for label, w in (("", mw), (" f32", march.march_weights(sdf_params, cfg, "float32"))):
        sdf0 = outs[f"K{label} sdf0"] = march.march_sweep(z0, o, d, w, cfg)
        for merge in ("bitonic", "rank"):
            outs[f"L{label} z ({merge})"] = march.march_rounds(z0, sdf0, o, d, w, cfg, merge=merge)
            outs[f"M{label} z ({merge})"] = march.importance_march(z0, o, d, w, cfg, merge=merge)
        outs[f"C{label} tau"] = march.shadow_final(sz, sl, sdir, sdist, inv_s, anneal, w, cfg)
        for merge in ("bitonic", "rank"):
            outs[f"N{label} tau ({merge})"] = march.shadow_march(z0s, sl, sdir, sdist, inv_s, anneal, w, cfg,
                                                                 merge=merge)
    ship = dict(mlp_dtype=mcfg.renderer.march_dtype, split=True, sweep_impl="xla", rounds_impl="xla")

    def shipping_z(merge="bitonic"):
        return march.fused_importance_z(sdf_params, cfg, o, d, z0, merge=merge, **ship)

    for merge in ("bitonic", "rank"):
        outs[f"shipping z ({merge})"] = shipping_z(merge)
        outs[f"shipping tau ({merge})"] = march.fused_shadow_tau(sdf_params, cfg, sl, sdir, z0s, sdist, inv_s, anneal,
                                                                 merge=merge, final_impl="pallas", **ship)

    sdf0 = outs["K sdf0"]
    calls = {
        "B": shipping_z, "C": lambda: march.shadow_final(sz, sl, sdir, sdist, inv_s, anneal, mw, cfg),
        "K": lambda: march.march_sweep(z0, o, d, mw, cfg), "L": lambda: march.march_rounds(z0, sdf0, o, d, mw, cfg),
        "M": lambda: march.importance_march(z0, o, d, mw, cfg),
        "N": lambda: march.shadow_march(z0s, sl, sdir, sdist, inv_s, anneal, mw, cfg),
    }
    before = cuda_lib.launch_counts["round_machinery"]
    shipping_z()
    b_launches = cuda_lib.launch_counts["round_machinery"] - before
    times = {k: kernel_device_ms(fn, TIMED[k], tries=5) / (b_launches if k == "B" else 1) for k, fn in calls.items()}
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
    for k in TIMED:
        per_tree = [[res["times"][k] for i, res in runs if i == t] for t in (0, 1)]
        mean = [sum(v) / len(v) for v in per_tree]
        seq = ", ".join(f"{res['times'][k]:.5f}" for _, res in runs)
        print(f"kernel {k} device time{' a launch' if k == 'B' else ''} (ms; runs A, B, B, A): {seq}; "
              f"{trees[1]} / {trees[0]} = {mean[1] / mean[0]:.4f}")
    print(f"kernel B: {runs[0][1]['b_launches']} launches a shipping camera march")
    a, b = runs[0][1]["outs"], runs[1][1]["outs"]
    equal = True
    for name in a:
        same = torch.equal(a[name], b[name])
        equal &= same
        print(f"march {name}: max abs difference {(a[name] - b[name]).abs().max().item():.3e}; "
              f"equal bit for bit: {same}")
    print(f"march kernels K, L, M, C, N (bf16 and f32) and the shipping route (B), {trees[0]} against "
          f"{trees[1]}: all outputs equal bit for bit: {equal}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
