#!/usr/bin/env python3
"""Where the time of the 64-point trunk forward goes: kernel I (and F) of
``nrhints_torch`` on trunks of other depths and widths, on one CUDA card.

    python3 scripts/profile_trunk_shapes.py

Every 64-point kernel (A, D, E, H, F, G, I, J) streams its weights through
``staged_mma.cuh::gemm_rows64``'s ring in 64-row k-slabs, one block of 16
warps per SM.  This script times kernel I by the profiler's device time
(mean of 10 launches) on ReLU trunks whose products differ only in slab
count, slab width and the warps they keep busy, so that the cost of a
product can be told apart:

- per slab whatever its width (the ring's wait and barrier, each warp's
  chain of dependent fragment loads and MMAs): a 256x64 product then costs
  as much per slab as a 256x256 one;
- per byte or per operation (L2 traffic, tensor-core throughput): a
  256x64 product then costs a quarter of a 256x256 one.

It prints, per configuration, the device ms per launch and the ms per
block wave (132 blocks of 64 points), and for the pairs that differ by
known products the ms that difference costs.  Weights: torch.nn.Linear's
default init from seed 1; inputs: seed 0.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

WAVE = 132 * 64  # one block per SM on an H100 SXM
SHIPPING = (361, 256, 256, 256, 256, 3)
# name -> (dims, points)
CONFIGS = {
    "shipping, 65,536 points": (SHIPPING, 65536),
    "shipping, 1 wave": (SHIPPING, WAVE),
    "shipping, 2 waves": (SHIPPING, 2 * WAVE),
    "shipping, 8 waves": (SHIPPING, 8 * WAVE),
    "256 -> 256 -> 16": ((256, 256, 16), 8 * WAVE),
    "256 -> 2x256 -> 16": ((256, 256, 256, 16), 8 * WAVE),
    "256 -> 4x256 -> 16": ((256, 256, 256, 256, 256, 16), 8 * WAVE),
    "256 -> 64 -> 256 -> 16": ((256, 64, 256, 16), 8 * WAVE),
    "256 -> 64 -> 256 -> 64 -> 256 -> 16": ((256, 64, 256, 64, 256, 16), 8 * WAVE),
    "64 -> 64 -> 16": ((64, 64, 16), 8 * WAVE),
    "64 -> 4x64 -> 16": ((64, 64, 64, 64, 64, 16), 8 * WAVE),
}
# (label, config a, config b, the products b adds to a as k-slabs of 64 rows x N columns)
PAIRS = (
    ("three 256x256 products (12 slabs of N=256)", "256 -> 256 -> 16", "256 -> 4x256 -> 16"),
    ("one 256x256 product (4 slabs of N=256)", "256 -> 256 -> 16", "256 -> 2x256 -> 16"),
    ("a 256x64 and a 64x256 product (4 slabs of N=64, 1 of N=256)", "256 -> 64 -> 256 -> 16",
     "256 -> 64 -> 256 -> 64 -> 256 -> 16"),
    ("three 64x64 products (3 slabs of N=64)", "64 -> 64 -> 16", "64 -> 4x64 -> 16"),
)


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nrhints_torch.fields.mlp import torch_default_linear_init
    from nrhints_torch.kernels import core_mlp, core_stash

    if not torch.cuda.is_available():
        print("profile_trunk_shapes: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    def device_ms(fn, key: str, reps: int = 10) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and key in e.key)
        return us / 1e3 / reps

    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    ms = {}
    for name, (dims, n) in CONFIGS.items():
        gen = torch.Generator().manual_seed(1)
        w = []
        for i in range(len(dims) - 1):
            w += list(torch_default_linear_init(gen, dims[i], dims[i + 1], dev))
        n_layers = len(dims) - 2
        pk = core_mlp.pack_mlp(w, n_layers)
        x = torch.tensor(np.random.default_rng(0).normal(size=(n, dims[0])).astype(np.float32), device=dev)
        ms[name] = device_ms(lambda: core_mlp.mlp_fwd(w, x, n_layers, pk), "mlp_fwd_kernel<__nv_bfloat16, __nv_bfloat16, 0>")
        waves = -(-n // 64) / 132
        line = f"kernel I, {name} ({n} points, {waves:.2f} waves): {ms[name]:.4f} ms, {ms[name] / waves:.4f} ms a wave"
        if dims == SHIPPING and n == 65536:
            f_ms = device_ms(lambda: core_stash.mlp_stash_fwd(w, x, n_layers, pk), "mlp_fwd_kernel<__nv_bfloat16, __nv_bfloat16, 1>")
            line += f"; kernel F {f_ms:.4f} ms (the stash store {f_ms - ms[name]:.4f} ms)"
        print(line, flush=True)
    for label, a, b in PAIRS:
        d = ms[b] - ms[a]
        print(f"{label}: {d:.4f} ms at 8 waves, {d / 8 * 1e3:.2f} us a block")
    return 0


if __name__ == "__main__":
    sys.exit(main())
