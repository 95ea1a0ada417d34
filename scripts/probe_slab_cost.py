#!/usr/bin/env python3
"""What one k-slab of ``staged_mma.cuh::gemm_rows64`` costs on the card, and
which of its parts costs it (``scripts/probe_slab_cost.cu`` describes the
eleven modes).

    python3 scripts/probe_slab_cost.py

Builds the probe with the package's nvcc flags into ``build/probe/``, runs
each mode on 8 waves of blocks (8 x 132, one block of 512 threads per SM)
and on one wave, with 0, 4 and 16 products of 64 x 256 x 256 a block, and
prints the time of a kernel (CUDA events, mean of 10 launches), and from
the 4 and 16 product runs the time of one product and of one slab of one
block (the slope) and a block's fixed time (the intercept), and whether
mode 8's products equal mode 0's, and mode 10's mode 9's, bit for bit.  It
needs one card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

LAYERS, SLABS = 16, 4  # products a block, slabs a product
MODES = ("gemm_rows64 as the kernels run it", "no weight copies", "copies, waits and barriers only",
         "waits and barriers only", "one barrier a product", "six barriers a product",
         "accumulator fill and store only", "commits, waits and barriers, no accumulators",
         "ldmatrix and mma.sync in place of WMMA", "gemm_rows64<true>, the transposed product",
         "the transposed product with ldmatrix and mma.sync")


def main() -> int:
    import torch

    from nrhints_torch.kernels import cuda_lib

    if not torch.cuda.is_available():
        print("probe_slab_cost: needs a CUDA card", file=sys.stderr)
        return 1
    out_dir = REPO / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libprobe_slab_cost.so"
    src = REPO / "scripts" / "probe_slab_cost.cu"
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(cuda_lib.CSRC), "-o", str(lib_path), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.probe_slab.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p]
    lib.probe_slab.restype = ctypes.c_int
    dev = torch.device("cuda")
    w = (torch.rand((4, 256, 256), generator=torch.Generator().manual_seed(0)) * 0.1).to(torch.bfloat16).to(dev)
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    for waves in (8, 1):
        blocks = 132 * waves
        out = torch.empty(blocks + 64 * 256, device=dev)
        last_c = {}
        stream = torch.cuda.current_stream(dev).cuda_stream
        for mode, label in enumerate(MODES):
            ms = {}
            for layers in (0, 4, LAYERS):
                def launch():
                    rc = lib.probe_slab(mode, w.data_ptr(), layers, out.data_ptr(), blocks, stream)
                    if rc:
                        raise RuntimeError(f"probe mode {mode}: CUDA error {rc}")
                for _ in range(3):
                    launch()
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    launch()
                end.record()
                end.synchronize()
                ms[layers] = start.elapsed_time(end) / 10
            last_c[mode] = out[blocks:].clone()
            per_product = (ms[LAYERS] - ms[4]) / (LAYERS - 4) / waves * 1e3
            print(f"mode {mode} ({label}), {waves} wave(s): {ms[0]:.4f} / {ms[4]:.4f} / {ms[LAYERS]:.4f} ms a kernel "
                  f"at 0 / 4 / {LAYERS} products a block; {per_product:.3f} us a product, "
                  f"{per_product / SLABS:.3f} us a slab, {(ms[4] / waves * 1e3 - 4 * per_product):.3f} us a block "
                  f"besides", flush=True)
        for a, b in ((0, 8), (9, 10)):
            same = torch.equal(last_c[a], last_c[b])
            print(f"{waves} wave(s): mode {b}'s last product equals mode {a}'s bit for bit: {same} (max abs "
                  f"difference {(last_c[a] - last_c[b]).abs().max().item():.3e}, largest |C| "
                  f"{last_c[a].abs().max().item():.3e})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"after the runs, SM clock, max SM clock, power draw, power limit: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
