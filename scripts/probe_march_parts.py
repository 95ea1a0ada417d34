#!/usr/bin/env python3
"""Where the time of a march kernel on the row engine goes: its launch with
one part left out at a time.

    python3 scripts/probe_march_parts.py [C] [K] [L] [M]

Kernels (C when none is named): C (``shadow_final``, the final dual sweep
of the shadow march), K (``march_sweep``, the initial value sweep), L
(``march_rounds``, the 4 refinement rounds from K's sdf0) and M
(``importance_march``, the initial sweep and the 4 refinement rounds; L and
M by the bitonic merge).  Each variant is a copy of ``csrc/`` under
``build/probe/march_parts/`` with text substitutions applied to
``mma_rows.cuh`` or ``march_common.cuh`` (each must match), built with the
package's nvcc flags, all builds started together (``march.cu`` for C,
``march_fused.cu`` for K, L and M).  Every variant runs the kernel on
``chip_smoke.py``'s phase 3 inputs (one 512-ray chunk: C on its shadow
rays' refined z, K, L and M on its camera rays' z0; full width, seed 0), the
weights packed once, and the script prints the time of one launch (CUDA
events around 20 launches, the best of 3 repeats) and the time the
left-out part saved.  Variants:

  full          the kernel as shipped (its output is checked against the
                package's wrapper, bit for bit);
  no_softplus   the epilogue's softplus and gate replaced by z + b and 1
                (the bf16 stores and the skip rounding kept);
  no_copies     no weight slab copied (the ring's stale contents multiplied);
  no_mma        the ldmatrix fragments loaded, no mma.sync;
  no_fragments  neither ldmatrix nor mma.sync (the slab loop's waits,
                barriers and copies kept);
  no_encoding   the sin and cos channels replaced by a coordinate;
  skeleton      no_softplus, no_copies and no_fragments together;
  no_machinery  (L and M) no draw and no merge in the rounds: each round
                sweeps the first n_new slots of the buffer as its new samples.

The outputs of every variant but ``full`` are wrong by design; only their
times are read.  It needs one card.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# kernel: (source, C function)
KERNELS = {"C": ("march", "shadow_final"), "K": ("march_fused", "march_sweep"), "L": ("march_fused", "march_rounds"),
           "M": ("march_fused", "importance_march")}
ROWS, COMMON = "mma_rows.cuh", "march_common.cuh"
# (header, substring, replacement)
NO_SOFTPLUS = [
    (ROWS, "softplus100_gate(acc[0][j][e] + bc, &sp, &gate);", "sp = acc[0][j][e] + bc, gate = 1.0f;"),
    (ROWS, "softplus100_gate(acc[MT - 1][j][e] + bc, &sp, &gate);", "sp = acc[MT - 1][j][e] + bc;"),
]
NO_COPIES = [
    (ROWS, "stage_rows_slab<Cls>(W, np, kp, ring, s + kChainStages - 1);", "cp_async_commit();"),
    (ROWS, "  stage_first_rows_slabs<Cls>(wpack + m.w_off[0]", "  if (0) stage_first_rows_slabs<Cls>(wpack + m.w_off[0]"),
    (ROWS, "if (!last) stage_first_rows_slabs", "if (0) stage_first_rows_slabs"),
]
NO_MMA = [(ROWS, "for (int i = 0; i < MT; ++i) mma_16816(", "for (int i = 0; i < 0; ++i) mma_16816(")]
NO_FRAGMENTS = [(ROWS, "for (int kk = 0; kk < kend; kk += 16) {", "for (int kk = 0; kk < 0; kk += 16) {")]
NO_ENCODING = [(ROWS, "v = freq_channel(xs, ts, c, F, DUAL ? &t : nullptr);", "v = xs[c % 3], t = ts[c % 3];")]
NO_MACHINERY = [
    (COMMON, """ray_step<RANK>(zr, sr, i == 0 ? -1 : vn - n_new, pz, ps, vn, base_inv_s * ldexpf(1.0f, i), oo, od, last,
                       S.sz[warp], S.ss[warp], S.sc[warp], nn, nz);""",
     "for (int q = 0; q < 4; ++q) nz[q] = zr[q];"),
]
VARIANTS = {
    "full": [], "no_softplus": NO_SOFTPLUS, "no_copies": NO_COPIES, "no_mma": NO_MMA,
    "no_fragments": NO_FRAGMENTS, "no_encoding": NO_ENCODING, "skeleton": NO_SOFTPLUS + NO_COPIES + NO_FRAGMENTS,
    "no_machinery": NO_MACHINERY,
}


def variants_of(kernel: str) -> list[str]:
    return [v for v in VARIANTS if v != "no_machinery" or kernel in ("L", "M")]


def build_variants(root: Path, kernels: list[str]) -> dict[tuple[str, str], Path]:
    """Every (variant, source) the named kernels run, built in parallel."""
    from nrhints_torch.kernels import cuda_lib

    procs, libs = {}, {}
    for name, subs in VARIANTS.items():
        sources = sorted({KERNELS[k][0] for k in kernels if name in variants_of(k)})
        if not sources:
            continue
        src = root / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(cuda_lib.CSRC, src)
        for header, old, new in subs:
            text = (src / header).read_text()
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in {header}")
            (src / header).write_text(text.replace(old, new))
        for source in sources:
            lib = libs[name, source] = src / f"lib{source}.so"
            cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(src), "-o", str(lib), str(src / f"{source}.cu")]
            procs[name, source] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for key, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {key[0]} of {key[1]}.cu:\n{text}")
    return libs


def main() -> int:
    import torch

    kernels = sys.argv[1:] or ["C"]
    if not set(kernels) <= set(KERNELS):
        print(f"probe_march_parts: kernels are {', '.join(KERNELS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("probe_march_parts: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import march_chunk
    from nrhints_torch.kernels import cuda_lib, march
    from nrhints_torch.kernels.core_mlp import meta_args, pack_sdf_mlp

    libs = build_variants(REPO / "build" / "probe" / "march_parts", kernels)
    mc = march_chunk("cuda")
    cfg = mc["cfg"].model.sdf_network
    mw = mc["mw"]
    dev = mc["sz"].device
    inv_s = torch.as_tensor(mc["inv_s"], dtype=torch.float32, device=dev).reshape(1)
    anneal = torch.as_tensor(mc["anneal"], dtype=torch.float32, device=dev).reshape(1)
    pk = pack_sdf_mlp(mw, cfg, with_feat=False)
    weights = (pk["wpack"].data_ptr(), pk["bpack"].data_ptr(), pk["w_sdf"].data_ptr())
    meta, scale, stream = meta_args(pk), float(cfg.scale), cuda_lib.stream_ptr(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    for kernel in kernels:
        source, fn = KERNELS[kernel]
        if kernel == "C":
            sz, sl, sdir, sdist = mc["sz"], mc["sl"], mc["sdir"], mc["sdist"]
            out = torch.empty((sz.shape[0], 1), device=dev)
            args = (sz.data_ptr(), sl.data_ptr(), sdir.data_ptr(), sdist.data_ptr(), *weights, inv_s.data_ptr(),
                    anneal.data_ptr(), out.data_ptr(), sz.shape[0], *meta, scale)
            ref = march.shadow_final(sz, sl, sdir, sdist, inv_s, anneal, mw, cfg)
        else:
            z0, o, d = mc["z0"], mc["o"], mc["d"]
            out = torch.empty((z0.shape[0], 64 if kernel == "K" else 128), device=dev)
            args = (z0.data_ptr(), o.data_ptr(), d.data_ptr(), *weights, out.data_ptr(), z0.shape[0], *meta, scale)
            if kernel == "K":
                ref = march.march_sweep(z0, o, d, mw, cfg)
            elif kernel == "L":
                sdf0 = march.march_sweep(z0, o, d, mw, cfg)
                args = args[:1] + (sdf0.data_ptr(),) + args[1:] + (64.0, 0)
                ref = march.march_rounds(z0, sdf0, o, d, mw, cfg)
            else:
                args += (64.0, 0)
                ref = march.importance_march(z0, o, d, mw, cfg)
        times = {}
        for name in variants_of(kernel):
            lib = ctypes.CDLL(str(libs[name, source]))
            f = getattr(lib, fn)
            f.argtypes = cuda_lib._SIGNATURES[source][fn]
            f.restype = ctypes.c_int

            def launch():
                rc = f(*args, stream)
                if rc:
                    raise RuntimeError(f"{kernel} variant {name}: CUDA error {rc}")

            for _ in range(3):
                launch()
            torch.cuda.synchronize()
            if name == "full":
                print(f"{kernel} full: output equals the package's {fn} bit for bit: {torch.equal(out, ref)}")
            reps = []
            for _ in range(3):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    launch()
                end.record()
                end.synchronize()
                reps.append(start.elapsed_time(end) / 20)
            times[name] = min(reps)
            saved = f"; saves {times['full'] - times[name]:.4f} ms" if name != "full" else ""
            print(f"{kernel} {name}: {times[name]:.4f} ms a launch (repeats {', '.join(f'{r:.4f}' for r in reps)}){saved}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
