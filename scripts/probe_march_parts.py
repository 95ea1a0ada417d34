#!/usr/bin/env python3
"""Where kernel C's time goes: its launch with one part of the row engine
(``csrc/mma_rows.cuh``) left out at a time.

    python3 scripts/probe_march_parts.py

Each variant is a copy of ``csrc/`` under ``build/probe/march_parts/`` with
text substitutions applied to ``mma_rows.cuh`` (each must match), built
with the package's nvcc flags, all builds started together.  Every variant
runs kernel C (``shadow_final``) on ``chip_smoke.py``'s phase 3 inputs (512
shadow rays, full width, seed 0), the weights packed once, and the script
prints the time of one launch (CUDA events around 20 launches, the best of
3 repeats) and the time the left-out part saved.  Variants:

  full          the kernel as shipped (its tau is checked against
                ``kernels.march.shadow_final``);
  no_softplus   the epilogue's softplus and gate replaced by z + b and 1
                (the bf16 stores and the skip rounding kept);
  no_copies     no weight slab copied (the ring's stale contents multiplied);
  no_mma        the ldmatrix fragments loaded, no mma.sync;
  no_fragments  neither ldmatrix nor mma.sync (the slab loop's waits,
                barriers and copies kept);
  no_encoding   the sin and cos channels replaced by a coordinate;
  skeleton      no_softplus, no_copies and no_fragments together.

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

# (substring of mma_rows.cuh, replacement)
NO_SOFTPLUS = [
    ("softplus100_gate(acc[0][j][e] + bc, &sp, &gate);", "sp = acc[0][j][e] + bc, gate = 1.0f;"),
    ("softplus100_gate(acc[MT - 1][j][e] + bc, &sp, &gate);", "sp = acc[MT - 1][j][e] + bc;"),
]
NO_COPIES = [
    ("stage_slab<false>(W, np, kp, np, ring, s + kChainStages - 1);", "cp_async_commit();"),
    ("  stage_first_slabs<false>(wpack + m.w_off[0]", "  if (0) stage_first_slabs<false>(wpack + m.w_off[0]"),
    ("if (!last) stage_first_slabs", "if (0) stage_first_slabs"),
]
NO_MMA = [("for (int i = 0; i < MT; ++i) mma_16816(", "for (int i = 0; i < 0; ++i) mma_16816(")]
NO_FRAGMENTS = [("for (int kk = 0; kk < kend; kk += 16) {", "for (int kk = 0; kk < 0; kk += 16) {")]
NO_ENCODING = [("v = freq_channel(xs, ts, c, F, DUAL ? &t : nullptr);", "v = xs[c % 3], t = ts[c % 3];")]
VARIANTS = {
    "full": [], "no_softplus": NO_SOFTPLUS, "no_copies": NO_COPIES, "no_mma": NO_MMA,
    "no_fragments": NO_FRAGMENTS, "no_encoding": NO_ENCODING, "skeleton": NO_SOFTPLUS + NO_COPIES + NO_FRAGMENTS,
}


def build_variants(root: Path) -> dict[str, Path]:
    from nrhints_torch.kernels import cuda_lib

    procs, libs = {}, {}
    for name, subs in VARIANTS.items():
        src = root / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(cuda_lib.CSRC, src)
        text = (src / "mma_rows.cuh").read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in mma_rows.cuh")
            text = text.replace(old, new)
        (src / "mma_rows.cuh").write_text(text)
        libs[name] = src / "libmarch.so"
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(src), "-o", str(libs[name]), str(src / "march.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{text}")
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_march_parts: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import march_chunk
    from nrhints_torch.kernels import cuda_lib, march
    from nrhints_torch.kernels.core_mlp import pack_sdf_mlp

    libs = build_variants(REPO / "build" / "probe" / "march_parts")
    mc = march_chunk("cuda")
    cfg = mc["cfg"].model.sdf_network
    sz, sl, sdir, sdist, mw = mc["sz"], mc["sl"], mc["sdir"], mc["sdist"], mc["mw"]
    inv_s = torch.as_tensor(mc["inv_s"], dtype=torch.float32, device=sz.device).reshape(1)
    anneal = torch.as_tensor(mc["anneal"], dtype=torch.float32, device=sz.device).reshape(1)
    pk = pack_sdf_mlp(mw, cfg, with_feat=False)
    stream = cuda_lib.stream_ptr(sz.device)
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    times = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.shadow_final.argtypes = cuda_lib._SIGNATURES["march"]["shadow_final"]
        lib.shadow_final.restype = ctypes.c_int
        tau = torch.empty((sz.shape[0], 1), device=sz.device)

        def launch():
            rc = lib.shadow_final(
                sz.data_ptr(), sl.data_ptr(), sdir.data_ptr(), sdist.data_ptr(), pk["wpack"].data_ptr(),
                pk["bpack"].data_ptr(), pk["w_sdf"].data_ptr(), inv_s.data_ptr(), anneal.data_ptr(), tau.data_ptr(),
                sz.shape[0], pk["meta"].ctypes.data, float(cfg.scale), stream)
            if rc:
                raise RuntimeError(f"variant {name}: CUDA error {rc}")

        for _ in range(3):
            launch()
        torch.cuda.synchronize()
        if name == "full":
            ref = march.shadow_final(sz, sl, sdir, sdist, inv_s, anneal, mw, cfg)
            print(f"full: tau equals kernels.march.shadow_final's bit for bit: {torch.equal(tau, ref)}")
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
        print(f"{name}: {times[name]:.4f} ms a launch (repeats {', '.join(f'{r:.4f}' for r in reps)}){saved}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
