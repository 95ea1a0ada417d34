"""Build and load the port's CUDA kernels.

Each ``nrhints_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``build/nrhints_torch/`` at the repository root, and loaded with
``ctypes``.  The library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and a stale build is never loaded.
Nothing here runs at import: the CPU tests import every module.

The wrappers in ``core_mlp.py``, ``core_stash.py`` and ``march.py`` add one to
``launch_counts[<kernel>]`` where they launch a kernel, and nowhere else.
Headers (``*.cuh``) hold what several sources share: ``sdf_fwd.cuh`` the
SDF forward of kernels A, D and H, ``sdf_bwd.cuh`` the chain of E and H,
``dw_sum.cuh`` the dW passes of E, G, H and J, ``staged_mma.cuh`` the
cp.async-staged products of that forward, that chain and those passes,
``march_common.cuh`` the march machinery (one warp a ray) and template of B,
C, K, L, M and N, ``mma_rows.cuh`` the ldmatrix and mma.sync row engine of
the sweeps of C, K, L, M and N, and the f32 engine of their f32 instances
(``*_f32``, counted under their own names) and of the SDF core's f32
instances and the trunk's.  The SDF core's entry points (A, D, E, H and
D's and E's stash_all variants) and the trunk's (F, G, I and J) take an
int of dtype bits (``core_mlp.dtype_bits``); each instance counts under
``core_mlp.instance_name``: the kernel's name, with ``_f32`` for f32 dot
operands and ``_f32stash`` / ``_bf16stash`` for a stash dtype other than
the operands'; the SDF core's wide instances (``core_mlp.WIDE``: padded
widths above 256 or encodings above 64, every dtype pair) count as
``_wide`` after the dtypes' suffix (its huge ones, ``core_mlp.CORE_HUGE``:
any wider SDF, bf16 only, bit 3 of the dtypes int, as ``_huge``), and so do
the march kernels' wide
instances (``core_mlp.ROWS_WIDE``: C, K, L,
M and N, ``*_wide`` and ``*_f32_wide``, each its own C entry point; their
huge ones, ``core_mlp.ROWS_HUGE``: any wider SDF, bf16 weights only,
``*_huge``, each taking its device-memory rows scratch last, K-N in
``march_fused_huge.cu`` with their run-time geometry twins), and
the trunk's (``core_mlp.TRUNK_WIDE``: padded hidden widths above 256 or
inputs above 384, bf16 and f32, ``*_wide`` after the dtypes' suffix, bit 2
of the dtypes int).  Kernels B, K, L, M and N at a march geometry other
than 64 + 4 x 16 run their run-time geometry instances, ``*_geom`` after
the other suffixes (B in ``march.cu``, K-N in ``march_geom.cu`` and, with
f32 weights, ``march_geom_f32.cu``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nrhints_torch"
SOURCES = ("sdf_core", "march", "sdf_stash", "mlp_stash", "sdf_core_bwd", "march_fused", "march_fused_wide",
           "march_geom", "march_geom_f32", "march_fused_huge")
# -fmad=false keeps each f32 multiply and add separately rounded, as the
# plain PyTorch versions compute them, so kernel and plain version differ
# only in summation order and bf16 rounding flips.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# The launch counters of the SDF core's instances (core_mlp.instance_name)
# by dtypes and width class (core_mlp.NARROW, WIDE: "_wide"), and the huge
# class's bf16 instances (core_mlp.CORE_HUGE: "_huge").  Every instance is
# one of the six C entry points below, picked by the dtypes int's bits.
SDF_CORE_KERNELS = ("sdf_core_fwd", "sdf_core_bwd", "sdf_stash_fwd", "sdf_stash_bwd", "sdf_stash_all_fwd",
                    "sdf_stash_all_bwd")
SDF_CORE_INSTANCES = [
    f"{k}{c}{w}" for w in ("", "_wide") for k, dtypes in (
        ("sdf_core_fwd", ("", "_f32")), ("sdf_core_bwd", ("", "_f32")),
        *((k, ("", "_f32", "_f32_bf16stash", "_f32stash"))
          for k in ("sdf_stash_fwd", "sdf_stash_bwd", "sdf_stash_all_fwd", "sdf_stash_all_bwd"))) for c in dtypes
] + [f"{k}_huge" for k in SDF_CORE_KERNELS]
# The march kernels' instances by weight dtype and width class: each is a
# C entry point of march.cu (C) or march_fused.cu (K, L, M, N; the wide
# class's march_fused_wide.cu, the huge class's march_fused_huge.cu) and a
# launch counter of the same name; and K-N's run-time geometry instances,
# "_geom" (march_geom.cu, with f32 weights march_geom_f32.cu, the huge
# class's march_fused_huge.cu), and B's (round_machinery_geom, march.cu).
MARCH_FUSED = ("march_sweep", "march_rounds", "importance_march", "shadow_march")
MARCH_INSTANCES = [f"{k}{d}{w}" for k in ("shadow_final", *MARCH_FUSED) for d in ("", "_f32")
                   for w in ("", "_wide")] + [f"{k}_huge" for k in ("shadow_final", *MARCH_FUSED)]
MARCH_GEOM_INSTANCES = ["round_machinery_geom"] + [
    f"{k}{d}{w}_geom" for k in MARCH_FUSED for d in ("", "_f32") for w in ("", "_wide")] + [
    f"{k}_huge_geom" for k in MARCH_FUSED]
# The trunk's instances by dtypes and width class (core_mlp.TRUNK_NARROW,
# TRUNK_WIDE: "_wide"), each a launch counter of one C entry point.
TRUNK_INSTANCES = [
    f"{k}{c}{w}" for w in ("", "_wide") for k, dtypes in (
        ("mlp_fwd", ("", "_f32")), ("mlp_bwd", ("", "_f32")),
        ("mlp_stash_fwd", ("", "_f32", "_f32_bf16stash", "_f32stash")),
        ("mlp_stash_bwd", ("", "_f32", "_f32_bf16stash", "_f32stash"))) for c in dtypes
]

launch_counts = {
    "sdf_core_fwd": 0, "round_machinery": 0, "shadow_final": 0,
    "sdf_stash_fwd": 0, "sdf_stash_bwd": 0, "mlp_stash_fwd": 0, "mlp_stash_bwd": 0,
    "sdf_stash_all_fwd": 0, "sdf_stash_all_bwd": 0,
    "sdf_core_bwd": 0, "mlp_fwd": 0, "mlp_bwd": 0,
    "march_sweep": 0, "march_rounds": 0, "importance_march": 0, "shadow_march": 0,
    "shadow_final_f32": 0, "march_sweep_f32": 0, "march_rounds_f32": 0, "importance_march_f32": 0,
    "shadow_march_f32": 0,
}
launch_counts.update({k: 0 for k in SDF_CORE_INSTANCES + TRUNK_INSTANCES + MARCH_INSTANCES
                      + MARCH_GEOM_INSTANCES if k not in launch_counts})

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Every entry point that reads a meta vector takes it twice: in host memory
# and, for a network deeper than core_mlp.MAX_LAYERS, its copy on the card
# (else NULL); the backward entries take the dW job table the same way.
# Kernels K, L, M and N at 64 + 4 x 16, and at a run-time geometry ((...,
# rounds, n_new) after rank; K: n0 after scale).
_FUSED_SIGNATURES = {"march_sweep": [_P] * 7 + [_I, _P, _P, _F, _P],
                     "march_rounds": [_P] * 8 + [_I, _P, _P, _F, _F, _I, _P],
                     "importance_march": [_P] * 7 + [_I, _P, _P, _F, _F, _I, _P],
                     "shadow_march": [_P] * 10 + [_I, _P, _P, _F, _F, _I, _P]}
_GEOM_SIGNATURES = {"march_sweep": [_P] * 7 + [_I, _P, _P, _F, _I, _P],
                    "march_rounds": [_P] * 8 + [_I, _P, _P, _F, _F, _I, _I, _I, _P],
                    "importance_march": [_P] * 7 + [_I, _P, _P, _F, _F, _I, _I, _I, _P],
                    "shadow_march": [_P] * 10 + [_I, _P, _P, _F, _F, _I, _I, _I, _P]}
_SIGNATURES = {
    "sdf_core": {
        "sdf_core_fwd": [_P] * 9 + [_I, _P, _P, _F, _I, _P],
        "sdf_stash_fwd": [_P] * 10 + [_I, _P, _P, _F, _I, _P],
        "sdf_stash_all_fwd": [_P] * 10 + [_I, _P, _P, _F, _I, _P],
    },
    "sdf_stash": {
        "sdf_stash_bwd": [_P] * 17 + [_I, _I, _I, _P, _P, _F, _I, _P],
        "sdf_stash_all_bwd": [_P] * 17 + [_I, _I, _I, _P, _P, _F, _I, _P],
    },
    "sdf_core_bwd": {"sdf_core_bwd": [_P] * 19 + [_I, _I, _I, _P, _P, _F, _I, _P]},
    "mlp_stash": {
        "mlp_stash_fwd": [_P] * 5 + [_I, _P, _P, _I, _P],
        "mlp_fwd": [_P] * 4 + [_I, _P, _P, _I, _P],
        "mlp_stash_bwd": [_P] * 13 + [_I, _I, _I, _P, _P, _I, _P],
        "mlp_bwd": [_P] * 14 + [_I, _I, _I, _P, _P, _I, _P],
    },
    "march": {
        "round_machinery": [_P] * 9 + [_I, _I, _I, _F, _I, _I, _P],
        "round_machinery_geom": [_P] * 9 + [_I, _I, _I, _F, _I, _I, _I, _P],
        **{f"shadow_final{k}": [_P] * 10 + [_I, _P, _P, _F, _P] for k in ("", "_f32", "_wide", "_f32_wide")},
        "shadow_final_huge": [_P] * 10 + [_I, _P, _P, _F, _P, _P],
    },
    **{lib: {
        f"{fn}{k}": sig
        for fn, sig in _FUSED_SIGNATURES.items() for k in classes
    } for lib, classes in (("march_fused", ("", "_f32")), ("march_fused_wide", ("_wide", "_f32_wide")))},
    **{lib: {
        f"{fn}{k}_geom": sig
        for fn, sig in _GEOM_SIGNATURES.items() for k in classes
    } for lib, classes in (("march_geom", ("", "_wide")), ("march_geom_f32", ("_f32", "_f32_wide")))},
    # The huge class's: the rows scratch after the stream.
    "march_fused_huge": {
        **{f"{fn}_huge": sig + [_P] for fn, sig in _FUSED_SIGNATURES.items()},
        **{f"{fn}_huge_geom": sig + [_P] for fn, sig in _GEOM_SIGNATURES.items()},
    },
}
_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile the named sources that have no current build, one ``nvcc``
    per source, all started together.  Returns, per name, the build seconds
    (0 when it was already built) and the ``-Xptxas -v`` report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, info = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        log = out.with_suffix(".log")
        if out.exists():
            info[name] = {"seconds": 0.0, "ptxas": log.read_text() if log.exists() else ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{text}")
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(text)
        info[name] = {"seconds": time.perf_counter() - t0, "ptxas": text}
    return info


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.nrh_error_string.argtypes = [ctypes.c_int]
        lib.nrh_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    """Raise when a launcher returned a non-zero ``cudaGetLastError()``."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA error {rc}: {lib.nrh_error_string(rc).decode()}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
