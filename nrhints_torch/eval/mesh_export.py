"""Mesh export (port of ``nrhints_tpu/eval/mesh_export.py``): marching
cubes over an SDF grid on the host, and OBJ writing.

The marching cubes are ``native/marching_cubes.cpp``, compiled with ``g++``
at first use into ``build/nrhints_torch/`` at the repository root (the file
name carries a hash of the source and flags, and a finished build is moved
into place whole, so parallel processes never load a partial one) and
loaded with ``ctypes``.  Vertices come back in grid-index coordinates;
``marching_cubes_to_obj`` scales them into the world bounds as the
original code does: v / (res - 1) * (bmax - bmin) + bmin.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_SOURCE = _REPO / "native" / "marching_cubes.cpp"
BUILD_DIR = _REPO / "build" / "nrhints_torch"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
_LIB_LOCK = threading.Lock()
_LIB = None


def _build_library() -> Path:
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libmarching_cubes_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *_FLAGS, str(_SOURCE), "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"marching-cubes build failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _get_lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build_library()))
            lib.mc_run.restype = ctypes.c_void_p
            lib.mc_run.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_float]
            lib.mc_num_vertices.restype = ctypes.c_int64
            lib.mc_num_vertices.argtypes = [ctypes.c_void_p]
            lib.mc_num_triangles.restype = ctypes.c_int64
            lib.mc_num_triangles.argtypes = [ctypes.c_void_p]
            lib.mc_copy_vertices.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
            lib.mc_copy_triangles.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
            lib.mc_free.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


def marching_cubes(grid: np.ndarray, iso: float = 0.0):
    """[nx, ny, nz] scalar field -> (vertices [V, 3] in grid-index
    coordinates, triangles [T, 3] int32)."""
    lib = _get_lib()
    grid = np.ascontiguousarray(grid, dtype=np.float32)
    nx, ny, nz = grid.shape
    handle = lib.mc_run(grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nx, ny, nz, iso)
    if not handle:
        raise RuntimeError("marching cubes failed")
    try:
        verts = np.empty((lib.mc_num_vertices(handle), 3), dtype=np.float32)
        tris = np.empty((lib.mc_num_triangles(handle), 3), dtype=np.int32)
        if len(verts):
            lib.mc_copy_vertices(handle, verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if len(tris):
            lib.mc_copy_triangles(handle, tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return verts, tris
    finally:
        lib.mc_free(handle)


def write_obj(path, vertices: np.ndarray, triangles: np.ndarray) -> None:
    """OBJ with 1-indexed faces."""
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in triangles:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def marching_cubes_to_obj(grid: np.ndarray, iso, bound_min, bound_max, path):
    """Grid -> OBJ in world coordinates; returns (vertices, triangles)."""
    verts, tris = marching_cubes(grid, float(iso))
    bmin = np.asarray(bound_min, np.float32)
    bmax = np.asarray(bound_max, np.float32)
    res = np.asarray(grid.shape, np.float32)
    verts_world = verts / (res - 1.0)[None, :] * (bmax - bmin)[None, :] + bmin[None, :]
    write_obj(path, verts_world, tris)
    return verts_world, tris
