"""ctypes bridge to the native iso-surface extractor (counterpart of
``genre_shapehd_tpu/viz/mcubes.py``).

``native/isosurface.cpp`` is compiled with the host C++ compiler at first
use into ``build/native/libisosurface-<hash>.so`` under the repository
root (never next to the source); the hash covers the source text and the
flags, so an edited source never loads a stale library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "native" / "isosurface.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


class _IsoMesh(ctypes.Structure):
    _fields_ = [
        ("verts", ctypes.POINTER(ctypes.c_float)),
        ("nverts", ctypes.c_int64),
        ("tris", ctypes.POINTER(ctypes.c_int32)),
        ("ntris", ctypes.c_int64),
    ]


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libisosurface-{digest[:12]}.so"


def build() -> Path:
    """Compile the extractor if its library is missing; returns its path.
    Raises with the compiler's output on failure."""
    so = library_path()
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SOURCE), "-o",
           str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.iso_extract.restype = ctypes.c_int
            lib.iso_extract.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.POINTER(_IsoMesh)]
            lib.iso_free.argtypes = [ctypes.POINTER(_IsoMesh)]
            lib.iso_write_obj.restype = ctypes.c_int
            lib.iso_write_obj.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64]
            _lib = lib
        return _lib


def marching_cubes(vol: np.ndarray, iso: float,
                   spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of a 3D scalar field.

    Returns (verts (V,3) float32, faces (F,3) int32); empty arrays when the
    surface does not cross ``iso``.
    """
    lib = _load()
    vol = np.ascontiguousarray(vol, dtype=np.float32)
    if vol.ndim != 3:
        raise ValueError(f"marching_cubes takes a 3D field, got {vol.shape}")
    mesh = _IsoMesh()
    rc = lib.iso_extract(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        vol.shape[0], vol.shape[1], vol.shape[2],
        ctypes.c_float(iso), ctypes.c_float(spacing[0]),
        ctypes.c_float(spacing[1]), ctypes.c_float(spacing[2]),
        ctypes.byref(mesh))
    if rc != 0:
        raise RuntimeError(f"iso_extract failed with code {rc}")
    try:
        if mesh.nverts == 0:
            return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
        verts = np.ctypeslib.as_array(mesh.verts, (mesh.nverts, 3)).copy()
        faces = np.ctypeslib.as_array(mesh.tris, (mesh.ntris, 3)).copy()
        return verts, faces
    finally:
        lib.iso_free(ctypes.byref(mesh))


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Write a Wavefront .obj: ``v %.6f %.6f %.6f`` per vertex, then
    ``f %d %d %d`` per face with 1-based indices -- the text
    ``numpy.savetxt`` gives, written by the native library."""
    verts = np.ascontiguousarray(verts, np.float32).reshape(-1, 3)
    faces = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)
    rc = _load().iso_write_obj(
        os.fsencode(path),
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(verts),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces))
    if rc != 0:
        raise OSError(f"iso_write_obj({path!r}) failed with code {rc}")
