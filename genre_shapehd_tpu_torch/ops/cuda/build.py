"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into ``build/kernels/<stem>-<hash>.so`` under the
repository root at first use, and loaded with ``ctypes``.  The hash covers
the source text, every ``csrc/*.cuh`` header and the flags, so an edited
source or header never loads a stale library.  :func:`build_all` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
SOURCES = ("render_kernel.cu", "deconv_final_kernel.cu", "chamfer_kernel.cu",
           "critic_stem_kernel.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output per source (ptxas register/spill report)
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.isfile(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(source: str) -> Path:
    h = hashlib.sha1((CSRC_DIR / source).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build_all(sources: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every source whose library is missing, all in parallel.
    Returns seconds per source built; raises with nvcc's output on any
    failure."""
    todo = [s for s in sources if not library_path(s).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    start = time.perf_counter()
    for src in todo:
        tmp = library_path(src).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / src)]
        procs[src] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed, seconds = [], {}
    for src, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[src] = out
        seconds[src] = time.perf_counter() - start
        if proc.returncode != 0:
            failed.append(f"{src}:\n{out}")
            continue
        os.replace(tmp, library_path(src))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _lock:
        if source not in _libs:
            build_all([source])
            _libs[source] = ctypes.CDLL(str(library_path(source)))
        return _libs[source]
