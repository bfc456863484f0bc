"""Build and bind the package's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (Hopper), one
process per source, all started together, and links the objects into one
shared library with a plain C interface, loaded with ctypes.  The library is
built at first use into ``_build_cache/`` inside the package, under a name
keyed by a hash of the sources and flags, so an edited kernel is rebuilt
and an unchanged one is loaded as it is.  A missing ``nvcc`` or a failed
build raises; there is no fallback.

Each C function launches on the stream it is given, allocates nothing and
returns ``cudaGetLastError()``; ``check`` raises on a nonzero code.

``LAUNCHES`` counts kernel launches by kernel name: each wrapper adds one
where it launches its kernel and nowhere else, so a caller can show which
kernels a run went through.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build_cache"

# -fmad=false keeps each float32 multiply and add separately rounded, in
# the order the source writes them, as the plain PyTorch versions evaluate
# them: the kernels then agree with those versions to rounding of exp and
# summation order, not to FMA contraction of cancelling terms (det, mh).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every exported launcher (pointers and the stream as c_void_p)
SIGNATURES = {
    # feat, n, gaussian_idx, tile_starts, n_tiles, x_tiles, out, stream
    "gs_render_fwd": (_P, _I, _P, _P, _I, _I, _P, _P),
    # feat, n, gaussian_idx, tile_starts, n_tiles, x_tiles, alpha_threshold,
    # out, stream
    "gs_depth_fwd": (_P, _I, _P, _P, _I, _I, _F, _P, _P),
    # feat, n, gaussian_idx, tile_starts, n_tiles, x_tiles, raw, grad_raw,
    # grad_feat, stream
    "gs_render_bwd": (_P, _I, _P, _P, _I, _I, _P, _P, _P, _P),
    # feat, n, basis, n_sh, gaussian_idx, tile_starts, n_tiles, x_tiles, out,
    # stream
    "gs_render_sh_fwd": (_P, _I, _P, _I, _P, _P, _I, _I, _P, _P),
    # feat, n, basis, n_sh, gaussian_idx, tile_starts, n_tiles, x_tiles, raw,
    # grad_raw, grad_feat, stream
    "gs_render_sh_bwd": (_P, _I, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P),
}

LAUNCHES: collections.Counter = collections.Counter()

_lib = None
build_seconds = None  # wall time of this process's build, None if loaded


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for home in cands:
        p = Path(home, "bin", "nvcc")
        if home and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels of gaussian_splatting_torch cannot be built"
        )
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgs_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the current sources exists.
    Returns the library path; the compiler's report (registers, spills)
    is kept beside it as ``.log``."""
    global build_seconds
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        tmp = Path(tmp_dir)
        jobs, objs = [], []
        for src in sorted(SRC_DIR.glob("*.cu")):
            objs.append(str(tmp / f"{src.stem}.o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", objs[-1]]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp / so.name), *objs]
        log, failed = [], []
        for cmd, proc in jobs:  # wait for every job, so none outlives build()
            log.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append((cmd, proc.returncode, log[-1]))
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append((link, proc.returncode, log[-1]))
        build_seconds = time.perf_counter() - t0
        so.with_suffix(".log").write_text("".join(log))
        if failed:
            cmd, rc, out = failed[0]
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
        # atomic: a concurrent loader sees all or nothing
        os.replace(tmp / so.name, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
