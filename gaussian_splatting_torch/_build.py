"""Build and bind the package's CUDA kernels.

``nvcc`` compiles the sources of each library for ``sm_90a`` (Hopper), one
process per source, all started together, and links each library's objects
into one shared library with a plain C interface, loaded with ctypes.  There
are two libraries: ``kernels``, the render and training kernels
(``csrc/*.cu``), which the package loads, and ``probes``, the TPU probes
(``csrc/probes/*.cu``), which only ``gaussian_splatting_torch.experiments``
loads.  A library is built at first use into ``_build_cache/`` inside the
package, under a name keyed by a hash of its sources, the shared headers and
the flags, so an edited kernel is rebuilt, an unchanged one is loaded as it
is, and editing a probe leaves the package's library alone.  A missing
``nvcc`` or a failed build raises; there is no fallback.

Each C function launches on the stream it is given, allocates nothing and
returns ``cudaGetLastError()``; ``check`` raises on a nonzero code.

Each wrapper counts its launch in ``telemetry.LAUNCHES``.
"""

from __future__ import annotations

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

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# each library's sources: the package's kernels and the TPU probes
SOURCE_DIRS = {"kernels": SRC_DIR, "probes": SRC_DIR / "probes"}
# C signature of every exported launcher, by library (pointers and the
# stream as c_void_p)
SIGNATURES = {
    "kernels": {
        # feat, n, rows, rec, stream
        "gs_pack_fwd_rows": (_P, _I, _I, _P, _P),
        # tile_starts, n_tiles, order, stream
        "gs_tile_order": (_P, _I, _P, _P),
        # rec, gaussian_idx, tile_starts, tile_order, n_tiles, x_tiles, out,
        # stream
        "gs_render_fwd": (_P, _P, _P, _P, _I, _I, _P, _P),
        # rec, gaussian_idx, tile_starts, tile_order, n_tiles, x_tiles,
        # alpha_threshold, out, stream
        "gs_depth_fwd": (_P, _P, _P, _P, _I, _I, _F, _P, _P),
        # feat, n, gaussian_idx, tile_starts, n_tiles, x_tiles, raw,
        # grad_raw, grad_feat, stream
        "gs_render_bwd": (_P, _I, _P, _P, _I, _I, _P, _P, _P, _P),
        # rec, basis, n_sh, gaussian_idx, tile_starts, tile_order, n_tiles,
        # x_tiles, out, stream
        "gs_render_sh_fwd": (_P, _P, _I, _P, _P, _P, _I, _I, _P, _P),
        # feat, n, basis, n_sh, gaussian_idx, tile_starts, n_tiles, x_tiles,
        # raw, grad_raw, grad_feat, stream
        "gs_render_sh_bwd": (_P, _I, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P),
        # ptrs, dims, mult (host arrays), n_leaves, n_chunks, hyper (host),
        # bc1, bc2, ok, count, count_out, stream
        "gs_adam_step": (_P, _P, _P, _I, _L, _P, _P, _P, _P, _P, _P, _P),
        # ptrs, dims (host arrays), mode, n_sh, cull (host), feat, z, visible,
        # stream
        "gs_geometry_fwd": (_P, _P, _I, _I, _P, _P, _P, _P, _P),
        # ptrs, dims (host), mode, n_sh, grad_feat, grads (host), stream
        "gs_geometry_bwd": (_P, _P, _I, _I, _P, _P, _P),
        # n, s, end_bit, out (host int64[2]): the scan's and the sort's scratch
        "gs_layout_temp_bytes": (_I, _I, _I, _P),
        # ptrs, strides (host), n, mh_dist, x_tiles, y_tiles, counts, first,
        # sizes, temp, temp_bytes, stream
        "gs_layout_count": (_P, _P, _I, _F, _I, _I, _P, _P, _P, _P, _L, _P),
        # ptrs, strides (host), n, mh_dist, x_tiles, y_tiles, counts, first,
        # keys, ids, stream
        "gs_layout_fill": (_P, _P, _I, _F, _I, _I, _P, _P, _P, _P, _P),
        # keys0, keys1, ids0, ids1, s, end_bit, temp, temp_bytes, n_tiles,
        # starts, tile_counts, has, selector (host int), stream
        "gs_layout_sort": (_P, _P, _P, _P, _I, _I, _P, _L, _I, _P, _P, _P, _P, _P),
    },
    "probes": {
        # vals, dest, n, rows, group, out, stream
        "gs_permute_probe": (_P, _P, _I, _I, _I, _P, _P),
        # x, n_seg, chunk, out, stream
        "gs_scan_probe": (_P, _L, _I, _P, _P),
        # x, n_rows, off, sub, out, stream
        "gs_place_probe": (_P, _I, _P, _I, _P, _P),
    },
}

_libs: dict = {}
build_seconds = None  # wall time of this process's last build, None if none ran


def sources(name: str) -> list:
    """The .cu files of library ``name``."""
    return sorted(SOURCE_DIRS[name].glob("*.cu"))


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


def library_path(name: str = "kernels") -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(name) + sorted(SRC_DIR.glob("*.cuh")):
        h.update(src.relative_to(SRC_DIR).as_posix().encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgs_{name}_{h.hexdigest()[:16]}.so"


def build(*names: str) -> list:
    """Compile each of the libraries ``names`` unless one of its current
    sources exists, every source of every library at once.  Returns the
    library paths; the compiler's report (registers, spills) is kept beside
    each as ``.log``."""
    global build_seconds
    paths = [library_path(n) for n in names]
    todo = [(n, so) for n, so in zip(names, paths) if not so.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        tmp = Path(tmp_dir)
        jobs = {}  # library -> [(cmd, process)]
        for name, _ in todo:
            for src in sources(name):
                obj = tmp / name / f"{src.stem}.o"
                obj.parent.mkdir(exist_ok=True)
                cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                jobs.setdefault(name, []).append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, so in todo:  # wait for every job, so none outlives build()
            log = []
            for cmd, proc in jobs[name]:
                log.append(proc.communicate()[0])
                if proc.returncode != 0:
                    failed.append((cmd, proc.returncode, log[-1]))
            if not failed:
                objs = [cmd[-1] for cmd, _ in jobs[name]]
                link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp / so.name), *objs]
                proc = subprocess.run(link, capture_output=True, text=True)
                log.append(proc.stdout + proc.stderr)
                if proc.returncode != 0:
                    failed.append((link, proc.returncode, log[-1]))
            so.with_suffix(".log").write_text("".join(log))
        build_seconds = time.perf_counter() - t0
        if failed:
            cmd, rc, out = failed[0]
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
        for _, so in todo:  # atomic: a concurrent loader sees all or nothing
            os.replace(tmp / so.name, so)
    return paths


def library(name: str = "kernels") -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build(name)[0]))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
