"""ctypes bindings for the port's native host code, built with ``g++`` at
first use (counterpart of ``gaussian_splatting_tpu/dataio/native.py``).

Two libraries, each from one source under ``dataio/csrc/``:

- ``colmap_reader`` (``csrc/colmap_reader.cpp``, the port's copy of
  ``native/colmap_reader.cpp``): the COLMAP binary reader.  If no compiler
  is found or the build fails, its entry points return None and the numpy
  parsers of ``colmap.py`` run.
- ``image_decode`` (``csrc/image_decode.cpp``): PNG row unfiltering and the
  JPEG decoder of ``png.py`` and ``jpeg.py``.  There is no fallback: a
  failed build raises with the compiler's standard error.

Each is built into the package's ``_build_cache/`` under a name keyed by a
hash of its source and the flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"colmap_reader": CSRC / "colmap_reader.cpp",
           "image_decode": CSRC / "image_decode.cpp"}
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build_cache"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
_lib = None
_lib_failed = False
_decoders = None


def library_path(name: str = "colmap_reader") -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCES[name].read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _build(name: str, path: Path) -> None:
    """Compile library ``name`` into ``path``, through a temporary file and
    a rename, so processes that build at once never load a partial file.
    Raises OSError without a compiler, CalledProcessError (with the
    compiler's stderr) when it fails."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise OSError("no C++ compiler (g++ or c++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCES[name])], check=True,
                       capture_output=True, text=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def decoders():
    """The image decoders' library, built at first use.  Raises
    RuntimeError with the compiler's output if it cannot be built."""
    global _decoders
    if _decoders is not None:
        return _decoders
    path = library_path("image_decode")
    try:
        if not path.exists():
            _build("image_decode", path)
        lib = ctypes.CDLL(str(path))
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"building the image decoders ({SOURCES['image_decode']}) "
                           f"failed:\n{e.stderr}") from None
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building the image decoders ({SOURCES['image_decode']}) "
                           f"failed: {e}") from None
    P, L = ctypes.c_void_p, ctypes.c_int64
    for name, args in [
        # in, height, row_bytes, bpp, out, err, errlen
        ("gs_png_unfilter", [P, L, L, L, P, P, L]),
        # data, size, info (4 x int32), err, errlen
        ("gs_jpeg_header", [P, L, P, P, L]),
        # data, size, out, err, errlen
        ("gs_jpeg_decode", [P, L, P, P, L]),
    ]:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args
    _decoders = lib
    return lib


def check(code: int, err, path) -> None:
    """Raise ValueError naming ``path`` with the message in ``err`` (a
    ctypes string buffer) when a decoder returned nonzero."""
    if code:
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        path = library_path("colmap_reader")
        if not path.exists():
            _build("colmap_reader", path)
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.SubprocessError):
        _lib_failed = True
        return None

    p = ctypes.POINTER
    f64, u8 = p(ctypes.c_double), p(ctypes.c_uint8)
    i32, i64 = p(ctypes.c_int32), p(ctypes.c_int64)
    for name, res, args in [
        ("colmap_points_read", ctypes.c_void_p, [ctypes.c_char_p]),
        ("colmap_points_count", ctypes.c_int64, [ctypes.c_void_p]),
        ("colmap_points_fill", None, [ctypes.c_void_p, f64, u8, f64, i64]),
        ("colmap_points_free", None, [ctypes.c_void_p]),
        ("colmap_images_read", ctypes.c_void_p, [ctypes.c_char_p]),
        ("colmap_images_count", ctypes.c_int64, [ctypes.c_void_p]),
        ("colmap_images_fill", None,
         [ctypes.c_void_p, i32, f64, f64, i32, ctypes.c_char_p]),
        ("colmap_images_free", None, [ctypes.c_void_p]),
        ("colmap_cameras_read", ctypes.c_void_p, [ctypes.c_char_p]),
        ("colmap_cameras_count", ctypes.c_int64, [ctypes.c_void_p]),
        ("colmap_cameras_fill", None, [ctypes.c_void_p, i32, i32, i64, f64]),
        ("colmap_cameras_free", None, [ctypes.c_void_p]),
    ]:
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    _lib = lib
    return _lib


def _cptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def read_points3d(path) -> dict | None:
    """{'xyz' (n,3) f64, 'rgb' (n,3) u8, 'error' (n,), 'ids' (n,)} or None."""
    lib = _load()
    if lib is None:
        return None
    h = lib.colmap_points_read(str(path).encode())
    if not h:
        return None
    try:
        n = lib.colmap_points_count(h)
        xyz = np.empty((n, 3), np.float64)
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty((n,), np.float64)
        ids = np.empty((n,), np.int64)
        lib.colmap_points_fill(
            h, _cptr(xyz, ctypes.c_double), _cptr(rgb, ctypes.c_uint8),
            _cptr(err, ctypes.c_double), _cptr(ids, ctypes.c_int64),
        )
        return dict(xyz=xyz, rgb=rgb, error=err, ids=ids)
    finally:
        lib.colmap_points_free(h)


def read_images(path) -> dict | None:
    """{'image_ids', 'qvec' (n,4), 'tvec' (n,3), 'camera_ids', 'names'}"""
    lib = _load()
    if lib is None:
        return None
    h = lib.colmap_images_read(str(path).encode())
    if not h:
        return None
    try:
        n = lib.colmap_images_count(h)
        image_ids = np.empty((n,), np.int32)
        qvec = np.empty((n, 4), np.float64)
        tvec = np.empty((n, 3), np.float64)
        camera_ids = np.empty((n,), np.int32)
        names_raw = ctypes.create_string_buffer(int(n) * 256)
        lib.colmap_images_fill(
            h, _cptr(image_ids, ctypes.c_int32), _cptr(qvec, ctypes.c_double),
            _cptr(tvec, ctypes.c_double), _cptr(camera_ids, ctypes.c_int32),
            names_raw,
        )
        names = [
            names_raw.raw[i * 256 : (i + 1) * 256].split(b"\0")[0].decode()
            for i in range(n)
        ]
        return dict(
            image_ids=image_ids, qvec=qvec, tvec=tvec,
            camera_ids=camera_ids, names=names,
        )
    finally:
        lib.colmap_images_free(h)


def read_cameras(path) -> dict | None:
    """{'camera_ids', 'model_ids', 'wh' (n,2), 'params' (n,12)}"""
    lib = _load()
    if lib is None:
        return None
    h = lib.colmap_cameras_read(str(path).encode())
    if not h:
        return None
    try:
        n = lib.colmap_cameras_count(h)
        camera_ids = np.empty((n,), np.int32)
        model_ids = np.empty((n,), np.int32)
        wh = np.empty((n, 2), np.int64)
        params = np.empty((n, 12), np.float64)
        lib.colmap_cameras_fill(
            h, _cptr(camera_ids, ctypes.c_int32),
            _cptr(model_ids, ctypes.c_int32), _cptr(wh, ctypes.c_int64),
            _cptr(params, ctypes.c_double),
        )
        return dict(
            camera_ids=camera_ids, model_ids=model_ids, wh=wh, params=params
        )
    finally:
        lib.colmap_cameras_free(h)
