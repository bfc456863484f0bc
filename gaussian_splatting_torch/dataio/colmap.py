"""COLMAP sparse-reconstruction binary parsers (the port's copy of
``gaussian_splatting_tpu/dataio/colmap.py``; numpy only).

Reads ``cameras.bin`` / ``images.bin`` / ``points3D.bin`` per the COLMAP
binary format (https://colmap.github.io/format.html).  The C++ reader of
``native/`` runs when it builds (``native.py``); otherwise the numpy
parsers here do.  ``last_reader`` names the reader of the last call,
"native" or "numpy".

Only the fields the pipeline needs are materialised.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

# COLMAP camera model ids -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}

# the reader of the last call: "native" (native/colmap_reader.cpp) or "numpy"
last_reader = None


def _ran(reader: str) -> None:
    global last_reader
    last_reader = reader


@dataclasses.dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # (4,) wxyz, world->camera rotation
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str


def read_cameras_bin(path) -> dict:
    from gaussian_splatting_torch.dataio import native

    nat = native.read_cameras(path)
    _ran("numpy" if nat is None else "native")
    if nat is not None:
        cams = {}
        for i in range(len(nat["camera_ids"])):
            cam_id = int(nat["camera_ids"][i])
            name, n_params = CAMERA_MODELS[int(nat["model_ids"][i])]
            cams[cam_id] = ColmapCamera(
                cam_id, name, int(nat["wh"][i, 0]), int(nat["wh"][i, 1]),
                nat["params"][i, :n_params].copy(),
            )
        return cams
    data = Path(path).read_bytes()
    (n,) = struct.unpack_from("<Q", data, 0)
    off = 8
    cams = {}
    for _ in range(n):
        cam_id, model_id, width, height = struct.unpack_from("<iiQQ", data, off)
        off += 24
        name, n_params = CAMERA_MODELS[model_id]
        params = np.frombuffer(data, "<f8", n_params, off).copy()
        off += 8 * n_params
        cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height), params)
    return cams


def read_images_bin(path) -> dict:
    from gaussian_splatting_torch.dataio import native

    nat = native.read_images(path)
    _ran("numpy" if nat is None else "native")
    if nat is not None:
        return {
            int(nat["image_ids"][i]): ColmapImage(
                int(nat["image_ids"][i]), nat["qvec"][i].copy(),
                nat["tvec"][i].copy(), int(nat["camera_ids"][i]),
                nat["names"][i],
            )
            for i in range(len(nat["image_ids"]))
        }
    data = Path(path).read_bytes()
    (n,) = struct.unpack_from("<Q", data, 0)
    off = 8
    images = {}
    for _ in range(n):
        vals = struct.unpack_from("<idddddddi", data, off)
        off += 4 + 7 * 8 + 4
        image_id, qw, qx, qy, qz, tx, ty, tz, cam_id = vals
        end = data.index(b"\x00", off)
        name = data[off:end].decode("utf-8")
        off = end + 1
        (n_pts,) = struct.unpack_from("<Q", data, off)
        off += 8 + n_pts * 24  # skip 2D points (x, y f64 + point3D id i64)
        images[image_id] = ColmapImage(
            image_id,
            np.array([qw, qx, qy, qz], np.float64),
            np.array([tx, ty, tz], np.float64),
            cam_id,
            name,
        )
    return images


def read_points3d_bin(path):
    """Returns (xyz (N,3) f64, rgb (N,3) u8).  Track data is skipped."""
    from gaussian_splatting_torch.dataio import native

    nat = native.read_points3d(path)
    _ran("numpy" if nat is None else "native")
    if nat is not None:
        return nat["xyz"], nat["rgb"]
    data = Path(path).read_bytes()
    (n,) = struct.unpack_from("<Q", data, 0)
    off = 8
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    for i in range(n):
        # id i64, xyz 3xf64, rgb 3xu8, error f64, track_len u64
        xyz[i] = np.frombuffer(data, "<f8", 3, off + 8)
        rgb[i] = np.frombuffer(data, "<u1", 3, off + 32)
        (track_len,) = struct.unpack_from("<Q", data, off + 43)
        off += 51 + track_len * 8
    return xyz, rgb


def qvec_to_rotation(qvec: np.ndarray) -> np.ndarray:
    """wxyz quaternion -> 3x3 rotation (COLMAP convention)."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )
