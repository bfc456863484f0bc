"""Datasets and gaussian initialisation (counterpart of
``gaussian_splatting_tpu/dataio/dataset.py``, plus ``train.py``'s synthetic
scene).

A COLMAP / Mip-NeRF-360 dataset has the layout

    dataset_dir/
        images_{N}/        images downsampled N times
        sparse/0/{cameras,images,points3D}.bin

Initialisation follows the reference (dataloader.py:43-67, utils.py:19-37):
- opacity  <- inverse_sigmoid(initial_opacity)
- scale    <- log(min(mean distance to the k nearest neighbours, cap) * factor)
- quat     <- identity
- rgb      <- point_rgb / 255 / SH_0   (SH DC convention)

Images (``read_rgb``) are told apart by their first bytes, not their
names.  PNG is decoded by the port's own decoder (``png.read_png``: it is
lossless, so its output is OpenCV's bit for bit); JPEG by OpenCV where it
is installed, so the port sees the JAX package's exact input, else by
Pillow, else by the port's own decoder (``jpeg.read_jpeg``, baseline and
extended-sequential); any other format by OpenCV or Pillow.  Those two are
imported only where such an image is read: the synthetic scene, and a
capture of PNG or baseline JPEG images, need neither.  ``last_decoder``
names the decoder of the last image read: "png", "jpeg", "cv2" or "pil".
"""

from __future__ import annotations

import dataclasses
import importlib
import os
from typing import Dict, List

import numpy as np

from gaussian_splatting_torch.config import SplatConfig
from gaussian_splatting_torch.dataio import colmap
from gaussian_splatting_torch.dataio.jpeg import SOI as JPEG_SOI
from gaussian_splatting_torch.dataio.jpeg import read_jpeg
from gaussian_splatting_torch.dataio.png import SIGNATURE as PNG_SIGNATURE
from gaussian_splatting_torch.dataio.png import read_png
from gaussian_splatting_torch.geometry import SH_0
from gaussian_splatting_torch.structs import GaussianScene


# the decoder of the last image read_rgb decoded: "png", "jpeg", "cv2", "pil"
last_decoder = None


def _optional(name):
    try:
        return importlib.import_module(name)
    except ImportError:
        return None


def read_rgb(path: str) -> np.ndarray:
    """uint8 (H, W, 3) RGB of an image file, as ``cv2.imread`` decodes it
    (EXIF orientation applied), by the decoder its signature calls for."""
    global last_decoder
    with open(path, "rb") as f:
        head = f.read(8)
    if head == PNG_SIGNATURE:
        img = read_png(path)
        last_decoder = "png"
        return img
    cv2 = _optional("cv2")
    if cv2 is not None:
        img = cv2.imread(path)
        if img is None:
            raise ValueError(f"{path}: OpenCV cannot decode this file")
        last_decoder = "cv2"
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if _optional("PIL") is not None:
        from PIL import Image, ImageOps

        with Image.open(path) as im:
            img = np.asarray(ImageOps.exif_transpose(im).convert("RGB"))
        last_decoder = "pil"
        return img
    if head[:2] == JPEG_SOI:
        img = read_jpeg(path)
        last_decoder = "jpeg"
        return img
    raise ImportError(
        f"reading {path} needs OpenCV (cv2) or Pillow (PIL), and neither is "
        "installed: the port decodes PNG and baseline JPEG itself, not this format")


@dataclasses.dataclass
class CameraInfo:
    K: np.ndarray  # (3, 3) f32
    width: int
    height: int


@dataclasses.dataclass
class ImageInfo:
    path: str
    camera_id: int
    camera_T_world: np.ndarray  # (4, 4) f32


@dataclasses.dataclass
class SceneData:
    xyz: np.ndarray  # (N, 3) f32
    rgb: np.ndarray  # (N, 3) f32 (already / 255 / SH_0)
    images: List[ImageInfo]
    cameras: Dict[int, CameraInfo]

    def load_image(self, idx: int) -> np.ndarray:
        """uint8 (H, W, 3) RGB."""
        return read_rgb(self.images[idx].path)


def knn_mean_distance(points: np.ndarray, k: int) -> np.ndarray:
    """Mean distance to the k nearest neighbours per point, the point
    itself included at distance 0 as in the reference (utils.py:30-33):
    its 'mean of 3 neighbours' is mean(0, d1, d2).  One batched query of
    scipy's C tree."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    dist, _ = tree.query(points, k=k, workers=-1)
    return dist.mean(axis=1)


def initial_scale(points: np.ndarray, config: SplatConfig) -> np.ndarray:
    d = knn_mean_distance(points, config.initial_scale_num_neighbors)
    s = np.minimum(d, config.max_initial_scale) * config.initial_scale_factor
    return np.log(np.clip(s, 1e-10, None)).astype(np.float32)[:, None].repeat(3, 1)


def create_scene(data: SceneData, config: SplatConfig, capacity: int, device) -> GaussianScene:
    """The initial scene of ``data``'s points in ``capacity`` slots on
    ``device``."""
    n = data.xyz.shape[0]
    opacity = np.full((n, 1), np.log(
        config.initial_opacity / (1 - config.initial_opacity)
    ), np.float32)
    scale = initial_scale(data.xyz, config)
    quat = np.zeros((n, 4), np.float32)
    quat[:, 0] = 1.0
    return GaussianScene.create(
        xyz=data.xyz, rgb=data.rgb, opacity=opacity, scale=scale,
        quaternion=quat, capacity=capacity, device=device,
    )


def make_synthetic_scene_data(n_points=20000, n_images=48, seed=0, width=640,
                              height=480) -> SceneData:
    """``train.py``'s synthetic scene: a colourful box of points seen from
    a ring of ``n_images`` cameras at radius 8 looking at the origin (48
    views at the defaults, 7.5 degrees apart; with 16 the trainer overfits
    the train views).  The runner renders its ground truth from a denser
    set of gaussians, so training has a real target.  numpy only."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-2, 2, (n_points, 3)).astype(np.float32)
    rgb_raw = (np.abs(np.sin(xyz * 3.0)) * 255).astype(np.uint8)
    rgb = rgb_raw.astype(np.float32) / 255.0 / SH_0
    W, H = width, height
    f = 500.0 * (W / 640.0)  # keep the 640px field of view at any size
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    cameras = {0: CameraInfo(K=K, width=W, height=H)}
    images = []
    for i in range(n_images):
        th = 2 * np.pi * i / n_images
        c = np.array([8 * np.sin(th), 0.0, -8 * np.cos(th)], np.float32)
        fwd = -c / np.linalg.norm(c)
        right = np.cross(np.array([0, 1, 0], np.float32), fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        R = np.stack([right, up, fwd])  # world->camera rows
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = -R @ c
        images.append(ImageInfo(path=f"synthetic_{i}", camera_id=0, camera_T_world=T))
    return SceneData(xyz=xyz, rgb=rgb, images=images, cameras=cameras)


class ColmapDataset:
    """A COLMAP / Mip-NeRF-360 dataset (splat_py/dataloader.py:84-188):
    points, per-image poses and per-camera intrinsics scaled to the
    downsampled images, whose size is read from the first image."""

    def __init__(self, root: str, downsample_factor: int):
        self.root = root
        self.downsample = downsample_factor
        sparse = os.path.join(root, "sparse", "0")
        xyz, rgb = colmap.read_points3d_bin(os.path.join(sparse, "points3D.bin"))
        self.xyz = xyz.astype(np.float32)
        self.rgb = (rgb.astype(np.float32) / 255.0 / SH_0).astype(np.float32)

        images = colmap.read_images_bin(os.path.join(sparse, "images.bin"))
        cameras = colmap.read_cameras_bin(os.path.join(sparse, "cameras.bin"))

        self.images: List[ImageInfo] = []
        img_dir = os.path.join(root, f"images_{downsample_factor}")
        for _, im in sorted(images.items()):
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = colmap.qvec_to_rotation(im.qvec)
            T[:3, 3] = im.tvec
            self.images.append(ImageInfo(
                path=os.path.join(img_dir, im.name), camera_id=im.camera_id,
                camera_T_world=T,
            ))

        # the downsampled images' size (downsampling may round dimensions)
        try:
            height, width = read_rgb(self.images[0].path).shape[:2]
        except FileNotFoundError:
            raise FileNotFoundError(
                f"cannot read {self.images[0].path}: is images_"
                f"{downsample_factor}/ present?"
            ) from None

        self.cameras: Dict[int, CameraInfo] = {}
        for cam_id, cam in cameras.items():
            K = np.zeros((3, 3), np.float32)
            d = float(downsample_factor)
            if cam.model == "SIMPLE_PINHOLE":
                K[0, 0] = K[1, 1] = cam.params[0] / d
                K[0, 2] = cam.params[1] / d
                K[1, 2] = cam.params[2] / d
            elif cam.model == "PINHOLE":
                K[0, 0] = cam.params[0] / d
                K[1, 1] = cam.params[1] / d
                K[0, 2] = cam.params[2] / d
                K[1, 2] = cam.params[3] / d
            else:
                raise NotImplementedError(
                    f"camera model {cam.model} not supported (the reference "
                    "supports SIMPLE_PINHOLE and PINHOLE only, "
                    "dataloader.py:166-181)"
                )
            K[2, 2] = 1.0
            self.cameras[cam_id] = CameraInfo(K=K, width=width, height=height)

    def scene_data(self) -> SceneData:
        return SceneData(xyz=self.xyz, rgb=self.rgb, images=self.images,
                         cameras=self.cameras)
