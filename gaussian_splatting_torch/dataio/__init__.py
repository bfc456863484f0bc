"""Datasets: COLMAP reconstructions, the synthetic scene, images (counterpart
of ``gaussian_splatting_tpu/dataio``)."""

from gaussian_splatting_torch.dataio.colmap import (
    qvec_to_rotation,
    read_cameras_bin,
    read_images_bin,
    read_points3d_bin,
)
from gaussian_splatting_torch.dataio.dataset import (
    ColmapDataset,
    SceneData,
    make_synthetic_scene_data,
)

__all__ = [
    "read_cameras_bin",
    "read_images_bin",
    "read_points3d_bin",
    "qvec_to_rotation",
    "ColmapDataset",
    "SceneData",
    "make_synthetic_scene_data",
]
