"""Cameras, the gaussian scene, tile grids and the training run's metrics
log (counterpart of ``gaussian_splatting_tpu/structs.py``).

Parameterisation matches the reference: ``opacity`` is pre-sigmoid,
``scale`` is log-space, ``quaternion`` is wxyz (normalised on use, not on
store).  The scene keeps an ``alive`` mask so a checkpoint with dead slots
loads as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

# side length of a rasterization tile in pixels
TILE_PX = 16

# SH coefficients per channel including the DC term (bands 0..3); the DC
# term is stored in `rgb`, the other 15 in `sh`
MAX_SH_COEFFS = 16

PARAM_NAMES = ("xyz", "rgb", "opacity", "scale", "quaternion", "sh")


class GSMetricsLog:
    """A training run's record, written to ``metrics.json``: train PSNR and
    gaussian count per step, test PSNR/SSIM per evaluation, the ADC events,
    and the steps and cells lost to the window truncation
    (``culling.MAX_WINDOW_CELLS``).  ``overflow_steps`` is the JAX
    package's capacity-overflow count; the port has no capacities, so it
    stays 0.  The keys are the JAX package's."""

    def __init__(self):
        self.train_psnr = []
        self.test_psnr = []
        self.test_ssim = []
        self.eval_iters = []
        self.num_gaussians = []
        self.adc_events = []  # dicts: iter, deleted, cloned, split, alive, cap_hit
        self.overflow_steps = 0
        self.truncated_steps = 0
        self.truncated_cells = 0

    def to_dict(self) -> dict:
        return dict(
            train_psnr=self.train_psnr,
            test_psnr=self.test_psnr,
            test_ssim=self.test_ssim,
            eval_iters=self.eval_iters,
            num_gaussians=self.num_gaussians,
            adc_events=self.adc_events,
            overflow_steps=self.overflow_steps,
            truncated_steps=self.truncated_steps,
            truncated_cells=self.truncated_cells,
        )


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera: ``K`` is the (3, 3) float32 intrinsic matrix."""

    K: torch.Tensor
    width: int
    height: int


class GaussianScene(nn.Module):
    """The scene's parameters, one row per gaussian slot.

    Fields (C = capacity):
      xyz        (C, 3)  world positions
      rgb        (C, 3)  SH DC coefficients (colour / SH_0 convention)
      opacity    (C, 1)  pre-sigmoid opacity
      scale      (C, 3)  log-space scales
      quaternion (C, 4)  wxyz rotation (normalised on use)
      sh         (C, 3, 15) higher-band SH coefficients (bands 1..3)
      alive      (C,)    bool buffer; dead slots are never rendered
    """

    def __init__(self, xyz, rgb, opacity, scale, quaternion, sh, alive):
        super().__init__()
        self.xyz = nn.Parameter(xyz)
        self.rgb = nn.Parameter(rgb)
        self.opacity = nn.Parameter(opacity)
        self.scale = nn.Parameter(scale)
        self.quaternion = nn.Parameter(quaternion)
        self.sh = nn.Parameter(sh)
        self.register_buffer("alive", alive)

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def num_alive(self) -> int:
        return int(self.alive.sum())

    def params(self) -> dict:
        """The trainable tensors by name, as ``rasterize`` takes them."""
        return {k: getattr(self, k) for k in PARAM_NAMES}

    @staticmethod
    def create(
        xyz,
        rgb,
        opacity,
        scale,
        quaternion,
        sh=None,
        capacity: Optional[int] = None,
        *,
        device,
        dtype=torch.float32,
    ) -> "GaussianScene":
        """Build a scene from N gaussians (numpy arrays or tensors), padded
        up to ``capacity`` slots."""
        n = len(xyz)
        cap = int(capacity) if capacity is not None else n
        if cap < n:
            raise ValueError(f"capacity {cap} < n {n}")

        def cpu(a):
            if isinstance(a, torch.Tensor):
                return a.detach().to("cpu", dtype)
            return torch.tensor(np.asarray(a), dtype=dtype)

        def pad(a, tail):
            a = cpu(a).reshape((n,) + tail)
            out = torch.zeros((cap,) + tail, dtype=dtype)
            out[:n] = a
            return out.to(device)

        quat = pad(quaternion, (4,))
        # dead slots keep an identity quaternion so normalisation stays finite
        quat[n:, 0] = 1.0
        sh_full = torch.zeros((cap, 3, MAX_SH_COEFFS - 1), dtype=dtype)
        if sh is not None:
            sh_arr = cpu(sh)
            sh_full[:n, :, : sh_arr.shape[2]] = sh_arr
        alive = torch.zeros(cap, dtype=torch.bool)
        alive[:n] = True
        return GaussianScene(
            xyz=pad(xyz, (3,)),
            rgb=pad(rgb, (3,)),
            opacity=pad(opacity, (1,)),
            scale=pad(scale, (3,)),
            quaternion=quat,
            sh=sh_full.to(device),
            alive=alive.to(device),
        )


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Tile-grid geometry of an image."""

    image_height: int
    image_width: int

    @property
    def image_height_padded(self) -> int:
        return -(-self.image_height // TILE_PX) * TILE_PX

    @property
    def image_width_padded(self) -> int:
        return -(-self.image_width // TILE_PX) * TILE_PX

    @property
    def y_tiles(self) -> int:
        return self.image_height_padded // TILE_PX

    @property
    def x_tiles(self) -> int:
        return self.image_width_padded // TILE_PX

    @property
    def tile_count(self) -> int:
        return self.y_tiles * self.x_tiles
