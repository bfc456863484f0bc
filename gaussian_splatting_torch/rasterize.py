"""Forward rendering pipeline: geometry -> culling -> CUDA rasterizer
(counterpart of ``gaussian_splatting_tpu/rasterize.py``: the DC branch, the
per-pixel SH branch and depth).

The pipeline runs on whatever device the parameters live on: on CUDA the
rasterizer and depth renderer launch their hand-written kernels, on the
CPU they run their plain PyTorch versions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from gaussian_splatting_torch import geometry as geo
from gaussian_splatting_torch.culling import SplatLayout, build_layout, frustum_visible_rows
from gaussian_splatting_torch.ops.depth import depth_feature_rows, render_depth_tiles
from gaussian_splatting_torch.ops.reference_impl import tiles_to_image
from gaussian_splatting_torch.ops.render import render_tiles, splat_feature_rows
from gaussian_splatting_torch.ops.render_sh import (
    build_pixel_basis,
    render_tiles_sh,
    sh_splat_feature_rows,
)
from gaussian_splatting_torch.structs import Camera, TileGrid


class RenderResult(NamedTuple):
    image: torch.Tensor  # (H, W, 3)
    visible: torch.Tensor  # (N,) bool
    uv: torch.Tensor  # (N, 2) projected centres (all gaussians)
    transmittance: torch.Tensor  # (n_tiles, 256)
    num_splats: int  # live (gaussian, tile) pairs
    num_visible: int  # gaussians with at least one window cell
    truncated: int  # window cells dropped past culling.MAX_WINDOW_CELLS


def _active_sh_coeffs(n_sh_band: int) -> int:
    if n_sh_band not in (0, 1, 2, 3):
        raise ValueError(f"n_sh_band must be 0..3, got {n_sh_band}")
    return (n_sh_band + 1) ** 2


def _check_inputs(params: dict, alive, camera_T_world, camera: Camera):
    """Shape, dtype and device validation at the API boundary."""
    n = params["xyz"].shape[0] if "xyz" in params else None
    want = dict(xyz=(n, 3), rgb=(n, 3), opacity=(n, 1), scale=(n, 3),
                quaternion=(n, 4))
    for k, s in want.items():
        if k not in params:
            raise ValueError(f"params missing '{k}'")
        if tuple(params[k].shape) != s:
            raise ValueError(f"params['{k}'] shape {tuple(params[k].shape)} != {s}")
        if not params[k].dtype.is_floating_point:
            raise TypeError(f"params['{k}'] dtype {params[k].dtype} is not floating")
    sh = params.get("sh")
    if sh is not None and (sh.dim() != 3 or sh.shape[0] != n or sh.shape[1] != 3):
        raise ValueError(f"params['sh'] shape {tuple(sh.shape)} != ({n}, 3, n_coeffs)")
    if tuple(alive.shape) != (n,) or alive.dtype != torch.bool:
        raise ValueError(f"alive must be ({n},) bool, got {tuple(alive.shape)} {alive.dtype}")
    if tuple(camera_T_world.shape) != (4, 4):
        raise ValueError(f"camera_T_world shape {tuple(camera_T_world.shape)} != (4, 4)")
    if tuple(camera.K.shape) != (3, 3):
        raise ValueError(f"camera.K shape {tuple(camera.K.shape)} != (3, 3)")
    dev = params["xyz"].device
    tensors = [*(params[k] for k in want), alive, camera_T_world, camera.K]
    if sh is not None:
        tensors.append(sh)
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"inputs on {t.device} and {dev}: move them to one device")


def _camera_rows(params, camera_T_world, camera):
    """Camera-frame centres, projections and conics of every gaussian."""
    xyzT = params["xyz"].T
    xc, yc, zc = geo.transform_rows(xyzT[0], xyzT[1], xyzT[2], camera_T_world)
    u, v = geo.project_rows(xc, yc, zc, camera.K)
    sig6 = geo.sigma_world_rows(params["quaternion"], params["scale"])
    conic3 = geo.conic_rows(sig6, xc, yc, zc, camera.K, camera_T_world)
    opacity_v = torch.sigmoid(params["opacity"][:, 0])
    return xc, yc, zc, u, v, conic3, opacity_v


def splat_features(params, u, v, conic3, opacity_v, camera_T_world, n_sh_band: int,
                   use_sh_precompute: bool):
    """The rasterizer's per-gaussian feature rows and whether they are the
    per-pixel SH rows: (6 + 3*n_sh, N) raw coefficients, which the kernel
    contracts with each pixel's view-direction basis, when n_sh > 1 and not
    ``use_sh_precompute``; else (9, N) DC colour, the SH bands evaluated
    once per gaussian along its view direction."""
    n_sh = _active_sh_coeffs(n_sh_band)
    if n_sh > 1:
        coeffs = torch.cat(
            [params["rgb"][:, :, None], params["sh"][:, :, : n_sh - 1]], dim=2
        )
    if n_sh > 1 and not use_sh_precompute:
        return sh_splat_feature_rows(u, v, opacity_v, conic3, coeffs), True
    if n_sh == 1:
        rgb = params["rgb"]
    else:
        center = geo.camera_center_from_pose(camera_T_world)
        rgb = geo.precompute_rgb_from_sh(coeffs, params["xyz"], center)
    # the DC rasterizer path scales colour by SH_0; folding it into the
    # features keeps the kernel linear in colour
    feat = splat_feature_rows(
        u, v, opacity_v, *conic3,
        rgb[:, 0] * geo.SH_0, rgb[:, 1] * geo.SH_0, rgb[:, 2] * geo.SH_0,
    )
    return feat, False


class KernelInputs(NamedTuple):
    """Everything ``rasterize`` hands the rasterizer kernels."""

    feat: torch.Tensor  # (9, N) DC rows, or (6 + 3*n_sh, N) per-pixel SH rows
    basis: Optional[torch.Tensor]  # (n_sh, n_tiles*256) per-pixel SH only
    layout: SplatLayout
    grid: TileGrid
    visible: torch.Tensor  # (N,) bool
    u: torch.Tensor  # (N,)
    v: torch.Tensor  # (N,)


def kernel_inputs(
    params: dict,
    alive: torch.Tensor,
    camera_T_world: torch.Tensor,
    camera: Camera,
    *,
    near_thresh: float,
    far_thresh: float,
    cull_mask_padding: float,
    mh_dist: float,
    n_sh_band: int = 0,
    use_sh_precompute: bool = True,
    uv_offset: Optional[torch.Tensor] = None,
) -> KernelInputs:
    """Camera rows, visibility and the tile layout, shared by both colour
    paths, and the features of the one ``rasterize`` takes: per-pixel SH
    (``basis`` set) when n_sh > 1 and not ``use_sh_precompute``, else DC
    colour with the SH bands evaluated once per gaussian.  ``uv_offset``
    (2, N) is added to u and v before visibility and features."""
    _check_inputs(params, alive, camera_T_world, camera)
    n_sh = _active_sh_coeffs(n_sh_band)
    grid = TileGrid(camera.height, camera.width)
    xc, yc, zc, u, v, conic3, opacity_v = _camera_rows(params, camera_T_world, camera)
    if uv_offset is not None:
        u = u + uv_offset[0]
        v = v + uv_offset[1]
    visible = frustum_visible_rows(
        u, v, zc, (camera.width, camera.height),
        near_thresh, far_thresh, cull_mask_padding,
    )
    visible = visible & alive
    with torch.no_grad(), record_function("gs::layout"):
        layout = build_layout(u, v, conic3, zc, visible, grid, mh_dist,
                              opacity=opacity_v)

    feat, per_pixel_sh = splat_features(params, u, v, conic3, opacity_v, camera_T_world,
                                        n_sh_band, use_sh_precompute)
    basis = None
    if per_pixel_sh:
        # the basis gets no gradient
        with torch.no_grad():
            basis = build_pixel_basis(camera.K, camera_T_world, n_sh, grid)
    return KernelInputs(feat, basis, layout, grid, visible, u, v)


def rasterize(
    params: dict,
    alive: torch.Tensor,
    camera_T_world: torch.Tensor,
    camera: Camera,
    *,
    near_thresh: float,
    far_thresh: float,
    cull_mask_padding: float,
    mh_dist: float,
    background_rgb: torch.Tensor,
    n_sh_band: int = 0,
    use_sh_precompute: bool = True,
    uv_offset: Optional[torch.Tensor] = None,
) -> RenderResult:
    """Render the scene from one camera.

    params: dict of parameter tensors (``GaussianScene.params()``).  With
    ``use_sh_precompute`` (the default) SH bands 1..n_sh_band are evaluated
    once per gaussian along its view direction and enter the DC rasterizer
    (B1/B2) as colour; without it, every pixel evaluates them along its own
    view ray in the per-pixel SH rasterizer (B3/B4).  Band 0 always takes
    the DC rasterizer.
    uv_offset: optional (2, N) zero rows; its gradient is the uv-space
    gradient the trainer accumulates for densification.
    """
    if uv_offset is not None and tuple(uv_offset.shape) != (2, params["xyz"].shape[0]):
        raise ValueError(f"uv_offset shape {tuple(uv_offset.shape)} != "
                         f"(2, {params['xyz'].shape[0]})")
    k = kernel_inputs(
        params, alive, camera_T_world, camera,
        near_thresh=near_thresh, far_thresh=far_thresh,
        cull_mask_padding=cull_mask_padding, mh_dist=mh_dist,
        n_sh_band=n_sh_band, use_sh_precompute=use_sh_precompute,
        uv_offset=uv_offset,
    )
    if k.basis is None:
        img_tiles, T = render_tiles(k.feat, k.layout, background_rgb, k.grid.x_tiles)
    else:
        img_tiles, T = render_tiles_sh(k.feat, k.basis, k.layout, background_rgb,
                                       k.grid.x_tiles)
    return RenderResult(
        image=tiles_to_image(img_tiles, k.grid),
        visible=k.visible,
        uv=torch.stack([k.u, k.v], dim=1),
        transmittance=T,
        num_splats=k.layout.num_splats,
        num_visible=k.layout.num_visible,
        truncated=k.layout.truncated,
    )


@torch.no_grad()
def depth_kernel_inputs(
    params: dict,
    alive: torch.Tensor,
    camera_T_world: torch.Tensor,
    camera: Camera,
    *,
    near_thresh: float,
    cull_mask_padding: float,
    mh_dist: float,
):
    """Everything ``render_depth`` hands the depth renderer: (feat (7, N),
    SplatLayout, TileGrid).  No far-plane cull, as in the reference's depth
    renderer."""
    _check_inputs(params, alive, camera_T_world, camera)
    grid = TileGrid(camera.height, camera.width)
    xc, yc, zc, u, v, conic3, opacity_v = _camera_rows(params, camera_T_world, camera)
    visible = frustum_visible_rows(
        u, v, zc, (camera.width, camera.height),
        near_thresh, float("inf"), cull_mask_padding,
    )
    visible = visible & alive
    feat = depth_feature_rows(
        u, v, opacity_v, *conic3, geo.camera_distance_rows(xc, yc, zc)
    )
    layout = build_layout(u, v, conic3, zc, visible, grid, mh_dist,
                          opacity=opacity_v)
    return feat, layout, grid


def render_depth(
    params: dict,
    alive: torch.Tensor,
    camera_T_world: torch.Tensor,
    camera: Camera,
    *,
    alpha_threshold: float,
    near_thresh: float,
    cull_mask_padding: float,
    mh_dist: float,
) -> torch.Tensor:
    """Depth image (H, W, 1); -1 where no splat crosses alpha_threshold."""
    feat, layout, grid = depth_kernel_inputs(
        params, alive, camera_T_world, camera, near_thresh=near_thresh,
        cull_mask_padding=cull_mask_padding, mh_dist=mh_dist,
    )
    depth_tiles = render_depth_tiles(feat, layout, alpha_threshold, grid.x_tiles)
    return tiles_to_image(depth_tiles[..., None], grid)
