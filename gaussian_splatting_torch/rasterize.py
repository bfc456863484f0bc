"""Forward rendering pipeline: geometry -> culling -> CUDA rasterizer
(counterpart of ``gaussian_splatting_tpu/rasterize.py``: the DC branch, the
per-pixel SH branch and depth).

The pipeline runs on whatever device the parameters live on: on CUDA the
geometry (``ops.geometry.splat_rows``), the rasterizer and the depth
renderer launch their hand-written kernels, on the CPU they run their plain
PyTorch versions.  The depth path forms its geometry with the plain chain
on both.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussian_splatting_torch import geometry as geo
from gaussian_splatting_torch import telemetry
from gaussian_splatting_torch.culling import (
    SplatLayout,
    build_layout,
    feature_layout,
    frustum_visible_rows,
)
from gaussian_splatting_torch.ops.depth import depth_feature_rows, render_depth_tiles
from gaussian_splatting_torch.ops.geometry import active_sh_coeffs, camera_rows, splat_rows
from gaussian_splatting_torch.ops.reference_impl import tiles_to_image
from gaussian_splatting_torch.ops.render import render_tiles
from gaussian_splatting_torch.ops.render_sh import build_pixel_basis, render_tiles_sh
from gaussian_splatting_torch.structs import Camera, TileGrid


class RenderResult(NamedTuple):
    image: torch.Tensor  # (H, W, 3)
    visible: torch.Tensor  # (N,) bool
    uv: torch.Tensor  # (N, 2) projected centres (all gaussians)
    transmittance: torch.Tensor  # (n_tiles, 256)
    num_splats: int  # live (gaussian, tile) pairs
    num_visible: int  # gaussians with at least one window cell
    truncated: int  # window cells dropped past culling.MAX_WINDOW_CELLS


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
    """Feature rows, visibility and the tile layout, and the per-pixel SH
    basis (``basis`` set) when n_sh > 1 and not ``use_sh_precompute``; else
    DC colour with the SH bands evaluated once per gaussian
    (``ops.geometry.splat_rows``: one kernel launch on the card).
    ``uv_offset`` (2, N) is added to u and v before visibility and
    features."""
    _check_inputs(params, alive, camera_T_world, camera)
    grid = TileGrid(camera.height, camera.width)
    with telemetry.span("gs::render.geometry"):
        g = splat_rows(params, alive, camera_T_world, camera, near_thresh=near_thresh,
                       far_thresh=far_thresh, cull_mask_padding=cull_mask_padding,
                       n_sh_band=n_sh_band, use_sh_precompute=use_sh_precompute,
                       uv_offset=uv_offset)
    with torch.no_grad(), telemetry.span("gs::layout"):
        layout = feature_layout(g.feat, g.z, g.visible, grid, mh_dist)

    basis = None
    if g.per_pixel_sh:
        # the basis gets no gradient
        with torch.no_grad(), telemetry.span("gs::render.features"):
            basis = build_pixel_basis(camera.K, camera_T_world,
                                      active_sh_coeffs(n_sh_band), grid)
    return KernelInputs(g.feat, basis, layout, grid, g.visible, g.feat[0], g.feat[1])


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
    telemetry.count("views")
    with telemetry.span("gs::render"):
        k = kernel_inputs(
            params, alive, camera_T_world, camera,
            near_thresh=near_thresh, far_thresh=far_thresh,
            cull_mask_padding=cull_mask_padding, mh_dist=mh_dist,
            n_sh_band=n_sh_band, use_sh_precompute=use_sh_precompute,
            uv_offset=uv_offset,
        )
        return _raster(k, background_rgb)


def _raster(k: KernelInputs, background_rgb) -> RenderResult:
    """The kernels' image of ``k``: B1/B2 on DC features, B3/B4 with a
    per-pixel basis."""
    with telemetry.span("gs::render.raster"):
        if k.basis is None:
            img_tiles, T = render_tiles(k.feat, k.layout, background_rgb, k.grid.x_tiles)
        else:
            img_tiles, T = render_tiles_sh(k.feat, k.basis, k.layout, background_rgb,
                                           k.grid.x_tiles)
        image = tiles_to_image(img_tiles, k.grid)
    return RenderResult(
        image=image,
        visible=k.visible,
        uv=torch.stack([k.u, k.v], dim=1),
        transmittance=T,
        num_splats=k.layout.num_splats,
        num_visible=k.layout.num_visible,
        truncated=k.layout.truncated,
    )


ROW_KEYS = dict(xyz=3, scale=3, quaternion=4, rgb=3)


def rows_kernel_inputs(
    rows: dict,
    camera_T_world: torch.Tensor,
    camera: Camera,
    *,
    near_thresh: float,
    far_thresh: float,
    cull_mask_padding: float,
    mh_dist: float,
) -> KernelInputs:
    """``kernel_inputs`` of gaussian rows that carry their activated opacity
    and their colour, as a Scaffold-GS decode gives them (``scaffold.
    decode``): ``xyz``, ``scale`` (log-space), ``quaternion`` (normalised
    on use), ``rgb`` (direct colour, not SH coefficients), each (N, C), and
    ``opacity`` (N,), activated: a row of opacity <= 1/255 is never
    rendered (the layout's opacity-aware window).  The DC path at band 0,
    with the colour taken as it is: no sigmoid, no SH_0."""
    n = rows["opacity"].shape
    if len(n) != 1 or any(tuple(rows[k].shape) != (n[0], c) for k, c in ROW_KEYS.items()):
        raise ValueError("rows must hold opacity (N,) and xyz, scale, quaternion, rgb "
                         f"(N, 3/3/4/3); got { {k: tuple(v.shape) for k, v in rows.items()} }")
    grid = TileGrid(camera.height, camera.width)
    with telemetry.span("gs::render.geometry"):
        g = splat_rows(rows, None, camera_T_world, camera, near_thresh=near_thresh,
                       far_thresh=far_thresh, cull_mask_padding=cull_mask_padding)
    with torch.no_grad(), telemetry.span("gs::layout"):
        layout = feature_layout(g.feat, g.z, g.visible, grid, mh_dist)
    return KernelInputs(g.feat, None, layout, grid, g.visible, g.feat[0], g.feat[1])


def rasterize_rows(
    rows: dict,
    camera_T_world: torch.Tensor,
    camera: Camera,
    *,
    near_thresh: float,
    far_thresh: float,
    cull_mask_padding: float,
    mh_dist: float,
    background_rgb: torch.Tensor,
) -> RenderResult:
    """Render gaussian rows with activated opacity and direct colour
    (``rows_kernel_inputs``) through the layout and B1/B2, as ``rasterize``
    renders a scene at band 0.  It opens no ``gs::render`` span and counts
    no view: its caller, ``scaffold.render``, does both around its decode."""
    k = rows_kernel_inputs(rows, camera_T_world, camera, near_thresh=near_thresh,
                           far_thresh=far_thresh, cull_mask_padding=cull_mask_padding,
                           mh_dist=mh_dist)
    return _raster(k, background_rgb)


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
    xc, yc, zc, u, v, conic3, opacity_v = camera_rows(params, camera_T_world, camera)
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
