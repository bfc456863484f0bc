"""Forward rendering pipeline: geometry -> culling -> CUDA rasterizer
(counterpart of ``gaussian_splatting_tpu/rasterize.py``: the DC branch, the
per-pixel SH branch and depth).

Every view goes through ``kernel_inputs`` (geometry, layout and, for
per-pixel SH, the pixel basis) and one raster tail (``raster``): a scene's
view (``rasterize``), a Scaffold-GS decode (``scaffold.render``) and a band
of the model-parallel render (``parallel.gsharded``); a depth map takes
``kernel_inputs`` into B5 (``render_depth``).  The pipeline runs on
whatever device the gaussians live on: on CUDA the geometry
(``ops.geometry.splat_rows``), the rasterizer and the depth renderer launch
their hand-written kernels, on the CPU they run their plain PyTorch
versions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussian_splatting_torch import geometry as geo
from gaussian_splatting_torch import telemetry
from gaussian_splatting_torch.culling import SplatLayout, feature_layout
from gaussian_splatting_torch.ops.depth import FEAT_DEPTH, render_depth_tiles
from gaussian_splatting_torch.ops.geometry import active_sh_coeffs, splat_rows
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


ROW_KEYS = dict(xyz=3, scale=3, quaternion=4, rgb=3)


def _check_inputs(gaussians: dict, alive, camera_T_world, camera: Camera, uv_offset=None):
    """Shape, dtype and device validation at the API boundary: scene
    parameters with their alive mask, or decoded rows (``alive`` None)."""
    if alive is None:
        rows, n = gaussians, gaussians["opacity"].shape
        if len(n) != 1 or any(tuple(rows[k].shape) != (n[0], c) for k, c in ROW_KEYS.items()):
            raise ValueError("rows must hold opacity (N,) and xyz, scale, quaternion, rgb "
                             f"(N, 3/3/4/3); got { {k: tuple(v.shape) for k, v in rows.items()} }")
        return
    params = gaussians
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
    if uv_offset is not None and tuple(uv_offset.shape) != (2, n):
        raise ValueError(f"uv_offset shape {tuple(uv_offset.shape)} != (2, {n})")
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
    """Everything a view hands the rasterizer kernels."""

    feat: torch.Tensor  # (9, N) DC rows, or (6 + 3*n_sh, N) per-pixel SH rows
    basis: Optional[torch.Tensor]  # (n_sh, n_tiles*256) per-pixel SH only
    layout: SplatLayout
    grid: TileGrid
    visible: torch.Tensor  # (N,) bool


def kernel_inputs(
    gaussians: dict,
    alive: Optional[torch.Tensor],
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

    gaussians: scene parameters (``GaussianScene.params()``) with their
    ``alive`` mask, or, with ``alive`` None and at band 0, gaussian rows
    that carry their activated opacity and their colour, as a Scaffold-GS
    decode gives them (``scaffold.decode``): ``xyz``, ``scale``
    (log-space), ``quaternion`` (normalised on use), ``rgb`` (the colour
    itself: no sigmoid, no SH_0), each (N, C), and ``opacity`` (N,); a row
    of opacity <= 1/255 is never rendered (the layout's opacity-aware
    window).  ``uv_offset`` (2, N) is added to u and v before visibility
    and features."""
    _check_inputs(gaussians, alive, camera_T_world, camera, uv_offset)
    grid = TileGrid(camera.height, camera.width)
    with telemetry.span("gs::render.geometry"):
        g = splat_rows(gaussians, alive, camera_T_world, camera, near_thresh=near_thresh,
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
    return KernelInputs(g.feat, basis, layout, grid, g.visible)


def raster(feat, basis, layout: SplatLayout, grid: TileGrid, background_rgb):
    """The kernels' image of a layout: (image (H, W, 3), T (n_tiles, 256)),
    through B1/B2 on DC rows when ``basis`` is None, else through B3/B4
    with the per-pixel basis."""
    if basis is None:
        img_tiles, T = render_tiles(feat, layout, background_rgb, grid.x_tiles)
    else:
        img_tiles, T = render_tiles_sh(feat, basis, layout, background_rgb, grid.x_tiles)
    return tiles_to_image(img_tiles, grid), T


def render_view(gaussians: dict, alive, camera_T_world, camera: Camera, *,
                background_rgb: torch.Tensor, **kw) -> RenderResult:
    """``kernel_inputs`` (``kw`` its settings) and the raster tail of one
    view, in no ``gs::render`` span and counted as no view: its callers,
    ``rasterize`` and ``scaffold.render``, do both."""
    k = kernel_inputs(gaussians, alive, camera_T_world, camera, **kw)
    with telemetry.span("gs::render.raster"):
        image, T = raster(k.feat, k.basis, k.layout, k.grid, background_rgb)
    return RenderResult(
        image=image,
        visible=k.visible,
        uv=torch.stack([k.feat[0], k.feat[1]], dim=1),
        transmittance=T,
        num_splats=k.layout.num_splats,
        num_visible=k.layout.num_visible,
        truncated=k.layout.truncated,
    )


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
    telemetry.count("views")
    with telemetry.span("gs::render"):
        return render_view(
            params, alive, camera_T_world, camera,
            near_thresh=near_thresh, far_thresh=far_thresh,
            cull_mask_padding=cull_mask_padding, mh_dist=mh_dist,
            background_rgb=background_rgb, n_sh_band=n_sh_band,
            use_sh_precompute=use_sh_precompute, uv_offset=uv_offset,
        )


@torch.no_grad()
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
    """Depth image (H, W, 1); -1 where no splat crosses alpha_threshold.
    No far-plane cull, as in the reference's depth renderer.  B5 reads the
    rows 0-5 of ``kernel_inputs`` at band 0 and each gaussian's camera
    distance as row ``FEAT_DEPTH``."""
    k = kernel_inputs(params, alive, camera_T_world, camera, near_thresh=near_thresh,
                      far_thresh=float("inf"), cull_mask_padding=cull_mask_padding,
                      mh_dist=mh_dist)
    xyzT = params["xyz"].T
    dist = geo.camera_distance_rows(*geo.transform_rows(xyzT[0], xyzT[1], xyzT[2],
                                                        camera_T_world))
    feat = torch.cat([k.feat[:FEAT_DEPTH], dist[None]])
    depth_tiles = render_depth_tiles(feat, k.layout, alpha_threshold, k.grid.x_tiles)
    return tiles_to_image(depth_tiles[..., None], k.grid)
