"""Per-gaussian geometry and features: the kernel pair G (forward) and its
backward, and their host side.

``splat_rows`` takes every gaussian from its parameters to what the layout
and the rasterizer read: the feature rows (u, v, opacity, a + 1/4, b / 2,
c + 1/4, then colour), the camera-frame depth and the visibility.  It
dispatches on the device of its input: on a CUDA tensor it launches the
hand-written kernel ``csrc/geometry.cu`` through ``_SplatRows``, an
autograd Function whose backward is the second kernel and which keeps no
intermediate graph; on a CPU tensor it runs ``splat_rows_plain``, the chain
of ``geometry.py``'s rows functions and ``splat_features``, differentiated
by autograd.  There is no fallback from one to the other.  The kernel
replaces no Pallas kernel: the JAX package leaves this chain to XLA.

The colour comes from one of three epilogues, chosen by what the input
holds: scene parameters with SH evaluated once per gaussian (the DC
rasterizer's 9 rows), scene parameters with the per-pixel SH rasterizer's
raw coefficients (6 + 3 n_sh rows), or decoded rows, whose ``opacity`` is
(N,) and already activated and whose ``rgb`` is the colour itself (a
Scaffold-GS decode, ``scaffold.decode``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from gaussian_splatting_torch import _build, telemetry
from gaussian_splatting_torch import geometry as geo
from gaussian_splatting_torch.culling import frustum_visible_rows
from gaussian_splatting_torch.ops.render import splat_feature_rows
from gaussian_splatting_torch.ops.render_sh import sh_feat_rows, sh_splat_feature_rows
from gaussian_splatting_torch.structs import Camera

# the kernels' colour epilogues (csrc/geometry.cu)
MODE_DC, MODE_SH, MODE_ROWS = 0, 1, 2


class SplatRows(NamedTuple):
    """What the layout and the rasterizer take of every gaussian."""

    feat: torch.Tensor  # (9, N) DC rows, or (6 + 3*n_sh, N) per-pixel SH rows
    z: torch.Tensor  # (N,) camera-frame depth
    visible: torch.Tensor  # (N,) bool: in the frustum (and alive)
    per_pixel_sh: bool  # feat holds the per-pixel SH rows


def active_sh_coeffs(n_sh_band: int) -> int:
    if n_sh_band not in (0, 1, 2, 3):
        raise ValueError(f"n_sh_band must be 0..3, got {n_sh_band}")
    return (n_sh_band + 1) ** 2


def camera_geometry(rows, camera_T_world, camera):
    """Camera-frame centres, projections and conics of every gaussian of
    ``rows`` (xyz, quaternion, log-space scale)."""
    xyzT = rows["xyz"].T
    xc, yc, zc = geo.transform_rows(xyzT[0], xyzT[1], xyzT[2], camera_T_world)
    u, v = geo.project_rows(xc, yc, zc, camera.K)
    sig6 = geo.sigma_world_rows(rows["quaternion"], rows["scale"])
    conic3 = geo.conic_rows(sig6, xc, yc, zc, camera.K, camera_T_world)
    return xc, yc, zc, u, v, conic3


def camera_rows(params, camera_T_world, camera):
    """``camera_geometry`` and the activated opacity of every gaussian."""
    xc, yc, zc, u, v, conic3 = camera_geometry(params, camera_T_world, camera)
    opacity_v = torch.sigmoid(params["opacity"][:, 0])
    return xc, yc, zc, u, v, conic3, opacity_v


def splat_features(params, u, v, conic3, opacity_v, camera_T_world, n_sh_band: int,
                   use_sh_precompute: bool):
    """The rasterizer's per-gaussian feature rows and whether they are the
    per-pixel SH rows: (6 + 3*n_sh, N) raw coefficients, which the kernel
    contracts with each pixel's view-direction basis, when n_sh > 1 and not
    ``use_sh_precompute``; else (9, N) DC colour, the SH bands evaluated
    once per gaussian along its view direction."""
    n_sh = active_sh_coeffs(n_sh_band)
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


def _decoded(gaussians: dict) -> bool:
    """Decoded rows carry their activated opacity as (N,)."""
    return gaussians["opacity"].dim() == 1


def splat_rows_plain(gaussians: dict, alive, camera_T_world, camera: Camera, *,
                     near_thresh: float, far_thresh: float, cull_mask_padding: float,
                     n_sh_band: int = 0, use_sh_precompute: bool = True,
                     uv_offset: Optional[torch.Tensor] = None) -> SplatRows:
    """Plain PyTorch version of ``splat_rows``: the rows chain of
    ``geometry.py``, the frustum test and the feature stack (the
    ``gs::render.features`` span), as tensor ops that autograd
    differentiates."""
    if _decoded(gaussians):
        _, _, zc, u, v, conic3 = camera_geometry(gaussians, camera_T_world, camera)
        opacity_v = gaussians["opacity"]
    else:
        _, _, zc, u, v, conic3, opacity_v = camera_rows(gaussians, camera_T_world, camera)
    if uv_offset is not None:
        u = u + uv_offset[0]
        v = v + uv_offset[1]
    visible = frustum_visible_rows(u, v, zc, (camera.width, camera.height),
                                   near_thresh, far_thresh, cull_mask_padding)
    if alive is not None:
        visible = visible & alive
    with telemetry.span("gs::render.features"):
        if _decoded(gaussians):
            rgb = gaussians["rgb"]
            feat = splat_feature_rows(u, v, opacity_v, *conic3, rgb[:, 0], rgb[:, 1],
                                      rgb[:, 2])
            return SplatRows(feat, zc, visible, False)
        feat, per_pixel_sh = splat_features(gaussians, u, v, conic3, opacity_v,
                                            camera_T_world, n_sh_band, use_sh_precompute)
    return SplatRows(feat, zc, visible, per_pixel_sh)


def _epilogue(gaussians: dict, n_sh_band: int, use_sh_precompute: bool):
    """(mode, n_sh, feature rows) of the kernels' colour epilogue."""
    n_sh = active_sh_coeffs(n_sh_band)
    if _decoded(gaussians):
        if n_sh != 1:
            raise ValueError(f"decoded rows carry direct colour: n_sh_band must be 0, "
                             f"got {n_sh_band}")
        return MODE_ROWS, 1, 9
    if n_sh > 1 and not use_sh_precompute:
        return MODE_SH, n_sh, sh_feat_rows(n_sh)
    return MODE_DC, n_sh, 9


def _rows_of(t: torch.Tensor, name: str, width: int) -> int:
    """The row stride of a float32 (N, width) or (N,) tensor on the card whose
    rows' entries are contiguous."""
    if t.dtype != torch.float32 or not t.is_cuda:
        raise ValueError(f"splat_rows: {name} must be float32 on a CUDA device, got "
                         f"{t.dtype} on {t.device}")
    if width > 1 and t.stride(1) != 1:
        raise ValueError(f"splat_rows: {name}'s rows must be contiguous, strides {t.stride()}")
    return t.stride(0)


def _kernel_args(gaussians: dict, mode: int, n_sh: int, camera_T_world, K,
                 uv_offset=None, alive=None):
    """(ptrs, dims, the tensors they point into) of the launchers' inputs
    (``gs_geometry_fwd``); the caller holds the tensors until the launch."""
    xyz, quat, scale = gaussians["xyz"], gaussians["quaternion"], gaussians["scale"]
    opacity, rgb = gaussians["opacity"], gaussians["rgb"]
    n = xyz.shape[0]
    strides = [_rows_of(xyz, "xyz", 3), _rows_of(quat, "quaternion", 4),
               _rows_of(scale, "scale", 3), _rows_of(opacity, "opacity", 1),
               _rows_of(rgb, "rgb", 3)]
    dev = xyz.device
    sh = None
    if mode != MODE_ROWS and n_sh > 1:
        sh = gaussians["sh"]
        if tuple(sh.shape) != (n, 3, 15) or sh.dtype != torch.float32:
            raise ValueError(f"splat_rows: sh must be float32 ({n}, 3, 15), got "
                             f"{sh.dtype} {tuple(sh.shape)}")
        sh = sh.contiguous()
    pose = camera_T_world.to(torch.float32).contiguous()
    K = K.to(torch.float32).contiguous()
    keep = [xyz, quat, scale, opacity, rgb, sh, uv_offset, alive, pose, K]
    for t in keep:
        if t is not None and t.device != dev:
            raise ValueError(f"splat_rows: inputs on {t.device} and {dev}")
    if uv_offset is not None and not (uv_offset.dtype == torch.float32
                                      and uv_offset.is_contiguous()):
        raise ValueError("splat_rows: uv_offset must be contiguous float32 (2, N)")
    if alive is not None and not (alive.dtype == torch.bool and alive.is_contiguous()):
        raise ValueError("splat_rows: alive must be contiguous bool (N,)")
    ptrs = (ctypes.c_longlong * 10)(*(0 if t is None else t.data_ptr() for t in keep))
    quat_vec = int(strides[1] == 4 and quat.data_ptr() % 16 == 0)
    sh_vec = int(sh is not None and sh.data_ptr() % 16 == 0)
    dims = (ctypes.c_longlong * 8)(*strides, n, quat_vec, sh_vec)
    return ptrs, dims, keep


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def splat_rows_fwd_cuda(gaussians: dict, alive, camera_T_world, camera: Camera, *,
                        near_thresh: float, far_thresh: float, cull_mask_padding: float,
                        n_sh_band: int = 0, use_sh_precompute: bool = True,
                        uv_offset: Optional[torch.Tensor] = None) -> SplatRows:
    """Launch the forward kernel on the current stream (in the
    ``gs::render.features`` span); the values of ``splat_rows_plain``, with
    no graph."""
    mode, n_sh, rows = _epilogue(gaussians, n_sh_band, use_sh_precompute)
    ptrs, dims, keep = _kernel_args(gaussians, mode, n_sh, camera_T_world, camera.K,
                                    uv_offset, alive)
    n = gaussians["xyz"].shape[0]
    dev = gaussians["xyz"].device
    feat = torch.empty(rows, n, dtype=torch.float32, device=dev)
    z = torch.empty(n, dtype=torch.float32, device=dev)
    visible = torch.empty(n, dtype=torch.bool, device=dev)
    pad = float(cull_mask_padding)
    cull = (ctypes.c_float * 5)(near_thresh, far_thresh, -pad, camera.width + pad,
                                camera.height + pad)
    with telemetry.span("gs::render.features"):  # the one launch writes them
        err = _build.library().gs_geometry_fwd(
            ptrs, dims, mode, n_sh, cull, feat.data_ptr(), z.data_ptr(), visible.data_ptr(),
            _stream(feat))
    _build.check(err, "gs_geometry_fwd")
    telemetry.LAUNCHES["geometry_fwd"] += 1
    return SplatRows(feat, z, visible, mode == MODE_SH)


def splat_rows_bwd_cuda(gaussians: dict, camera_T_world, K, grad_feat, *,
                        n_sh_band: int = 0, use_sh_precompute: bool = True) -> dict:
    """Launch the backward kernel on the current stream: the gradients of
    ``gaussians``' leaves (``sh`` where the colour reads it) from the
    feature rows' gradient ``grad_feat``.  On the per-pixel path rgb's and
    sh's are views of ``grad_feat``'s coefficient rows, and for decoded rows
    opacity's and rgb's of its opacity and colour rows: the kernel writes
    what it computes and no copy of a row."""
    mode, n_sh, rows = _epilogue(gaussians, n_sh_band, use_sh_precompute)
    ptrs, dims, keep = _kernel_args(gaussians, mode, n_sh, camera_T_world, K)
    n = gaussians["xyz"].shape[0]
    if tuple(grad_feat.shape) != (rows, n) or grad_feat.dtype != torch.float32:
        raise ValueError(f"splat_rows: grad_feat must be float32 ({rows}, {n}), got "
                         f"{grad_feat.dtype} {tuple(grad_feat.shape)}")
    grad_feat = grad_feat.contiguous()
    written = ("xyz", "quaternion", "scale") + {MODE_DC: ("opacity", "rgb"),
                                                MODE_SH: ("opacity",), MODE_ROWS: ()}[mode]
    grads = {k: torch.empty(gaussians[k].shape, dtype=torch.float32,
                            device=grad_feat.device) for k in written}
    if mode == MODE_DC and n_sh > 1:
        grads["sh"] = torch.empty(n, 3, 15, dtype=torch.float32, device=grad_feat.device)
    out = (ctypes.c_longlong * 6)(*(grads[k].data_ptr() if k in grads else 0 for k in
                                    ("xyz", "quaternion", "scale", "opacity", "rgb", "sh")))
    err = _build.library().gs_geometry_bwd(ptrs, dims, mode, n_sh, grad_feat.data_ptr(),
                                           out, _stream(grad_feat))
    _build.check(err, "gs_geometry_bwd")
    telemetry.LAUNCHES["geometry_bwd"] += 1
    if mode == MODE_SH:
        # the coefficient rows' gradients as they stand, viewed as autograd
        # viewed them: no copy beside B4's rows at the step's memory peak
        coeffs = grad_feat[6:].view(3, n_sh, n)
        grads["rgb"] = coeffs[:, 0].T
        grads["sh"] = coeffs[:, 1:].permute(2, 0, 1)
        if n_sh < 16:  # the inactive columns
            grads["sh"] = torch.nn.functional.pad(grads["sh"], (0, 16 - n_sh))
    elif mode == MODE_ROWS:
        grads["opacity"] = grad_feat[2]
        grads["rgb"] = grad_feat[6:9].T
    return grads


class _SplatRows(torch.autograd.Function):
    """``splat_rows`` through the forward kernel; its backward is the second
    kernel, which recomputes the geometry from the saved inputs.  The pose,
    K and alive get no gradient; uv_offset gets the u and v rows'."""

    @staticmethod
    def forward(ctx, settings, xyz, quaternion, scale, opacity, rgb, sh, uv_offset,
                alive, camera_T_world, K):
        camera, cull, n_sh_band, use_sh_precompute = settings
        gaussians = dict(xyz=xyz, quaternion=quaternion, scale=scale, opacity=opacity,
                         rgb=rgb, sh=sh)
        out = splat_rows_fwd_cuda(gaussians, alive, camera_T_world,
                                  Camera(K, camera[0], camera[1]), **cull,
                                  n_sh_band=n_sh_band, use_sh_precompute=use_sh_precompute,
                                  uv_offset=uv_offset)
        ctx.save_for_backward(xyz, quaternion, scale, opacity, rgb, sh, camera_T_world, K)
        ctx.colour = (n_sh_band, use_sh_precompute)
        ctx.mark_non_differentiable(out.z, out.visible)
        return out.feat, out.z, out.visible

    @staticmethod
    def backward(ctx, grad_feat, _grad_z, _grad_visible):
        xyz, quaternion, scale, opacity, rgb, sh, camera_T_world, K = ctx.saved_tensors
        gaussians = dict(xyz=xyz, quaternion=quaternion, scale=scale, opacity=opacity,
                         rgb=rgb, sh=sh)
        n_sh_band, use_sh_precompute = ctx.colour
        g = splat_rows_bwd_cuda(gaussians, camera_T_world, K, grad_feat,
                                n_sh_band=n_sh_band, use_sh_precompute=use_sh_precompute)
        g_uv = grad_feat[0:2] if ctx.needs_input_grad[7] else None
        return (None, g["xyz"], g["quaternion"], g["scale"], g["opacity"], g["rgb"],
                g.get("sh"), g_uv, None, None, None)


def splat_rows(gaussians: dict, alive, camera_T_world, camera: Camera, *,
               near_thresh: float, far_thresh: float, cull_mask_padding: float,
               n_sh_band: int = 0, use_sh_precompute: bool = True,
               uv_offset: Optional[torch.Tensor] = None) -> SplatRows:
    """Every gaussian's feature rows, camera-frame depth and visibility.

    gaussians: scene parameters (``GaussianScene.params()``: xyz, rgb,
    opacity (N, 1) pre-sigmoid, scale, quaternion, sh) or decoded rows
    (xyz, scale, quaternion, rgb as colour, opacity (N,) activated; band
    0).  alive: (N,) bool or None (every row).  uv_offset: optional (2, N),
    added to u and v before the frustum test; its gradient is the u and v
    rows'.  The features are the per-pixel SH rows when n_sh > 1 and not
    ``use_sh_precompute`` (``per_pixel_sh``), else the DC rows.  On a CUDA
    tensor the kernel pair (``_SplatRows``), on a CPU tensor
    ``splat_rows_plain``.
    """
    kw = dict(near_thresh=near_thresh, far_thresh=far_thresh,
              cull_mask_padding=cull_mask_padding)
    dev = gaussians["xyz"].device
    if dev.type == "cpu":
        return splat_rows_plain(gaussians, alive, camera_T_world, camera, **kw,
                                n_sh_band=n_sh_band, use_sh_precompute=use_sh_precompute,
                                uv_offset=uv_offset)
    if not gaussians["xyz"].is_cuda:
        raise ValueError(f"splat_rows: no kernel for device {dev}")
    mode, n_sh, _ = _epilogue(gaussians, n_sh_band, use_sh_precompute)
    sh = gaussians["sh"] if mode != MODE_ROWS and n_sh > 1 else None
    feat, z, visible = _SplatRows.apply(
        ((camera.width, camera.height), kw, n_sh_band, use_sh_precompute),
        gaussians["xyz"], gaussians["quaternion"], gaussians["scale"], gaussians["opacity"],
        gaussians["rgb"], sh, uv_offset, alive, camera_T_world, camera.K)
    return SplatRows(feat, z, visible, mode == MODE_SH)
