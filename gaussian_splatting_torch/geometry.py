"""Per-gaussian projective geometry on tensors (counterpart of
``gaussian_splatting_tpu/geometry.py``, its "rows" API).

Each function works component-wise on (N,) rows, like the JAX rows chain,
so the two packages evaluate the same float operations in the same order.
Every division is guarded: masked-out entries (z ~ 0, dead slots) give
zero, not NaN, in value and in gradient.
"""

from __future__ import annotations

import math

import torch

# real spherical-harmonics constants, bands 0..3
SH_0 = 0.28209479177387814
R_SH_0 = 3.544907701811032  # 1 / SH_0
SH_1 = (-0.4886025119029199, 0.4886025119029199, -0.4886025119029199)
SH_2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.263875515352797,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def _safe_div(num, den, ok):
    """num/den with zero (value and grad) where ``ok`` is False."""
    den_safe = torch.where(ok, den, torch.ones_like(den))
    return torch.where(ok, num / den_safe, torch.zeros_like(num))


def transform_rows(x, y, z, camera_T_world):
    """World -> camera frame: 3x(N,), (4,4) -> 3x(N,)."""
    R = camera_T_world[:3, :3]
    t = camera_T_world[:3, 3]
    xc = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + t[0]
    yc = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + t[1]
    zc = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + t[2]
    return xc, yc, zc


def project_rows(xc, yc, zc, K):
    """Pinhole projection: 3x(N,), (3,3) -> (u, v)."""
    ok = zc.abs() > 1e-12
    inv_z = _safe_div(torch.ones_like(zc), zc, ok)
    u = K[0, 0] * xc * inv_z + K[0, 2]
    v = K[1, 1] * yc * inv_z + K[1, 2]
    return u, v


def sigma_world_rows(quaternion, scale):
    """Sigma = R S S^T R^T as its six upper-triangular components.

    (N,4), (N,3) -> (xx, xy, xz, yy, yz, zz), each (N,).  The quaternion is
    normalised here; a zero (dead-slot) quaternion gives the identity.
    """
    qT = quaternion.T
    sT = scale.T
    sumsq = qT[0] * qT[0] + qT[1] * qT[1] + qT[2] * qT[2] + qT[3] * qT[3]
    ok = sumsq > 1e-24
    inv_norm = _safe_div(
        torch.ones_like(sumsq),
        torch.sqrt(torch.where(ok, sumsq, torch.ones_like(sumsq))),
        ok,
    )
    w = torch.where(ok, qT[0] * inv_norm, torch.ones_like(sumsq))
    x = qT[1] * inv_norm
    y = qT[2] * inv_norm
    z = qT[3] * inv_norm
    r00 = 1 - 2 * y * y - 2 * z * z
    r01 = 2 * x * y - 2 * z * w
    r02 = 2 * z * x + 2 * w * y
    r10 = 2 * x * y + 2 * z * w
    r11 = 1 - 2 * x * x - 2 * z * z
    r12 = 2 * y * z - 2 * w * x
    r20 = 2 * z * x - 2 * w * y
    r21 = 2 * y * z + 2 * w * x
    r22 = 1 - 2 * x * x - 2 * y * y
    s0 = torch.exp(2.0 * sT[0])
    s1 = torch.exp(2.0 * sT[1])
    s2 = torch.exp(2.0 * sT[2])
    xx = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    xy = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    xz = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    yy = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    yz = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    zz = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return xx, xy, xz, yy, yz, zz


def quaternion_to_rotation(q):
    """Normalised wxyz quaternions (N, 4) -> rotation matrices (N, 3, 3)."""
    w, x, y, z = q.unbind(1)
    r = torch.stack(
        [
            1 - 2 * y * y - 2 * z * z,
            2 * x * y - 2 * z * w,
            2 * z * x + 2 * w * y,
            2 * x * y + 2 * z * w,
            1 - 2 * x * x - 2 * z * z,
            2 * y * z - 2 * w * x,
            2 * z * x - 2 * w * y,
            2 * y * z + 2 * w * x,
            1 - 2 * x * x - 2 * y * y,
        ],
        dim=1,
    )
    return r.reshape(-1, 3, 3)


def inverse_sigmoid(x):
    """log(x / (1 - x)) of x clipped to [1e-4, 1 - 1e-4].  A tensor is worked
    in its own dtype; a Python number in double precision, as the JAX
    package forms it from a config value under x64, and the caller rounds
    the result to float32 where a float32 tensor takes it."""
    if isinstance(x, torch.Tensor):
        x = x.clamp(1e-4, 1 - 1e-4)
        return torch.log(x / (1.0 - x))
    x = min(max(float(x), 1e-4), 1 - 1e-4)
    return math.log(x / (1.0 - x))


def conic_rows(sig6, xc, yc, zc, K, camera_T_world):
    """2D conic [a, 2b, c] of the projected covariance J W Sigma W^T J^T,
    with the projection Jacobian J folded in.  No gradient reaches the
    camera pose."""
    xx, xy, xz, yy, yz, zz = sig6
    W = camera_T_world[:3, :3].detach()
    ok = zc.abs() > 1e-12
    inv_z = _safe_div(torch.ones_like(zc), zc, ok)
    fx, fy = K[0, 0], K[1, 1]
    j00 = fx * inv_z
    j02 = -fx * xc * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -fy * yc * inv_z * inv_z
    # M = J W  (2x3 per gaussian)
    m00 = j00 * W[0, 0] + j02 * W[2, 0]
    m01 = j00 * W[0, 1] + j02 * W[2, 1]
    m02 = j00 * W[0, 2] + j02 * W[2, 2]
    m10 = j11 * W[1, 0] + j12 * W[2, 0]
    m11 = j11 * W[1, 1] + j12 * W[2, 1]
    m12 = j11 * W[1, 2] + j12 * W[2, 2]
    # t = M Sigma  (Sigma symmetric)
    t00 = m00 * xx + m01 * xy + m02 * xz
    t01 = m00 * xy + m01 * yy + m02 * yz
    t02 = m00 * xz + m01 * yz + m02 * zz
    t10 = m10 * xx + m11 * xy + m12 * xz
    t11 = m10 * xy + m11 * yy + m12 * yz
    t12 = m10 * xz + m11 * yz + m12 * zz
    c0 = t00 * m00 + t01 * m01 + t02 * m02
    # both off-diagonals are summed into the middle entry
    c1 = (t00 * m10 + t01 * m11 + t02 * m12) + (
        t10 * m00 + t11 * m01 + t12 * m02
    )
    c2 = t10 * m10 + t11 * m11 + t12 * m12
    return c0, c1, c2


def camera_distance_rows(xc, yc, zc):
    """Euclidean camera distance per gaussian (the depth renderer's value)."""
    return torch.sqrt(xc * xc + yc * yc + zc * zc)


def sh_basis(view_dir, n_sh: int):
    """Real SH basis (bands 0..3) at unit directions: (..., 3) ->
    (..., n_sh) for n_sh in {1, 4, 9, 16}."""
    if n_sh not in (1, 4, 9, 16):
        raise ValueError(f"n_sh must be 1, 4, 9 or 16, got {n_sh}")
    out = [torch.full(view_dir.shape[:-1], SH_0, dtype=view_dir.dtype,
                      device=view_dir.device)]
    if n_sh >= 4:
        x, y, z = view_dir[..., 0], view_dir[..., 1], view_dir[..., 2]
        out += [SH_1[0] * y, SH_1[1] * z, SH_1[2] * x]
    if n_sh >= 9:
        xx, yy, zz = x * x, y * y, z * z
        out += [
            SH_2[0] * x * y,
            SH_2[1] * y * z,
            SH_2[2] * (3 * zz - 1.0),
            SH_2[3] * x * z,
            SH_2[4] * (xx - yy),
        ]
    if n_sh >= 16:
        out += [
            SH_3[0] * y * (3 * xx - yy),
            SH_3[1] * x * y * z,
            SH_3[2] * y * (5 * zz - 1.0),
            SH_3[3] * z * (5 * zz - 3.0),
            SH_3[4] * x * (5 * zz - 1.0),
            SH_3[5] * z * (xx - yy),
            SH_3[6] * x * (xx - 3 * yy),
        ]
    return torch.stack(out, dim=-1)


def precompute_rgb_from_sh(sh_coeffs, xyz, camera_center):
    """Per-gaussian SH -> pseudo-RGB along the centre-to-gaussian view dir.

    sh_coeffs: (N, 3, n_sh) including the DC coefficient at index 0.  The
    result is scaled by 1/SH_0 so it plugs into the DC rasterizer path,
    which multiplies by SH_0 again.  The contraction is an elementwise
    multiply-and-sum, not a matmul, so no TF32 setting reaches it.
    """
    n_sh = sh_coeffs.shape[2]
    if n_sh == 1:
        return sh_coeffs[:, :, 0]
    view = xyz - camera_center
    sumsq = (view * view).sum(dim=1, keepdim=True)
    ok = sumsq > 1e-24
    norm = torch.sqrt(torch.where(ok, sumsq, torch.ones_like(sumsq)))
    view = _safe_div(view, norm, ok)
    basis = sh_basis(view, n_sh)  # (N, n_sh)
    return (sh_coeffs * basis[:, None, :]).sum(dim=2) * R_SH_0


def compute_rays(K, width: int, height: int):
    """Unit rays through every pixel in the camera frame, (H, W, 3)."""
    u = torch.arange(width, dtype=K.dtype, device=K.device)
    v = torch.arange(height, dtype=K.dtype, device=K.device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d = torch.stack(
        [(uu - K[0, 2]) / K[0, 0], (vv - K[1, 2]) / K[1, 1], torch.ones_like(uu)],
        dim=-1,
    )
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def compute_rays_in_world_frame(K, width: int, height: int, camera_T_world):
    """World-frame unit rays per pixel, (H, W, 3): the camera-frame rays
    turned by inverse(camera_T_world)'s rotation and normalised again."""
    rays = compute_rays(K, width, height)
    world_R_camera = torch.linalg.inv(camera_T_world)[:3, :3]
    rays = rays @ world_R_camera.T
    return rays / torch.linalg.norm(rays, dim=-1, keepdim=True)


def camera_center_from_pose(camera_T_world):
    """World-frame camera centre = inverse(camera_T_world)[:3, 3]."""
    R = camera_T_world[:3, :3]
    t = camera_T_world[:3, 3]
    return -(R.T * t[None, :]).sum(dim=1)
