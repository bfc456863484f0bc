"""The geometry kernel pair's entry (``ops.geometry.splat_rows``): its
dispatch and argument checks, its plain version against the chain that
``rasterize`` ran before it, bit for bit on the CPU, and a float64 model of
the backward kernel's reverse pass (``csrc/geometry.cu``) against autograd
of the chain.  Marked ``card``: both kernels against the plain version on
the card.  The file imports no JAX, so the card tests run on a machine
without it: ``python3 -m pytest --noconftest tests/test_torch_geometry_op.py
-m card -q``."""

import math

import pytest
import torch

from gaussian_splatting_torch import geometry as geo
from gaussian_splatting_torch import rasterize, telemetry, trainer
from gaussian_splatting_torch.config import SplatConfig
from gaussian_splatting_torch.culling import build_layout, feature_layout, frustum_visible_rows
from gaussian_splatting_torch.ops import geometry as og
from gaussian_splatting_torch.ops.render import splat_feature_rows
from gaussian_splatting_torch.structs import Camera, GaussianScene, TileGrid
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

W, H = 96, 64
CULL = dict(near_thresh=0.2, far_thresh=100.0, cull_mask_padding=10.0)
SH_BANDS = [0, 1, 2, 3]


def _pose(dtype=torch.float32):
    ang = 0.3
    pose = torch.eye(4, dtype=torch.float64)
    pose[:3, :3] = torch.tensor([[math.cos(ang), 0, math.sin(ang)], [0, 1, 0],
                                 [-math.sin(ang), 0, math.cos(ang)]])
    pose[:3, 3] = torch.tensor([0.2, -0.1, 0.5])
    return pose.to(dtype)


def _K(dtype=torch.float32):
    return torch.tensor([[70.0, 0, 48.0], [0, 66.0, 32.0], [0, 0, 1]], dtype=dtype)


def _params(n, seed, dtype=torch.float32, edge=True, device="cpu"):
    """Seeded scene parameters (sh (n, 3, 15)) and alive; with ``edge``, slot
    0 sits on the camera plane (|z| <= 1e-12), slot 1 has a zero quaternion,
    slot 2 a NaN position, slot 3 an inf log-scale, slot 4 a NaN opacity,
    slot 5 a NaN sh coefficient, slot 6 is dead."""
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand(n, 3, generator=g, dtype=torch.float64) * 2.4 - 1.2
    xyz[:, 2] += 4.0
    p = dict(
        xyz=xyz,
        rgb=torch.rand(n, 3, generator=g, dtype=torch.float64),
        opacity=torch.randn(n, 1, generator=g, dtype=torch.float64),
        scale=math.log(0.08) + 0.3 * torch.randn(n, 3, generator=g, dtype=torch.float64),
        quaternion=torch.randn(n, 4, generator=g, dtype=torch.float64),
        sh=0.2 * torch.randn(n, 3, 15, generator=g, dtype=torch.float64),
    )
    alive = torch.ones(n, dtype=torch.bool)
    if edge:
        # world point on the camera plane: R x + t has z = 0
        pose = _pose(torch.float64)
        p["xyz"][0] = pose[:3, :3].T @ (torch.tensor([0.3, 0.2, 0.0],
                                                     dtype=torch.float64) - pose[:3, 3])
        p["quaternion"][1] = 0.0
        p["xyz"][2, 1] = float("nan")
        p["scale"][3, 0] = float("inf")
        p["opacity"][4, 0] = float("nan")
        p["sh"][5, 1, 4] = float("nan")
        alive[6] = False
    return ({k: v.to(dtype).to(device) for k, v in p.items()}, alive.to(device))


def _camera(dtype=torch.float32, device="cpu"):
    return Camera(_K(dtype).to(device), W, H)


def _before(params, alive, pose, cam, n_sh_band, use_sh_precompute, uv_offset):
    """``rasterize.kernel_inputs``' geometry and features as they were
    written before the entry took them: the same public steps, inlined."""
    xyzT = params["xyz"].T
    xc, yc, zc = geo.transform_rows(xyzT[0], xyzT[1], xyzT[2], pose)
    u, v = geo.project_rows(xc, yc, zc, cam.K)
    sig6 = geo.sigma_world_rows(params["quaternion"], params["scale"])
    conic3 = geo.conic_rows(sig6, xc, yc, zc, cam.K, pose)
    opacity_v = torch.sigmoid(params["opacity"][:, 0])
    if uv_offset is not None:
        u = u + uv_offset[0]
        v = v + uv_offset[1]
    visible = frustum_visible_rows(u, v, zc, (cam.width, cam.height), **CULL) & alive
    feat, per_pixel = og.splat_features(params, u, v, conic3, opacity_v, pose,
                                               n_sh_band, use_sh_precompute)
    return feat, zc, visible, per_pixel, (u, v, conic3, opacity_v)


def _leaves(params, uv):
    return [params[k] for k in ("xyz", "rgb", "opacity", "scale", "quaternion", "sh")] + [uv]


def _grads(out, leaves, cot):
    g = torch.autograd.grad(out, leaves, cot, allow_unused=True)
    return [torch.zeros_like(x) if a is None else a for a, x in zip(g, leaves)]


def _bitwise(a, b):
    """Equal, NaN where NaN."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("use_sh_precompute", [True, False])
@pytest.mark.parametrize("n_sh_band", SH_BANDS)
def test_cpu_entry_is_the_chain_bit_for_bit(n_sh_band, use_sh_precompute):
    """On the CPU ``splat_rows`` gives the values and gradients of the chain
    it replaced, bit for bit, edge slots (camera plane, zero quaternion,
    NaN and inf parameters, a dead slot) included; the layout of the
    feature rows is the layout of the rows they came from."""
    params, alive = _params(200, n_sh_band, edge=True)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    uv = torch.zeros(2, 200, requires_grad=True)
    pose, cam = _pose(), _camera()
    got = og.splat_rows(params, alive, pose, cam, **CULL, n_sh_band=n_sh_band,
                        use_sh_precompute=use_sh_precompute, uv_offset=uv)
    feat, zc, visible, per_pixel, (u, v, conic3, op) = _before(
        params, alive, pose, cam, n_sh_band, use_sh_precompute, uv)
    assert got.per_pixel_sh == per_pixel == (n_sh_band > 0 and not use_sh_precompute)
    assert _bitwise(got.feat, feat) and _bitwise(got.z, zc)
    assert torch.equal(got.visible, visible)
    cot = torch.randn(feat.shape, generator=torch.Generator().manual_seed(1))
    for a, b in zip(_grads(got.feat, _leaves(params, uv), cot),
                    _grads(feat, _leaves(params, uv), cot)):
        assert _bitwise(a, b)
    grid = TileGrid(H, W)
    with torch.no_grad():
        lay = feature_layout(got.feat, got.z, got.visible, grid, 3.0)
        want = build_layout(u, v, conic3, zc, visible, grid, 3.0, opacity=op)
    for a, b in zip(lay, want):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_cpu_decoded_rows_are_the_chain_bit_for_bit():
    """Decoded rows (opacity (N,), direct colour): the chain's geometry
    with the opacity and colour as they are, every row visible that the
    frustum keeps."""
    params, _ = _params(150, 7, edge=True)
    rows = dict(xyz=params["xyz"], scale=params["scale"], quaternion=params["quaternion"],
                rgb=params["rgb"], opacity=torch.sigmoid(params["opacity"][:, 0]))
    rows = {k: v.requires_grad_(True) for k, v in rows.items()}
    pose, cam = _pose(), _camera()
    got = og.splat_rows(rows, None, pose, cam, **CULL)
    _, _, zc, u, v, conic3 = og.camera_geometry(rows, pose, cam)
    rgb = rows["rgb"]
    feat = splat_feature_rows(u, v, rows["opacity"], *conic3, rgb[:, 0], rgb[:, 1],
                              rgb[:, 2])
    visible = frustum_visible_rows(u, v, zc, (W, H), **CULL)
    assert _bitwise(got.feat, feat) and _bitwise(got.z, zc) and not got.per_pixel_sh
    assert torch.equal(got.visible, visible)
    cot = torch.randn(9, 150, generator=torch.Generator().manual_seed(2))
    leaves = list(rows.values())
    for a, b in zip(_grads(got.feat, leaves, cot), _grads(feat, leaves, cot)):
        assert _bitwise(a, b)
    with pytest.raises(ValueError, match="n_sh_band must be 0"):
        og._epilogue(rows, 1, True)


@pytest.mark.parametrize("n_sh_band,use_sh_precompute,rows", [
    (0, True, 9), (3, True, 9), (1, False, 18), (2, False, 33), (3, False, 54),
    (0, False, 9)])
def test_epilogue_shapes(n_sh_band, use_sh_precompute, rows):
    """The three epilogues' feature rows: 9 DC rows (band 0 always), 6 +
    3 n_sh per-pixel SH rows, 9 decoded rows; the kernels' (mode, n_sh)."""
    params, alive = _params(40, 3, edge=False)
    out = og.splat_rows(params, alive, _pose(), _camera(), **CULL, n_sh_band=n_sh_band,
                        use_sh_precompute=use_sh_precompute)
    assert tuple(out.feat.shape) == (rows, 40) and out.z.shape == (40,)
    assert out.visible.dtype == torch.bool
    mode, n_sh, want_rows = og._epilogue(params, n_sh_band, use_sh_precompute)
    assert want_rows == rows and n_sh == (n_sh_band + 1) ** 2
    assert mode == (og.MODE_SH if out.per_pixel_sh else og.MODE_DC)
    rows_in = dict(params, opacity=params["opacity"][:, 0])
    assert og._epilogue(rows_in, 0, use_sh_precompute) == (og.MODE_ROWS, 1, 9)


def test_uv_offset_gradient_is_the_u_v_rows_gradient():
    """uv_offset's gradient is the feature rows' u and v gradients, and the
    offset moves u and v and nothing else."""
    params, alive = _params(120, 4, edge=False)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    uv = (0.5 * torch.randn(2, 120, generator=torch.Generator().manual_seed(3))
          ).requires_grad_(True)
    out = og.splat_rows(params, alive, _pose(), _camera(), **CULL, n_sh_band=3,
                        uv_offset=uv)
    base = og.splat_rows(params, alive, _pose(), _camera(), **CULL, n_sh_band=3)
    assert torch.equal(out.feat[2:], base.feat[2:])
    assert torch.equal(out.feat[0], base.feat[0] + uv[0])
    cot = torch.randn(9, 120, generator=torch.Generator().manual_seed(5))
    (g_uv,) = torch.autograd.grad(out.feat, [uv], cot)
    assert torch.equal(g_uv, cot[0:2])


def test_cpu_dispatch_launches_nothing_and_the_kernels_refuse_cpu_tensors():
    """A CPU input takes the plain version and launches nothing; the
    kernels' wrappers refuse it rather than falling back."""
    params, alive = _params(30, 5, edge=False)
    before = dict(telemetry.LAUNCHES)
    og.splat_rows(params, alive, _pose(), _camera(), **CULL, n_sh_band=3)
    assert dict(telemetry.LAUNCHES) == before
    assert "geometry_fwd" not in before and "geometry_bwd" not in before
    with pytest.raises(ValueError, match="CUDA"):
        og.splat_rows_fwd_cuda(params, alive, _pose(), _camera(), **CULL, n_sh_band=3)
    with pytest.raises(ValueError, match="CUDA"):
        og.splat_rows_bwd_cuda(params, _pose(), _K(), torch.zeros(9, 30), n_sh_band=3)
    meta = {k: v.to("meta") for k, v in params.items()}
    with pytest.raises(ValueError, match="no kernel"):
        og.splat_rows(meta, alive.to("meta"), _pose().to("meta"),
                      Camera(_K().to("meta"), W, H), **CULL)


# a float64 model of the backward kernel's reverse pass, statement by
# statement as csrc/geometry.cu writes it (vectorised over the gaussians)

def _sh_basis_grad(d, gb, n_sh):
    x, y, z = d
    gx = torch.zeros_like(x)
    gy = torch.zeros_like(x)
    gz = torch.zeros_like(x)
    S1, S2, S3 = geo.SH_1, geo.SH_2, geo.SH_3
    if n_sh >= 4:
        gy = gy + S1[0] * gb[1]
        gz = gz + S1[1] * gb[2]
        gx = gx + S1[2] * gb[3]
    if n_sh >= 9:
        xx, yy, zz = x * x, y * y, z * z
        gx = gx + S2[0] * (gb[4] * y)
        gy = gy + gb[4] * (S2[0] * x)
        gy = gy + S2[1] * (gb[5] * z)
        gz = gz + gb[5] * (S2[1] * y)
        gzz = 3.0 * (S2[2] * gb[6])
        gx = gx + S2[3] * (gb[7] * z)
        gz = gz + gb[7] * (S2[3] * x)
        gxx = S2[4] * gb[8]
        gyy = -S2[4] * gb[8]
        if n_sh >= 16:
            a9 = S3[0] * y
            gy = gy + S3[0] * (gb[9] * (3.0 * xx - yy))
            gxx = gxx + 3.0 * (gb[9] * a9)
            gyy = gyy - gb[9] * a9
            a10 = S3[1] * x
            b10 = a10 * y
            g10 = gb[10] * z
            gz = gz + gb[10] * b10
            gy = gy + g10 * a10
            gx = gx + S3[1] * (g10 * y)
            gy = gy + S3[2] * (gb[11] * (5.0 * zz - 1.0))
            gzz = gzz + 5.0 * (gb[11] * (S3[2] * y))
            gz = gz + S3[3] * (gb[12] * (5.0 * zz - 3.0))
            gzz = gzz + 5.0 * (gb[12] * (S3[3] * z))
            gx = gx + S3[4] * (gb[13] * (5.0 * zz - 1.0))
            gzz = gzz + 5.0 * (gb[13] * (S3[4] * x))
            a14 = S3[5] * z
            gz = gz + S3[5] * (gb[14] * (xx - yy))
            gxx = gxx + gb[14] * a14
            gyy = gyy - gb[14] * a14
            a15 = S3[6] * x
            gx = gx + S3[6] * (gb[15] * (xx - 3.0 * yy))
            gxx = gxx + gb[15] * a15
            gyy = gyy - 3.0 * (gb[15] * a15)
        gx = gx + 2.0 * x * gxx
        gy = gy + 2.0 * y * gyy
        gz = gz + 2.0 * z * gzz
    return gx, gy, gz


def _kernel_model_grads(p, pose, K, gf, mode, n_sh):
    """The gradients the backward kernel writes, from the parameters ``p``
    (the kernels' inputs), the pose, K and the feature rows' gradient."""
    R, t = pose[:3, :3], pose[:3, 3]
    fx, cx, fy, cy = K[0, 0], K[0, 2], K[1, 1], K[1, 2]
    x0, x1, x2 = p["xyz"].T
    q = p["quaternion"].T
    sc = p["scale"].T
    zero = torch.zeros_like(x0)
    # forward, as geometry() forms it
    xc = R[0, 0] * x0 + R[0, 1] * x1 + R[0, 2] * x2 + t[0]
    yc = R[1, 0] * x0 + R[1, 1] * x1 + R[1, 2] * x2 + t[1]
    zc = R[2, 0] * x0 + R[2, 1] * x1 + R[2, 2] * x2 + t[2]
    okz = zc.abs() > 1e-12
    inv_z = torch.where(okz, 1.0 / torch.where(okz, zc, 1.0), zero)
    sumsq = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]
    okq = sumsq > 1e-24
    qnorm = torch.sqrt(torch.where(okq, sumsq, 1.0))
    inv_norm = torch.where(okq, 1.0 / qnorm, zero)
    w = torch.where(okq, q[0] * inv_norm, 1.0)
    qx, qy, qz = q[1] * inv_norm, q[2] * inv_norm, q[3] * inv_norm
    r = [[1 - 2 * qy * qy - 2 * qz * qz, 2 * qx * qy - 2 * qz * w, 2 * qz * qx + 2 * w * qy],
         [2 * qx * qy + 2 * qz * w, 1 - 2 * qx * qx - 2 * qz * qz, 2 * qy * qz - 2 * w * qx],
         [2 * qz * qx - 2 * w * qy, 2 * qy * qz + 2 * w * qx, 1 - 2 * qx * qx - 2 * qy * qy]]
    s = [torch.exp(2.0 * sc[k]) for k in range(3)]
    pairs = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    sig = [sum(r[i][k] * r[j][k] * s[k] for k in range(3)) for i, j in pairs]
    S = [[sig[0], sig[1], sig[2]], [sig[1], sig[3], sig[4]], [sig[2], sig[4], sig[5]]]
    j00, j11 = fx * inv_z, fy * inv_z
    j02 = -fx * xc * inv_z * inv_z
    j12 = -fy * yc * inv_z * inv_z
    m = [[j00 * R[0, k] + j02 * R[2, k] for k in range(3)],
         [j11 * R[1, k] + j12 * R[2, k] for k in range(3)]]
    tt = [[sum(m[i][j] * S[j][k] for j in range(3)) for k in range(3)] for i in range(2)]
    out = {}
    gp = [zero, zero, zero]
    # colour
    rgb = p["rgb"].T
    if mode == og.MODE_ROWS:
        grgb = [gf[6 + k] for k in range(3)]
    elif mode == og.MODE_SH:
        grgb = [gf[6 + c * n_sh] for c in range(3)]
        gsh = torch.zeros_like(p["sh"])
        for c in range(3):
            for k in range(1, n_sh):
                gsh[:, c, k - 1] = gf[6 + c * n_sh + k]
        out["sh"] = gsh
    elif n_sh == 1:
        grgb = [gf[6 + k] * geo.SH_0 for k in range(3)]
    else:
        centre = [-(R[0, j] * t[0] + R[1, j] * t[1] + R[2, j] * t[2]) for j in range(3)]
        view = [p["xyz"][:, j] - centre[j] for j in range(3)]
        vs = view[0] * view[0] + view[1] * view[1] + view[2] * view[2]
        ok = vs > 1e-24
        norm = torch.sqrt(torch.where(ok, vs, 1.0))
        d = [torch.where(ok, view[j] / norm, zero) for j in range(3)]
        b = geo.sh_basis(torch.stack(d, 1), n_sh).T
        coeff = torch.cat([p["rgb"][:, :, None], p["sh"][:, :, :n_sh - 1]], 2)
        gsum = [gf[6 + c] * geo.SH_0 * geo.R_SH_0 for c in range(3)]
        gb = [sum(gsum[c] * coeff[:, c, k] for c in range(3)) for k in range(n_sh)]
        grgb = [gsum[c] * b[0] for c in range(3)]
        gsh = torch.zeros_like(p["sh"])
        for c in range(3):
            for k in range(1, n_sh):
                gsh[:, c, k - 1] = gsum[c] * b[k]
        out["sh"] = gsh
        gd = _sh_basis_grad(d, gb, n_sh)
        gnorm = -sum(gd[j] * view[j] / (norm * norm) for j in range(3))
        gsumsq = gnorm / (2.0 * norm)
        gp = [torch.where(ok, gd[j] / norm + 2.0 * view[j] * gsumsq, zero) for j in range(3)]
    out["rgb"] = torch.stack(grgb, 1)
    if mode == og.MODE_ROWS:
        out["opacity"] = gf[2]
    else:
        op = 1.0 / (1.0 + torch.exp(-p["opacity"][:, 0]))
        out["opacity"] = (gf[2] * (1.0 - op) * op)[:, None]
    # projection, conic, J W, J, inv_z
    gxc = gf[0] * inv_z * fx
    gyc = gf[1] * inv_z * fy
    ginv = gf[0] * (fx * xc) + gf[1] * (fy * yc)
    gc0, gc1, gc2 = gf[3], gf[4] * 0.5, gf[5]
    gt = [[gc0 * m[0][k] + gc1 * m[1][k] for k in range(3)],
          [gc1 * m[0][k] + gc2 * m[1][k] for k in range(3)]]
    gm = [[gc0 * tt[0][k] + gc1 * tt[1][k] for k in range(3)],
          [gc1 * tt[0][k] + gc2 * tt[1][k] for k in range(3)]]
    gS = [[gt[0][k] * m[0][j] + gt[1][k] * m[1][j] for k in range(3)] for j in range(3)]
    gm = [[gm[i][j] + (gt[i][0] * S[j][0] + gt[i][1] * S[j][1] + gt[i][2] * S[j][2])
           for j in range(3)] for i in range(2)]
    gxx, gxy, gxz = gS[0][0], gS[0][1] + gS[1][0], gS[0][2] + gS[2][0]
    gyy, gyz, gzz = gS[1][1], gS[1][2] + gS[2][1], gS[2][2]
    gj00 = sum(gm[0][k] * R[0, k] for k in range(3))
    gj02 = sum(gm[0][k] * R[2, k] for k in range(3))
    gj11 = sum(gm[1][k] * R[1, k] for k in range(3))
    gj12 = sum(gm[1][k] * R[2, k] for k in range(3))
    ginv = ginv + gj00 * fx + gj11 * fy
    A, B, gB = -fx * xc, -fx * xc * inv_z, gj02 * inv_z
    ginv = ginv + gj02 * B + gB * A
    gxc = gxc + gB * inv_z * (-fx)
    A, B, gB = -fy * yc, -fy * yc * inv_z, gj12 * inv_z
    ginv = ginv + gj12 * B + gB * A
    gyc = gyc + gB * inv_z * (-fy)
    gzc = torch.where(okz, -ginv * ((1.0 / zc) / zc), zero)
    out["xyz"] = torch.stack([gp[j] + (R[0, j] * gxc + R[1, j] * gyc + R[2, j] * gzc)
                              for j in range(3)], 1)
    gr = [[None] * 3 for _ in range(3)]
    gsc = []
    for k in range(3):
        r0, r1, r2, sk = r[0][k], r[1][k], r[2][k], s[k]
        gs = (gxx * r0 * r0 + gxy * r0 * r1 + gxz * r0 * r2 + gyy * r1 * r1
              + gyz * r1 * r2 + gzz * r2 * r2)
        gr[0][k] = (2.0 * gxx * r0 + gxy * r1 + gxz * r2) * sk
        gr[1][k] = (gxy * r0 + 2.0 * gyy * r1 + gyz * r2) * sk
        gr[2][k] = (gxz * r0 + gyz * r1 + 2.0 * gzz * r2) * sk
        gsc.append(gs * sk * 2.0)
    out["scale"] = torch.stack(gsc, 1)
    gw = 2.0 * (-qz * gr[0][1] + qy * gr[0][2] + qz * gr[1][0] - qx * gr[1][2]
                - qy * gr[2][0] + qx * gr[2][1])
    gx = 2.0 * (qy * gr[0][1] + qz * gr[0][2] + qy * gr[1][0] - 2.0 * qx * gr[1][1]
                - w * gr[1][2] + qz * gr[2][0] + w * gr[2][1] - 2.0 * qx * gr[2][2])
    gy = 2.0 * (-2.0 * qy * gr[0][0] + qx * gr[0][1] + w * gr[0][2] + qx * gr[1][0]
                + qz * gr[1][2] - w * gr[2][0] + qz * gr[2][1] - 2.0 * qy * gr[2][2])
    gz = 2.0 * (-2.0 * qz * gr[0][0] - w * gr[0][1] + qx * gr[0][2] + w * gr[1][0]
                - 2.0 * qz * gr[1][1] + qy * gr[1][2] + qx * gr[2][0] + qy * gr[2][1])
    gq = [torch.where(okq, gw * inv_norm, zero), gx * inv_norm, gy * inv_norm, gz * inv_norm]
    ginv_norm = gw * q[0] + gx * q[1] + gy * q[2] + gz * q[3]
    gsumsq = torch.where(okq, -ginv_norm * ((1.0 / qnorm) / qnorm) / (2.0 * qnorm), zero)
    out["quaternion"] = torch.stack([gq[k] + 2.0 * q[k] * gsumsq for k in range(4)], 1)
    return out


def _close_per_leaf(got, want, rtol, name):
    """|got - want| <= rtol * max|want| over the finite entries, and the same
    entries non-finite."""
    assert got.shape == want.shape, name
    got, want = got.detach(), want.detach()
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin), name
    scale = want[fin].abs().max() if fin.any() else torch.tensor(0.0)
    err = (got[fin] - want[fin]).abs().max() if fin.any() else torch.tensor(0.0)
    assert float(err) <= rtol * float(scale) + 1e-300, (name, float(err), float(scale))


def _elem_ratio(got, want, floor):
    """The largest |got - want| / (|want| + floor * max|want|) over the finite
    entries: each entry against its own size, with a floor at ``floor`` of
    the largest for entries whose terms cancel."""
    got, want = got.detach().double(), want.detach().double()
    fin = torch.isfinite(want)
    if not fin.any():
        return 0.0
    w, g = want[fin], got[fin]
    den = w.abs() + floor * float(w.abs().max())
    return float(((g - w).abs() / den.clamp_min(1e-300)).max())


def _close_per_element(got, want, rtol, floor, name):
    """|got - want| <= rtol * (|want| + floor * max|want|) entry by entry."""
    ratio = _elem_ratio(got, want, floor)
    assert ratio <= rtol, (name, ratio)


@pytest.mark.parametrize("mode,n_sh_band", [
    ("dc", 0), ("dc", 1), ("dc", 2), ("dc", 3), ("sh", 1), ("sh", 2), ("sh", 3),
    ("rows", 0)])
def test_backward_kernel_model_matches_autograd(mode, n_sh_band):
    """The backward kernel's reverse pass, modelled in float64, against
    autograd of the plain chain in float64, on edge slots and a random
    cotangent: to 1e-10 of each leaf's largest gradient, the same slots
    non-finite, and zero in the inactive SH columns."""
    params, alive = _params(300, 11 + n_sh_band, dtype=torch.float64, edge=True)
    if mode == "rows":
        params = dict(xyz=params["xyz"], scale=params["scale"],
                      quaternion=params["quaternion"], rgb=params["rgb"],
                      opacity=torch.sigmoid(params["opacity"][:, 0]))
        alive = None
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    pose, cam = _pose(torch.float64), _camera(torch.float64)
    out = og.splat_rows_plain(params, alive, pose, cam, **CULL, n_sh_band=n_sh_band,
                              use_sh_precompute=mode != "sh")
    cot = torch.randn(out.feat.shape, generator=torch.Generator().manual_seed(9),
                      dtype=torch.float64)
    names = list(params)
    want = dict(zip(names, _grads(out.feat, [params[k] for k in names], cot)))
    kmode, n_sh, _ = og._epilogue(params, n_sh_band, mode != "sh")
    got = _kernel_model_grads({k: v.detach() for k, v in params.items()}, pose, cam.K,
                              cot, kmode, n_sh)
    for k in names:
        if k == "sh" and n_sh == 1:
            assert k not in got and not want[k].any()
            continue
        _close_per_leaf(got[k], want[k], 1e-10, k)
    if "sh" in got:
        assert not got["sh"][:, :, n_sh - 1:].any()
    assert not torch.isfinite(got["xyz"][2]).all()  # the NaN position


# on the card: both kernels against the plain version


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")


N_CARD = 1 << 16
# forward: rows 0-5, the depth and the visibility are the same float32
# operations in the same order as PyTorch's kernels run them, and match to
# a few ulp; the SH colour sums 16 products in another order than PyTorch's
# reduction.  Backward: the reverse pass regroups autograd's sums (the
# covariance and quaternion chains), so float32 rounding differs by a few
# ulp of each term: against the leaf's largest gradient the worst entry is
# 6.2e-7 on the card, and BWD_RTOL is some ten times that.  Entry by entry,
# against the entry's own size with a floor at BWD_FLOOR of the leaf's
# largest (an entry whose terms cancel keeps the rounding of its terms), the
# worst is 9.8e-5 (a quaternion's), and BWD_ELEM_RTOL, ten times that, holds
# every slot, the small gradients of edge and far slots included.
FWD_RTOL = 1e-6
COLOUR_RTOL = 1e-5
BWD_RTOL = 1e-5
BWD_FLOOR = 1e-3
BWD_ELEM_RTOL = 1e-3


def _card_case(card, n_sh_band, mode, edge=True):
    params, alive = _params(N_CARD, 20 + n_sh_band, edge=edge, device=card)
    if mode == "rows":
        params = dict(xyz=params["xyz"], scale=params["scale"],
                      quaternion=params["quaternion"], rgb=params["rgb"],
                      opacity=torch.sigmoid(params["opacity"][:, 0]))
        alive = None
    return params, alive, _pose().to(card), _camera(device=card)


@pytest.mark.card
@pytest.mark.parametrize("mode,n_sh_band", [
    ("dc", 0), ("dc", 1), ("dc", 3), ("sh", 1), ("sh", 2), ("sh", 3), ("rows", 0)])
def test_card_kernels_match_the_plain_version(card, mode, n_sh_band):
    params, alive, pose, cam = _card_case(card, n_sh_band, mode)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    uv = None if mode == "rows" else torch.zeros(2, N_CARD, device=card,
                                                 requires_grad=True)
    kw = dict(n_sh_band=n_sh_band, use_sh_precompute=mode != "sh", uv_offset=uv)
    telemetry.LAUNCHES.clear()
    got = og.splat_rows(params, alive, pose, cam, **CULL, **kw)
    want = og.splat_rows_plain(params, alive, pose, cam, **CULL, **kw)
    assert telemetry.LAUNCHES["geometry_fwd"] == 1
    assert torch.equal(got.visible, want.visible)
    _close_per_leaf(got.z, want.z, FWD_RTOL, "z")
    for r in range(got.feat.shape[0]):
        _close_per_leaf(got.feat[r], want.feat[r], FWD_RTOL if r < 6 else COLOUR_RTOL,
                        f"feat row {r}")
    cot = torch.randn(got.feat.shape, device=card,
                      generator=torch.Generator(card).manual_seed(4))
    leaves = list(params.values()) + ([uv] if uv is not None else [])
    for k, a, b in zip(list(params) + ["uv"], _grads(got.feat, leaves, cot),
                       _grads(want.feat, leaves, cot)):
        _close_per_leaf(a, b, BWD_RTOL, k)
        _close_per_element(a, b, BWD_ELEM_RTOL, BWD_FLOOR, k)
    assert telemetry.LAUNCHES["geometry_bwd"] == 1


@pytest.mark.card
def test_card_step_and_view_launch_the_pair_once_and_read_nothing_more(card):
    """One train_step launches the forward and the backward kernel once
    each, and a served view the forward once; each builds one layout
    through its count and fill kernels, which make the one host read, and
    the geometry none."""
    scene = GaussianScene.create(*(v.cpu() for k, v in _params(4096, 30, edge=False)[0]
                                   .items() if k != "sh"), capacity=4096, device=card)
    state = trainer.init_train_state(scene, SplatConfig())
    K, pose = _K().to(card), _pose().to(card)
    gt = torch.rand(H, W, 3, device=card)
    bg = torch.zeros(3, device=card)
    trainer.train_step(state, gt, K, pose, bg, config=SplatConfig(), camera_hw=(H, W),
                       n_sh_band=3)
    telemetry.LAUNCHES.clear()
    with telemetry.recording():
        trainer.train_step(state, gt, K, pose, bg, config=SplatConfig(), camera_hw=(H, W),
                           n_sh_band=3)
        torch.cuda.synchronize(card)
    counters = telemetry.window()["counters"]
    assert telemetry.LAUNCHES["geometry_fwd"] == 1 and telemetry.LAUNCHES["geometry_bwd"] == 1
    assert telemetry.LAUNCHES["layout_count"] == telemetry.LAUNCHES["layout_fill"] == 1
    assert {k: v for k, v in counters.items() if k.startswith("sync.")} == {
        "sync.layout.size": 1}
    telemetry.LAUNCHES.clear()
    with torch.no_grad():
        rasterize.rasterize(scene.params(), scene.alive, pose, Camera(K, W, H),
                            mh_dist=3.0, background_rgb=bg, n_sh_band=3, **CULL)
    assert telemetry.LAUNCHES["geometry_fwd"] == 1 and "geometry_bwd" not in telemetry.LAUNCHES
    assert telemetry.LAUNCHES["layout_count"] == telemetry.LAUNCHES["layout_fill"] == 1
