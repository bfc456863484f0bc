"""Kernels B3 and B4's plain PyTorch versions (the per-pixel SH forward and
backward rasterizer) against the JAX per-pixel SH rasterizer run in Pallas
interpret mode, against float64 compositing (``composite_dense_sh``) and
its autograd, and the per-pixel basis against JAX's ``build_pixel_basis``.

Inputs: the 6-gaussian fixture seen by the 64x48 camera of the JAX
gradient tests, with the seeded SH coefficients of
``tests/test_render_sh_grads.py`` at n_sh 4, 9 and 16.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussian_splatting_tpu import culling as jcu
from gaussian_splatting_tpu import geometry as jgeo
from gaussian_splatting_tpu.ops import render as jrender
from gaussian_splatting_tpu.ops import render_sh as jrsh
from gaussian_splatting_tpu.structs import TileGrid as JGrid
from gaussian_splatting_torch import geometry as geo
from gaussian_splatting_torch.culling import build_layout
from gaussian_splatting_torch.ops import common as cc
from gaussian_splatting_torch.ops import reference_impl as ref
from gaussian_splatting_torch.ops import render_sh as trsh
from gaussian_splatting_torch.structs import TileGrid
from tests import fixtures as fx
from tests.test_render_grads import _small_camera
from tests.test_torch_render_bwd import _rel_err

# JAX composites with exp(sum log1p(-alpha)) prefix products and contracts
# the basis after summing coefficient * weight over splats; the port
# multiplies T and contracts per splat-pixel pair: float32 rounding apart
JAX_IMG_TOL = 1e-5
JAX_T_TOL = 1e-5
# gradients, relative to each row's max: the JAX suite's own bound for its
# pixel-moment reassociation of the geometry rows (test_render_sh_grads.py)
JAX_REL_TOL = 2e-4
# float32 plain versions against float64: rounding only
ORACLE_TOL = 1e-5
ORACLE_REL_TOL = 1e-5
BACKGROUND = np.array([0.3, 0.1, 0.6], np.float32)
CAP = 1 << 13


def _sh_rows(n_sh, opacity_cap=None):
    """Per-gaussian rows (u, v, opacity, conic c0, c1, c2; (N,) each), the
    coefficients (N, 3, n_sh) and depths of the fixture's gaussians in
    front of the small camera, with its K and pose."""
    scene = fx.test_scene(opacity_presigmoid=True)
    cam, pose = _small_camera(), fx.test_camera_T_world()
    xc, yc, zc = jgeo.transform_rows(*scene.xyz.T, pose)
    u, v = jgeo.project_rows(xc, yc, zc, cam.K)
    sig = jgeo.sigma_world_rows(scene.quaternion, scene.scale)
    conic = jgeo.conic_rows(sig, xc, yc, zc, cam.K, pose)
    op = np.asarray(jax.nn.sigmoid(scene.opacity[:, 0]))
    if opacity_cap is not None:
        op = np.minimum(op, opacity_cap)
    rng = np.random.default_rng(3)
    coeffs = rng.normal(size=(scene.capacity, 3, n_sh)) * 0.4
    coeffs[:, :, 0] = np.asarray(scene.rgb)
    keep = np.asarray(zc) > 0.3
    rows = [np.asarray(r, np.float32)[keep] for r in (u, v, op, *conic, zc)]
    return (rows, coeffs.astype(np.float32)[keep], np.asarray(cam.K),
            np.asarray(pose), TileGrid(cam.height, cam.width))


def _cotangent(n_tiles, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_tiles, cc.PIXELS_PER_TILE, 3)).astype(np.float32),
            rng.normal(size=(n_tiles, cc.PIXELS_PER_TILE)).astype(np.float32))


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax_sh(uv, conic, z, feat_g, grid, n_sh, K, pose, bg, g_img, g_t):
    """The JAX layout + Pallas per-pixel SH render (interpret mode): image,
    T and the VJP for the per-gaussian rows and the background."""
    basis = jrsh.build_pixel_basis(K, grid.image_width, grid.image_height, pose,
                                   n_sh, grid)
    feat_rows = jrsh._pad8(jrsh.sh_feat_rows(n_sh))

    def render(feat_g, bg):
        layout, feat = jcu.layout_with_features(
            uv, conic, z, jnp.ones_like(z, bool), feat_g, grid, 3.0, CAP, 256
        )
        meta = jrender.build_step_meta(layout, grid.tile_count, 256)
        return jrsh.render_tiles_sh(
            jrender.pad_feature_rows(feat, feat_rows), basis, meta, bg,
            layout.tile_has_output, n_sh=n_sh, n_tiles=grid.tile_count,
            x_tiles=grid.x_tiles, chunk=256, interpret=True,
        )

    (img, T), vjp = jax.vjp(render, feat_g, bg)
    return img, T, vjp((g_img, g_t))


def _port(rows, coeffs, K, pose, grid, bg, dtype=torch.float32):
    """The port's layout, pixel basis and plain B3 (B4 under autograd)."""
    u, v, op, c0, c1, c2, z = [torch.tensor(x) for x in rows]
    layout = build_layout(u, v, (c0, c1, c2), z, torch.ones_like(z, dtype=torch.bool),
                          grid, 3.0, opacity=op)
    feat = trsh.sh_splat_feature_rows(u, v, op, (c0, c1, c2), torch.tensor(coeffs))
    feat = feat.to(dtype).requires_grad_(True)
    basis = trsh.build_pixel_basis(torch.tensor(K), torch.tensor(pose),
                                   coeffs.shape[2], grid).to(dtype)
    bg_t = torch.tensor(bg, dtype=dtype, requires_grad=True)
    img, T = trsh.render_tiles_sh(feat, basis, layout, bg_t, grid.x_tiles)
    return img, T, layout, feat, basis, bg_t


@pytest.mark.parametrize("with_bg", [False, True])
@pytest.mark.parametrize("n_sh", [4, 9, 16])
def test_plain_b3_b4_match_jax(n_sh, with_bg):
    """Image and T through plain B3, and the gradients of every feature row
    (uv, opacity, conic, coefficients) and of the background through plain
    B4, against the JAX per-pixel SH rasterizer and its backward."""
    rows, coeffs, K, pose, grid = _sh_rows(n_sh)
    bg = BACKGROUND if with_bg else np.zeros(3, np.float32)
    g_img, g_t = _cotangent(grid.tile_count, seed=n_sh)
    img, T, layout, feat, _, bg_t = _port(rows, coeffs, K, pose, grid, bg)
    (img * torch.tensor(g_img)).sum().add((T * torch.tensor(g_t)).sum()).backward()

    u, v, op, c0, c1, c2, z = [jnp.asarray(x) for x in rows]
    feat_g = jrsh.sh_splat_feature_rows(u, v, op, (c0, c1, c2), jnp.asarray(coeffs))
    jimg, jT, (gfeat, gbg) = _jax_sh(
        (u, v), (c0, c1, c2), z, feat_g, JGrid(grid.image_height, grid.image_width),
        n_sh, jnp.asarray(K), jnp.asarray(pose), jnp.asarray(bg),
        jnp.asarray(g_img), jnp.asarray(g_t),
    )
    jimg, jT = np.asarray(jimg), np.asarray(jT)
    assert layout.num_splats > 0 and float(img.detach().abs().max()) > 0.1
    np.testing.assert_allclose(img.detach().numpy(), jimg, atol=JAX_IMG_TOL, rtol=0)
    live = (jT >= cc.T_EPS) & (T.detach().numpy() >= cc.T_EPS)
    np.testing.assert_allclose(T.detach().numpy()[live], jT[live], atol=JAX_T_TOL, rtol=0)

    want = np.asarray(gfeat)
    assert want.shape == tuple(feat.shape) and (np.abs(want).max(axis=1) > 0).all()
    err = _rel_err(feat.grad.numpy(), want)
    assert (err < JAX_REL_TOL).all(), err
    bg_err = _rel_err(bg_t.grad.numpy()[None], np.asarray(gbg)[None])
    assert (bg_err < JAX_REL_TOL).all(), bg_err


def _dense(layout, feat, basis, grid):
    """The port's layout as dense per-tile lists for composite_dense_sh."""
    counts = layout.tile_counts.long()
    slot = torch.arange(int(counts.max()))
    valid = slot[None, :] < counts[:, None]
    idx = (layout.tile_starts[:-1, None].long() + slot).clamp_max(layout.num_splats - 1)
    gid = layout.gaussian_idx[idx].long()
    n_sh = basis.shape[0]
    basis_tiles = basis.reshape(n_sh, grid.tile_count, cc.PIXELS_PER_TILE).permute(1, 2, 0)
    return feat.T[gid], valid, basis_tiles


@pytest.mark.parametrize("n_sh", [4, 9, 16])
def test_plain_b3_b4_match_f64_oracle(n_sh):
    """composite_dense_sh in float64 (one splat at a time) on the port's own
    layout and basis: the float32 plain B3 agrees to rounding, and where
    alpha < 0.9999 (opacity capped, so the backward's clamp never acts)
    plain B4 is the exact VJP that float64 autograd gives."""
    rows, coeffs, K, pose, grid = _sh_rows(n_sh, opacity_cap=0.99)
    g_img, g_t = _cotangent(grid.tile_count, seed=20 + n_sh)
    img, T, layout, feat, basis, bg_t = _port(rows, coeffs, K, pose, grid, BACKGROUND)
    (img * torch.tensor(g_img)).sum().add((T * torch.tensor(g_t)).sum()).backward()

    feat64 = feat.detach().double().requires_grad_(True)
    dense, valid, basis_tiles = _dense(layout, feat64, basis.double(), grid)
    oimg, oT = ref.composite_dense_sh(dense, valid, basis_tiles, grid.x_tiles)
    oimg = ref.apply_background(oimg, oT, torch.tensor(BACKGROUND, dtype=torch.float64))
    np.testing.assert_allclose(img.detach().numpy(), oimg.detach().numpy(),
                               atol=ORACLE_TOL, rtol=0)
    live = oT.detach().numpy() >= cc.T_EPS
    np.testing.assert_allclose(T.detach().numpy()[live], oT.detach().numpy()[live],
                               atol=ORACLE_TOL, rtol=0)
    (oimg * torch.tensor(g_img, dtype=torch.float64)).sum().add(
        (oT * torch.tensor(g_t, dtype=torch.float64)).sum()).backward()
    err = _rel_err(feat.grad.numpy(), feat64.grad.numpy())
    assert (err < ORACLE_REL_TOL).all(), err


@pytest.mark.parametrize("n_sh", [4, 9, 16])
def test_build_pixel_basis_matches_jax(n_sh):
    """(n_sh, n_tiles*256) tile-major basis against the JAX basis without its
    TPU padding (pad8 rows, one dummy tile), on a camera whose size is not
    a multiple of the tile; the world-frame rays agree as well."""
    K = np.array([[51.0, 0.0, 27.5], [0.0, 47.0, 20.0], [0.0, 0.0, 1.0]], np.float32)
    pose = np.asarray(fx.test_camera_T_world())
    grid = TileGrid(37, 53)
    jgrid = JGrid(37, 53)
    got = trsh.build_pixel_basis(torch.tensor(K), torch.tensor(pose), n_sh, grid)
    want = np.asarray(jrsh.build_pixel_basis(jnp.asarray(K), 53, 37, jnp.asarray(pose),
                                             n_sh, jgrid))
    assert tuple(got.shape) == (n_sh, grid.tile_count * cc.PIXELS_PER_TILE)
    np.testing.assert_allclose(got.numpy(), want[:n_sh, : got.shape[1]],
                               atol=2e-6, rtol=0)
    rays = geo.compute_rays_in_world_frame(torch.tensor(K), 64, 48, torch.tensor(pose))
    jrays = jgeo.compute_rays_in_world_frame(jnp.asarray(K), 64, 48, jnp.asarray(pose))
    np.testing.assert_allclose(rays.numpy(), np.asarray(jrays), atol=1e-6, rtol=0)


def test_sh_feature_rows_match_jax():
    """Rows u, v, opacity, a + 1/4, b / 2, c + 1/4 and then coefficient
    c * n_sh + k, the DC coefficient unscaled, as the JAX package packs them."""
    rows, coeffs, *_ = _sh_rows(9)
    u, v, op, c0, c1, c2, _ = rows
    got = trsh.sh_splat_feature_rows(*[torch.tensor(x) for x in (u, v, op)],
                                     tuple(torch.tensor(x) for x in (c0, c1, c2)),
                                     torch.tensor(coeffs))
    want = jrsh.sh_splat_feature_rows(u, v, op, (c0, c1, c2), jnp.asarray(coeffs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert trsh.sh_feat_rows(9) == jrsh.sh_feat_rows(9) == got.shape[0] == 33
    np.testing.assert_array_equal(got[6 + 9 * 2 + 4].numpy(), coeffs[:, 2, 4])


def test_render_sh_dispatch():
    """render_sh_fwd / render_sh_bwd run their plain versions on the CPU,
    refuse any device without a kernel and any n_sh the kernels were not
    built for; the CUDA wrappers refuse CPU tensors."""
    rows, coeffs, K, pose, grid = _sh_rows(4)
    _, _, layout, feat, basis, _ = _port(rows, coeffs, K, pose, grid, BACKGROUND)
    feat = feat.detach()
    fwd_args = (feat, basis, layout.gaussian_idx, layout.tile_starts, grid.x_tiles)
    raw = trsh.render_sh_fwd(*fwd_args)
    np.testing.assert_array_equal(raw.numpy(), trsh.render_sh_fwd_plain(*fwd_args).numpy())
    g_img, g_t = _cotangent(grid.tile_count, seed=1)
    cot = torch.tensor(np.concatenate([g_img.reshape(-1, 3).T, g_t.reshape(1, -1)]))
    bwd_args = fwd_args + (raw, cot)
    np.testing.assert_array_equal(trsh.render_sh_bwd(*bwd_args).numpy(),
                                  trsh.render_sh_bwd_plain(*bwd_args).numpy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        trsh.render_sh_fwd_cuda(*fwd_args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        trsh.render_sh_bwd_cuda(*bwd_args)
    meta = [t.to("meta") if isinstance(t, torch.Tensor) else t for t in bwd_args]
    with pytest.raises(ValueError, match="no kernel for device"):
        trsh.render_sh_fwd(*meta[:5])
    with pytest.raises(ValueError, match="no kernel for device"):
        trsh.render_sh_bwd(*meta)
    with pytest.raises(ValueError, match="n_sh must be one of"):
        trsh.render_sh_fwd(feat[:9], basis[:1], *fwd_args[2:])
