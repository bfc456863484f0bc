"""Kernel B1's plain PyTorch version (the DC forward rasterizer) against
the JAX rasterizer run in Pallas interpret mode, against the port's float64
compositing oracle, and at the reference golden pixels."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussian_splatting_tpu import culling as jcu
from gaussian_splatting_tpu import geometry as jgeo
from gaussian_splatting_tpu.ops import render as jrender
from gaussian_splatting_tpu.structs import TileGrid as JGrid
from gaussian_splatting_torch.culling import build_layout
from gaussian_splatting_torch.ops import common as cc
from gaussian_splatting_torch.ops import reference_impl as ref
from gaussian_splatting_torch.ops import render as trender
from gaussian_splatting_torch.ops import render_sh as trsh
from gaussian_splatting_torch.rasterize import rasterize
from gaussian_splatting_torch.structs import Camera, GaussianScene, TileGrid
from tests import fixtures as fx
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

# JAX composites with exp(sum log1p(-alpha)) prefix products, the port with
# sequential products: on these inputs the two differ by float32 rounding,
# under 1e-6.  (A pixel whose T sat within rounding of T_EPS could take one
# more splat in one of them, a difference of up to T_EPS times its colour;
# these inputs have none.)
JAX_IMG_TOL = 1e-5
JAX_T_TOL = 1e-5
# against the float64 oracle the port differs only by float32 rounding
ORACLE_TOL = 1e-5


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax_render(uv, conic, z, feat_g, grid, cap):
    """The JAX layout + Pallas forward (interpret mode, f32) on per-gaussian
    features (9, N); returns (image tiles, T, overflow)."""
    layout, feat = jcu.layout_with_features(
        uv, conic, z, jnp.ones_like(z, bool), feat_g, grid, 3.0, cap, 256
    )
    meta = jrender.build_step_meta(layout, grid.tile_count, 256)
    img, T = jrender.render_tiles(
        jrender.pad_feature_rows(feat), meta, jnp.zeros(3, jnp.float32),
        layout.tile_has_output, n_tiles=grid.tile_count, x_tiles=grid.x_tiles,
        chunk=256, interpret=True, precision="f32",
    )
    return img, T, layout.overflow


def _fixture_rows():
    """Per-gaussian rows of the 6-gaussian fixture's view (visible ones)."""
    scene = fx.test_scene(opacity_presigmoid=True)
    cam, pose = fx.test_camera(), fx.test_camera_T_world()
    xc, yc, zc = jgeo.transform_rows(*scene.xyz.T, pose)
    u, v = jgeo.project_rows(xc, yc, zc, cam.K)
    sig = jgeo.sigma_world_rows(scene.quaternion, scene.scale)
    conic = jgeo.conic_rows(sig, xc, yc, zc, cam.K, pose)
    op = jax.nn.sigmoid(scene.opacity[:, 0])
    rgb = scene.rgb * jgeo.SH_0
    keep = np.asarray(zc) > 0.3
    rows = [u, v, op, *conic, rgb[:, 0], rgb[:, 1], rgb[:, 2], zc]
    rows = [np.asarray(r, np.float32)[keep] for r in rows]
    return rows, TileGrid(480, 640)


def _seeded_rows(n=300, width=128, height=96, seed=11):
    """Random splats; depths spaced 0.01 apart so both layouts agree on the
    order (the JAX key quantises depth)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-8, width + 8, n)
    v = rng.uniform(-8, height + 8, n)
    sx, sy = rng.uniform(0.7, 8.0, n), rng.uniform(0.7, 8.0, n)
    rho = rng.uniform(-0.9, 0.9, n)
    op = rng.uniform(0.02, 1.0, n)
    rgb = rng.uniform(0.0, 1.2, (3, n))
    z = 2.0 + 0.01 * rng.permutation(n)
    rows = [u, v, op, sx * sx, 2 * rho * sx * sy, sy * sy, *rgb, z]
    return [r.astype(np.float32) for r in rows], TileGrid(height, width)


def _port(rows, grid):
    """The port's layout and plain B1 on the same rows."""
    u, v, op, c0, c1, c2, r, g, b, z = [torch.tensor(x) for x in rows]
    layout = build_layout(u, v, (c0, c1, c2), z, torch.ones_like(z, dtype=torch.bool),
                          grid, 3.0, opacity=op)
    feat = trender.splat_feature_rows(u, v, op, c0, c1, c2, r, g, b)
    img, T = trender.render_tiles(feat, layout, torch.zeros(3), grid.x_tiles)
    return img, T, layout, feat


@pytest.mark.parametrize("case", ["fixture", "seeded"])
def test_plain_b1_matches_jax_render_tiles(case):
    rows, grid = _fixture_rows() if case == "fixture" else _seeded_rows()
    img, T, layout, _ = _port(rows, grid)
    u, v, op, c0, c1, c2, r, g, b, z = [jnp.asarray(x) for x in rows]
    feat_g = jnp.stack([u, v, op, c0 + 0.25, c1 * 0.5, c2 + 0.25, r, g, b])
    jimg, jT, overflow = _jax_render(
        (u, v), (c0, c1, c2), z, feat_g,
        JGrid(grid.image_height, grid.image_width), 1 << 13,
    )
    assert not bool(overflow)
    jimg, jT = np.asarray(jimg), np.asarray(jT)
    np.testing.assert_allclose(img.numpy(), jimg, atol=JAX_IMG_TOL, rtol=0)
    live = (jT >= cc.T_EPS) & (T.numpy() >= cc.T_EPS)
    np.testing.assert_allclose(T.numpy()[live], jT[live], atol=JAX_T_TOL, rtol=0)
    assert layout.num_splats > 0 and float(img.max()) > 0.1


@pytest.mark.parametrize("case", ["fixture", "seeded"])
def test_plain_b1_matches_f64_oracle(case):
    """composite_dense (float64, one splat at a time) on the port's own
    layout agrees with the chunked float32 plain version."""
    rows, grid = _fixture_rows() if case == "fixture" else _seeded_rows()
    img, T, layout, feat = _port(rows, grid)
    counts = layout.tile_counts.long()
    L = int(counts.max())
    slot = torch.arange(L)
    valid = slot[None, :] < counts[:, None]
    idx = (layout.tile_starts[:-1, None].long() + slot).clamp_max(
        max(layout.num_splats - 1, 0))
    gid = layout.gaussian_idx[idx].long()
    dense = feat.double().T[gid]  # (n_tiles, L, 9)
    oimg, oT = ref.composite_dense(dense, valid, grid.x_tiles)
    oimg = ref.apply_background(oimg, oT, torch.zeros(3, dtype=torch.float64))
    np.testing.assert_allclose(img.numpy(), oimg.numpy(), atol=ORACLE_TOL, rtol=0)
    live = oT.numpy() >= cc.T_EPS
    np.testing.assert_allclose(T.numpy()[live], oT.numpy()[live], atol=ORACLE_TOL)
    # the dense oracle round-trips through the image layout
    full = ref.tiles_to_image(img, grid)
    assert tuple(full.shape) == (grid.image_height, grid.image_width, 3)
    np.testing.assert_array_equal(ref.image_to_tiles(full, grid).numpy(), img.numpy())


def _fixture_scene():
    s = fx.test_scene(opacity_presigmoid=True)
    scene = GaussianScene.create(
        *(np.asarray(getattr(s, k)) for k in
          ("xyz", "rgb", "opacity", "scale", "quaternion")), device="cpu")
    cam = Camera(torch.tensor(np.asarray(fx.test_camera().K)), 640, 480)
    return scene, cam, torch.tensor(np.asarray(fx.test_camera_T_world()))


def _render_fixture(background=None, **kw):
    scene, cam, pose = _fixture_scene()
    bg = torch.zeros(3) if background is None else background
    return rasterize(
        {k: v.detach() for k, v in scene.params().items()}, scene.alive, pose,
        cam, near_thresh=0.3, far_thresh=100.0, cull_mask_padding=10.0,
        mh_dist=3.0, background_rgb=bg, **kw,
    )


def test_golden_pixels():
    """The reference CUDA implementation's pixels (tests/test_render.py)."""
    res = _render_fixture()
    img = res.image.numpy()
    assert img.shape == (480, 640, 3)
    np.testing.assert_allclose(img[340, 348], [0.47698545455932617, 0.0, 0.0],
                               atol=1e-5)
    np.testing.assert_allclose(
        img[200, 348], [0.03330837935209274, 0.0, 0.267561137676239], atol=1e-5
    )
    np.testing.assert_array_equal(res.visible.numpy(),
                                  [False, False, False, True, True, True])
    assert res.num_splats == 641 and res.num_visible == 3 and res.truncated == 0


def test_background_blend():
    bg = torch.tensor([0.25, 0.5, 0.75])
    img = _render_fixture(background=bg).image.numpy()
    np.testing.assert_allclose(img[470, 10], [0.25, 0.5, 0.75], atol=1e-6)


def test_backward_is_refused():
    """The DC backward (B2) is refused only where it has no kernel: on the
    CPU a gradient request runs its plain version and gives finite
    gradients, nonzero only on the visible gaussians; on a device without
    a kernel it raises instead of returning zeros."""
    scene, cam, pose = _fixture_scene()
    res = rasterize(scene.params(), scene.alive, pose, cam, near_thresh=0.3,
                    far_thresh=100.0, cull_mask_padding=10.0, mh_dist=3.0,
                    background_rgb=torch.zeros(3))
    res.image.sum().backward()
    g = scene.rgb.grad
    assert bool(torch.isfinite(g).all())
    np.testing.assert_array_equal((g.abs().sum(1) > 0).numpy(), res.visible.numpy())
    feat = torch.zeros(cc.N_FEAT, 4, device="meta")
    idx = torch.zeros(2, dtype=torch.int32, device="meta")
    starts = torch.zeros(2, dtype=torch.int32, device="meta")
    raw = torch.zeros(4, cc.PIXELS_PER_TILE, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        trender.render_bwd(feat, idx, starts, 1, raw, raw)


def test_unported_paths_raise():
    """The per-pixel SH path, once refused, now renders (B3's plain version
    on the CPU); every rasterizer entry still raises on a device without a
    kernel instead of returning zeros."""
    res = _render_fixture(n_sh_band=2, use_sh_precompute=False)
    img = res.image.numpy()
    assert np.isfinite(img).all() and img.max() > 0.1 and res.num_splats == 641
    feat = torch.zeros(cc.N_FEAT, 4, device="meta")
    idx = torch.zeros(2, dtype=torch.int32, device="meta")
    starts = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        trender.render_fwd(feat, idx, starts, 1)
    sh_feat = torch.zeros(trsh.sh_feat_rows(4), 4, device="meta")
    basis = torch.zeros(4, cc.PIXELS_PER_TILE, device="meta")
    raw = torch.zeros(4, cc.PIXELS_PER_TILE, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        trsh.render_sh_fwd(sh_feat, basis, idx, starts, 1)
    with pytest.raises(ValueError, match="no kernel for device"):
        trsh.render_sh_bwd(sh_feat, basis, idx, starts, 1, raw, raw)


def _nc_feature_inputs(n=64, seed=21):
    """Seeded (N, C) per-gaussian arrays, float32, for the feature wrappers."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return dict(uv=f32(rng.uniform(-20, 700, (n, 2))),
                opacity=f32(rng.uniform(0, 1, (n, 1))),
                conic=f32(rng.uniform(-5, 50, (n, 3))),
                rgb=f32(rng.normal(size=(n, 3)))), rng


def test_splat_features_wrapper_matches_jax():
    """``ops.render.splat_features``, the (N, C) wrapper, equals JAX's
    bitwise: the same float32 additions and halvings."""
    a, _ = _nc_feature_inputs()
    got = trender.splat_features(*(torch.from_numpy(a[k]) for k in
                                   ("uv", "opacity", "conic", "rgb")))
    want = jrender.splat_features(*(jnp.asarray(a[k]) for k in
                                    ("uv", "opacity", "conic", "rgb")))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (cc.N_FEAT, 64)
