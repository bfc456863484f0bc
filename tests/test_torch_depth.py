"""Kernel B5's plain PyTorch version (the depth renderer) against the JAX
depth renderer run in Pallas interpret mode, and the reference goldens."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussian_splatting_tpu import culling as jcu
from gaussian_splatting_tpu.ops import depth as jdepth
from gaussian_splatting_tpu.ops import render as jrender
from gaussian_splatting_tpu.structs import TileGrid as JGrid
from gaussian_splatting_torch.culling import build_layout
from gaussian_splatting_torch.ops import depth as tdepth
from gaussian_splatting_torch.rasterize import render_depth
from tests.test_torch_render import _fixture_rows, _fixture_scene, _seeded_rows
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

# Both renderers return the distance feature of the crossing splat itself,
# so where they pick the same splat the values are equal.  The crossing test
# (1 - T) > threshold compares products formed in another order (JAX:
# exp(sum log1p(-alpha))), so a pixel whose 1 - T lands within float32
# rounding of the threshold could pick the next splat; these inputs have none.
DEPTH_TOL = 1e-6


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _jax_depth(uv, conic, z, feat_g, grid, cap, alpha_threshold):
    layout, feat = jcu.layout_with_features(
        uv, conic, z, jnp.ones_like(z, bool), feat_g, grid, 3.0, cap, 256
    )
    meta = jrender.build_step_meta(layout, grid.tile_count, 256)
    depth = jdepth.render_depth_tiles(
        jrender.pad_feature_rows(feat), meta, layout.tile_has_output,
        alpha_threshold, n_tiles=grid.tile_count, x_tiles=grid.x_tiles,
        chunk=256, interpret=True,
    )
    return depth, layout.overflow


@pytest.mark.parametrize("case,alpha_threshold", [("fixture", 0.2), ("seeded", 0.5)])
def test_plain_b5_matches_jax_depth(case, alpha_threshold):
    rows, grid = _fixture_rows() if case == "fixture" else _seeded_rows()
    u, v, op, c0, c1, c2, _, _, _, z = rows
    dist = np.float32(1.5) * z  # any per-gaussian value rides as the depth
    t = [torch.tensor(x) for x in (u, v, op, c0, c1, c2, z, dist)]
    layout = build_layout(t[0], t[1], tuple(t[3:6]), t[6],
                          torch.ones(len(u), dtype=torch.bool), grid, 3.0,
                          opacity=t[2])
    feat = tdepth.depth_feature_rows(*t[:6], t[7])
    depth = tdepth.render_depth_tiles(feat, layout, alpha_threshold,
                                      grid.x_tiles).numpy()
    j = [jnp.asarray(x) for x in (u, v, op, c0, c1, c2, z, dist)]
    feat_g = jnp.stack([j[0], j[1], j[2], j[3] + 0.25, j[4] * 0.5, j[5] + 0.25, j[7]])
    jdep, overflow = _jax_depth(
        (j[0], j[1]), tuple(j[3:6]), j[6], feat_g,
        JGrid(grid.image_height, grid.image_width), 1 << 13, alpha_threshold,
    )
    assert not bool(overflow)
    jdep = np.asarray(jdep)
    np.testing.assert_array_equal(depth < 0, jdep < 0)
    np.testing.assert_allclose(depth, jdep, atol=DEPTH_TOL, rtol=0)
    assert (depth > 0).any() and (depth == -1.0).any()


def test_depth_goldens_and_misses():
    """The reference's depth goldens (tests/test_depth.py) through the
    port's render_depth; pixels that never cross stay -1."""
    scene, cam, pose = _fixture_scene()
    d = render_depth(
        {k: v.detach() for k, v in scene.params().items()}, scene.alive, pose,
        cam, alpha_threshold=0.2, near_thresh=0.3, cull_mask_padding=10.0,
        mh_dist=3.0,
    ).numpy()
    assert d.shape == (480, 640, 1)
    np.testing.assert_allclose(d[340, 348, 0], 17.29551887512207, atol=1e-4)
    np.testing.assert_allclose(d[200, 348, 0], 13.205718040466309, atol=1e-4)
    assert d[0, 0, 0] == -1.0 and d[470, 10, 0] == -1.0
    assert (d[d != -1.0] > 0).all()


# jnp.linalg.norm against torch.linalg.norm: each may square, sum and take
# the root in its own order; held to 2 float32 ulps of the JAX value
DEPTH_ROW_ULPS = 2


def test_depth_features_wrapper_matches_jax():
    """``ops.depth.depth_features``, the (N, C) wrapper: rows 0-5 equal JAX's
    bitwise, the depth row |xyz_camera| within ``DEPTH_ROW_ULPS``."""
    rng = np.random.default_rng(23)
    n = 64
    a = dict(uv=rng.uniform(-20, 700, (n, 2)), opacity=rng.uniform(0, 1, (n, 1)),
             conic=rng.uniform(-5, 50, (n, 3)),
             xyz=np.concatenate([rng.uniform(-5, 5, (n, 2)),
                                 rng.uniform(0.2, 90, (n, 1))], axis=1))
    a = {k: v.astype(np.float32) for k, v in a.items()}
    names = ("uv", "opacity", "conic", "xyz")
    got = tdepth.depth_features(*(torch.from_numpy(a[k]) for k in names)).numpy()
    want = np.asarray(jdepth.depth_features(*(jnp.asarray(a[k]) for k in names)))
    assert got.shape == want.shape == (tdepth.N_DEPTH_FEAT, n)
    np.testing.assert_array_equal(got[:tdepth.FEAT_DEPTH], want[:tdepth.FEAT_DEPTH])
    d, dw = got[tdepth.FEAT_DEPTH], want[tdepth.FEAT_DEPTH]
    ulps = np.abs(d - dw) / np.spacing(dw)
    assert ulps.max() <= DEPTH_ROW_ULPS, ulps.max()
