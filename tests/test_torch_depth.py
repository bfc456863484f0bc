"""Kernel B5's plain PyTorch version (the depth renderer) against the JAX
depth renderer run in Pallas interpret mode, the reference goldens, and
``render_depth`` against the per-gaussian chain it ran before it went
through ``rasterize.kernel_inputs``: bit for bit on the CPU and, marked
``card``, on the card.

The JAX package is imported in a fixture, not at the top: the card tests
run on a machine without it, with ``python3 -m pytest --noconftest
tests/test_torch_depth.py -m card``."""

import os
import types

import numpy as np
import pytest
import torch

from gaussian_splatting_torch import geometry as geo
from gaussian_splatting_torch import rasterize as tras
from gaussian_splatting_torch.culling import build_layout, frustum_visible_rows
from gaussian_splatting_torch.ops import depth as tdepth
from gaussian_splatting_torch.ops.geometry import camera_rows
from gaussian_splatting_torch.ops.reference_impl import tiles_to_image
from gaussian_splatting_torch.rasterize import render_depth
from gaussian_splatting_torch.structs import Camera, TileGrid
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

# Both renderers return the distance feature of the crossing splat itself,
# so where they pick the same splat the values are equal.  The crossing test
# (1 - T) > threshold compares products formed in another order (JAX:
# exp(sum log1p(-alpha))), so a pixel whose 1 - T lands within float32
# rounding of the threshold could pick the next splat; these inputs have none.
DEPTH_TOL = 1e-6


@pytest.fixture(scope="module")
def jx():
    """The JAX depth renderer on a layout of per-gaussian rows (jitted),
    the JAX package's ``depth_features``, its TileGrid and jax.numpy."""
    import functools

    import jax
    import jax.numpy as jnp

    from gaussian_splatting_tpu import culling as jcu
    from gaussian_splatting_tpu.ops import depth as jdepth
    from gaussian_splatting_tpu.ops import render as jrender
    from gaussian_splatting_tpu.structs import TileGrid as JGrid

    @functools.partial(jax.jit, static_argnums=(4, 5, 6))
    def depth(uv, conic, z, feat_g, grid, cap, alpha_threshold):
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

    return types.SimpleNamespace(depth=depth, depth_features=jdepth.depth_features,
                                 JGrid=JGrid, jnp=jnp)


def _fixture_scene():
    from tests.test_torch_render import _fixture_scene

    return _fixture_scene()


@pytest.mark.parametrize("case,alpha_threshold", [("fixture", 0.2), ("seeded", 0.5)])
def test_plain_b5_matches_jax_depth(jx, case, alpha_threshold):
    from tests.test_torch_render import _fixture_rows, _seeded_rows

    jnp = jx.jnp
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
    jdep, overflow = jx.depth(
        (j[0], j[1]), tuple(j[3:6]), j[6], feat_g,
        jx.JGrid(grid.image_height, grid.image_width), 1 << 13, alpha_threshold,
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


def test_depth_features_wrapper_matches_jax(jx):
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
    want = np.asarray(jx.depth_features(*(jx.jnp.asarray(a[k]) for k in names)))
    assert got.shape == want.shape == (tdepth.N_DEPTH_FEAT, n)
    np.testing.assert_array_equal(got[:tdepth.FEAT_DEPTH], want[:tdepth.FEAT_DEPTH])
    d, dw = got[tdepth.FEAT_DEPTH], want[tdepth.FEAT_DEPTH]
    ulps = np.abs(d - dw) / np.spacing(dw)
    assert ulps.max() <= DEPTH_ROW_ULPS, ulps.max()


def _garden_view(device="cpu", every=32, width=128, height=96, focal=110.0):
    """Every ``every``-th gaussian of the trained garden scene and the first
    of render_torch's 4 orbit views (at 128x96, every 32nd: the slice of
    ``test_torch_rasterize.py``)."""
    import render_torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene = render_torch.load_scene(
        os.path.join(root, "runs", "refscale7k", "scene_final.ply"), device)
    params = {k: v.detach()[::every].contiguous() for k, v in scene.params().items()}
    alive = scene.alive[::every].contiguous()
    pose = render_torch.orbit_poses(params["xyz"][alive].cpu().numpy(), 4)[0]
    K = torch.tensor([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]])
    return (params, alive, torch.from_numpy(pose).to(device),
            Camera(K.to(device), width, height))


def _depth_before(params, alive, pose, cam, *, near_thresh, cull_mask_padding, mh_dist):
    """B5's feature rows and layout as ``render_depth`` formed them before
    it went through ``rasterize.kernel_inputs``: the plain chain, inlined."""
    xc, yc, zc, u, v, conic3, opacity_v = camera_rows(params, pose, cam)
    visible = frustum_visible_rows(u, v, zc, (cam.width, cam.height), near_thresh,
                                   float("inf"), cull_mask_padding) & alive
    feat = tdepth.depth_feature_rows(u, v, opacity_v, *conic3,
                                     geo.camera_distance_rows(xc, yc, zc))
    layout = build_layout(u, v, conic3, zc, visible, TileGrid(cam.height, cam.width),
                          mh_dist, opacity=opacity_v)
    return feat, layout


FIXTURE_DEPTH = dict(near_thresh=0.3, cull_mask_padding=10.0, mh_dist=3.0)
GARDEN_DEPTH = dict(near_thresh=0.3, cull_mask_padding=100.0, mh_dist=3.0)


def _assert_depth_is_the_chain(monkeypatch, params, alive, pose, cam, alpha_threshold, kw):
    """``render_depth`` hands B5 the chain's feature rows and layout and
    gives the chain's image, bit for bit."""
    seen = []

    def recorded(feat, layout, *args):
        seen.append((feat, layout))
        return tdepth.render_depth_tiles(feat, layout, *args)

    monkeypatch.setattr(tras, "render_depth_tiles", recorded)
    got = render_depth(params, alive, pose, cam, alpha_threshold=alpha_threshold, **kw)
    with torch.no_grad():
        feat, layout = _depth_before(params, alive, pose, cam, **kw)
    [(got_feat, got_layout)] = seen
    assert torch.equal(got_feat, feat)
    for a, b in zip(got_layout, layout):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    grid = TileGrid(cam.height, cam.width)
    want = tiles_to_image(
        tdepth.render_depth_tiles(feat, layout, alpha_threshold, grid.x_tiles)[..., None], grid)
    assert torch.equal(got, want)
    assert layout.num_splats > 0 and (want > 0).any()


@pytest.mark.parametrize("case", ["fixture", "garden"])
def test_render_depth_is_the_chain_bit_for_bit(case, monkeypatch):
    """On the CPU, on the fixture and on a slice of the garden scene."""
    if case == "fixture":
        scene, cam, pose = _fixture_scene()
        params = {k: v.detach() for k, v in scene.params().items()}
        _assert_depth_is_the_chain(monkeypatch, params, scene.alive, pose, cam, 0.2,
                                   FIXTURE_DEPTH)
    else:
        _assert_depth_is_the_chain(monkeypatch, *_garden_view(), 0.5, GARDEN_DEPTH)


# ---------------------------------------------------------------------------
# on the card: the geometry kernel's rows into B5 against the chain's
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    """The CUDA device, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")


@pytest.mark.card
@pytest.mark.parametrize("case", ["fixture", "garden"])
def test_card_render_depth_is_the_chain_bit_for_bit(card, case, monkeypatch):
    """On the card: the geometry kernel's rows 0-5, visibility and layout,
    and B5's image, equal to the chain's on the card, on the fixture and
    on the whole garden scene at 1296x840."""
    if case == "fixture":
        import chip_smoke

        scene, cam, pose = chip_smoke.fixture_scene(card)
        params = {k: v.detach() for k, v in scene.params().items()}
        _assert_depth_is_the_chain(monkeypatch, params, scene.alive, pose, cam, 0.2,
                                   FIXTURE_DEPTH)
    else:
        _assert_depth_is_the_chain(
            monkeypatch, *_garden_view(card, every=1, width=1296, height=840, focal=1100.0),
            0.5, GARDEN_DEPTH)
