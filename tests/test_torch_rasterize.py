"""The port's serving slice end to end against the JAX package: a
subsample of the trained reference scene through rasterize and
render_depth, scene files, weight conversion, and the render_torch CLI;
then the per-pixel SH path (use_sh_precompute=False) through rasterize:
its golden pixels, its equality with the DC path at zero higher bands,
and image and gradients against the JAX package at SH bands 1-3."""

import functools
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import render
import render_torch
from gaussian_splatting_tpu import checkpoint as jckpt
from gaussian_splatting_tpu import rasterize as jras
from gaussian_splatting_tpu.ops import common as jcc
from gaussian_splatting_tpu.structs import Camera as JCamera
from gaussian_splatting_torch import checkpoint as tckpt
from gaussian_splatting_torch import convert
from gaussian_splatting_torch.rasterize import rasterize, render_depth
from gaussian_splatting_torch.structs import Camera
from tests import fixtures as fx
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "runs", "refscale7k", "scene_final.ply")
W, H, FOCAL = 128, 96, 110.0  # render.py's 1296x840 view, scaled down ~10x
RENDER = dict(near_thresh=0.3, far_thresh=500.0, cull_mask_padding=100.0,
              mh_dist=3.0)
DEPTH = dict(near_thresh=0.3, cull_mask_padding=100.0, mh_dist=3.0)
ALPHA_THRESHOLD = 0.5
# float32 rounding of the geometry and of the two prefix-product forms (see
# tests/test_torch_render.py); measured below 1e-5 on this view
IMG_TOL = 2e-5
T_TOL = 2e-5


@pytest.fixture(scope="module")
def subsample():
    """Every 32nd gaussian of the trained garden scene (1,997 of 63,879)
    and the first of render.py's 4 orbit views."""
    scene = jckpt.import_ply(SCENE)
    params = {k: np.asarray(v)[::32] for k, v in scene.params().items()}
    alive = np.asarray(scene.alive)[::32]
    pose = render.orbit_poses(params["xyz"][alive], 4)[0]
    K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]], np.float32)
    return params, alive, pose, K


@jax.jit
def _jax_slice(params, alive, pose, K):
    cam = JCamera(K=K, width=W, height=H)
    res = jras.rasterize(
        params, alive, pose, cam, background_rgb=jnp.zeros(3, jnp.float32),
        n_sh_band=3, splat_capacity=1 << 14, chunk=256, interpret=True,
        kernel_precision="f32", **RENDER,
    )
    depth = jras.render_depth(
        params, alive, pose, cam, alpha_threshold=ALPHA_THRESHOLD,
        splat_capacity=1 << 14, chunk=256, interpret=True, **DEPTH,
    )
    return res, depth


def test_slice_matches_jax(subsample):
    params, alive, pose, K = subsample
    jres, jdepth = _jax_slice(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(alive),
        jnp.asarray(pose), jnp.asarray(K),
    )
    assert not bool(jres.overflow)
    scene = convert.scene_from_numpy(params, alive, "cpu")
    tparams = {k: v.detach() for k, v in scene.params().items()}
    cam = Camera(torch.tensor(K), W, H)
    tpose = torch.tensor(pose)
    res = rasterize(tparams, scene.alive, tpose, cam, n_sh_band=3,
                    background_rgb=torch.zeros(3), **RENDER)
    depth = render_depth(tparams, scene.alive, tpose, cam,
                         alpha_threshold=ALPHA_THRESHOLD, **DEPTH).numpy()

    assert res.num_splats == int(jres.num_splats) > 1000
    assert res.num_visible == int(jres.num_visible)
    assert res.truncated == int(jres.truncated)
    np.testing.assert_array_equal(res.visible.numpy(), np.asarray(jres.visible))
    np.testing.assert_allclose(res.uv.numpy(), np.asarray(jres.uv), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(res.image.numpy(), np.asarray(jres.image),
                               atol=IMG_TOL, rtol=0)
    T, jT = res.transmittance.numpy(), np.asarray(jres.transmittance)
    live = (T >= jcc.T_EPS) & (jT >= jcc.T_EPS)
    np.testing.assert_allclose(T[live], jT[live], atol=T_TOL, rtol=0)
    jdepth = np.asarray(jdepth)
    np.testing.assert_array_equal(depth < 0, jdepth < 0)
    np.testing.assert_allclose(depth, jdepth, rtol=1e-6, atol=1e-5)
    # a sparse 1-in-32 subsample: most pixels see some colour, ~12% a surface
    assert float(res.image.mean()) > 0.02 and (depth > 0).mean() > 0.05


def test_scene_files_match_jax(tmp_path):
    """import_ply reads the trained scene as the JAX package does; a JAX
    .npz checkpoint's params and alive mask load slot for slot; the numpy
    conversion round-trips."""
    jscene = jckpt.import_ply(SCENE)
    tscene = tckpt.import_ply(SCENE, device="cpu")
    jp = {k: np.asarray(v) for k, v in jscene.params().items()}
    tp, talive = convert.scene_to_numpy(tscene)
    assert tscene.capacity == 63879
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    np.testing.assert_array_equal(talive, np.asarray(jscene.alive))

    alive = np.ones(10, bool)
    alive[[2, 7]] = False
    ckpt = {f"param.{k}": v[:10] for k, v in jp.items()}
    ckpt.update(alive=alive, iteration=np.asarray(7), adam_count=np.asarray(7))
    np.savez(tmp_path / "ckpt.npz", **ckpt)
    loaded = tckpt.load_npz_scene(str(tmp_path / "ckpt.npz"), device="cpu")
    lp, lalive = convert.scene_to_numpy(loaded)
    np.testing.assert_array_equal(lalive, alive)
    for k in jp:
        np.testing.assert_array_equal(lp[k], jp[k][:10], err_msg=k)

    # export drops dead slots; the JAX importer reads the port's file
    n = tckpt.export_ply(str(tmp_path / "out.ply"), loaded)
    back = jckpt.import_ply(str(tmp_path / "out.ply"))
    assert n == 8
    for k in jp:
        np.testing.assert_array_equal(np.asarray(back.params()[k]),
                                      jp[k][:10][alive], err_msg=k)


def test_orbit_poses_copy_matches_render_py():
    rng = np.random.default_rng(4)
    xyz = rng.normal(size=(500, 3)).astype(np.float32) * [3.0, 1.0, 2.0]
    for n in (1, 4, 7):
        for a, b in zip(render_torch.orbit_poses(xyz, n), render.orbit_poses(xyz, n)):
            np.testing.assert_array_equal(a, b)


def _png_shape(path):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h, depth, colour = struct.unpack(">IIBB", data[16:26])
    # the image data inflates to one filter byte plus the pixels per row
    idat_len = struct.unpack(">I", data[33:37])[0]
    raw = zlib.decompress(data[41:41 + idat_len])
    channels = 3 if colour == 2 else 1
    assert depth == 8 and len(raw) == h * (1 + w * channels)
    return h, w, channels


def test_render_torch_cli(tmp_path):
    """render_torch.py on the CPU renders an exported fixture scene into
    orbit PNGs with nonzero splat counts, and a dataset path without a
    reconstruction fails naming the missing file."""
    s = fx.test_scene(opacity_presigmoid=True)
    scene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in s.params().items()}, np.asarray(s.alive), "cpu")
    ply = str(tmp_path / "scene.ply")
    assert tckpt.export_ply(ply, scene) == 6
    out = tmp_path / "renders"
    env = dict(os.environ, PYTHONPATH=ROOT)
    cmd = [sys.executable, os.path.join(ROOT, "render_torch.py"), ply,
           "--orbit", "2", "--width", "96", "--height", "64", "--focal", "60",
           "--sh_band", "0", "--depth", "--device", "cpu", "--out", str(out)]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(out)) == [
        "orbit_000.png", "orbit_000_depth.png", "orbit_001.png", "orbit_001_depth.png"]
    assert _png_shape(out / "orbit_000.png") == (64, 96, 3)
    assert _png_shape(out / "orbit_001_depth.png") == (64, 96, 1)
    counts = [int(ln.split(", ")[1].split()[0]) for ln in proc.stdout.splitlines()
              if "wrote orbit_" in ln]
    assert len(counts) == 2 and min(counts) > 0

    bad = subprocess.run(cmd[:3] + ["--dataset_path", "garden", "--device", "cpu"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert bad.returncode != 0 and "FileNotFoundError" in bad.stderr
    assert os.path.join("garden", "sparse", "0", "points3D.bin") in bad.stderr


# --- the per-pixel SH path (use_sh_precompute=False) -------------------------

SH_RENDER = dict(near_thresh=0.3, far_thresh=100.0, cull_mask_padding=10.0,
                 mh_dist=3.0)
# rasterize end to end at 64x48, relative to each leaf's largest gradient:
# the geometry chain's float32 rounding amplified by its Jacobians, and the
# JAX kernel's pixel-moment conic rows (tests/test_torch_render_bwd.py)
SH_RASTER_REL_TOL = 2e-4
SH_BG = np.array([0.2, 0.3, 0.4], np.float32)


def _fixture_sh(sh_value=None, seed=9):
    """The 6-gaussian fixture with opacity 0.9 and SH bands 1..3 either all
    ``sh_value`` or seeded."""
    s = fx.test_scene(opacity_presigmoid=True)
    p = {k: np.asarray(v).copy() for k, v in s.params().items()}
    if sh_value is None:
        p["opacity"][:] = np.log(0.9 / 0.1)
        p["sh"] = (0.3 * np.random.default_rng(seed).normal(size=p["sh"].shape)).astype(np.float32)
    else:
        p["sh"][:] = sh_value
    return p, np.asarray(s.alive)


def _port_fixture(params, alive, cam, grad=False, **kw):
    scene = convert.scene_from_numpy(params, alive, "cpu")
    tp = {k: v.detach().clone().requires_grad_(grad) for k, v in scene.params().items()}
    pose = torch.tensor(np.asarray(fx.test_camera_T_world()))
    return rasterize(tp, scene.alive, pose, cam, **SH_RENDER, **kw), tp


FX_CAM = Camera(torch.tensor(np.asarray(fx.test_camera().K)), 640, 480)


def test_per_pixel_sh_golden_pixels():
    """Every sh coefficient 0.1 at band 3 (tests/test_render.py: pinned by a
    float64 per-pixel compositing oracle)."""
    params, alive = _fixture_sh(0.1)
    res, _ = _port_fixture(params, alive, FX_CAM, n_sh_band=3, use_sh_precompute=False,
                           background_rgb=torch.zeros(3))
    img = res.image.numpy()
    np.testing.assert_allclose(img[340, 348], [0.63091441, 0.15392897, 0.15392897],
                               atol=1e-5)
    np.testing.assert_allclose(img[200, 348], [0.14358045, 0.11027012, 0.37783123],
                               atol=1e-5)


def test_per_pixel_sh_dc_only_matches_dc_path():
    """Zero higher bands through the per-pixel path equal the DC path: basis
    row 0 is the constant SH_0 that the DC path folds into colour."""
    params, alive = _fixture_sh(0.0)
    bg = torch.zeros(3)
    pp, _ = _port_fixture(params, alive, FX_CAM, n_sh_band=3, use_sh_precompute=False,
                          background_rgb=bg)
    dc, _ = _port_fixture(params, alive, FX_CAM, background_rgb=bg)
    np.testing.assert_allclose(pp.image.numpy(), dc.image.numpy(), atol=1e-6, rtol=0)
    assert float(dc.image.max()) > 0.1


def test_per_pixel_sh_grads_only_on_visible():
    """Gradients reach every leaf, sh included, through B4's plain version:
    finite, nonzero exactly on the visible gaussians (tests/test_render.py's
    check, on its 640x480 view)."""
    params, alive = _fixture_sh(0.1)
    res, tp = _port_fixture(params, alive, FX_CAM, grad=True, n_sh_band=3,
                            use_sh_precompute=False, background_rgb=torch.zeros(3))
    (res.image ** 2).sum().backward()
    vis = res.visible.numpy()
    assert vis.any() and not vis.all()
    for name, t in tp.items():
        g = t.grad.reshape(t.shape[0], -1).numpy()
        assert np.isfinite(g).all(), name
        np.testing.assert_array_equal(np.abs(g).sum(1) > 0, vis, err_msg=name)


@functools.partial(jax.jit, static_argnums=(6,))
def _jax_sh_raster(params, alive, pose, K, weights, bg, band):
    """jax.grad of the JAX rasterize's per-pixel SH path at 64x48 (Pallas in
    interpret mode, f32), for every param and uv_offset."""
    def loss(params, uv_offset):
        res = jras.rasterize(
            params, alive, pose, JCamera(K=K, width=64, height=48), background_rgb=bg,
            n_sh_band=band, use_sh_precompute=False, splat_capacity=1 << 14,
            chunk=256, uv_offset=uv_offset, interpret=True, kernel_precision="f32",
            **SH_RENDER,
        )
        return jnp.sum(res.image * weights), res.image

    return jax.grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.zeros((2, alive.shape[0]), jnp.float32))


@pytest.mark.parametrize("band", [1, 2, 3])
def test_per_pixel_sh_slice_matches_jax(band):
    """rasterize(..., use_sh_precompute=False) at SH band 1, 2, 3 on the
    fixture at 64x48 with a background: the image and d(sum(image * W)) /
    d(every param, uv_offset) against the JAX package.  In this path xyz
    gets its gradient only through u, v and the conic (the basis is
    constant), in both packages."""
    params, alive = _fixture_sh()
    K = np.asarray(fx.test_camera().K) * np.array([[0.1], [0.1], [1.0]], np.float32)
    pose = np.asarray(fx.test_camera_T_world())
    weights = np.random.default_rng(band).normal(size=(48, 64, 3)).astype(np.float32)
    (jg, juv), jimg = _jax_sh_raster(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(alive),
        jnp.asarray(pose), jnp.asarray(K), jnp.asarray(weights), jnp.asarray(SH_BG),
        band)
    scene = convert.scene_from_numpy(params, alive, "cpu")
    tp = {k: v.detach().clone().requires_grad_(True) for k, v in scene.params().items()}
    uv = torch.zeros(2, alive.shape[0], requires_grad=True)
    res = rasterize(tp, scene.alive, torch.tensor(pose), Camera(torch.tensor(K), 64, 48),
                    background_rgb=torch.tensor(SH_BG), n_sh_band=band,
                    use_sh_precompute=False, uv_offset=uv, **SH_RENDER)
    np.testing.assert_allclose(res.image.detach().numpy(), np.asarray(jimg), atol=2e-5,
                               rtol=0)
    (res.image * torch.tensor(weights)).sum().backward()
    leaves = {**{k: (tp[k].grad, jg[k]) for k in tp}, "uv_offset": (uv.grad, juv)}
    for k, (got, want) in leaves.items():
        want = np.asarray(want)
        n = (band + 1) ** 2 - 1
        if k == "sh" and n < want.shape[2]:  # bands above n_sh_band get none
            assert np.abs(got.numpy()[:, :, n:]).max() == 0 == np.abs(want[:, :, n:]).max()
            got, want = got[:, :, :n], want[:, :, :n]
        assert np.abs(want).max() > 0, k
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < SH_RASTER_REL_TOL, (k, err)
