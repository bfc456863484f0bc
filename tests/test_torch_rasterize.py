"""The port's serving slice end to end against the JAX package: a
subsample of the trained reference scene through rasterize and
render_depth, scene files, weight conversion, and the render_torch CLI."""

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
    orbit PNGs with nonzero splat counts, and refuses dataset views."""
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
    assert bad.returncode != 0 and "dataio" in bad.stderr
