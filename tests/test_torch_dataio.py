"""The port's ``dataio`` against the JAX package's: COLMAP binaries in the
format of ``tests/test_colmap.py`` with PNG images, written here; the native
and numpy readers; the initialisation; the synthetic scene of ``train.py``;
and ``render_torch.py`` rendering a dataset's views."""

import os
import struct
import sys

import cv2
import numpy as np
import pytest
import torch

import render_torch
import train
from gaussian_splatting_torch.config import SplatConfig
from gaussian_splatting_torch.dataio import colmap as tcolmap
from gaussian_splatting_torch.dataio import dataset as tds
from gaussian_splatting_torch.dataio import native as tnative
from gaussian_splatting_torch.dataio.png import write_png
from gaussian_splatting_tpu.config import SplatConfig as JConfig
from gaussian_splatting_tpu.dataio import dataset as jds
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

DOWNSAMPLE = 2
W, H = 96, 64  # the downsampled images


def write_colmap(root, n_pts=120, n_imgs=5, seed=0):
    """A COLMAP reconstruction in the binary format (points with tracks,
    images with 2D points, one PINHOLE and one SIMPLE_PINHOLE camera) and
    its images_{DOWNSAMPLE}/ PNGs.  The cameras look down +z from near the
    origin at points 3-5 units ahead, so every view sees the points.
    Returns (xyz, rgb, qvec, tvec)."""
    rng = np.random.default_rng(seed)
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    xyz = rng.normal(0, 0.6, (n_pts, 3)) + [0.0, 0.0, 4.0]
    rgb = rng.integers(0, 256, (n_pts, 3), dtype=np.uint8)
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_pts))
        for i in range(n_pts):
            track_len = int(rng.integers(0, 4))
            f.write(struct.pack("<q", i + 1))
            f.write(struct.pack("<3d", *xyz[i]))
            f.write(struct.pack("<3B", *rgb[i]))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", track_len))
            f.write(b"\0" * (8 * track_len))
    qvec = np.concatenate([np.ones((n_imgs, 1)), rng.normal(0, 0.05, (n_imgs, 3))], 1)
    qvec /= np.linalg.norm(qvec, axis=1, keepdims=True)
    tvec = rng.normal(0, 0.2, (n_imgs, 3))
    img_dir = os.path.join(root, f"images_{DOWNSAMPLE}")
    os.makedirs(img_dir)
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_imgs))
        for i in range(n_imgs):
            n2d = int(rng.integers(0, 3))
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<4d", *qvec[i]))
            f.write(struct.pack("<3d", *tvec[i]))
            f.write(struct.pack("<i", 1 + i % 2))
            f.write(f"frame_{i:04d}.png".encode() + b"\0")
            f.write(struct.pack("<Q", n2d))
            f.write(b"\0" * (24 * n2d))
            image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
            cv2.imwrite(os.path.join(img_dir, f"frame_{i:04d}.png"), image)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 1, 2 * W, 2 * H))
        f.write(struct.pack("<4d", 120.0, 118.0, 96.0, 64.0))
        f.write(struct.pack("<iiQQ", 2, 0, 2 * W, 2 * H))
        f.write(struct.pack("<3d", 110.0, 96.0, 64.0))
    return xyz, rgb, qvec, tvec


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("colmap"))
    return root, write_colmap(root)


def _numpy_reader(monkeypatch):
    monkeypatch.setattr(tnative, "_load", lambda: None)


def test_colmap_dataset_matches_jax(dataset_dir):
    root, (xyz, rgb, qvec, tvec) = dataset_dir
    got = tds.ColmapDataset(root, DOWNSAMPLE)
    want = jds.ColmapDataset(root, DOWNSAMPLE)
    np.testing.assert_array_equal(got.xyz, want.xyz)
    np.testing.assert_array_equal(got.rgb, want.rgb)
    np.testing.assert_allclose(got.xyz, xyz.astype(np.float32))
    assert got.cameras.keys() == want.cameras.keys() == {1, 2}
    for cid, cam in want.cameras.items():
        np.testing.assert_array_equal(got.cameras[cid].K, cam.K)
        assert (got.cameras[cid].width, got.cameras[cid].height) == (cam.width, cam.height) == (W, H)
    assert len(got.images) == len(want.images) == 5
    for a, b in zip(got.images, want.images):
        assert (a.path, a.camera_id) == (b.path, b.camera_id)
        np.testing.assert_array_equal(a.camera_T_world, b.camera_T_world)
    data, jdata = got.scene_data(), want.scene_data()
    for i in range(len(got.images)):
        img = data.load_image(i)
        assert img.dtype == np.uint8 and img.shape == (H, W, 3)
        np.testing.assert_array_equal(img, jdata.load_image(i))


def test_native_and_numpy_readers_agree(dataset_dir, monkeypatch):
    root, (xyz, rgb, qvec, tvec) = dataset_dir
    sparse = os.path.join(root, "sparse", "0")

    def read_all():
        pts = tcolmap.read_points3d_bin(os.path.join(sparse, "points3D.bin"))
        imgs = tcolmap.read_images_bin(os.path.join(sparse, "images.bin"))
        cams = tcolmap.read_cameras_bin(os.path.join(sparse, "cameras.bin"))
        return pts, imgs, cams

    (n_xyz, n_rgb), n_imgs, n_cams = read_all()
    assert tcolmap.last_reader == "native"
    assert tnative.library_path().is_file()
    assert tnative.library_path().parent.name == "_build_cache"
    _numpy_reader(monkeypatch)
    (p_xyz, p_rgb), p_imgs, p_cams = read_all()
    assert tcolmap.last_reader == "numpy"
    np.testing.assert_array_equal(n_xyz, p_xyz)
    np.testing.assert_array_equal(n_rgb, p_rgb)
    np.testing.assert_array_equal(p_xyz, xyz)
    np.testing.assert_array_equal(p_rgb, rgb)
    assert n_imgs.keys() == p_imgs.keys()
    for k in p_imgs:
        a, b = n_imgs[k], p_imgs[k]
        assert (a.image_id, a.camera_id, a.name) == (b.image_id, b.camera_id, b.name)
        np.testing.assert_array_equal(a.qvec, b.qvec)
        np.testing.assert_array_equal(a.tvec, b.tvec)
    np.testing.assert_array_equal(p_imgs[3].qvec, qvec[2])
    assert n_cams.keys() == p_cams.keys()
    for k in p_cams:
        a, b = n_cams[k], p_cams[k]
        assert (a.model, a.width, a.height) == (b.model, b.width, b.height)
        np.testing.assert_array_equal(a.params, b.params)


def test_image_decoders(dataset_dir, tmp_path, monkeypatch):
    """A PNG decodes as OpenCV does with cv2 missing, and with Pillow
    missing too, through the port's read_png; with neither, a format the
    port does not decode itself raises an ImportError that names both
    packages and the formats the port decodes."""
    root, _ = dataset_dir
    path = os.path.join(root, f"images_{DOWNSAMPLE}", "frame_0001.png")
    want = tds.read_rgb(path)
    bmp = str(tmp_path / "frame.bmp")
    cv2.imwrite(bmp, cv2.cvtColor(want, cv2.COLOR_RGB2BGR))
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(tds.read_rgb(path), want)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(tds.read_rgb(path), want)
    assert tds.last_decoder == "png"
    with pytest.raises(ImportError, match="OpenCV.*Pillow.*PNG and baseline JPEG") as e:
        tds.read_rgb(bmp)
    assert bmp in str(e.value)
    # the synthetic scene needs no decoder
    assert tds.make_synthetic_scene_data(50, 4).xyz.shape == (50, 3)


def test_initialisation_matches_jax():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    jcfg, cfg = JConfig(), SplatConfig()
    for k in (2, 3, 5):
        np.testing.assert_array_equal(tds.knn_mean_distance(pts, k),
                                      jds.knn_mean_distance(pts, k))
    np.testing.assert_array_equal(tds.initial_scale(pts, cfg), jds.initial_scale(pts, jcfg))
    data = tds.SceneData(xyz=pts, rgb=rng.normal(size=(200, 3)).astype(np.float32),
                         images=[], cameras={})
    jdata = jds.SceneData(xyz=data.xyz, rgb=data.rgb, images=[], cameras={})
    got = tds.create_scene(data, cfg, 256, "cpu")
    want = jds.create_scene(jdata, jcfg, 256)
    assert got.capacity == want.capacity == 256
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    for k, v in want.params().items():
        np.testing.assert_array_equal(getattr(got, k).detach().numpy(), np.asarray(v),
                                      err_msg=k)


@pytest.mark.parametrize("args", [(200, 8, 0, 96, 64), (1000, 48, 3, 640, 480)])
def test_synthetic_scene_matches_train_py(args):
    n, m, seed, w, h = args
    got = tds.make_synthetic_scene_data(n, m, seed, w, h)
    want = train.make_synthetic_scene_data(n, m, seed, w, h)
    np.testing.assert_array_equal(got.xyz, want.xyz)
    np.testing.assert_array_equal(got.rgb, want.rgb)
    assert got.rgb.dtype == want.rgb.dtype and got.xyz.dtype == want.xyz.dtype
    assert got.cameras.keys() == want.cameras.keys()
    for cid, cam in want.cameras.items():
        np.testing.assert_array_equal(got.cameras[cid].K, cam.K)
        assert (got.cameras[cid].width, got.cameras[cid].height) == (cam.width, cam.height)
    for a, b in zip(got.images, want.images, strict=True):
        assert (a.path, a.camera_id) == (b.path, b.camera_id)
        np.testing.assert_array_equal(a.camera_T_world, b.camera_T_world)


def test_png_writer_reads_back(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (7, 5, 3), dtype=np.uint8)
    grey = rng.integers(0, 256, (4, 9), dtype=np.uint8)
    write_png(str(tmp_path / "c.png"), img)
    write_png(str(tmp_path / "g.png"), grey)
    np.testing.assert_array_equal(tds.read_rgb(str(tmp_path / "c.png")), img)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_UNCHANGED), grey)


def test_render_torch_renders_dataset_views(dataset_dir, tmp_path):
    """render_torch.render_views on the CPU renders every view of the
    dataset from a scene of its points, at each view's camera."""
    from gaussian_splatting_torch import checkpoint as tckpt

    root, _ = dataset_dir
    data = tds.ColmapDataset(root, DOWNSAMPLE).scene_data()
    scene = tds.create_scene(data, SplatConfig(), len(data.xyz), "cpu")
    with torch.no_grad():
        scene.opacity.fill_(2.0)
    ply = str(tmp_path / "scene.ply")
    tckpt.export_ply(ply, scene)
    out = tmp_path / "renders"
    views = render_torch.render_views(ply, out=str(out), dataset_path=root,
                                      downsample_factor=DOWNSAMPLE, sh_band=0,
                                      depth=True, device="cpu")
    assert [v["name"] for v in views] == [f"view_{j:03d}" for j in range(5)]
    assert len(os.listdir(out)) == 10
    for v in views:
        assert tuple(v["image"].shape) == (H, W, 3)
        assert v["num_splats"] > 0 and float(v["image"].mean()) > 0.01
        assert bool((v["depth"] > 0).any())
    assert tds.read_rgb(str(out / "view_000.png")).shape == (H, W, 3)
