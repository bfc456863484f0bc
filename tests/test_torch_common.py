"""Shared definitions of the PyTorch port against the JAX package:
constants, the SplatConfig mirror, TileGrid, GaussianScene padding, and the
port's independence from jax."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gaussian_splatting_tpu import config as jcfg
from gaussian_splatting_tpu import geometry as jgeo
from gaussian_splatting_tpu import structs as jstructs
from gaussian_splatting_tpu.ops import common as jcc
from gaussian_splatting_torch import config as tcfg
from gaussian_splatting_torch import geometry as tgeo
from gaussian_splatting_torch import structs as tstructs
from gaussian_splatting_torch.ops import common as tcc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "name",
    ["ALPHA_SKIP", "T_EPS", "BG_T_EPS", "ALPHA_CLAMP", "PIXELS_PER_TILE",
     "FEAT_U", "FEAT_V", "FEAT_OPACITY", "FEAT_A", "FEAT_B", "FEAT_C",
     "FEAT_R", "FEAT_G", "FEAT_B_COL", "OUT_R", "OUT_G", "OUT_B", "OUT_T"],
)
def test_rasterizer_constants_equal(name):
    assert getattr(tcc, name) == getattr(jcc, name)


def test_struct_and_sh_constants_equal():
    assert tstructs.TILE_PX == jstructs.TILE_PX
    assert tstructs.MAX_SH_COEFFS == jstructs.MAX_SH_COEFFS
    for name in ("SH_0", "R_SH_0", "SH_1", "SH_2", "SH_3"):
        assert getattr(tgeo, name) == getattr(jgeo, name), name


def test_splat_config_mirrors_jax():
    """Same field names, in the same order, with the same defaults."""
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.SplatConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.SplatConfig)]
    assert tf == jf
    assert tcfg.SplatConfig().replace(mh_dist=2.0).mh_dist == 2.0


@pytest.mark.parametrize("hw", [(1080, 1920), (840, 1296), (96, 128), (1, 17)])
def test_tile_grid_equal(hw):
    jg, tg = jstructs.TileGrid(*hw), tstructs.TileGrid(*hw)
    for prop in ("image_height_padded", "image_width_padded", "y_tiles",
                 "x_tiles", "tile_count"):
        assert getattr(tg, prop) == getattr(jg, prop), prop


def test_scene_create_matches_jax():
    """Capacity padding, dead-slot identity quaternions, the SH layout and
    the alive mask equal the JAX scene's, slot for slot."""
    n, cap = 5, 9
    rng = np.random.default_rng(3)
    args = dict(
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        rgb=rng.uniform(size=(n, 3)).astype(np.float32),
        opacity=rng.normal(size=(n, 1)).astype(np.float32),
        scale=rng.normal(size=(n, 3)).astype(np.float32),
        quaternion=rng.normal(size=(n, 4)).astype(np.float32),
        sh=rng.normal(size=(n, 3, 8)).astype(np.float32),
    )
    js = jstructs.GaussianScene.create(**args, capacity=cap)
    ts = tstructs.GaussianScene.create(**args, capacity=cap, device="cpu")
    assert ts.capacity == js.capacity == cap
    assert ts.num_alive() == int(js.num_alive()) == n
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    for k, v in js.params().items():
        np.testing.assert_array_equal(
            getattr(ts, k).detach().numpy(), np.asarray(v), err_msg=k
        )
    assert isinstance(ts, torch.nn.Module)
    assert "alive" in dict(ts.named_buffers())


def test_port_never_imports_jax():
    """Every module of the port, render_torch, chip_smoke and bwd_bench
    import without pulling in jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import gaussian_splatting_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods + ['render_torch', 'chip_smoke', 'bwd_bench']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.startswith('gaussian_splatting_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 12  # every module was walked
