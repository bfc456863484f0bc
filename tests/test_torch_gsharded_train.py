"""Gaussian-sharded training: ``mp_train_step`` on two ranks spawned over
gloo on the CPU against the JAX package's ``mp_train_step`` on a 2-device
model mesh, on the DC path at SH band 3 (kernels B1/B2 on band grids) and
the per-pixel SH path at band 1 (B3/B4); the skip of a step whose gradient is not finite
in one shard only; and one rank against ``trainer.train_step``.

The scene is ``test_torch_gsharded.py``'s: the fixture's gaussians spread
over both shards, seeded SH, the 64x48 camera.  The ranks import this
module to find their function, so it imports no jax at the top.
"""

import numpy as np
import pytest
import torch

from gaussian_splatting_torch import convert, trainer
from gaussian_splatting_torch.config import SplatConfig
from gaussian_splatting_torch.convert import scene_from_numpy
from gaussian_splatting_torch.parallel import comm, gsharded
from gaussian_splatting_torch.rasterize import rasterize
from gaussian_splatting_torch.structs import Camera
from tests.test_torch_gsharded import leaves
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

D = 2
HW = (48, 64)
# (use_sh_precompute, SH band): JAX compiles its per-pixel step at band 3
# in ~35 s on the CPU, at band 1 in less; test_torch_gsharded.py renders
# bands 1-3
PATHS = {"dc": (True, 3), "per_pixel": (False, 1)}
NAN_SLOT = 12  # a dead slot of shard 1


def _inputs(seed=1):
    """The seeded scene, a uint8 target and three backgrounds."""
    from tests import fixtures as fx
    from tests.test_render_grads import _small_camera
    from tests.test_torch_gsharded import seeded_params

    params, alive = seeded_params()
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, 256, HW + (3,), dtype=np.uint8)
    bgs = rng.uniform(0, 1, (3, 3)).astype(np.float32)
    return params, alive, gt, np.asarray(_small_camera().K), np.asarray(
        fx.test_camera_T_world()), bgs


def _state(params, alive):
    return trainer.init_train_state(scene_from_numpy(params, alive, "cpu"), SplatConfig())


def _mp_rank(params, alive, gt, K, pose, bgs):
    """2 mp_train_steps on each path, the gathered state after each; then a
    step with a NaN in shard 1's dead slot NAN_SLOT."""
    torch.set_num_threads(1)
    mesh = comm.make_model_mesh(device_type="cpu")
    gt, K, pose = torch.tensor(gt), torch.tensor(K), torch.tensor(pose)
    out = {}
    for name, (pre, band) in PATHS.items():
        state = gsharded.shard_state(_state(params, alive), mesh.model_rank, mesh.mp)
        kw = dict(config=SplatConfig(use_sh_precompute=pre), camera_hw=HW,
                  n_sh_band=band, mesh=mesh)
        steps = []
        for bg in bgs[:2]:
            state, info = gsharded.mp_train_step(state, gt, K, pose, torch.tensor(bg), **kw)
            steps.append((convert.train_state_to_numpy(gsharded.gather_state(state, mesh)),
                          {k: float(v) for k, v in info.items()}))
        out[name] = steps
    p = {k: v.copy() for k, v in params.items()}
    p["xyz"][NAN_SLOT] = np.nan
    state = gsharded.shard_state(_state(p, alive), mesh.model_rank, mesh.mp)
    skipped, info = gsharded.mp_train_step(state, gt, K, pose, torch.tensor(bgs[0]),
                                           config=SplatConfig(), camera_hw=HW,
                                           n_sh_band=PATHS["dc"][1], mesh=mesh)
    out["nan"] = (float(info["loss"]), all(
        torch.equal(a, b) if not a.is_floating_point() else torch.allclose(
            a, b, rtol=0, atol=0, equal_nan=True)
        for a, b in zip(leaves(skipped), leaves(state))))
    return out


def _one_rank(params, alive, gt, K, pose, bgs):
    """mp_train_step on a model mesh of one rank and trainer.train_step,
    on both paths, from the same state; and the band render's image and
    rasterize's."""
    torch.set_num_threads(1)
    mesh = comm.make_model_mesh(device_type="cpu")
    gt, K, pose, bg = torch.tensor(gt), torch.tensor(K), torch.tensor(pose), torch.tensor(bgs[0])
    out = {}
    for name, (pre, band) in PATHS.items():
        kw = dict(config=SplatConfig(use_sh_precompute=pre), camera_hw=HW, n_sh_band=band)
        a, ainfo = gsharded.mp_train_step(_state(params, alive), gt, K, pose, bg, mesh=mesh, **kw)
        b, binfo = trainer.train_step(_state(params, alive), gt, K, pose, bg, **kw)
        state, cfg = _state(params, alive), kw["config"]
        band_img, _, _ = gsharded.mp_render(state.params, state.alive, pose, K, config=cfg,
                                            camera_hw=HW, n_sh_band=band, background_rgb=bg,
                                            mesh=mesh)
        res = rasterize(state.params, state.alive, pose, Camera(K=K, width=HW[1], height=HW[0]),
                        near_thresh=cfg.near_thresh, far_thresh=cfg.far_thresh,
                        cull_mask_padding=cfg.cull_mask_padding, mh_dist=cfg.mh_dist,
                        background_rgb=bg, n_sh_band=band, use_sh_precompute=pre)
        out[name] = ([x.numpy() for x in leaves(a)], [x.numpy() for x in leaves(b)],
                     {k: float(v) for k, v in ainfo.items()},
                     {k: float(v) for k, v in binfo.items()},
                     band_img.detach().numpy(), res.image.detach().numpy())
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(inputs):
    return comm.launch(_mp_rank, D, *inputs, device_type="cpu")


def _jax_steps(inputs, path, nan=False):
    import jax
    import jax.numpy as jnp

    from gaussian_splatting_tpu import trainer as jt
    from gaussian_splatting_tpu.config import SplatConfig as JConfig
    from gaussian_splatting_tpu.parallel import make_model_mesh, mp_train_step, shard_state
    from gaussian_splatting_tpu.structs import GaussianScene

    params, alive, gt, K, pose, bgs = inputs
    pre, band = PATHS[path]
    if nan:
        params = {k: v.copy() for k, v in params.items()}
        params["xyz"][NAN_SLOT] = np.nan
    cfg = JConfig(splat_capacity=1 << 12, chunk=32, kernel_precision="f32",
                  use_sh_precompute=pre)
    mesh = make_model_mesh(D)
    state = jt.init_train_state(GaussianScene(
        **{k: jnp.asarray(v) for k, v in params.items()}, alive=jnp.asarray(alive)), cfg)
    start = jax.tree_util.tree_map(np.asarray, state)
    out = []
    for bg in bgs[:1] if nan else bgs[:2]:
        state, info = mp_train_step(
            shard_state(state, mesh), jnp.asarray(gt), jnp.asarray(K), jnp.asarray(pose),
            jnp.asarray(bg), config=cfg, camera_hw=HW, n_sh_band=band, mesh=mesh)
        out.append((jax.tree_util.tree_map(np.asarray, state),
                    jax.tree_util.tree_map(np.asarray, info)))
    return start, out


@pytest.mark.parametrize("path", list(PATHS))
def test_mp_train_step_matches_jax(inputs, ranks, path):
    """Params, moments, accumulators and info after 1 and 2 steps, at the
    trainer test's tolerances; both ranks gather the same state."""
    from tests.test_torch_trainer import LOSS_RTOL, _assert_states_agree

    _, jsteps = _jax_steps(inputs, path)
    for (got, info), (want, jinfo), (got1, info1) in zip(
            ranks[0][path], jsteps, ranks[1][path]):
        _assert_states_agree(convert.train_state_from_numpy(got, "cpu"), want)
        np.testing.assert_allclose(info["loss"], jinfo["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(info["psnr"], jinfo["psnr"], rtol=LOSS_RTOL)
        assert info["num_visible"] == int(jinfo["num_visible"])
        assert info["n_alive"] == int(jinfo["n_alive"]) == 6
        assert info == info1
        for a, b in zip(convert.train_state_from_numpy(got, "cpu").params.values(),
                        convert.train_state_from_numpy(got1, "cpu").params.values()):
            assert torch.equal(a, b)
    assert int(jsteps[-1][0].grad_accum_count.max()) == 2
    if path == "per_pixel":
        assert np.abs(jsteps[-1][0].opt_state[0].mu["sh"]).max() > 0


def test_mp_step_skips_a_non_finite_shard(inputs, ranks):
    """A NaN at a dead slot of shard 1 leaves the loss finite and makes
    that shard's gradient NaN: the step is skipped on every rank.  JAX's
    mp_train_step takes the same global skip (its dp_mp_train_step skips
    per shard: test_torch_gsharded_dpmp.py)."""
    start, [(jskip, jinfo)] = _jax_steps(inputs, "dc", nan=True)
    assert np.isfinite(jinfo["loss"])
    import jax

    for a, b in zip(jax.tree_util.tree_leaves(jskip), jax.tree_util.tree_leaves(start)):
        np.testing.assert_array_equal(a, b)
    for r in ranks:
        loss, unchanged = r["nan"]
        assert np.isfinite(loss) and unchanged


def test_one_rank_equals_train_step(inputs):
    """On one rank the band is the image: mp_render gives rasterize's image,
    and mp_train_step trainer.train_step's state and info, bit for bit, on
    both paths."""
    [out] = comm.launch(_one_rank, 1, *inputs, device_type="cpu")
    for name in PATHS:
        a, b, ainfo, binfo, band_img, img = out[name]
        np.testing.assert_array_equal(band_img, img, err_msg=name)
        assert (img != img[:1, :1]).any(axis=-1).mean() > 0.1, name
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=name)
        assert ainfo == binfo
