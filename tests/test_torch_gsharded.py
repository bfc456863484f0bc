"""Gaussian-sharded rendering (``parallel/gsharded.py``): ``mp_render`` on
two ranks spawned over gloo on the CPU against the JAX package's
``mp_render`` on a 2-device model mesh, on the DC path and on the
per-pixel SH path at bands 1-3 (kernels B1 and B3 on the band grids), and
``shard_state`` / ``gather_state``.

The scene is the 6-gaussian fixture in 16 slots with seeded SH
coefficients, its gaussians spread over both shards (slots 0-2 and 8-10),
seen by the 64x48 camera, whose 3 tile rows split into bands of 2 (the
second band overhangs the image by 16 rows).  The ranks import this module
to find their function, so it imports no jax at the top.
"""

import numpy as np
import pytest
import torch

from gaussian_splatting_torch import trainer
from gaussian_splatting_torch.config import SplatConfig
from gaussian_splatting_torch.convert import scene_from_numpy
from gaussian_splatting_torch.parallel import comm, gsharded
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

D = 2
HW = (48, 64)
BANDS = [(0, True), (1, False), (2, False), (3, False)]  # (SH band, use_sh_precompute)
IMG_ATOL = 1e-5  # the eval test's image tolerance (test_torch_trainer.py)
# slot of each fixture gaussian: three in each shard
SLOTS = [0, 1, 2, 8, 9, 10]
BG = np.array([0.2, 0.5, 0.8], np.float32)


def spread_scene(params, alive, capacity=16):
    """The fixture's leaves with gaussian i moved to slot SLOTS[i]; the
    other slots dead, with the fixture's dead-slot values."""
    order = np.full(capacity, 6 + capacity)  # past the end: a dead slot's values
    order[SLOTS] = np.arange(6)
    dead = next(i for i in range(len(alive)) if not alive[i])
    order = np.where(order >= len(alive), dead, order)
    return {k: np.asarray(v)[order] for k, v in params.items()}, np.asarray(alive)[order]


def seeded_params(seed=3):
    """The fixture scene, its SH bands 1-3 seeded, spread over the shards."""
    from tests import fixtures as fx

    scene = fx.test_scene(opacity_presigmoid=True, capacity=16)
    params = {k: np.asarray(v) for k, v in scene.params().items()}
    rng = np.random.default_rng(seed)
    params["sh"] = (0.3 * rng.normal(size=params["sh"].shape)).astype(np.float32)
    return spread_scene(params, np.asarray(scene.alive))


def _render_rank(params, alive, K, pose):
    """mp_render at every (band, path) of BANDS on this rank; the state's
    shard round trip."""
    torch.set_num_threads(1)
    mesh = comm.make_model_mesh(device_type="cpu")
    scene = scene_from_numpy(params, alive, "cpu")
    state = trainer.init_train_state(scene, SplatConfig())
    shard = gsharded.shard_state(state, mesh.model_rank, mesh.mp)
    out = {"shard_alive": shard.alive.numpy(), "shard_count": int(shard.opt_state.count)}
    back = gsharded.gather_state(shard, mesh)
    out["round_trip"] = all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(state)))
    out["renders"] = []
    K, pose, bg = torch.tensor(K), torch.tensor(pose), torch.tensor(BG)
    for band, pre in BANDS:
        img, vis, info = gsharded.mp_render(
            shard.params, shard.alive, pose, K, config=SplatConfig(use_sh_precompute=pre),
            camera_hw=HW, n_sh_band=band, background_rgb=bg, mesh=mesh)
        out["renders"].append((img.numpy(), vis.numpy(), int(info["num_splats"]),
                               int(info["num_visible"]), int(info["n_alive"])))
    return out


def leaves(state):
    """Every tensor of a TrainState, in a fixed order."""
    out = []
    trainer.map_state(lambda x: out.append(x) or x, state)
    return out


@pytest.fixture(scope="module")
def scene():
    from tests import fixtures as fx
    from tests.test_render_grads import _small_camera

    params, alive = seeded_params()
    cam = _small_camera()
    return params, alive, np.asarray(cam.K), np.asarray(fx.test_camera_T_world())


@pytest.fixture(scope="module")
def ranks(scene):
    return comm.launch(_render_rank, D, *scene, device_type="cpu")


def _jax_mp_render(scene, band, pre):
    import jax
    import jax.numpy as jnp

    from gaussian_splatting_tpu import trainer as jt
    from gaussian_splatting_tpu.config import SplatConfig as JConfig
    from gaussian_splatting_tpu.parallel import make_model_mesh, mp_render, shard_state
    from gaussian_splatting_tpu.structs import GaussianScene

    params, alive, K, pose = scene
    # chunk 32: the same image as chunk 256, and a third less compile time
    cfg = JConfig(splat_capacity=1 << 12, chunk=32, kernel_precision="f32",
                  use_sh_precompute=pre)
    jscene = GaussianScene(**{k: jnp.asarray(v) for k, v in params.items()},
                           alive=jnp.asarray(alive))
    mesh = make_model_mesh(D)
    state = shard_state(jt.init_train_state(jscene, cfg), mesh)
    img, vis, info = jax.jit(lambda p, a: mp_render(
        p, a, jnp.asarray(pose), jnp.asarray(K), config=cfg, camera_hw=HW, n_sh_band=band,
        background_rgb=jnp.asarray(BG), mesh=mesh))(state.params, state.alive)
    return np.asarray(img), np.asarray(vis), int(info["num_splats"])


@pytest.mark.parametrize("case", range(len(BANDS)),
                         ids=[f"band{b}-{'dc' if p else 'per_pixel'}" for b, p in BANDS])
def test_mp_render_matches_jax(scene, ranks, case):
    """Image and visibility of the band render against JAX's, both ranks
    holding the whole image."""
    band, pre = BANDS[case]
    jimg, jvis, jsplats = _jax_mp_render(scene, band, pre)
    img0, vis0, splats, n_visible, n_alive = ranks[0]["renders"][case]
    img1, vis1, *_ = ranks[1]["renders"][case]
    assert img0.shape == HW + (3,)
    np.testing.assert_array_equal(img0, img1)
    np.testing.assert_allclose(img0, jimg, rtol=0, atol=IMG_ATOL)
    np.testing.assert_array_equal(np.concatenate([vis0, vis1]), jvis)
    assert vis0.any() and vis1.any(), "both shards hold a visible gaussian"
    assert splats == jsplats > 0 and n_visible > 0 and n_alive == 6
    assert (img0 != img0[:1, :1]).any(axis=-1).mean() > 0.1  # not the background alone


def test_shard_and_gather_state(ranks):
    """shard_state keeps each rank's 8 slots and the Adam count;
    gather_state returns every leaf bitwise."""
    _, alive = seeded_params()
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["shard_alive"], alive[8 * r:8 * (r + 1)])
        assert out["shard_count"] == 0 and out["round_trip"]
    with pytest.raises(ValueError, match="must divide"):
        state = trainer.init_train_state(scene_from_numpy(*seeded_params(), "cpu"),
                                         SplatConfig())
        gsharded.shard_state(state, 0, 3)
