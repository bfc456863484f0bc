"""Both parallel axes together: ``dp_mp_train_step`` on a (2, 2) mesh of
four ranks spawned over gloo on the CPU, against the JAX package's
``dp_mp_train_step`` on ``make_2d_mesh(2, 2)``; the state's shards over
the model groups; and the step skip, which the port decides over every
rank where JAX decides it per model shard.

The scene is ``test_torch_gsharded.py``'s; camera 0 is the fixture's,
camera 1 the same moved 0.05 along x.  The ranks import this module to
find their function, so it imports no jax at the top.
"""

import numpy as np
import pytest
import torch

from gaussian_splatting_torch import convert, trainer
from gaussian_splatting_torch.config import SplatConfig
from gaussian_splatting_torch.convert import scene_from_numpy
from gaussian_splatting_torch.parallel import comm, gsharded
from gaussian_splatting_torch.parallel import mesh as pmesh
from tests.test_torch_gsharded import leaves

DP, MP = 2, 2
HW = (48, 64)
SH_BAND = 3
NAN_SLOT = 12  # a dead slot of model shard 1


def _inputs(seed=2):
    from tests import fixtures as fx
    from tests.test_render_grads import _small_camera
    from tests.test_torch_gsharded import seeded_params

    params, alive = seeded_params()
    rng = np.random.default_rng(seed)
    gts = rng.integers(0, 256, (DP,) + HW + (3,), dtype=np.uint8)
    K = np.asarray(_small_camera().K)
    pose = np.asarray(fx.test_camera_T_world())
    pose2 = pose.copy()
    pose2[0, 3] += 0.05
    bgs = rng.uniform(0, 1, (2, DP, 3)).astype(np.float32)  # (step, camera, 3)
    return params, alive, gts, np.stack([K, K]), np.stack([pose, pose2]), bgs


def _state(params, alive):
    return trainer.init_train_state(scene_from_numpy(params, alive, "cpu"), SplatConfig())


def _same(a, b):
    if a.is_floating_point():
        return torch.allclose(a, b, rtol=0, atol=0, equal_nan=True)
    return torch.equal(a, b)


def _dpmp_rank(params, alive, gts, Ks, poses, bgs):
    """2 steps from the scene, each shard and the gathered state after each;
    then a step with a NaN in model shard 1's slot NAN_SLOT."""
    torch.set_num_threads(1)
    mesh = comm.make_2d_mesh(DP, MP, device_type="cpu")
    gt, K, pose = (torch.tensor(pmesh.shard_batch(a, mesh)) for a in (gts, Ks, poses))
    kw = dict(config=SplatConfig(), camera_hw=HW, n_sh_band=SH_BAND, mesh=mesh)
    state = gsharded.shard_state(_state(params, alive), mesh.model_rank, MP)
    out = {"layout": (mesh.rank, mesh.data_rank, mesh.model_rank), "steps": []}
    for bg in bgs:
        state, info = gsharded.dp_mp_train_step(
            state, gt, K, pose, torch.tensor(pmesh.shard_batch(bg, mesh)), **kw)
        out["steps"].append((
            [x.numpy() for x in leaves(state)],
            convert.train_state_to_numpy(gsharded.gather_state(state, mesh)),
            {k: float(v) for k, v in info.items()}))
    p = {k: v.copy() for k, v in params.items()}
    p["xyz"][NAN_SLOT] = np.nan
    state = gsharded.shard_state(_state(p, alive), mesh.model_rank, MP)
    skipped, info = gsharded.dp_mp_train_step(
        state, gt, K, pose, torch.tensor(pmesh.shard_batch(bgs[0], mesh)), **kw)
    out["nan"] = (float(info["loss"]),
                  all(_same(a, b) for a, b in zip(leaves(skipped), leaves(state))))
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(inputs):
    return comm.launch(_dpmp_rank, DP * MP, *inputs, device_type="cpu")


def _jax_step(inputs, state_np, bg):
    import jax
    import jax.numpy as jnp

    from gaussian_splatting_tpu.config import SplatConfig as JConfig
    from gaussian_splatting_tpu.parallel import dp_mp_train_step, make_2d_mesh, shard_state
    from gaussian_splatting_tpu.parallel.mesh import shard_batch

    _, _, gts, Ks, poses, _ = inputs
    cfg = JConfig(splat_capacity=1 << 12, chunk=32, kernel_precision="f32")
    mesh = make_2d_mesh(DP, MP)
    put = lambda a: shard_batch(jnp.asarray(a), mesh)  # noqa: E731
    state, info = dp_mp_train_step(
        shard_state(jax.tree_util.tree_map(jnp.asarray, state_np), mesh), put(gts), put(Ks),
        put(poses), put(bg), config=cfg, camera_hw=HW, n_sh_band=SH_BAND, mesh=mesh)
    return jax.tree_util.tree_map(np.asarray, state), jax.tree_util.tree_map(np.asarray, info)


def _jax_state(params, alive):
    import jax
    import jax.numpy as jnp

    from gaussian_splatting_tpu import trainer as jt
    from gaussian_splatting_tpu.config import SplatConfig as JConfig
    from gaussian_splatting_tpu.structs import GaussianScene

    scene = GaussianScene(**{k: jnp.asarray(v) for k, v in params.items()},
                          alive=jnp.asarray(alive))
    return jax.tree_util.tree_map(np.asarray, jt.init_train_state(scene, JConfig()))


def test_mesh_layout(ranks):
    """Rank r sits at (r // mp, r % mp), as make_2d_mesh's reshape places
    devices."""
    assert [r["layout"] for r in ranks] == [(0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]


def test_dp_mp_train_step_matches_jax(inputs, ranks):
    """The gathered state and info after 1 and 2 steps against JAX's, at the
    trainer test's tolerances; every rank gathers the same state, and the
    ranks of a data group hold the same shard bitwise."""
    from tests.test_torch_trainer import LOSS_RTOL, _assert_states_agree

    params, alive, *_, bgs = inputs
    jstate = _jax_state(params, alive)
    for t, bg in enumerate(bgs):
        jstate, jinfo = _jax_step(inputs, jstate, bg)
        shards = [r["steps"][t][0] for r in ranks]
        for a, b in ((0, 2), (1, 3)):  # the data group of each model rank
            for x, y in zip(shards[a], shards[b]):
                np.testing.assert_array_equal(x, y)
        got, info = ranks[0]["steps"][t][1:]
        _assert_states_agree(convert.train_state_from_numpy(got, "cpu"), jstate)
        np.testing.assert_allclose(info["loss"], jinfo["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(info["psnr"], jinfo["psnr"], rtol=LOSS_RTOL)
        assert info["num_visible"] == int(jinfo["num_visible"])
        assert info["n_alive"] == int(jinfo["n_alive"]) == 6
        assert all(r["steps"][t][2] == info for r in ranks)
    # each step, both cameras saw the visible gaussians
    assert int(jstate.grad_accum_count.max()) == 2 * len(bgs)


def test_a_non_finite_shard_skips_every_rank(inputs, ranks):
    """A NaN at a dead slot of model shard 1 leaves the loss finite and
    makes only that shard's gradient NaN (the single-device gradient, which
    the shards' gradients equal, shows where).  The port skips the step on
    every rank, as trainer.train_step skips it.  JAX's dp_mp_train_step
    forms its skip inside the shard_map, from each model shard's own
    gradient, so there shard 0 would take the step and shard 1 not (ROADMAP
    §C: a reference behaviour the port does not copy)."""
    params, alive, gts, Ks, poses, bgs = inputs
    p = {k: v.copy() for k, v in params.items()}
    p["xyz"][NAN_SLOT] = np.nan
    loss, _, grads, _ = trainer.camera_loss(
        _state(p, alive), torch.tensor(gts[0]), torch.tensor(Ks[0]), torch.tensor(poses[0]),
        torch.tensor(bgs[0, 0]), config=SplatConfig(), camera_hw=HW, n_sh_band=SH_BAND)
    half = len(alive) // MP
    finite = torch.stack([g.reshape(len(alive), -1).isfinite().all(1) for g in grads.values()])
    assert torch.isfinite(loss) and finite[:, :half].all() and not finite[:, half:].all()
    for r in ranks:
        loss, unchanged = r["nan"]
        assert np.isfinite(loss) and unchanged
