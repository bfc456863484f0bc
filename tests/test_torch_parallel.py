"""Data parallelism over cameras (``parallel/mesh.py``) and the process
groups and collectives under it (``parallel/comm.py``), on two ranks
spawned over gloo on the CPU, against the JAX package's ``dp_train_step``
on a 2-device mesh cut from the suite's 8 virtual CPU devices.

The ranks import this module to find their function, so it imports no
jax at the top: the JAX side is imported inside the fixtures and tests.
"""

import numpy as np
import pytest
import torch

from gaussian_splatting_torch import convert
from gaussian_splatting_torch.config import SplatConfig
from gaussian_splatting_torch.parallel import comm
from gaussian_splatting_torch.parallel import mesh as pmesh
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

D = 2
SH_BAND = 3
HW = (48, 64)
CFG = SplatConfig()


def _numpy_state(state):
    return convert.train_state_to_numpy(state)


def _comm_checks(mesh):
    """The collectives on this rank: gathers (float, bool), the gather's
    backward, all_ok, broadcast and a mesh of the wrong size."""
    r = mesh.rank
    out = {}
    x = torch.arange(6.0).reshape(3, 2) + 10 * r
    out["gather_dim1"] = comm.gather(x, 1, mesh.data_group).numpy()
    out["gather_bool"] = comm.gather(torch.tensor([r == 0, True]), 0, mesh.data_group).numpy()
    xg = x.clone().requires_grad_(True)
    w = torch.arange(12.0).reshape(3, 4) * (r + 1)
    (comm.all_gather(xg, 1, mesh.data_group) * w).sum().backward()
    out["gather_grad"] = xg.grad.numpy()
    out["all_ok"] = [bool(comm.all_ok(torch.tensor(True))),
                     bool(comm.all_ok(torch.tensor(r == 0)))]
    out["broadcast"] = comm.broadcast(torch.tensor([r, r == 1]), 1).numpy()
    out["sum"] = comm.all_sum(torch.tensor([1.0 + r]), mesh.data_group).numpy()
    try:
        comm.make_2d_mesh(3, 1, device_type="cpu")
    except ValueError as e:
        out["bad_mesh"] = str(e)
    return out


def _dp_rank(state, cams):
    """On each rank: the collectives' checks; replicate_state from a state
    that differs on rank 1; 2 dp_train_steps on this rank's camera, each
    state returned; a step whose background is NaN on rank 1 only."""
    torch.set_num_threads(1)
    mesh = comm.make_mesh(device_type="cpu")
    out = {"comm": _comm_checks(mesh), "ranks": (mesh.rank, mesh.data_rank, mesh.model_rank)}
    if mesh.rank == 1:
        state = state._replace(params=dict(state.params, xyz=state.params["xyz"] + 1.0))
    state = pmesh.replicate_state(state, mesh)
    gt, K, pose, bgs = (torch.tensor(a) for a in pmesh.shard_batch(cams, mesh))
    kw = dict(config=CFG, camera_hw=HW, n_sh_band=SH_BAND, mesh=mesh)
    out["states"], out["infos"] = [_numpy_state(state)], []
    for bg in bgs:
        state, info = pmesh.dp_train_step(state, gt, K, pose, bg, **kw)
        out["states"].append(_numpy_state(state))
        out["infos"].append({k: float(v) for k, v in info.items()})
    nan_bg = bgs[0].clone()
    if mesh.rank == 1:
        nan_bg[0] = float("nan")
    skipped, info = pmesh.dp_train_step(state, gt, K, pose, nan_bg, **kw)
    out["skip_loss"] = float(info["loss"])
    out["skipped_equal"] = all(np.array_equal(a, b) for a, b in
                               zip(_leaves_np(_numpy_state(skipped)),
                                   _leaves_np(_numpy_state(state))))
    return out


def _raise_on_rank_1():
    if torch.distributed.get_rank() == 1:
        raise KeyError("rank 1 failed")
    torch.distributed.barrier()  # rank 0 waits in a collective until stopped


def _die_on_rank_1():
    import os

    if torch.distributed.get_rank() == 1:
        os._exit(3)
    return "done"


@pytest.fixture(scope="module")
def setup():
    """test_torch_gsharded.py's scene (the fixture's gaussians in 16 slots,
    seeded SH) as a JAX state in numpy form, and two cameras at 64x48: the
    small camera, and the same moved 0.05 along x, each with a seeded uint8
    target and two backgrounds."""
    import jax
    import jax.numpy as jnp

    from gaussian_splatting_tpu import trainer as jt
    from gaussian_splatting_tpu.config import SplatConfig as JConfig
    from gaussian_splatting_tpu.structs import GaussianScene
    from tests import fixtures as fx
    from tests.test_render_grads import _small_camera
    from tests.test_torch_gsharded import seeded_params

    params, alive = seeded_params()
    scene = GaussianScene(**{k: jnp.asarray(v) for k, v in params.items()},
                          alive=jnp.asarray(alive))
    jstate = jax.tree_util.tree_map(np.asarray, jt.init_train_state(scene, JConfig()))
    rng = np.random.default_rng(4)
    pose = np.asarray(fx.test_camera_T_world())
    pose2 = pose.copy()
    pose2[0, 3] += 0.05
    K = np.asarray(_small_camera().K)
    gts = rng.integers(0, 256, (D,) + HW + (3,), dtype=np.uint8)
    bg_steps = rng.uniform(0, 1, (D, 2, 3)).astype(np.float32)  # (camera, step, 3)
    return jstate, gts, np.stack([K, K]), np.stack([pose, pose2]), bg_steps


@pytest.fixture(scope="module")
def ranks(setup):
    jstate, gts, Ks, poses, bg_steps = setup
    state = convert.train_state_from_numpy(jstate, "cpu")
    cams = [(gts[d], Ks[d], poses[d], bg_steps[d]) for d in range(D)]
    return comm.launch(_dp_rank, D, state, cams, device_type="cpu")


@pytest.fixture(scope="module")
def jax_steps(setup):
    """The JAX dp_train_step on a 2-device mesh: 2 steps, then the NaN step."""
    import jax
    import jax.numpy as jnp

    from gaussian_splatting_tpu.config import SplatConfig as JConfig
    from gaussian_splatting_tpu.parallel import dp_train_step, make_mesh
    from gaussian_splatting_tpu.parallel.mesh import replicate_state, shard_batch

    jstate, gts, Ks, poses, bg_steps = setup
    mesh = make_mesh(D)
    cfg = JConfig(splat_capacity=1 << 12, chunk=32, kernel_precision="f32")

    def step(state, bg):
        put = lambda a: shard_batch(jnp.asarray(a), mesh)  # noqa: E731
        state = replicate_state(jax.tree_util.tree_map(jnp.asarray, state), mesh)
        s, info = dp_train_step(state, put(gts), put(Ks), put(poses), put(bg), config=cfg,
                                camera_hw=HW, n_sh_band=SH_BAND, mesh=mesh)
        return jax.tree_util.tree_map(np.asarray, s), jax.tree_util.tree_map(np.asarray, info)

    states, infos = [jstate], []
    for t in range(bg_steps.shape[1]):
        s, info = step(states[-1], bg_steps[:, t])
        states.append(s)
        infos.append(info)
    nan_bg = bg_steps[:, 0].copy()
    nan_bg[1, 0] = np.nan
    return states, infos, step(states[-1], nan_bg)


@pytest.mark.parametrize("device_type,count,n,backend", [
    ("cpu", 0, 4, "gloo"), ("cuda", 4, 4, "nccl"), ("cuda", 8, 2, "nccl"),
    ("cuda", 1, 2, "gloo")])
def test_backend_rule(device_type, count, n, backend, monkeypatch):
    """The backend from the device count alone: NCCL when every rank has a
    card, gloo on the CPU or when ranks share cards (rank r on r % count)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert comm.backend_for(device_type, n) == backend
    want = ["cpu"] * n if device_type == "cpu" else [f"cuda:{r % count}" for r in range(n)]
    assert [str(comm.rank_device(device_type, r)) for r in range(n)] == want
    with pytest.raises(ValueError, match="backend"):
        comm.backend_for("mps", n)


def test_launch_raises_a_rank_exception():
    """A rank's exception reaches the caller with its type and the rank's
    traceback; the rank waiting in a collective is stopped."""
    with pytest.raises(KeyError, match="rank 1 failed") as info:
        comm.launch(_raise_on_rank_1, 2, device_type="cpu")
    assert any("raised on rank 1 of 2" in n for n in info.value.__notes__)


def test_launch_reports_a_rank_that_dies():
    with pytest.raises(RuntimeError, match="rank 1 exited with code 3"):
        comm.launch(_die_on_rank_1, 2, device_type="cpu")


def test_mesh_layout_and_collectives(ranks):
    assert [r["ranks"] for r in ranks] == [(0, 0, 0), (1, 1, 0)]
    c0, c1 = ranks[0]["comm"], ranks[1]["comm"]
    x = [np.arange(6.0).reshape(3, 2) + 10 * r for r in range(D)]
    for c in (c0, c1):
        np.testing.assert_array_equal(c["gather_dim1"], np.concatenate(x, 1))
        np.testing.assert_array_equal(c["gather_bool"], [True, True, False, True])
        assert c["all_ok"] == [True, False]
        np.testing.assert_array_equal(c["broadcast"], [1, 1])
        np.testing.assert_array_equal(c["sum"], [3.0])
        assert "needs 3 ranks" in c["bad_mesh"]
    # the gather's backward sums the group's cotangents and keeps the own part
    w = sum(np.arange(12.0).reshape(3, 4) * (r + 1) for r in range(D))
    np.testing.assert_array_equal(c0["gather_grad"], w[:, :2])
    np.testing.assert_array_equal(c1["gather_grad"], w[:, 2:])


def test_replicate_state(ranks):
    for a, b in zip(_leaves_np(ranks[0]["states"][0]), _leaves_np(ranks[1]["states"][0])):
        np.testing.assert_array_equal(a, b)


def _leaves_np(s):
    adam = s.opt_state[0]
    return ([s.params[k] for k in sorted(s.params)] + [s.alive, adam.count]
            + [adam.mu[k] for k in sorted(adam.mu)] + [adam.nu[k] for k in sorted(adam.nu)]
            + [s.uv_grad_accum, s.xyz_grad_accum, s.grad_accum_count])


@pytest.mark.parametrize("step", [1, 2])
def test_dp_train_step_matches_jax(ranks, jax_steps, step):
    """Params, moments, both accumulators, the counts and the info after 1
    and 2 steps, at the trainer test's tolerances."""
    from tests.test_torch_trainer import _assert_states_agree, LOSS_RTOL

    jstates, jinfos, _ = jax_steps
    got = convert.train_state_from_numpy(ranks[0]["states"][step], "cpu")
    _assert_states_agree(got, jstates[step])
    info, jinfo = ranks[0]["infos"][step - 1], jinfos[step - 1]
    np.testing.assert_allclose(info["loss"], jinfo["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(info["psnr"], jinfo["psnr"], rtol=LOSS_RTOL)
    for k in ("num_visible", "truncated", "n_alive"):
        assert info[k] == int(jinfo[k]), k
    assert info["num_splats"] > 0
    # both cameras saw the three visible gaussians each step
    assert int(jstates[step].grad_accum_count.max()) == 2 * step


def test_dp_replicas_bitwise_equal(ranks):
    for s0, s1 in zip(ranks[0]["states"], ranks[1]["states"]):
        for a, b in zip(_leaves_np(s0), _leaves_np(s1)):
            np.testing.assert_array_equal(a, b)
    assert ranks[0]["infos"] == ranks[1]["infos"]


def test_dp_skips_a_non_finite_step(ranks, jax_steps):
    """A NaN background on one camera makes the averaged loss NaN: both
    packages skip the step on every replica."""
    _, _, (jskip, jinfo) = jax_steps
    assert np.isnan(jinfo["loss"])
    for r in ranks:
        assert np.isnan(r["skip_loss"]) and r["skipped_equal"]
