"""The training CLI with data and model parallelism on the CPU: ranks
spawned over gloo by ``train_torch.main`` itself, with ADC, evals and
checkpoints that the JAX package reads; a model-parallel resume; the data
draw of each step against the JAX runner's ``_dp_step``; and
``dryrun_multigpu`` on four ranks.

The ranks import this module to find their function, so it imports no
jax at the top.
"""

import dataclasses
import json
import os

import numpy as np
import torch

import train_torch
from gaussian_splatting_torch.parallel import comm
from gaussian_splatting_torch.parallel import mesh as pmesh
from gaussian_splatting_torch.parallel.dryrun import dryrun_multigpu
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

# test_torch_runner.py's tiny run: ADC at 4 and 8, a reset at 6, a
# checkpoint at 5, debug images at 4 and 8, evals at 0, 5 and the end
TINY = ["synthetic", "--device", "cpu", "--synthetic_points", "200",
        "--synthetic_init_points", "100", "--synthetic_images", "6",
        "--synthetic_width", "64", "--synthetic_height", "48", "--test_split_ratio", "3",
        "--print_interval", "3"]
RUN = ["--num_iters", "10", "--test_eval_interval", "5", "--adaptive_control_start", "2",
       "--adaptive_control_interval", "4", "--adaptive_control_end", "9",
       "--reset_opacity_start", "5", "--reset_opacity_interval", "6",
       "--reset_opacity_end", "9", "--checkpoint_interval", "5",
       "--save_debug_image_interval", "4", "--add_sh_band_interval", "3"]
FILES = ["ckpt_final.npz", "ckpt_iter_5.npz", "config.yaml", "debug_iter4.png",
         "debug_iter8.png", "iter10_test_image_0.png", "iter10_test_image_3.png",
         "metrics.json", "scene_final.ply"]


def _recording_rank(argv):
    """train_torch.main(argv) as one rank, recording the view its data
    replica trains on at every step."""
    torch.set_num_threads(1)
    from gaussian_splatting_torch import runner as trunner

    views, data = [], []
    init, step = trunner.TrainingRunner.__init__, pmesh.dp_train_step

    def keep_data(self, scene_data, *args, **kwargs):
        data.append(scene_data)
        init(self, scene_data, *args, **kwargs)

    def recorded(state, gt, K, pose, *args, **kwargs):
        views.append(next(i for i, im in enumerate(data[0].images)
                          if np.array_equal(np.float32(im.camera_T_world), pose.numpy())))
        return step(state, gt, K, pose, *args, **kwargs)

    trunner.TrainingRunner.__init__ = keep_data
    pmesh.dp_train_step = recorded
    return train_torch.rank_summary(train_torch.main(argv)), views


def _jax_reads(out, n_alive):
    """The JAX package reads the run's checkpoint, scene and config."""
    from gaussian_splatting_tpu import checkpoint as jckpt
    from gaussian_splatting_tpu.config import SplatConfig as JConfig

    with open(out / "config.yaml") as f:
        JConfig.from_yaml(f.read())
    jstate, it, _ = jckpt.load_checkpoint(str(out / "ckpt_final.npz"), JConfig())
    assert it == 10 and int(np.asarray(jstate.alive).sum()) == n_alive
    assert jckpt.import_ply(str(out / "scene_final.ply")).capacity == n_alive
    return jstate


def test_cli_model_parallel_run_and_resume(tmp_path):
    """--model_parallel 2: two ranks, each a shard of 1024 slots; the run's
    files, read by the JAX package, hold the whole state; the metrics
    follow the single-process run's; a resume from the periodic checkpoint
    starts each rank at iteration 5 with its shard of the file."""
    single = train_torch.main(TINY + RUN + ["--output_dir", str(tmp_path / "one")])
    out = tmp_path / "mp"
    ranks = train_torch.main(TINY + RUN + ["--model_parallel", "2", "--output_dir", str(out)])
    assert [r["rank"] for r in ranks] == [0, 1]
    assert sorted(os.listdir(out)) == FILES
    metrics = json.loads((out / "metrics.json").read_text())
    assert metrics == ranks[0]["metrics"] and ranks[1]["metrics"]["eval_iters"] == [0, 5, 10]
    want = single.metrics.to_dict()
    assert metrics["adc_events"] == want["adc_events"]
    assert metrics["num_gaussians"] == want["num_gaussians"]
    np.testing.assert_allclose(metrics["test_psnr"], want["test_psnr"], rtol=1e-4)
    np.testing.assert_allclose(metrics["train_psnr"], want["train_psnr"], rtol=1e-4)
    n_alive = sum(r["n_alive"] for r in ranks)
    assert n_alive == metrics["adc_events"][-1]["alive"] == int(single.state.alive.sum())
    jstate = _jax_reads(out, n_alive)
    np.testing.assert_allclose(np.asarray(jstate.params["xyz"]), single.state.params["xyz"],
                               rtol=0, atol=1e-4)

    resumed = train_torch.main(TINY + RUN[2:] + [
        "--num_iters", "8", "--model_parallel", "2", "--output_dir", str(tmp_path / "resumed"),
        "--load_checkpoint", "true", "--checkpoint_path", str(out / "ckpt_iter_5.npz")])
    for r in resumed:
        assert r["start_iter"] == 5 and r["metrics"]["eval_iters"] == [5, 8]
        assert len(r["metrics"]["train_psnr"]) == 3
    with np.load(out / "ckpt_iter_5.npz") as z:
        assert resumed[0]["metrics"]["num_gaussians"][0] == int(z["alive"].sum())


def test_cli_data_parallel_run_and_draw(tmp_path, monkeypatch):
    """--data_parallel 2: each step's two views are the JAX runner's
    _dp_step draw for the seed, each replica on its own; only rank 0
    evaluates; the files are read by the JAX package."""
    import jax.numpy as jnp

    import gaussian_splatting_tpu.parallel as jparallel
    from gaussian_splatting_torch.config import SplatConfig
    from gaussian_splatting_tpu import runner as jrunner
    from gaussian_splatting_tpu.config import SplatConfig as JConfig
    from tests.test_torch_runner import Recorder, _data, _record_jax

    out = tmp_path / "dp"
    argv = TINY + RUN + ["--data_parallel", "2", "--output_dir", str(out)]
    ranks = comm.launch(_recording_rank, 2, argv, device_type="cpu")
    (s0, v0), (s1, v1) = ranks
    assert sorted(os.listdir(out)) == FILES
    assert s0["metrics"]["eval_iters"] == [0, 5, 10] and s1["metrics"]["eval_iters"] == []
    assert s0["n_alive"] == s1["n_alive"] == s0["metrics"]["adc_events"][-1]["alive"]
    _jax_reads(out, s0["n_alive"])

    # the JAX runner's draws for the same config, its step recorded
    args = train_torch.build_parser().parse_args(argv)
    cfg = SplatConfig(**{f.name: getattr(args, f.name) for f in dataclasses.fields(SplatConfig)})
    jcfg = JConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(JConfig)})
    rec = Recorder(_data(cfg))
    _record_jax(monkeypatch, rec, tmp_path)
    jviews = []

    def dp_train_step(state, gts, Ks, poses, bgs, **kwargs):
        jviews.append([rec.view(p) for p in np.asarray(poses)])
        return state, dict(psnr=jnp.float32(20.0), n_alive=jnp.int32(100), num_splats=100,
                           num_visible=30, overflow=False, truncated=0)

    monkeypatch.setattr(jparallel, "dp_train_step", dp_train_step)
    jrunner.TrainingRunner(_data(cfg), jcfg, synthetic=True).train()
    assert [list(v) for v in zip(v0, v1)] == jviews and len(jviews) == 10
    assert v0 != v1


def test_dryrun_multigpu_cpu(capfd):
    """dryrun_multigpu on four CPU ranks: each mode's 3 steps, ADC, the
    re-placement and an eval, with the JAX dry run's lines."""
    lines = dryrun_multigpu(4, device="cpu")
    printed = capfd.readouterr().out.splitlines()
    modes = ["dp", "mp", "dp(2)xmp(2)"]
    assert len(lines) == 6 and all(line in printed for line in lines)
    for mode, (step, event) in zip(modes, zip(lines[::2], lines[1::2])):
        assert step.startswith(f"dryrun_multigpu(4) {mode}: loss=") and step.endswith(" OK")
        assert event.startswith(f"dryrun_multigpu(4) {mode} ADC: deleted=")
        assert " alive=" in event and event.endswith(" OK")
