"""The training CLI end to end on the CPU, against the JAX package's runner:
the schedule that ``TrainingRunner.train`` drives, recorded in both
packages with the trainer's functions replaced by recorders; the synthetic
ground truth; real ``train_torch.main`` runs with an ADC event, a reset, a
checkpoint, a resume and the abort; and the port's CLI without jax."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import train_torch
from gaussian_splatting_torch import checkpoint as tckpt
from gaussian_splatting_torch import runner as trunner
from gaussian_splatting_torch import trainer as ttrainer
from gaussian_splatting_torch.config import SplatConfig
from gaussian_splatting_torch.dataio.dataset import make_synthetic_scene_data
from gaussian_splatting_torch.structs import GSMetricsLog
from gaussian_splatting_tpu import checkpoint as jckpt
from gaussian_splatting_tpu import runner as jrunner
from gaussian_splatting_tpu import trainer as jtrainer
from gaussian_splatting_tpu.config import SplatConfig as JConfig
from gaussian_splatting_tpu.ops import common as jcc
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a compressed schedule: evals at 0, 10, 20 and the end, ADC at 5..25 every
# 5, resets at 10 and 20, debug images every 5, checkpoints at 10 and 20,
# SH bands at 7, 14, 21, the background cycle until 17; events share
# iterations so their order within an iteration is pinned too
SCHEDULE = dict(
    num_iters=30, test_eval_interval=10, print_interval=4,
    adaptive_control_start=3, adaptive_control_interval=5, adaptive_control_end=26,
    reset_opacity_start=6, reset_opacity_interval=10, reset_opacity_end=29,
    save_debug_image_interval=5, checkpoint_interval=10, add_sh_band_interval=7,
    use_background_end=17, synthetic_points=60, synthetic_init_points=30,
    synthetic_images=8, synthetic_width=32, synthetic_height=24, test_split_ratio=3,
    seed=5,
)


def _data(cfg):
    return make_synthetic_scene_data(cfg.synthetic_points, cfg.synthetic_images,
                                     cfg.seed, cfg.synthetic_width, cfg.synthetic_height)


class Recorder:
    """The runner's calls into the trainer and the checkpoint module, as
    (event, steps taken so far, ...) tuples."""

    def __init__(self, data):
        self.poses = [im.camera_T_world for im in data.images]
        self.events = []
        self.steps = 0

    def view(self, pose):
        pose = np.asarray(pose, np.float32)
        return [j for j, p in enumerate(self.poses) if np.array_equal(p, pose)][0]

    def add(self, *event):
        self.events.append((event[0], self.steps) + event[1:])


def _record_jax(monkeypatch, rec, tmp_path):
    def train_step(state, gt, K, pose, bg, *, config, camera_hw, n_sh_band, use_background):
        rec.add("step", rec.view(pose), n_sh_band, float(np.asarray(bg)[0]))
        rec.steps += 1
        return state, dict(psnr=20.0, n_alive=30, num_splats=100, num_visible=30,
                           overflow=False, truncated=0)

    def eval_step(state, gt, K, pose, *, config, camera_hw, n_sh_band):
        rec.add("eval", rec.view(pose), n_sh_band)
        return np.zeros(camera_hw + (3,), np.float32), 21.0, 0.5, False

    def adc(state, key, iteration, *, config):
        rec.add("adc", int(iteration))
        return state, dict(n_deleted=1, n_clone=2, n_split=3, n_alive=34, cap_hit=False,
                           clone_deferred=0, split_deferred=0)

    def reset(state, *, config):
        rec.add("reset")
        return state

    monkeypatch.setattr(jtrainer, "train_step", train_step)
    monkeypatch.setattr(jtrainer, "eval_step", eval_step)
    monkeypatch.setattr(jtrainer, "adaptive_density_control", adc)
    monkeypatch.setattr(jtrainer, "reset_opacity", reset)
    monkeypatch.setattr(jckpt, "save_checkpoint", lambda path, state, i, key, extra=None:
                        rec.add("ckpt", i, os.path.basename(path)))
    monkeypatch.setattr(jckpt, "export_ply", lambda path, state:
                        rec.add("ply", os.path.basename(path)))
    monkeypatch.setattr(jrunner.TrainingRunner, "_save_image", lambda self, img, name:
                        rec.add("png", name))

    def gt(self):
        for i, im in enumerate(self.data.images):
            cam = self.data.cameras[im.camera_id]
            self._gt_cache[i] = np.zeros((cam.height, cam.width, 3), np.float32)

    monkeypatch.setattr(jrunner.TrainingRunner, "_synthetic_gt", gt)


def _record_port(monkeypatch, rec):
    def train_step(state, gt, K, pose, bg, *, config, camera_hw, n_sh_band):
        rec.add("step", rec.view(pose.numpy()), n_sh_band, float(bg[0]))
        rec.steps += 1
        return state, dict(psnr=torch.tensor(20.0), n_alive=torch.tensor(30),
                           num_splats=100, num_visible=30, truncated=0)

    def eval_step(state, gt, K, pose, *, config, camera_hw, n_sh_band):
        rec.add("eval", rec.view(pose.numpy()), n_sh_band)
        return torch.zeros(camera_hw + (3,)), torch.tensor(21.0), torch.tensor(0.5)

    def adc(state, generator, iteration, *, config):
        rec.add("adc", int(iteration))
        stats = dict(n_deleted=1, n_clone=2, n_split=3, n_alive=34, cap_hit=False,
                     clone_deferred=0, split_deferred=0)
        return state, {k: torch.tensor(v) for k, v in stats.items()}

    def reset(state, *, config):
        rec.add("reset")
        return state

    monkeypatch.setattr(ttrainer, "train_step", train_step)
    monkeypatch.setattr(ttrainer, "eval_step", eval_step)
    monkeypatch.setattr(ttrainer, "adaptive_density_control", adc)
    monkeypatch.setattr(ttrainer, "reset_opacity", reset)
    monkeypatch.setattr(tckpt, "save_checkpoint", lambda path, state, i, gen, extra=None:
                        rec.add("ckpt", i, os.path.basename(path)))
    monkeypatch.setattr(tckpt, "export_ply", lambda path, state:
                        rec.add("ply", os.path.basename(path)))
    monkeypatch.setattr(trunner.TrainingRunner, "_save_image", lambda self, img, name:
                        rec.add("png", name))

    def gt(self):
        for i, im in enumerate(self.data.images):
            cam = self.data.cameras[im.camera_id]
            self._gt_cache[i] = torch.zeros(cam.height, cam.width, 3)

    monkeypatch.setattr(trunner.TrainingRunner, "_synthetic_gt", gt)


@pytest.mark.parametrize("resume_at", [0, 13, 10])
def test_schedule_matches_jax_runner(resume_at, tmp_path, monkeypatch):
    """The sequence of steps (view, SH band, background), evals, ADC
    events, resets, debug images, checkpoints and the final files is the
    JAX runner's, fresh and resumed from a checkpoint at iteration 13, or
    at 10, where a resumed run repeats iteration 10's step and events as
    the JAX runner does."""
    kw = dict(SCHEDULE, output_dir=str(tmp_path))
    jcfg, cfg = JConfig(**kw), SplatConfig(**kw)
    if resume_at:
        # one JAX file, which both runners resume from
        path = str(tmp_path / "start.npz")
        scene = jrunner.create_scene(jrunner.SceneData(**{
            f.name: getattr(_data(cfg), f.name) for f in dataclasses.fields(jrunner.SceneData)
        }), jcfg, 64)
        jckpt.save_checkpoint(path, jtrainer.init_train_state(scene, jcfg), resume_at,
                              jax.random.PRNGKey(1))
        jcfg = jcfg.replace(load_checkpoint=True, checkpoint_path=path)
        cfg = cfg.replace(load_checkpoint=True, checkpoint_path=path)

    jrec, trec = Recorder(_data(cfg)), Recorder(_data(cfg))
    _record_jax(monkeypatch, jrec, tmp_path)
    _record_port(monkeypatch, trec)
    jr = jrunner.TrainingRunner(_data(cfg), jcfg, synthetic=True)
    jr.train()
    tr = trunner.TrainingRunner(_data(cfg), cfg, synthetic=True, device="cpu")
    assert tr.start_iter == jr.start_iter == resume_at
    tr.train()

    assert trec.events == jrec.events
    kinds = {e[0] for e in jrec.events}
    assert kinds == {"step", "eval", "adc", "reset", "png", "ckpt", "ply"}
    assert jrec.steps == SCHEDULE["num_iters"] - tr.start_iter
    assert tr.metrics.to_dict() == jr.metrics.to_dict()


class Watched(torch.Tensor):
    """A step's 0-d info tensor that logs every operation on it: (step it
    belongs to, steps taken when read, read inside _drain)."""

    reads = []
    in_drain = False
    rec = None

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        for a in args:
            if isinstance(a, Watched):
                cls.reads.append((a.step, cls.rec.steps, cls.in_drain))
        with torch._C.DisableTorchFunctionSubclass():
            return func(*args, **(kwargs or {}))


def test_step_info_read_only_in_drain(tmp_path, monkeypatch):
    """The host reads a step's info tensors only in _drain, DRAIN_LAG steps
    after the step unless an event drains the queue first."""
    cfg = SplatConfig(**dict(SCHEDULE, output_dir=str(tmp_path)))
    rec = Recorder(_data(cfg))
    _record_port(monkeypatch, rec)
    monkeypatch.setattr(Watched, "reads", [])
    monkeypatch.setattr(Watched, "rec", rec)

    def train_step(state, gt, K, pose, bg, *, config, camera_hw, n_sh_band):
        info = {}
        for k, v in (("psnr", 20.0), ("n_alive", 30)):
            info[k] = torch.tensor(v).as_subclass(Watched)
            info[k].step = rec.steps
        rec.steps += 1
        return state, dict(info, num_splats=100, num_visible=30, truncated=0)

    drain = trunner.TrainingRunner._drain

    def watched_drain(self, upto=0):
        monkeypatch.setattr(Watched, "in_drain", True)
        try:
            drain(self, upto)
        finally:
            monkeypatch.setattr(Watched, "in_drain", False)

    monkeypatch.setattr(ttrainer, "train_step", train_step)
    monkeypatch.setattr(trunner.TrainingRunner, "_drain", watched_drain)
    tr = trunner.TrainingRunner(_data(cfg), cfg, synthetic=True, device="cpu")
    tr.train()
    assert Watched.reads and all(inside for _, _, inside in Watched.reads)
    assert {s for s, _, _ in Watched.reads} == set(range(cfg.num_iters))
    assert max(taken - s for s, taken, _ in Watched.reads) == trunner.DRAIN_LAG + 1
    assert tr.metrics.train_psnr == [20.0] * cfg.num_iters


def test_synthetic_ground_truth_matches_jax(monkeypatch):
    """The port's _synthetic_gt images against the JAX runner's
    _gt_render_step on 2 views at 1e-5, where T >= 1e-4 (below it the
    port's kernel stops compositing)."""
    kw = dict(synthetic_points=200, synthetic_init_points=100, synthetic_images=2,
              synthetic_width=64, synthetic_height=48, seed=3)
    jcfg = JConfig(**kw, splat_capacity=1 << 14, kernel_precision="f32")
    cfg = SplatConfig(**kw)
    renders = []
    original = jrunner._gt_render_step

    def keep(*args, **kwargs):
        res = original(*args, **kwargs)
        renders.append(res)
        return res

    monkeypatch.setattr(jrunner, "_gt_render_step", keep)
    data = _data(cfg)
    jr = jrunner.TrainingRunner(data, jcfg, synthetic=True)
    tr = trunner.TrainingRunner(data, cfg, synthetic=True, device="cpu")
    assert len(renders) == 2 and not any(bool(r.overflow) for r in renders)
    for i, res in enumerate(renders):
        got = tr.gt_image(i).numpy()
        np.testing.assert_array_equal(np.clip(np.asarray(res.image), 0, 1), jr.gt_image(i))
        T = np.asarray(res.transmittance).reshape(3, 4, 16, 16).transpose(0, 2, 1, 3)
        live = T.reshape(48, 64)[..., None] >= jcc.T_EPS
        assert live.mean() > 0.3 and got.min() >= 0 and got.max() <= 1
        np.testing.assert_allclose(np.where(live, got, 0), np.where(live, jr.gt_image(i), 0),
                                   atol=1e-5, rtol=0)
        u8 = tr.gt_image_dev(i).numpy()
        assert u8.dtype == np.uint8
        np.testing.assert_array_equal(u8, (np.clip(got * 255.0, 0, 255)).astype(np.uint8))


TINY = ["synthetic", "--device", "cpu", "--synthetic_points", "200",
        "--synthetic_init_points", "100", "--synthetic_images", "6",
        "--synthetic_width", "64", "--synthetic_height", "48", "--test_split_ratio", "3",
        "--print_interval", "3"]
# ADC at 4 and 8, a reset at 6, a checkpoint at 5, debug images at 4 and 8,
# SH bands at 3, 6, 9, evals at 0, 5 and the end
RUN = ["--num_iters", "10", "--test_eval_interval", "5", "--adaptive_control_start", "2",
       "--adaptive_control_interval", "4", "--adaptive_control_end", "9",
       "--reset_opacity_start", "5", "--reset_opacity_interval", "6",
       "--reset_opacity_end", "9", "--checkpoint_interval", "5",
       "--save_debug_image_interval", "4", "--add_sh_band_interval", "3"]


def test_cli_run_resume_and_files(tmp_path):
    """train_torch.main on the CPU: the run's files, each readable by the
    JAX package; a resume from the periodic checkpoint."""
    out = tmp_path / "run"
    r = train_torch.main(TINY + RUN + ["--output_dir", str(out)])
    names = sorted(os.listdir(out))
    assert names == ["ckpt_final.npz", "ckpt_iter_5.npz", "config.yaml", "debug_iter4.png",
                     "debug_iter8.png", "iter10_test_image_0.png",
                     "iter10_test_image_3.png", "metrics.json", "scene_final.ply"]
    metrics = json.loads((out / "metrics.json").read_text())
    assert metrics.keys() == GSMetricsLog().to_dict().keys()
    assert metrics == json.loads(json.dumps(r.metrics.to_dict()))
    assert metrics["eval_iters"] == [0, 5, 10]
    assert [e["iter"] for e in metrics["adc_events"]] == [4, 8]
    assert len(metrics["train_psnr"]) == len(metrics["num_gaussians"]) == 10
    assert all(np.isfinite(metrics["train_psnr"] + metrics["test_psnr"]))
    assert metrics["num_gaussians"][0] == 100
    assert metrics["adc_events"][-1]["alive"] == int(r.state.alive.sum())

    # the JAX package reads every file the run wrote
    with open(out / "config.yaml") as f:
        assert JConfig.from_yaml(f.read()).num_iters == 10
    jstate, it, key = jckpt.load_checkpoint(str(out / "ckpt_final.npz"), JConfig())
    assert it == 10 and np.asarray(key).tolist() == [0, 0]
    for k, v in r.state.params.items():
        np.testing.assert_array_equal(np.asarray(jstate.params[k]), v.numpy(), err_msg=k)
    alive = r.state.alive.numpy()
    np.testing.assert_array_equal(np.asarray(jstate.alive), alive)
    jscene = jckpt.import_ply(str(out / "scene_final.ply"))
    assert jscene.capacity == alive.sum()
    np.testing.assert_array_equal(np.asarray(jscene.xyz), r.state.params["xyz"].numpy()[alive])

    # resume from the periodic checkpoint
    out2 = tmp_path / "resumed"
    r2 = train_torch.main(TINY + RUN[2:] + [
        "--num_iters", "8", "--output_dir", str(out2), "--load_checkpoint", "true",
        "--checkpoint_path", str(out / "ckpt_iter_5.npz")])
    assert r2.start_iter == 5
    m2 = r2.metrics.to_dict()
    assert m2["eval_iters"] == [5, 8] and len(m2["train_psnr"]) == 3
    assert [e["iter"] for e in m2["adc_events"]] == []
    saved, _, _ = tckpt.load_checkpoint(str(out / "ckpt_iter_5.npz"), SplatConfig(),
                                        device="cpu")
    assert m2["num_gaussians"][0] == int(saved.alive.sum())


def test_cli_trains_a_colmap_dataset(tmp_path):
    """train_torch.py 7k on the COLMAP files of test_torch_dataio.py: the
    dataset's images are the targets, read once into device memory."""
    from tests.test_torch_dataio import DOWNSAMPLE, write_colmap

    root = str(tmp_path / "colmap")
    write_colmap(root)
    out = tmp_path / "run"
    r = train_torch.main(["7k", "--device", "cpu", "--dataset_path", root,
                          "--downsample_factor", str(DOWNSAMPLE), "--num_iters", "4",
                          "--test_split_ratio", "3", "--output_dir", str(out)])
    assert r.metrics.eval_iters == [0, 4] and len(r.metrics.train_psnr) == 4
    assert all(np.isfinite(r.metrics.train_psnr + r.metrics.test_psnr))
    for idx in r._gt_dev:
        np.testing.assert_array_equal(r.gt_image_dev(idx).numpy(), r.data.load_image(idx))
        np.testing.assert_array_equal(r.gt_image(idx).numpy(),
                                      r.data.load_image(idx).astype(np.float32) / 255.0)
    assert sorted(os.listdir(out)) == ["ckpt_final.npz", "config.yaml",
                                       "iter4_test_image_0.png", "iter4_test_image_3.png",
                                       "metrics.json", "scene_final.ply"]


def test_cli_per_pixel_sh_from_a_ply(tmp_path, monkeypatch):
    """--load_ply starts from a 3DGS .ply in the capacity derive_capacity
    gives its count; --use_sh_precompute false trains and evaluates
    through the per-pixel SH path (B3/B4's dispatchers) from band 1 on."""
    from gaussian_splatting_torch.dataio import dataset as tds
    from gaussian_splatting_torch.ops import render, render_sh

    data = make_synthetic_scene_data(150, 6, 0, 64, 48)
    ply = str(tmp_path / "start.ply")
    tckpt.export_ply(ply, tds.create_scene(data, SplatConfig(), 150, "cpu"))
    calls = {}

    def count(module, name):
        fn = getattr(module, name)

        def counted(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)

    for module, name in ((render, "render_fwd"), (render, "render_bwd"),
                         (render_sh, "render_sh_fwd"), (render_sh, "render_sh_bwd")):
        count(module, name)
    r = train_torch.main(TINY + ["--load_ply", ply, "--use_sh_precompute", "false",
                                 "--num_iters", "4", "--add_sh_band_interval", "1",
                                 "--output_dir", str(tmp_path / "run")])
    assert r.state.alive.shape[0] == trunner.derive_capacity(150, r.config) == 2048
    assert r.metrics.num_gaussians[0] == 150
    # the ground truth and the step and eval at band 0 stay on B1/B2
    assert calls == {"render_fwd": 6 + 1 + 2, "render_bwd": 1,
                     "render_sh_fwd": 3 + 2, "render_sh_bwd": 3}
    assert all(np.isfinite(r.metrics.train_psnr + r.metrics.test_psnr))


def test_cli_refusals(tmp_path):
    """The abort when ADC deletes every gaussian; no silent fallback to the
    CPU; the JAX runner's two refusals of a parallel layout: a capacity
    that model_parallel does not divide (raised on the ranks
    train_torch.main starts, and in the caller), and cameras of several
    sizes with data_parallel > 1."""
    with pytest.raises(RuntimeError, match="deleted every gaussian"):
        train_torch.main(TINY + RUN + ["--output_dir", str(tmp_path / "a"),
                                       "--delete_opacity_threshold", "0.99"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_torch.main(["synthetic", "--output_dir", str(tmp_path / "b")])
    with pytest.raises(ValueError, match="capacity 1024 must divide model_parallel=3"):
        train_torch.main(TINY + ["--model_parallel", "3", "--output_dir", str(tmp_path / "c")])
    from gaussian_splatting_torch.dataio.dataset import CameraInfo

    cfg = SplatConfig(**dict(SCHEDULE, data_parallel=2, output_dir=str(tmp_path / "d")))
    data = _data(cfg)
    data.cameras[1] = CameraInfo(K=data.cameras[0].K, width=16, height=16)
    data.images[0] = dataclasses.replace(data.images[0], camera_id=1)
    with pytest.raises(ValueError, match="single camera resolution"):
        trunner.TrainingRunner(data, cfg, synthetic=True, device="cpu")


def test_cli_runs_without_jax(tmp_path):
    """With jax and the JAX package unimportable, the runner, dataio and
    train_torch import, and a short run trains."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gaussian_splatting_tpu'] = None\n"
        "import gaussian_splatting_torch.runner, gaussian_splatting_torch.dataio, train_torch\n"
        f"r = train_torch.main({TINY + ['--num_iters', '3', '--output_dir', str(tmp_path)]!r})\n"
        "assert len(r.metrics.train_psnr) == 3\n"
        "bad = sorted(m for m in sys.modules if m.startswith('jax')\n"
        "             or m.startswith('gaussian_splatting_tpu'))\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert (tmp_path / "ckpt_final.npz").is_file()
