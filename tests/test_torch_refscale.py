"""The reference-scale run of the port on the CPU: the runner's schedule
over runs/refscale7k/config.yaml against the JAX run's record (the event
function over 7,000 iterations, and ``TrainingRunner.train`` driven through
them with the trainer's functions replaced by recorders); the port's
``make_bench_scene`` bitwise against the JAX script's; ``refscale_run``'s
flags against experiments/refscale_run.sh's; and ``refscale_run.main`` end
to end at a tiny cut."""

import dataclasses
import json
import os
import shlex
import subprocess
import sys

import numpy as np
import pytest
import torch

import train
import train_torch
from gaussian_splatting_torch import checkpoint as tckpt
from gaussian_splatting_torch import runner as trunner
from gaussian_splatting_torch import trainer as ttrainer
from gaussian_splatting_torch.config import SplatConfig
from gaussian_splatting_torch.dataio import dataset as tds
from gaussian_splatting_torch.dataio.dataset import make_synthetic_scene_data
from gaussian_splatting_torch.experiments import make_bench_scene, refscale_run
from tests.test_torch_runner import Recorder, _record_port
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(ROOT, "runs", "refscale7k")
# a cut of the run's sizes for the CPU; its schedule stays the script's
TINY = dict(num_iters=3, synthetic_points=100, synthetic_init_points=50, synthetic_images=4,
            synthetic_width=32, synthetic_height=24)


def _config():
    with open(os.path.join(RECORD, "config.yaml")) as f:
        return SplatConfig.from_yaml(f.read())


def _record():
    with open(os.path.join(RECORD, "metrics.json")) as f:
        return json.load(f)


def test_scheduled_events_match_the_jax_record():
    """scheduled_events over iterations 0..6999 of the JAX run's config:
    its 57 ADC events and 14 evals (the 15th, at 7000, is train()'s tail),
    the resets at 3001 and 6002, the checkpoint at 3500, a debug image
    every 200 (the record's files) and SH bands from 1000, 2000, 3000."""
    cfg, rec = _config(), _record()
    events = [trunner.scheduled_events(cfg, i) for i in range(cfg.num_iters)]

    def at(kind):
        return [i for i, e in enumerate(events) if getattr(e, kind)]

    assert at("adc") == [e["iter"] for e in rec["adc_events"]] == list(range(800, 6401, 100))
    assert at("eval") + [cfg.num_iters] == rec["eval_iters"] == list(range(0, 7001, 500))
    assert at("reset") == [3001, 6002]
    assert at("checkpoint") == [3500]
    debug = sorted(int(f[len("debug_iter"):-len(".png")]) for f in os.listdir(RECORD)
                   if f.startswith("debug_iter"))
    assert at("debug_image") == debug == list(range(200, 7000, 200))
    bands = [ttrainer.sh_band_for_iteration(cfg, i) for i in range(cfg.num_iters)]
    assert [i for i in range(1, cfg.num_iters) if bands[i] != bands[i - 1]] == [1000, 2000, 3000]
    assert bands[0] == 0 and bands[-1] == 3


def test_train_loop_runs_the_record_schedule(tmp_path, monkeypatch):
    """TrainingRunner.train over the JAX run's 7,000-iteration schedule,
    the trainer's functions and the files replaced by recorders: the
    events fire at the record's iterations, in the loop's order, and the
    final eval, checkpoint and ply come at 7000."""
    cfg = _config().replace(output_dir=str(tmp_path))
    data = make_synthetic_scene_data(40, 8, 0, 16, 12)
    rec = Recorder(data)
    _record_port(monkeypatch, rec)
    tr = trunner.TrainingRunner(data, cfg, synthetic=True, device="cpu")
    tr.train()
    kinds = [e[0] for e in rec.events]
    # ("eval", steps taken, view, ...) of a test view comes before step i
    # (the debug image renders a train view), every other event after it
    test = set(tr.test_split.tolist())
    evals = list(dict.fromkeys(e[1] for e in rec.events if e[0] == "eval" and e[2] in test))
    after = {k: [e for e in rec.events if e[0] == k] for k in ("adc", "reset", "png", "ckpt")}
    record = _record()
    assert rec.steps == kinds.count("step") == cfg.num_iters
    assert evals == record["eval_iters"]
    assert [e[2] for e in after["adc"]] == [e[1] - 1 for e in after["adc"]] == [
        e["iter"] for e in record["adc_events"]]
    assert [e[1] - 1 for e in after["reset"]] == [3001, 6002]
    assert [e[2] for e in after["png"] if e[2].startswith("debug")] == [
        f"debug_iter{i}.png" for i in range(200, 7000, 200)]
    assert [e[2:] for e in after["ckpt"]] == [(3500, "ckpt_iter_3500.npz"),
                                              (7000, "ckpt_final.npz")]
    assert kinds[-2:] == ["ckpt", "ply"]
    assert tr.metrics.eval_iters == record["eval_iters"]


def _shell_train_flags():
    """train.py's arguments in experiments/refscale_run.sh, with $OUT as
    'OUT'."""
    with open(os.path.join(ROOT, "experiments", "refscale_run.sh")) as f:
        text = f.read()
    cmd = text[text.index("python -u train.py"):text.index("2>&1")]
    tokens = shlex.split(cmd.replace("\\\n", " "))
    assert tokens[:3] == ["python", "-u", "train.py"]
    return [t.replace("$OUT", "OUT") for t in tokens[3:]]


def test_argv_is_the_shell_scripts():
    """refscale_run's arguments of train_torch.main are the shell script's
    arguments of train.py plus --device, and both CLIs parse them to the
    same config."""
    shell = _shell_train_flags()
    assert refscale_run.train_argv("OUT") == shell + ["--device", "cuda"]
    assert refscale_run.train_argv("OUT", "cpu")[-2:] == ["--device", "cpu"]
    port = vars(train_torch.build_parser().parse_args(refscale_run.train_argv("OUT")))
    jax = vars(train.build_parser().parse_args(shell))
    assert port.pop("device") == "cuda"
    assert port == jax
    assert (port["num_iters"], port["synthetic_points"], port["synthetic_init_points"],
            port["checkpoint_interval"]) == (7000, 1_200_000, 200_000, 3500)


@pytest.fixture(scope="module")
def small_checkpoint(tmp_path_factory):
    """A port checkpoint of 300 gaussians in 512 slots, a few of them dead
    between alive ones, at iteration 1234."""
    path = str(tmp_path_factory.mktemp("ckpt") / "ckpt.npz")
    data = make_synthetic_scene_data(300, 4, 3, 32, 24)
    state = ttrainer.init_train_state(tds.create_scene(data, SplatConfig(), 512, "cpu"),
                                      SplatConfig())
    state.alive[5:200:7] = False
    tckpt.save_checkpoint(path, state, 1234, torch.Generator().manual_seed(0))
    return path, int(state.alive.sum())


@pytest.mark.parametrize("n", [100, 10_000])
def test_make_bench_scene_equals_the_jax_script(small_checkpoint, n, tmp_path):
    """The port's make_bench_scene and experiments/make_bench_scene.py (in a
    subprocess on the CPU) write the same arrays, bitwise, from one port
    checkpoint; with n above the alive count both keep every alive
    gaussian."""
    path, n_alive = small_checkpoint
    port, jax = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert make_bench_scene.main([path, "--out", port, "--n", str(n), "--device", "cpu"]) == port
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, os.path.join("experiments", "make_bench_scene.py"),
                          path, "--out", jax, "--n", str(n)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(port) as p, np.load(jax) as j:
        assert p.files == j.files == ["xyz", "scale", "opacity", "quat", "nn", "n_alive",
                                      "iteration"]
        for k in p.files:
            assert p[k].dtype == j[k].dtype and np.array_equal(p[k], j[k]), k
        assert int(p["n_alive"]) == n_alive and int(p["iteration"]) == 1234
        assert p["xyz"].shape == (min(n, n_alive), 3) and (p["nn"] > 0).all()


def test_make_bench_scene_refusals(small_checkpoint, tmp_path):
    """--out is required, the committed sample is never written, and no
    CPU fallback when the card is missing."""
    path, _ = small_checkpoint
    with pytest.raises(SystemExit):
        make_bench_scene.main([path, "--device", "cpu"])
    with pytest.raises(ValueError, match="committed"):
        make_bench_scene.main([path, "--out", os.path.join(ROOT, "bench_scene_sample.npz"),
                               "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_bench_scene.main([path, "--out", str(tmp_path / "s.npz")])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            refscale_run.main([str(tmp_path / "run")])


def test_refscale_run_end_to_end_at_a_tiny_cut(tmp_path):
    """refscale_run.main on the CPU with the sizes cut through its
    arguments: the runner it returns, the run's files with the script's
    flags in config.yaml, and a bench sample of the final state."""
    out = tmp_path / "run"
    r = refscale_run.main([str(out), "--device", "cpu"], **TINY)
    assert isinstance(r, trunner.TrainingRunner) and r.device.type == "cpu"
    assert {"config.yaml", "metrics.json", "ckpt_final.npz", "scene_final.ply",
            refscale_run.SAMPLE} <= set(os.listdir(out))
    with open(out / "config.yaml") as f:
        cfg = SplatConfig.from_yaml(f.read())
    assert cfg == dataclasses.replace(
        r.config, **dict(refscale_run.FLAGS, **TINY, output_dir=str(out)))
    assert (cfg.max_gaussians, cfg.checkpoint_interval, cfg.steps_per_dispatch) == (
        4_000_000, 3500, 25)
    metrics = json.loads((out / "metrics.json").read_text())
    assert metrics["eval_iters"] == [0, 3] and len(metrics["train_psnr"]) == 3
    n_alive = int(r.state.alive.sum())
    want = make_bench_scene.bench_sample(r.state, 3, 50_000)
    with np.load(out / refscale_run.SAMPLE) as z:
        assert z.files == list(want)
        for k in z.files:
            assert np.array_equal(z[k], want[k]), k
        assert int(z["n_alive"]) == n_alive == TINY["synthetic_init_points"]


def test_runs_without_jax():
    """With jax and the JAX package unimportable, refscale_run and
    make_bench_scene import, and neither pulls in jax."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gaussian_splatting_tpu'] = None\n"
        "from gaussian_splatting_torch.experiments import make_bench_scene, refscale_run\n"
        "import train_torch, scipy.spatial\n"
        "bad = sorted(m for m in sys.modules if m.startswith('jax')\n"
        "             or m.startswith('gaussian_splatting_tpu'))\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
