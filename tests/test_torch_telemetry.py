"""The port's spans and counters (``gaussian_splatting_torch.telemetry``)
on the CPU: nothing recorded while recording is off; a layout's sizes and
its host reads counted inside ``recording()``; the window a profiler opens;
the spans a CPU profile shows, on the host timeline alone except the five
layer spans the benchmark's trace reader knows; ``telemetry.json`` beside
a runner's trace."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gaussian_splatting_torch import culling, telemetry, trainer
from gaussian_splatting_torch.config import SplatConfig
from gaussian_splatting_torch.dataio.dataset import make_synthetic_scene_data
from gaussian_splatting_torch.rasterize import rasterize
from gaussian_splatting_torch.runner import TrainingRunner
from gaussian_splatting_torch.structs import Camera, GaussianScene, TileGrid
from gsbench import trace as gstrace
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

N, H, W = 300, 48, 64
LAYOUT_READS = ("visible", "truncated", "nonzero", "repeat_gid", "repeat_first",
                "hit_gid", "hit_tx", "hit_ty")
# a repeat_interleave with tensor repeats reads the device twice
READS = dict.fromkeys(LAYOUT_READS, 1) | {"repeat_gid": 2, "repeat_first": 2}


def _scene(n=N, seed=3):
    """n gaussians in front of an identity camera at 64x48."""
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand(n, 3, generator=g) * torch.tensor([4.0, 3.0, 4.0]) - torch.tensor(
        [2.0, 1.5, -2.0])
    params = dict(
        xyz=xyz, rgb=torch.rand(n, 3, generator=g), opacity=torch.randn(n, 1, generator=g),
        scale=torch.rand(n, 3, generator=g) * 2.0 - 4.0,
        quaternion=torch.randn(n, 4, generator=g), sh=torch.randn(n, 3, 15, generator=g) * 0.1)
    alive = torch.ones(n, dtype=torch.bool)
    alive[::7] = False
    return params, alive


CAMERA = Camera(K=torch.tensor([[60.0, 0.0, W / 2], [0.0, 60.0, H / 2], [0.0, 0.0, 1.0]]),
                width=W, height=H)
POSE = torch.eye(4)
RENDER = dict(near_thresh=0.3, far_thresh=100.0, cull_mask_padding=10.0, mh_dist=3.0)


def _serve(params, alive):
    with torch.no_grad():
        return rasterize(params, alive, POSE, CAMERA, background_rgb=torch.zeros(3),
                         n_sh_band=1, **RENDER)


def _train_step():
    params, alive = _scene()
    scene = GaussianScene(*(params[k] for k in ("xyz", "rgb", "opacity", "scale",
                                                "quaternion", "sh")), alive)
    config = SplatConfig()
    state = trainer.init_train_state(scene, config)
    gt = torch.rand(H, W, 3, generator=torch.Generator().manual_seed(1))
    return lambda: trainer.train_step(state, gt, CAMERA.K, POSE, torch.zeros(3),
                                      config=config, camera_hw=(H, W), n_sh_band=1)


def test_recording_off_keeps_nothing():
    """No profiler and no recording() block: span is one shared no-op and
    neither a layout nor a step reaches the window."""
    telemetry.count("sync.made_up")  # closes a window an earlier profiler left open
    before = telemetry.window()
    assert telemetry.span("gs::layout") is telemetry.span("gs::layout.sort")
    telemetry.count("sync.made_up", 3)
    _serve(*_scene())
    _train_step()()
    assert telemetry.window() == before


def test_recording_counts_a_layout_and_its_reads():
    """A layout counted inside recording(): its three sizes as it returns
    them, its ten host reads at their eight sites, each stage a span."""
    g = torch.Generator().manual_seed(0)
    n = 400
    u, v = torch.rand(n, generator=g) * 1100, torch.rand(n, generator=g) * 1100
    conic = (torch.rand(n, generator=g) * 2 + 0.5, torch.zeros(n),
             torch.rand(n, generator=g) * 2 + 0.5)
    z = torch.rand(n, generator=g) * 5 + 1
    # one gaussian whose window covers more than MAX_WINDOW_CELLS tiles
    u[0], v[0], conic[0][0], conic[2][0] = 550.0, 550.0, 1e6, 1e6
    grid = TileGrid(1100, 1100)
    with telemetry.recording():
        layout = culling.build_layout(u, v, conic, z, torch.ones(n, dtype=torch.bool),
                                      grid, 3.0)
    w = telemetry.window()
    assert layout.truncated > 0
    want = dict(splats=layout.num_splats, visible=layout.num_visible,
                truncated_cells=layout.truncated,
                **{f"sync.layout.{r}": READS[r] for r in LAYOUT_READS})
    assert w["counters"] == want
    assert set(w["spans"]) == {f"gs::layout.{s}" for s in ("cull", "enumerate", "sat",
                                                            "sort")}
    assert all(s["calls"] == 1 and s["host_s"] > 0 for s in w["spans"].values())
    assert w["closed_ns"] >= w["opened_ns"] > 0


def test_window_opens_with_a_profiler_and_keeps_the_last_stretch():
    """The window opens at the first count under a profiler, stays the
    window after the profiler stops, and closes at the next count; a second
    profiler opens a new one."""
    params, alive = _scene()
    telemetry.count("sync.made_up")  # off: counted nowhere
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            res = _serve(params, alive)
    first = telemetry.window()
    assert first["closed_ns"] is None
    assert first["counters"]["views"] == 2
    assert first["counters"]["splats"] == 2 * res.num_splats
    assert first["spans"]["gs::render"]["calls"] == 2
    assert "sync.made_up" not in first["counters"]
    _serve(params, alive)  # after the profiler: closes the window, counts nothing
    closed = telemetry.window()
    assert closed["closed_ns"] >= closed["opened_ns"]
    assert closed["counters"] == first["counters"]
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(params, alive)
    assert telemetry.window()["counters"]["views"] == 1
    assert telemetry.window()["opened_ns"] >= closed["closed_ns"]


@pytest.mark.parametrize("path", ["train_step", "serve"])
def test_only_layer_spans_are_user_annotations(path):
    """Under a CPU profile, the user annotations (the device-timeline
    ranges of a card's trace) are the benchmark reader's span names, and
    every other span of the window is a host event that is not one."""
    params, alive = _scene()
    step = _train_step() if path == "train_step" else (lambda: _serve(params, alive))
    telemetry.count("sync.made_up")  # closes the window of an earlier profiler
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    spans = set(telemetry.window()["spans"])
    events = prof.events()
    annotations = {e.name for e in events if e.is_user_annotation}
    assert annotations <= set(gstrace.SPANS)
    assert annotations == spans & telemetry.LAYERS
    plain = {e.name for e in events if not e.is_user_annotation}
    new = spans - telemetry.LAYERS
    assert new and new <= plain and not new & annotations
    want = {"gs::render.geometry", "gs::render.features", "gs::render.raster",
            "gs::layout.cull", "gs::layout.enumerate", "gs::layout.sat", "gs::layout.sort"}
    assert want <= new
    if path == "train_step":
        assert "gs::step" in new
        assert {"gs::render", "gs::layout", "gs::loss", "gs::backward",
                "gs::adam"} == annotations


def test_span_intervals_nest_on_the_profiler_clock():
    """Each stage's host interval lies inside its parent's."""
    step = _train_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    ranges = {}
    for e in prof.events():
        if e.name.startswith("gs::"):
            ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    parents = {"gs::layout.cull": "gs::layout", "gs::layout.sort": "gs::layout",
               "gs::layout": "gs::render", "gs::render.geometry": "gs::render",
               "gs::render.raster": "gs::render", "gs::render": "gs::step",
               "gs::loss": "gs::step", "gs::adam": "gs::step", "gs::backward": "gs::step"}
    for child, parent in parents.items():
        for a, b in ranges[child]:
            assert any(pa <= a and b <= pb for pa, pb in ranges[parent]), (child, parent)


def test_runner_writes_telemetry_beside_its_trace(tmp_path):
    """The runner's profile window writes trace/telemetry.json: the
    window's counters and span totals over the profiled steps."""
    cfg = SplatConfig(num_iters=6, profile_start=2, profile_steps=3, test_eval_interval=100,
                      print_interval=100, adaptive_control_start=100,
                      reset_opacity_start=100, save_debug_image_interval=0,
                      checkpoint_interval=0, synthetic_points=60, synthetic_init_points=30,
                      synthetic_images=4, synthetic_width=32, synthetic_height=24, seed=5,
                      output_dir=str(tmp_path))
    data = make_synthetic_scene_data(cfg.synthetic_points, cfg.synthetic_images, cfg.seed,
                                     cfg.synthetic_width, cfg.synthetic_height)
    TrainingRunner(data, cfg, synthetic=True, device="cpu").train()
    assert (tmp_path / "trace" / "trace.json").is_file()
    with open(tmp_path / "trace" / "telemetry.json") as f:
        w = json.load(f)
    c = w["counters"]
    assert c["steps"] == 3 and c["views"] == 3
    assert c["sync.run.drain"] == 3  # the three steps' infos, read as the window ends
    assert all(c[f"sync.layout.{r}"] == 3 * READS[r] for r in LAYOUT_READS)
    assert w["spans"]["gs::step"]["calls"] == 3
    assert w["spans"]["gs::run.drain"]["host_s"] > 0
    assert np.isfinite(w["spans"]["gs::render"]["host_s"])
