"""The inputs are made from the seed alone."""

import math

import pytest
import torch

from gsbench import scene, spec

CONFIG = spec.load_json(spec.HERE / "configs" / "garden7k-sh3-precompute.json")
SMALL = dict(CONFIG, capacity=1024)


def test_bootstrap_is_deterministic_for_one_seed():
    a = scene.load(SMALL, 700, 5, torch.device("cpu"))
    b = scene.load(SMALL, 700, 5, torch.device("cpu"))
    c = scene.load(SMALL, 700, 6, torch.device("cpu"))
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k])
    assert not torch.equal(a["params"]["xyz"], c["params"]["xyz"])
    assert a["distance"] == b["distance"]


def test_bootstrap_law():
    s = scene.load(SMALL, 700, 5, torch.device("cpu"))
    p, alive = s["params"], s["alive"]
    assert int(alive.sum()) == 700 and not bool(alive[700:].any())
    assert torch.equal(p["quaternion"][700:], torch.tensor([[1.0, 0, 0, 0]]).expand(324, 4))
    rgb = p["rgb"][:700] * CONFIG["bootstrap"]["rgb_over"]
    assert float(rgb.min()) >= 0 and float(rgb.max()) < 1
    assert not bool(p["sh"].any())


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**33])
def test_large_seeds(seed):
    got = scene.seeds(seed, 3)
    assert len(set(got)) == 3 and all(0 <= s < 2**63 for s in got)
    assert got == scene.seeds(seed, 3)


def test_ring_cameras_look_at_the_centroid():
    s = scene.load(SMALL, 700, 5, torch.device("cpu"))
    for T in scene.ring_poses(s, 8):
        c = T[:3, :3] @ s["centroid"] + T[:3, 3]
        assert abs(float(c[0])) < 1e-3 and abs(float(c[1])) < 1e-3
        assert math.isclose(float(c[2]), s["distance"], rel_tol=1e-5)
