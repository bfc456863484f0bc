"""Test settings of the benchmark: the ``card`` marker for tests that need
an NVIDIA card (run them there with ``python3 -m pytest gsbench/tests -m
card``), and a small cell that the CPU runs in seconds."""

import copy

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


TINY = dict(alive=1500, capacity=2048, width=64, height=48, focal=60.0)


@pytest.fixture
def tiny_cell():
    """``tiny_cell(name)``: the cell of BENCHMARK.json at a size the CPU
    runs in seconds (1,500 gaussians in 2,048 slots at 64x48), with its
    committed limits."""
    from gsbench import spec

    def make(name):
        cell = spec.load_cell(name)
        cell = copy.deepcopy(cell)
        cell.config.update(TINY)
        if cell.traffic.get("alive"):
            cell.traffic["alive"] = TINY["alive"] // 4
        if cell.traffic["kind"] == "serve":  # a short window reaches its checked views
            cell.traffic.update(sample_from=8, trace_from=2)
        return cell

    return make


@pytest.fixture
def card():
    """The CUDA device, or a skip."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")
