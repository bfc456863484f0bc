"""On the card: the program's kernels against the plain reference at a
small size, and a whole run of each cell's traffic through the harness."""

import pytest

from gsbench import harness, spec

pytestmark = pytest.mark.card
NAMES = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("name", NAMES)
def test_small_run_on_the_card_is_correct(tiny_cell, card, name):
    res = harness.make(tiny_cell(name), 21, card).run(3.0, True, 0.0)
    assert res.correct, res.checks
    assert res.trace is not None and res.trace.busy_s > 0
    assert res.trace.parts.get("layout", 0) > 0
