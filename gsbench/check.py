"""What decides ``correct``: the numbers compared between the program's
outcome and the plain reference's on the same inputs, each against its
limit (``limits/<workload>.json``).

Training, the first checked steps of the object the window then drives:
- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the first step's gradient, as Adam's first moment holds it
  after one step, by the worst leaf: the gap between the two norms of the
  leaf over the reference's norm of that leaf or of the median leaf,
  whichever is larger;
- ``step_gap``: the same of each leaf's change after the checked steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move under Adam by round-off alone);
- ``accum_gap``: the densification accumulators after the checked steps,
  the worst relative gap of their norms.
Serving, a sample of the window's views drawn from the seed:
- ``image_gap``: the largest difference of a pixel of the float image;
- ``T_gap``: the largest difference of a pixel's final transmittance.
"""

from __future__ import annotations

import math
import statistics

import torch

ACCUMULATORS = ("uv_grad_accum", "xyz_grad_accum", "grad_accum_count")
EXCLUDE_BELOW = 1e-3  # of the median leaf's reference gradient norm


def norm(t) -> float:
    return float(t.detach().double().norm())


def train_outcome(losses, grads, changes, accums) -> dict:
    return dict(losses=list(losses), grads=dict(grads), changes=dict(changes),
                accums=dict(accums))


def _rel(a, b, scale):
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / scale if scale > 0 else (0.0 if a == b else math.inf)


def leaf_gap(prog: dict, ref: dict, leaves) -> float:
    """The worst leaf's gap of norms, over max(its reference norm, the
    median leaf's)."""
    med = statistics.median(ref[k] for k in leaves)
    return max(_rel(prog[k], ref[k], max(ref[k], med)) for k in leaves)


def train_numbers(prog: dict, ref: dict) -> dict:
    med = statistics.median(ref["grads"].values())
    moved = [k for k, g in ref["grads"].items() if g >= EXCLUDE_BELOW * med]
    return dict(
        loss_gap=max(_rel(p, r, abs(r)) for p, r in zip(prog["losses"], ref["losses"])),
        grad_gap=leaf_gap(prog["grads"], ref["grads"], list(ref["grads"])),
        step_gap=leaf_gap(prog["changes"], ref["changes"], moved),
        accum_gap=max(_rel(prog["accums"][k], ref["accums"][k], ref["accums"][k])
                      for k in ACCUMULATORS),
    )


def serve_numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: view index -> (image (H, W, 3), T (n_tiles, 256))."""
    if not prog:
        return dict(image_gap=math.inf, T_gap=math.inf)
    img = max(float((prog[i][0] - ref[i][0]).abs().max()) for i in prog)
    T = max(float((prog[i][1] - ref[i][1]).abs().max()) for i in prog)
    bad = [i for i in prog if not (bool(torch.isfinite(prog[i][0]).all())
                                   and bool(torch.isfinite(prog[i][1]).all()))]
    return dict(image_gap=math.inf if bad else img, T_gap=math.inf if bad else T)


def with_limits(numbers: dict, limits: dict) -> dict:
    return {k: dict(value=v, limit=limits.get(k)) for k, v in numbers.items()}


def compare_serve(prog, ref, limits, want: int) -> dict:
    numbers = serve_numbers(prog, ref)
    numbers["views_checked"] = len(prog)
    out = with_limits(numbers, limits)
    out["views_checked"]["limit"] = want  # at least this many
    return out


def passed(checks: dict) -> bool:
    """Every number within its limit (views_checked: at least its limit)."""
    for k, c in checks.items():
        v, lim = c["value"], c["limit"]
        if lim is None or not math.isfinite(v):
            return False
        if (v < lim) if k == "views_checked" else (v > lim):
            return False
    return True
