"""Terminal chart of a training run, printed at its end (counterpart of
``gaussian_splatting_tpu/plot.py``).

The reference draws a plotext dual-axis figure (train and test PSNR on the
left axis, gaussian count on the right); this is the same chart in plain
ASCII, so it needs no package and works in any terminal.
"""

from __future__ import annotations


def _downsample(xs, n):
    if len(xs) <= n:
        return list(xs)
    step = len(xs) / n
    return [xs[int(i * step)] for i in range(n)]


def _scale(v, lo, hi, rows):
    if hi <= lo:
        return 0
    return min(rows - 1, max(0, int((v - lo) / (hi - lo) * (rows - 1))))


def terminal_plot(metrics, width: int = 100, height: int = 18) -> str:
    """ASCII chart of a ``GSMetricsLog``; returns the printable text.

    '.' = train PSNR per iteration, 'x' = test PSNR per eval, '#' =
    gaussian count (scaled on its own to the same rows, right axis).
    """
    train = [p for p in metrics.train_psnr if p == p]  # drop NaN
    test = list(metrics.test_psnr)
    counts = list(metrics.num_gaussians)
    if not train:
        return "(no metrics recorded)"

    cols = max(10, width - 12)
    rows = height
    grid = [[" "] * cols for _ in range(rows)]

    psnr_vals = train + test
    p_lo, p_hi = min(psnr_vals), max(psnr_vals)
    c_lo = min(counts) if counts else 0
    c_hi = max(counts) if counts else 1

    for series, mark in ((counts, "#"), (train, "."), (test, "x")):
        if not series:
            continue
        lo, hi = (c_lo, c_hi) if mark == "#" else (p_lo, p_hi)
        pts = _downsample(series, cols)
        # test evals are sparse: spread them over the full width
        for i, v in enumerate(pts):
            col = int(i * cols / len(pts))
            row = rows - 1 - _scale(v, lo, hi, rows)
            grid[row][col] = mark

    lines = [
        f"PSNR {p_lo:6.2f}..{p_hi:6.2f} (. train, x test)   "
        f"N {c_lo}..{c_hi} (#)"
    ]
    for r, row in enumerate(grid):
        frac = 1.0 - r / max(1, rows - 1)
        label = p_lo + frac * (p_hi - p_lo)
        lines.append(f"{label:8.2f} |" + "".join(row))
    lines.append(" " * 9 + "+" + "-" * cols)
    lines.append(" " * 10 + f"iterations 0..{len(train)}")
    return "\n".join(lines)
