"""The sort ladder with ``torch.sort`` (counterpart of
``experiments/sort_bench.py``).

The JAX script asks what ``lax.sort`` costs on the TPU by operand count,
with int64 operand packing, and as batched minor-axis sorts against one
global sort.  A layout redesign on the H100 starts from the same
questions, asked of ``torch.sort``: a sort of the int32 key, then a gather
of each value row by the sorted indices.

- global: 2^21 and 2^22 elements with 1, 2, 3, 6, 9 and 12 operands (the
  key and 0-11 int32 value rows);
- int64 packing: an int32 key with int32 and int64 value rows, (1, 3),
  (1, 0), (1, 1), (2, 6) of each, at both sizes, per int32-equivalent
  operand (an int64 row counts two);
- batched: ``dim=1`` sorts of 8, 64 and 512 rows that hold 2^22 elements
  together, with 2 and 12 operands;
- the port's layout key (``culling.build_layout``): int64
  ``tile << 32 | float32_bits(z)`` over 4,293 tiles, sorted stable, and its
  gaussian ids gathered.

Keys and values are the JAX script's draws, ``default_rng(0)`` integers in
[0, 2^30) (int64 rows in [0, 2^62)), in its order.  Times are
``timing.Timer``'s, ms and ms per million elements per operand.  Nothing
here launches a kernel of the port, so there is no plain version to hold
it to; each sort's keys are checked to come out in order.

    python -m gaussian_splatting_torch.experiments.sort_bench [--device cuda]

On ``--device cpu`` every size is 2^12, to check the code.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussian_splatting_torch import timing
from gaussian_splatting_torch.experiments import device_label, probe_args

SIZES = (1 << 21, 1 << 22)
SIZE_CPU = 1 << 12
OPERANDS = (1, 2, 3, 6, 9, 12)
PACKING = ((1, 3), (1, 0), (1, 1), (2, 6))  # (int32 rows with the key, int64 rows)
BATCH_ROWS = (8, 64, 512)
BATCH_OPERANDS = (2, 12)
LAYOUT_TILES = 4293  # 1296x840 in 16 px tiles
SEED = 0


def _rows(rng, n, count, dtype, device):
    high = 2**30 if dtype == torch.int32 else 2**62
    np_dtype = np.int32 if dtype == torch.int32 else np.int64
    return [torch.from_numpy(rng.integers(0, high, size=n, dtype=np_dtype)).to(device)
            for _ in range(count)]


def sort_with_values(key, values, dim=-1, stable=False):
    """The key sorted along ``dim`` and every value row gathered by its
    sorted indices."""
    sorted_key, idx = torch.sort(key, dim=dim, stable=stable)
    return [sorted_key] + [torch.gather(v, dim, idx) for v in values]


def layout_key(rng, n, device):
    """(int64 ``tile << 32 | float32_bits(z)``, int32 gaussian ids) for n
    random (tile, positive depth) pairs, as ``culling.build_layout`` forms
    them."""
    tile = torch.from_numpy(rng.integers(0, LAYOUT_TILES, size=n)).to(device)
    z = torch.from_numpy(rng.uniform(0.2, 100.0, size=n).astype(np.float32)).to(device)
    key = (tile << 32) | z.view(torch.int32).to(torch.int64)
    return key, torch.arange(n, dtype=torch.int32, device=device)


def _point(timer, kind, n, operands, key, values, dim=-1, stable=False, **extra):
    out = sort_with_values(key, values, dim=dim, stable=stable)
    s = out[0]
    if not bool((s.narrow(dim, 1, s.shape[dim] - 1) >= s.narrow(dim, 0, s.shape[dim] - 1))
                .all()):
        raise AssertionError(f"sort_bench: {kind} n={n}: keys out of order")
    del out, s
    ms = timer.ms(lambda: sort_with_values(key, values, dim=dim, stable=stable))
    return dict(kind=kind, n=n, operands=operands, ms=ms,
                ms_per_m_op=ms / operands / (n / 1e6), **extra)


def ladder(device, sizes=SIZES, operands=OPERANDS, packing=PACKING,
           batch_rows=BATCH_ROWS):
    """Every point of the ladder on ``device`` (every size 2^12 on the CPU),
    a dict each, in the order the JAX script runs them, the layout key's
    points last."""
    dev = torch.device(device)
    timer = timing.Timer(dev)
    if not timer.cuda:
        sizes = (SIZE_CPU,)
    rng = np.random.default_rng(SEED)
    points = []
    for n in sizes:
        for k in operands:
            key, *values = _rows(rng, n, k, torch.int32, dev)
            points.append(_point(timer, "global", n, k, key, values))
    for n in sizes:
        for n32, n64 in packing:
            key, *values = _rows(rng, n, n32, torch.int32, dev)
            values += _rows(rng, n, n64, torch.int64, dev)
            points.append(_point(timer, "int64 packing", n, n32 + 2 * n64, key, values,
                                 int32_rows=n32, int64_rows=n64))
    n = max(sizes)
    for rows in batch_rows:
        if n % rows:
            continue
        for k in BATCH_OPERANDS:
            key, *values = (t.view(rows, n // rows)
                            for t in _rows(rng, n, k, torch.int32, dev))
            points.append(_point(timer, "batched", n, k, key, values, dim=1, rows=rows))
    for n in sizes:
        key, gid = layout_key(rng, n, dev)
        # the int64 key counts two int32 operands, the gathered ids one
        points.append(_point(timer, "layout key", n, 3, key, [gid], stable=True))
    return points, dict(clock=timer.clock)


def line(p: dict) -> str:
    if p["kind"] == "int64 packing":
        what = (f"i32x{p['int32_rows']} i64x{p['int64_rows']} (={p['operands']} "
                f"i32-eq)")
    elif p["kind"] == "batched":
        what = f"{p['rows']}x{p['n'] // p['rows']} ops={p['operands']:2d}"
    elif p["kind"] == "layout key":
        what = "int64 stable + int32 ids (=3 i32-eq)"
    else:
        what = f"ops={p['operands']:2d}"
    return (f"{p['kind']} n=2^{p['n'].bit_length() - 1} {what}: {p['ms']:8.4f} ms "
            f"({p['ms_per_m_op']:.4f} ms/M/op)")


def main(argv=None):
    args = probe_args("the sort ladder with torch.sort", argv)
    points, info = ladder(args.device)
    print(f"sort_bench on {device_label(args.device)} ({info['clock']})", flush=True)
    for p in points:
        print(line(p), flush=True)
    return points


if __name__ == "__main__":
    main()
