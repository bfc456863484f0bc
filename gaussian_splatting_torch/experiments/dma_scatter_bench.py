"""E3: placing row blocks at data-dependent offsets (counterpart of
``experiments/dma_scatter_bench.py``).

The question: how fast can a pass move every row to a row offset that the
data decides, the placement pass of a bucket sort, and what does each copy
cost?  x (n_rows, 128) float32 is cut into copies of ``sub`` rows, and copy
b goes to

    out[off[b] : off[b] + sub] = x[b*sub : (b+1)*sub]

Rows that no copy covers are undefined (``torch.empty``), as in the JAX
probe; the sweep's offsets are a permutation, so every row is written.

``place`` launches the hand-written kernel ``csrc/probes/dma_scatter.cu`` (which
replaces the Pallas kernel ``experiments/dma_scatter_bench.py::make_scatter``)
on a CUDA tensor and runs ``place_plain``, a loop of slice copies like the
JAX kernel's DMA loop, on a CPU tensor, with no fallback between them.
``place_library`` is the yardstick: one ``Tensor.index_copy_``.

    python -m gaussian_splatting_torch.experiments.dma_scatter_bench [--device cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from gaussian_splatting_torch import _build, telemetry, timing
from gaussian_splatting_torch.experiments import (
    device_label,
    probe_args,
    sort_line,
    sort_ms,
)

LANES = 128
N_ROWS = 1 << 15  # 32k rows x 128 lanes = 16.8 MB, as the JAX probe
N_ROWS_CPU = 1 << 12
BLOCK_ROWS = (2048, 512)
NSUBS = (1, 4, 16, 64)
SEED = 0


def place_reference(x: np.ndarray, off: np.ndarray, sub: int) -> np.ndarray:
    """numpy reference, the JAX probe's check."""
    want = np.zeros_like(x)
    for b, dst in enumerate(off):
        want[dst:dst + sub] = x[b * sub:(b + 1) * sub]
    return want


def place_plain(x, off, sub: int):
    """Plain PyTorch version of the kernel: one slice copy per block, as
    the JAX kernel issues one DMA per sub-range."""
    out = torch.empty_like(x)
    for b, dst in enumerate(off.tolist()):
        out[dst:dst + sub] = x[b * sub:(b + 1) * sub]
    return out


def _check_args(name, x, off, sub):
    if x.dim() != 2 or x.shape[1] != LANES or x.dtype != torch.float32:
        raise ValueError(f"{name}: x must be float32 (n_rows, {LANES}), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if sub <= 0 or x.shape[0] % sub:
        raise ValueError(f"{name}: sub {sub} must divide n_rows = {x.shape[0]}")
    if off.dtype != torch.int32 or tuple(off.shape) != (x.shape[0] // sub,):
        raise ValueError(f"{name}: off must be int32 ({x.shape[0] // sub},), got "
                         f"{off.dtype} {tuple(off.shape)}")


def place_cuda(x, off, sub: int):
    """Launch the kernel on the current stream; same contract as
    ``place_plain`` (a row whose destination falls outside x is dropped)."""
    _check_args("place", x, off, sub)
    if not x.is_cuda or off.device != x.device:
        raise ValueError(f"place: the kernel needs x and off on one CUDA device, "
                         f"got {x.device} and {off.device}")
    if not (x.is_contiguous() and off.is_contiguous()) or x.data_ptr() % 16:
        raise ValueError("place: x and off must be contiguous, x 16-byte aligned")
    out = torch.empty_like(x)
    err = _build.library("probes").gs_place_probe(
        x.data_ptr(), x.shape[0], off.data_ptr(), sub, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "gs_place_probe")
    telemetry.LAUNCHES["place_probe"] += 1
    return out


def place(x, off, sub: int):
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    _check_args("place", x, off, sub)
    if x.is_cuda:
        return place_cuda(x, off, sub)
    if x.device.type == "cpu":
        return place_plain(x, off, sub)
    raise ValueError(f"place: no kernel for device {x.device}")


def library_index(off, sub: int):
    """off as ``index_copy_`` takes it: int64 block indices off // sub."""
    return off.long() // sub


def place_library(x, index, sub: int):
    """One ``Tensor.index_copy_`` of the (n_rows/sub, sub, 128) views;
    ``index`` from ``library_index``."""
    out = torch.empty_like(x)
    out.view(-1, sub, LANES).index_copy_(0, index, x.view(-1, sub, LANES))
    return out


def sweep(device):
    """The JAX probe's sweep (rows_blk in ``BLOCK_ROWS`` x nsub in ``NSUBS``,
    sub = rows_blk / nsub; n_rows = 2^15 on a CUDA device, 2^12 on the CPU;
    seed 0), every point checked bitwise against the plain version and the
    numpy reference.  Returns (points, info), one dict per point."""
    dev = torch.device(device)
    timer = timing.Timer(dev)
    n_rows = N_ROWS if timer.cuda else N_ROWS_CPU
    rng = np.random.default_rng(SEED)
    x_np = rng.normal(size=(n_rows, LANES)).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    points = []
    for rows_blk in BLOCK_ROWS:
        for nsub in NSUBS:
            sub = rows_blk // nsub
            off_np = rng.permutation(n_rows // sub).astype(np.int32) * sub
            off = torch.from_numpy(off_np).to(dev)
            index = library_index(off, sub)
            got = place(x, off, sub)
            plain = place_plain(x, off, sub)
            lib = place_library(x, index, sub)
            want = torch.from_numpy(place_reference(x_np, off_np, sub)).to(dev)
            ok = bool(torch.equal(got, plain) and torch.equal(got, want)
                      and torch.equal(lib, want))
            ms, plain_ms, lib_ms = timing.compare(
                timer, lambda: place(x, off, sub), lambda: place_plain(x, off, sub),
                lambda: place_library(x, index, sub))
            copies = n_rows // sub
            points.append(dict(
                point=f"rows_blk={rows_blk} nsub={nsub}", rows_blk=rows_blk,
                nsub=nsub, sub=sub, copies=copies, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bytes=2 * n_rows * LANES * 4 + 4 * copies,
                ops=0, max_abs_err=float((got - plain).abs().max()), ok=ok))
    sort = sort_ms(timer, torch.from_numpy(
        rng.integers(-(2**31), 2**31, size=n_rows * LANES, dtype=np.int64)
        .astype(np.int32)).to(dev))
    return points, dict(n_rows=n_rows, clock=timer.clock, sort=sort)


def main(argv=None):
    args = probe_args("E3: block placement at data-dependent offsets", argv)
    points, info = sweep(args.device)
    n_rows = info["n_rows"]
    print(f"E3 place on {device_label(args.device)}: x ({n_rows}, {LANES}) "
          f"float32 ({info['clock']})", flush=True)
    for p in points:
        print(f"blk={p['rows_blk']:5d} nsub={p['nsub']:3d} sub_rows={p['sub']:5d} "
              f"copies={p['copies']:6d}: {p['ms']:7.4f} ms  "
              f"{p['bytes'] / p['ms'] / 1e6:7.1f} GB/s ({p['ms'] / p['copies'] * 1e3:.4f} "
              f"us/copy); plain {p['plain_ms']:.3f} ms, index_copy_ "
              f"{p['library_ms']:.4f} ms  {'OK' if p['ok'] else 'MISMATCH'}", flush=True)
    best = min(p["ms"] for p in points) / (n_rows * LANES / 1e6)
    print(f"{sort_line(info['sort'])}; placement of the same number of "
          f"elements: {best:.4f} ms/M at best")
    if not all(p["ok"] for p in points):
        raise SystemExit("E3: the kernel disagrees with its plain version")


if __name__ == "__main__":
    main()
